"""The serving tick's front end: wrapper of ``csrc/stream_update.cu``.

Replaces ``repro/kernels/stream_update.py::stream_update`` in both modes,
fused with the eviction repair the JAX engines run before it
(``repro/core/online.py::drop_backfill``): one launch per tick repairs
the lists of the rows that held each tenant's evicted point (in place,
over those rows only), then computes the distance row of each tenant's
new point against its ring block and inserts the gated candidate into
every row's ascending k-best list. ``mode="class"`` (the classification
tick) gates on the label and keeps distances only; ``mode="reg"`` (the
regression tick) gates on ``d < kth`` and carries the neighbour labels
and arrival ids along. Memory-bound; see the source for the
design and bound.

On a CPU tensor the wrapper runs the plain version (``ref.stream_tick``);
on a CUDA tensor it launches the kernel of the mode or raises.
``stream_update_class.launches`` and ``stream_update_reg.launches`` count
kernel launches per mode.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

MAX_K = 32


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"stream_update kernel: {what}")


def stream_update(X, y, nbr_d, nbr_y, x_new, y_new, n, *, mode: str,
                  head, wrap, D=None, ev=None, aid=None, nbr_a=None,
                  new_aid=None):
    """Batched eviction repair + distance row + gated ordered k-best merge.

    ``X (S, w, p)`` f32 with rows contiguous (any tenant stride, so ring
    block views of the padded state pass in place), ``y (S, w)`` with
    unit column stride (int32 labels in class mode, f32 in reg mode),
    ``nbr_d (S, w, k)`` f32 with rows contiguous, ``nbr_y`` the label
    lists of reg mode (laid out as ``nbr_d``; passed through in class
    mode), ``x_new (S, p)`` f32, ``y_new (S,)`` of ``y``'s type and ``n,
    head, wrap (S,)`` int32 (the window after any eviction), all
    contiguous. Reg mode also takes the arrival-id lists ``nbr_a (S, w,
    k)`` int32 and the new points' ids ``new_aid (S,)``, and merges them
    too. With ``ev (S,)`` bool, ``D (S, w, w)`` (unit column stride) and,
    in reg mode, ``aid (S, w)`` int32: the lists of the tenants with
    ``ev`` set are first repaired in place for the point at slot ``head -
    1`` (mod ``wrap``). Returns ``(d_row (S, w), nbr_d', nbr_y', nbr_a',
    lsum (S, w))``, ``nbr_a'`` None in class mode; ``lsum`` is the
    repaired lists' fixed-order sum (``ref.fsum(nbr_d[..., :-1])`` in
    class mode, ``ref.fsum(nbr_y)`` in reg mode).
    """
    if X.device.type == "cpu":
        return ref.stream_tick(X, y, nbr_d, nbr_y, x_new, y_new, n,
                               mode=mode, head=head, wrap=wrap, D=D, ev=ev,
                               aid=aid, nbr_a=nbr_a, new_aid=new_aid)
    if mode == "class":
        return stream_update_class(X, y, nbr_d, nbr_y, x_new, y_new, n,
                                   head, wrap, D, ev)
    if mode == "reg":
        return stream_update_reg(X, y, nbr_d, nbr_y, x_new, y_new, n, head,
                                 wrap, D, ev, aid, nbr_a, new_aid)
    raise ValueError(f"unknown stream_update mode {mode!r}")


def _lists(t, S, w, k, dtype, dev, what):
    _check(t.dtype == dtype and t.device == dev and t.shape == (S, w, k)
           and t.stride(2) == 1 and t.stride(1) == k,
           f"{what} (S, w, k) {dtype}, rows contiguous")


def _check_common(X, y, nbr_d, x_new, y_new, n, head, wrap, label_dtype):
    S, w, p = X.shape
    k = nbr_d.shape[-1]
    dev = X.device
    _check(X.dtype == torch.float32 and x_new.dtype == torch.float32,
           "float32 tensors only")
    _check(y.dtype == label_dtype and y_new.dtype == label_dtype,
           f"{label_dtype} labels")
    for t in (n, head, wrap):
        _check(t.dtype == torch.int32, "int32 ring scalars")
    for t in (y, x_new, y_new, n, head, wrap):
        _check(t.device == dev, "all tensors on one CUDA device")
    _check(X.stride(2) == 1 and X.stride(1) == p, "X rows contiguous")
    _check(y.shape == (S, w) and y.stride(1) == 1, "y (S, w), unit stride")
    _check(1 <= k <= MAX_K, f"1 <= k <= {MAX_K}")
    _lists(nbr_d, S, w, k, torch.float32, dev, "lists")
    _check(x_new.shape == (S, p) and x_new.is_contiguous(),
           "x_new (S, p) contiguous")
    for t in (y_new, n, head, wrap):
        _check(t.shape == (S,) and t.is_contiguous(), "scalars (S,)")
    _check(1 <= S <= 65535, "1 <= S <= 65535 tenants per launch")
    return S, w, p, k


def _check_evict(D, ev, S, w, dev):
    """``(D, stride 0, stride 1, ev)`` launch arguments; null without
    ``ev``."""
    if ev is None:
        return 0, 0, 0, 0
    _check(D is not None and D.dtype == torch.float32 and D.device == dev
           and D.shape == (S, w, w) and D.stride(2) == 1,
           "D (S, w, w) float32, unit column stride")
    _check(ev.dtype == torch.bool and ev.device == dev and ev.shape == (S,)
           and ev.is_contiguous(), "ev (S,) bool")
    return D.data_ptr(), D.stride(0), D.stride(1), ev.data_ptr()


def stream_update_class(X, y, nbr_d, nbr_y, x_new, y_new, n, head, wrap,
                        D=None, ev=None):
    """The classification kernel (CUDA tensors only)."""
    S, w, p, k = _check_common(X, y, nbr_d, x_new, y_new, n, head, wrap,
                               torch.int32)
    pD, sD0, sD1, pev = _check_evict(D, ev, S, w, X.device)
    lib = _build.load()
    d = torch.empty((S, w), dtype=torch.float32, device=X.device)
    base = torch.empty((S, w), dtype=torch.float32, device=X.device)
    nd = torch.empty((S, w, k), dtype=torch.float32, device=X.device)
    stream = torch.cuda.current_stream(X.device).cuda_stream
    with torch.cuda.device(X.device):  # the launch goes to the current device
        rc = lib.rt_stream_update_class(
            X.data_ptr(), X.stride(0), y.data_ptr(), y.stride(0),
            nbr_d.data_ptr(), nbr_d.stride(0), pD, sD0, sD1, pev,
            x_new.data_ptr(), y_new.data_ptr(), n.data_ptr(),
            head.data_ptr(), wrap.data_ptr(), d.data_ptr(), nd.data_ptr(),
            base.data_ptr(), S, w, p, k, stream)
    _build.check(rc, "stream_update (class)")
    stream_update_class.launches += 1
    return d, nd, nbr_y, None, base


def stream_update_reg(X, y, nbr_d, nbr_y, x_new, y_new, n, head, wrap,
                      D=None, ev=None, aid=None, nbr_a=None, new_aid=None):
    """The regression kernel (CUDA tensors only): labels and ids ride
    along."""
    S, w, p, k = _check_common(X, y, nbr_d, x_new, y_new, n, head, wrap,
                               torch.float32)
    dev = X.device
    _lists(nbr_y, S, w, k, torch.float32, dev, "label lists")
    pD, sD0, sD1, pev = _check_evict(D, ev, S, w, dev)
    _check(nbr_a is not None and new_aid is not None,
           "reg mode takes the id lists nbr_a and new_aid")
    _lists(nbr_a, S, w, k, torch.int32, dev, "id lists")
    _check(new_aid.dtype == torch.int32 and new_aid.device == dev
           and new_aid.shape == (S,) and new_aid.is_contiguous(),
           "new_aid (S,) int32")
    paid = said = 0
    if ev is not None:
        _check(aid is not None and aid.dtype == torch.int32
               and aid.device == dev and aid.shape == (S, w)
               and aid.stride(1) == 1, "the repair needs aid (S, w) int32")
        paid, said = aid.data_ptr(), aid.stride(0)
    lib = _build.load()
    d = torch.empty((S, w), dtype=torch.float32, device=dev)
    ysum = torch.empty((S, w), dtype=torch.float32, device=dev)
    nd = torch.empty((S, w, k), dtype=torch.float32, device=dev)
    ny = torch.empty((S, w, k), dtype=torch.float32, device=dev)
    na = torch.empty((S, w, k), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(X.device):  # the launch goes to the current device
        rc = lib.rt_stream_update_reg(
            X.data_ptr(), X.stride(0), y.data_ptr(), y.stride(0),
            nbr_d.data_ptr(), nbr_d.stride(0), nbr_y.data_ptr(),
            nbr_y.stride(0), nbr_a.data_ptr(), nbr_a.stride(0), paid, said, pD,
            sD0, sD1, pev, x_new.data_ptr(), y_new.data_ptr(),
            new_aid.data_ptr(), n.data_ptr(), head.data_ptr(), wrap.data_ptr(),
            d.data_ptr(), nd.data_ptr(), ny.data_ptr(), na.data_ptr(),
            ysum.data_ptr(),
            S, w, p, k, stream)
    _build.check(rc, "stream_update (reg)")
    stream_update_reg.launches += 1
    return d, nd, ny, na, ysum


stream_update_class.launches = 0
stream_update_reg.launches = 0
