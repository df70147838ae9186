"""Streaming observe front end: wrapper of ``csrc/stream_update.cu``.

Replaces ``repro/kernels/stream_update.py::stream_update`` in both modes:
one launch computes the distance row of each tenant's new point against
its ring block and inserts the gated candidate into every row's
ascending k-best list. ``mode="class"`` (the classification tick) gates
on the label and keeps distances only; ``mode="reg"`` (the regression
tick) gates on ``d < kth`` and carries the neighbour labels along. Both
are memory-bound (``S*w*(4p + 8k + 12)`` and ``S*w*(4p + 16k + 8)``
bytes); see the source for the design.

On a CPU tensor the wrapper runs the plain version
(``ref.stream_update_fast``); on a CUDA tensor it launches the kernel of
the mode or raises. ``stream_update_class.launches`` and
``stream_update_reg.launches`` count kernel launches per mode.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

MAX_K = 32


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"stream_update kernel: {what}")


def stream_update(X, y, nbr_d, nbr_y, x_new, y_new, n, *, mode: str,
                  head, wrap):
    """Batched distance row + gated ordered k-best merge.

    ``X (S, w, p)`` f32 with rows contiguous (any tenant stride, so ring
    block views of the padded state pass in place), ``y (S, w)`` with
    unit row stride (int32 labels in class mode, f32 in reg mode),
    ``nbr_d (S, w, k)`` f32 with rows contiguous, ``nbr_y`` the label
    lists of reg mode (laid out as ``nbr_d``; passed through in class
    mode), ``x_new (S, p)`` f32, ``y_new (S,)`` of ``y``'s type and ``n,
    head, wrap (S,)`` int32, all contiguous. Returns ``(d_row (S, w),
    nbr_d' (S, w, k), nbr_y')``.
    """
    if X.device.type == "cpu":
        return ref.stream_update_fast(X, y, nbr_d, nbr_y, x_new, y_new, n,
                                      mode=mode, head=head, wrap=wrap)
    if mode == "class":
        return stream_update_class(X, y, nbr_d, nbr_y, x_new, y_new, n,
                                   head, wrap)
    if mode == "reg":
        return stream_update_reg(X, y, nbr_d, nbr_y, x_new, y_new, n, head,
                                 wrap)
    raise ValueError(f"unknown stream_update mode {mode!r}")


def _check_common(X, y, nbr_d, x_new, y_new, n, head, wrap, label_dtype):
    S, w, p = X.shape
    k = nbr_d.shape[-1]
    dev = X.device
    _check(X.dtype == torch.float32 and nbr_d.dtype == torch.float32
           and x_new.dtype == torch.float32, "float32 tensors only")
    _check(y.dtype == label_dtype and y_new.dtype == label_dtype,
           f"{label_dtype} labels")
    for t in (n, head, wrap):
        _check(t.dtype == torch.int32, "int32 ring scalars")
    for t in (y, nbr_d, x_new, y_new, n, head, wrap):
        _check(t.device == dev, "all tensors on one CUDA device")
    _check(X.stride(2) == 1 and X.stride(1) == p, "X rows contiguous")
    _check(y.shape == (S, w) and y.stride(1) == 1, "y (S, w), unit stride")
    _check(nbr_d.shape == (S, w, k) and nbr_d.stride(2) == 1
           and nbr_d.stride(1) == k, "lists (S, w, k), rows contiguous")
    _check(1 <= k <= MAX_K, f"1 <= k <= {MAX_K}")
    _check(x_new.shape == (S, p) and x_new.is_contiguous(),
           "x_new (S, p) contiguous")
    for t in (y_new, n, head, wrap):
        _check(t.shape == (S,) and t.is_contiguous(), "scalars (S,)")
    _check(1 <= S <= 65535, "1 <= S <= 65535 tenants per launch")
    return S, w, p, k


def stream_update_class(X, y, nbr_d, nbr_y, x_new, y_new, n, head, wrap):
    """The classification kernel (CUDA tensors only)."""
    S, w, p, k = _check_common(X, y, nbr_d, x_new, y_new, n, head, wrap,
                               torch.int32)
    lib = _build.load()
    d = torch.empty((S, w), dtype=torch.float32, device=X.device)
    nd = torch.empty((S, w, k), dtype=torch.float32, device=X.device)
    stream = torch.cuda.current_stream(X.device).cuda_stream
    rc = lib.rt_stream_update_class(
        X.data_ptr(), X.stride(0), y.data_ptr(), y.stride(0),
        nbr_d.data_ptr(), nbr_d.stride(0), x_new.data_ptr(),
        y_new.data_ptr(), n.data_ptr(), head.data_ptr(), wrap.data_ptr(),
        d.data_ptr(), nd.data_ptr(), S, w, p, k, stream)
    _build.check(rc, "stream_update (class)")
    stream_update_class.launches += 1
    return d, nd, nbr_y


def stream_update_reg(X, y, nbr_d, nbr_y, x_new, y_new, n, head, wrap):
    """The regression kernel (CUDA tensors only): labels ride along."""
    S, w, p, k = _check_common(X, y, nbr_d, x_new, y_new, n, head, wrap,
                               torch.float32)
    _check(nbr_y.dtype == torch.float32 and nbr_y.device == X.device
           and nbr_y.shape == (S, w, k) and nbr_y.stride(2) == 1
           and nbr_y.stride(1) == k, "label lists (S, w, k) f32, rows "
           "contiguous")
    lib = _build.load()
    d = torch.empty((S, w), dtype=torch.float32, device=X.device)
    nd = torch.empty((S, w, k), dtype=torch.float32, device=X.device)
    ny = torch.empty((S, w, k), dtype=torch.float32, device=X.device)
    stream = torch.cuda.current_stream(X.device).cuda_stream
    rc = lib.rt_stream_update_reg(
        X.data_ptr(), X.stride(0), y.data_ptr(), y.stride(0),
        nbr_d.data_ptr(), nbr_d.stride(0), nbr_y.data_ptr(),
        nbr_y.stride(0), x_new.data_ptr(), y_new.data_ptr(), n.data_ptr(),
        head.data_ptr(), wrap.data_ptr(), d.data_ptr(), nd.data_ptr(),
        ny.data_ptr(), S, w, p, k, stream)
    _build.check(rc, "stream_update (reg)")
    stream_update_reg.launches += 1
    return d, nd, ny


stream_update_class.launches = 0
stream_update_reg.launches = 0
