"""Streaming observe front end: wrapper of ``csrc/stream_update.cu``.

Replaces ``repro/kernels/stream_update.py::stream_update`` (class mode):
one launch computes the distance row of each tenant's new point against
its ring block and inserts the gated candidate into every row's
ascending k-best list. The kernel is memory-bound (``S*w*(4p + 8k + 12)``
bytes); see the source for its design. The regression mode waits for the
regression slice and raises here on a CUDA tensor.

On a CPU tensor the wrapper runs the plain version
(``ref.stream_update_fast``); on a CUDA tensor it launches the kernel or
raises. ``stream_update.launches`` counts kernel launches.
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
    block views of the padded state pass in place), ``y (S, w)`` int32
    with unit row stride, ``nbr_d (S, w, k)`` f32 with rows contiguous,
    ``x_new (S, p)`` f32 and ``y_new, n, head, wrap (S,)`` int32, all
    contiguous. Returns ``(d_row (S, w), nbr_d' (S, w, k), nbr_y)``.
    """
    if X.device.type == "cpu":
        return ref.stream_update_fast(X, y, nbr_d, nbr_y, x_new, y_new, n,
                                      mode=mode, head=head, wrap=wrap)
    if mode != "class":
        raise NotImplementedError(
            f"stream_update mode {mode!r} has no CUDA kernel yet")
    S, w, p = X.shape
    k = nbr_d.shape[-1]
    dev = X.device
    _check(X.dtype == torch.float32 and nbr_d.dtype == torch.float32
           and x_new.dtype == torch.float32, "float32 tensors only")
    for t in (y, y_new, n, head, wrap):
        _check(t.dtype == torch.int32, "int32 labels and ring scalars")
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
    lib = _build.load()
    d = torch.empty((S, w), dtype=torch.float32, device=dev)
    nd = torch.empty((S, w, k), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.rt_stream_update_class(
        X.data_ptr(), X.stride(0), y.data_ptr(), y.stride(0),
        nbr_d.data_ptr(), nbr_d.stride(0), x_new.data_ptr(),
        y_new.data_ptr(), n.data_ptr(), head.data_ptr(), wrap.data_ptr(),
        d.data_ptr(), nd.data_ptr(), S, w, p, k, stream)
    _build.check(rc, "stream_update")
    stream_update.launches += 1
    return d, nd, nbr_y


stream_update.launches = 0
