"""Regression-CP critical points: wrapper of ``csrc/interval_sweep.cu``.

Replaces ``repro/kernels/interval_sweep.py::interval_sweep``. One launch
computes, for every tenant, test row and window column, the distance,
the O(1) update of the affine score coefficients ``(a_i, b_i)`` and the
endpoints of ``{t : |a_i + b_i t| >= |a_test + t|}``; the hull sweep
stays with the caller. The kernel is bound by its ``8*S*m*n`` output
bytes. It works in 64 x 128 output tiles, 8 rows x 4 columns a thread,
with every row's and column's norm computed once a block, the columns'
update statistics once a thread, negations where ``b_i = 0`` would
divide by -1, and 16-byte stores; it gives ``ref.reg_interval_endpoints``'
bits.
See the source for its design.

On a CPU tensor the wrapper runs the plain version
(``ref.reg_interval_endpoints``); on a CUDA tensor it launches the kernel
or raises. ``interval_sweep.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"interval_sweep kernel: {what}")


def interval_sweep(X, a_prime, kth_dist, kth_label, live, X_test, a_test,
                   *, k: int):
    """``X (S, n, p)`` f32 rows contiguous (arrival order); ``a_prime,
    kth_dist, kth_label (S, n)`` f32 and ``live (S, n)`` bool, contiguous;
    ``X_test (S, m, p)`` f32 rows contiguous (any tenant stride, 0 for a
    batch shared by every tenant); ``a_test (S, m)`` f32 -> ``lo, hi (S,
    m, n)`` f32."""
    if X.device.type == "cpu":
        return ref.reg_interval_endpoints(X, a_prime, kth_dist, kth_label,
                                          live, X_test, a_test, k)
    _check(X.dim() == 3 and X_test.dim() == 3, "batched operands")
    S, n, p = X.shape
    m = X_test.shape[1]
    for t in (X, a_prime, kth_dist, kth_label, X_test, a_test):
        _check(t.dtype == torch.float32, "float32 only")
        _check(t.device == X.device, "all tensors on one CUDA device")
    _check(live.dtype == torch.bool and live.device == X.device,
           "bool live mask on the same device")
    for t in (X, X_test):
        _check(t.stride(2) == 1 and t.stride(1) == p, "rows contiguous")
    _check(X_test.shape[0] == S and X_test.shape[2] == p, "X_test (S, m, p)")
    for t in (a_prime, kth_dist, kth_label, live):
        _check(t.shape == (S, n) and t.is_contiguous(), "columns (S, n)")
    _check(a_test.shape == (S, m) and a_test.is_contiguous(),
           "a_test (S, m) contiguous")
    _check(k >= 1, "k >= 1")
    _check(1 <= S <= 65535 and m <= 65535 * 64, "launch grid limits")
    lib = _build.load()
    lo = torch.empty((S, m, n), dtype=torch.float32, device=X.device)
    hi = torch.empty((S, m, n), dtype=torch.float32, device=X.device)
    stream = torch.cuda.current_stream(X.device).cuda_stream
    with torch.cuda.device(X.device):  # the launch goes to the current device
        rc = lib.rt_interval_sweep(
            X.data_ptr(), X.stride(0), a_prime.data_ptr(), kth_dist.data_ptr(),
            kth_label.data_ptr(), live.data_ptr(), X_test.data_ptr(),
            X_test.stride(0), a_test.data_ptr(), lo.data_ptr(), hi.data_ptr(),
            S, m, n, p, k, -1.0 / k, stream)
    _build.check(rc, "interval_sweep")
    interval_sweep.launches += 1
    return lo, hi


interval_sweep.launches = 0


def sqd_sqrt(x: torch.Tensor) -> torch.Tensor:
    """The read kernels' own square root (``sqd_sqrt`` of
    ``csrc/sqdist.cuh``) applied to a CUDA f32 tensor, to hold it against
    ``torch.sqrt`` on the card (not counted as a launch)."""
    _check(x.device.type == "cuda" and x.dtype == torch.float32
           and x.is_contiguous(), "contiguous CUDA float32")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):  # the launch goes to the current device
        rc = _build.load().rt_sqd_sqrt(
            x.data_ptr(), out.data_ptr(), x.numel(),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "sqd_sqrt")
    return out
