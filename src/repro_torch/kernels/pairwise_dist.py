"""Batched pairwise squared distances: wrapper of ``csrc/pairwise_dist.cu``.

Replaces ``repro/kernels/pairwise_dist.py::pairwise_sq_dists``. The
kernel writes ``(S, m, n)`` f32 in the ``|a|^2 + |b|^2 - 2ab`` form with
fixed-order f32 sums (``csrc/sqdist.cuh``, no TF32, row-decomposable),
each row's norm computed once by a first launch; at the serving shapes it
is bound by its output bytes. See the source for its design.

On a CPU tensor the wrapper runs the plain version (``ref.sq_dists``); on
a CUDA tensor it launches the kernel or raises.
``pairwise_sq_dists.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"pairwise_sq_dists kernel: {what}")


def rows_contiguous(t: torch.Tensor) -> bool:
    """Features contiguous and rows ``p`` apart, the layout the kernel
    indexes; a single row's stride is never used (PyTorch may report 0)."""
    return t.stride(2) == 1 and (t.shape[1] <= 1 or t.stride(1) == t.shape[2])


def pairwise_sq_dists(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``A (S, m, p)``, ``B (S, n, p)`` f32 with rows contiguous (any
    tenant stride, 0 included for a query batch shared by every tenant)
    -> ``(S, m, n)`` f32."""
    if A.device.type == "cpu":
        return ref.sq_dists(A, B)
    _check(A.dim() == 3 and B.dim() == 3, "batched (S, rows, p) operands")
    S, m, p = A.shape
    n = B.shape[1]
    _check(A.dtype == torch.float32 and B.dtype == torch.float32,
           "float32 only")
    _check(B.device == A.device, "both operands on one CUDA device")
    _check(B.shape[0] == S and B.shape[2] == p, "matching S and p")
    for t in (A, B):
        _check(rows_contiguous(t), "rows contiguous")
    _check(1 <= S <= 65535 and m <= 65535 * 64, "launch grid limits")
    lib = _build.load()
    out = torch.empty((S, m, n), dtype=torch.float32, device=A.device)
    norms = torch.empty(S * (m + n), dtype=torch.float32, device=A.device)
    stream = torch.cuda.current_stream(A.device).cuda_stream
    with torch.cuda.device(A.device):  # the launch goes to the current device
        rc = lib.rt_pairwise_sq_dists(A.data_ptr(), A.stride(0), B.data_ptr(),
                                      B.stride(0), norms.data_ptr(),
                                      out.data_ptr(), S, m, n, p, stream)
    _build.check(rc, "pairwise_sq_dists")
    pairwise_sq_dists.launches += 1
    return out


pairwise_sq_dists.launches = 0
