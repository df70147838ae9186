"""Fused CP score update + p-value counts: wrapper of ``csrc/cp_update.cu``.

Replaces ``repro/kernels/cp_update.py::cp_knn_counts``. One block per
(tenant, tile of 64 test rows) loops over every training column, 128 at
a time, in register tiles of 8 rows x 4 columns a thread; norms are
computed once, the counts stay in registers and the lanes that share a
row add theirs by warp shuffles, so there are no atomics and no second
pass. The kernel is bound by the ``S*m*n*(2p + 7 + 3L)`` flops of the
fused distance and update, and gives ``ref.cp_knn_counts``' counts
exactly.
See the source for its design.

On a CPU tensor the wrapper runs the plain version
(``ref.cp_knn_counts``); on a CUDA tensor it launches the kernel or
raises. ``cp_knn_counts.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

MAX_LABELS = 16


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"cp_knn_counts kernel: {what}")


def cp_knn_counts(X, y, sum_same, kth_same, X_test, alpha, *,
                  n_labels: int):
    """``X (S, n, p)`` f32 rows contiguous; ``y (S, n)`` int32 (-1 on
    columns never counted); ``sum_same, kth_same (S, n)`` f32;
    ``X_test (S, m, p)`` f32 rows contiguous (any tenant stride);
    ``alpha (S, m, L)`` f32 -> int32 counts ``(S, m, L)``."""
    if X.device.type == "cpu":
        return ref.cp_knn_counts(X, y, sum_same, kth_same, X_test, alpha)
    _check(X.dim() == 3 and X_test.dim() == 3, "batched operands")
    S, n, p = X.shape
    m = X_test.shape[1]
    _check(1 <= n_labels <= MAX_LABELS, f"1 <= n_labels <= {MAX_LABELS}")
    for t in (X, sum_same, kth_same, X_test, alpha):
        _check(t.dtype == torch.float32, "float32 only")
    _check(y.dtype == torch.int32, "int32 labels")
    for t in (y, sum_same, kth_same, X_test, alpha):
        _check(t.device == X.device, "all tensors on one CUDA device")
    for t in (X, X_test):
        _check(t.stride(2) == 1 and t.stride(1) == p, "rows contiguous")
    _check(X_test.shape[0] == S and X_test.shape[2] == p, "X_test (S, m, p)")
    for t in (y, sum_same, kth_same):
        _check(t.shape == (S, n) and t.is_contiguous(), "columns (S, n)")
    _check(alpha.shape == (S, m, n_labels) and alpha.is_contiguous(),
           "alpha (S, m, n_labels) contiguous")
    _check(1 <= S <= 65535, "1 <= S <= 65535 tenants per launch")
    _check(p >= 1, "at least one feature")
    lib = _build.load()
    out = torch.empty((S, m, n_labels), dtype=torch.int32, device=X.device)
    stream = torch.cuda.current_stream(X.device).cuda_stream
    with torch.cuda.device(X.device):  # the launch goes to the current device
        rc = lib.rt_cp_knn_counts(
            X.data_ptr(), X.stride(0), y.data_ptr(), sum_same.data_ptr(),
            kth_same.data_ptr(), X_test.data_ptr(), X_test.stride(0),
            alpha.data_ptr(), out.data_ptr(), S, n, m, p, n_labels, stream)
    _build.check(rc, "cp_knn_counts")
    cp_knn_counts.launches += 1
    return out


cp_knn_counts.launches = 0
