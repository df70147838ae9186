"""Masked Gaussian-kernel row sums: wrapper of ``csrc/kde_score.cu``.

Replaces ``repro/kernels/kde_score.py::kde_rowsums``, the KDE measure's
training phase (paper Section 4.1). One thread per output sum adds every
column strictly left to right, so a row's bits depend neither on ``m``
nor on the launch; at the fit's shapes the kernel is bound by the
``m*n*(2p + 5)`` flops of the fused distance, exp and sum. Without
``y_A`` it returns every label's sum of each row, ``(m, n_labels)``: a
read's candidate scores from one pass over the training set. See the
source for its design and its two layouts.

On a CPU tensor the wrapper runs the plain version (``ref.kde_rowsums``);
on a CUDA tensor it launches the kernel or raises.
``kde_rowsums.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

# Fewer rows than this take the kernel's wide layout (one block per row),
# more its rows layout (one thread per row): where their times cross on an
# H100 at n = 100,000, p = 30 (``python -m repro_torch.launch.profile
# --kde-layouts``). The wide layout's time grows with the rows; the rows
# layout's barely moves until the SMs fill.
WIDE_ROWS = 9000
MAX_LABELS = 256  # the per-label form's limit (KS_MAX_LABELS)


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"kde_rowsums kernel: {what}")


def kde_rowsums(A: torch.Tensor, B: torch.Tensor, y_A: torch.Tensor | None,
                y_B: torch.Tensor, h: float, exclude_diag: bool = False,
                n_labels: int | None = None, *,
                layout: str | None = None) -> torch.Tensor:
    """``A (m, p)``, ``B (n, p)`` f32 contiguous, ``y_A (m,)``, ``y_B
    (n,)`` int32 -> ``(m,)`` f32; with ``y_A=None``, every label's sum
    ``(m, n_labels)``. ``layout`` ("rows" or "wide") overrides the choice
    by ``m`` (``WIDE_ROWS``), to time one layout against the other; the
    bits are the same."""
    if A.device.type == "cpu":
        return ref.kde_rowsums(A, B, y_A, y_B, h, exclude_diag, n_labels)
    _check(A.dim() == 2 and B.dim() == 2, "unbatched (rows, p) operands")
    m, p = A.shape
    n = B.shape[0]
    per_label = y_A is None
    _check(A.dtype == torch.float32 and B.dtype == torch.float32,
           "float32 only")
    _check(y_B.dtype == torch.int32 and (per_label
                                         or y_A.dtype == torch.int32),
           "int32 labels")
    for t in (B, y_B) if per_label else (B, y_A, y_B):
        _check(t.device == A.device, "all tensors on one CUDA device")
    _check(B.shape[1] == p and p >= 1, "matching p >= 1")
    _check(y_B.shape == (n,) and (per_label or y_A.shape == (m,)),
           "labels (m,), (n,)")
    _check(not per_label or (n_labels is not None
                             and 1 <= n_labels <= MAX_LABELS),
           f"y_A=None needs 1 <= n_labels <= {MAX_LABELS}")
    for t in (A, B, y_B) if per_label else (A, B, y_A, y_B):
        _check(t.is_contiguous(), "contiguous operands")
    _check(m + n < 2**31, "m + n below 2^31")
    _check(layout in (None, "rows", "wide"), "layout rows, wide or None")
    wide_below = {None: WIDE_ROWS, "rows": 0, "wide": 2**31 - 1}[layout]
    L = n_labels if per_label else 1
    lib = _build.load()
    out = torch.empty((m, L) if per_label else (m,), dtype=torch.float32,
                      device=A.device)
    norms = torch.empty(m + n, dtype=torch.float32, device=A.device)
    stream = torch.cuda.current_stream(A.device).cuda_stream
    rc = lib.rt_kde_rowsums(
        A.data_ptr(), B.data_ptr(), None if per_label else y_A.data_ptr(),
        y_B.data_ptr(), norms.data_ptr(), norms[m:].data_ptr(),
        out.data_ptr(), m, n, p, L, 2.0 * h * h, int(exclude_diag),
        wide_below, stream)
    _build.check(rc, "kde_rowsums")
    kde_rowsums.launches += 1
    return out


kde_rowsums.launches = 0


def kde_exp(x: torch.Tensor) -> torch.Tensor:
    """The kernel's own ``exp`` applied to a CUDA f32 tensor, to hold it
    against ``torch.exp`` on the card (not counted as a launch)."""
    _check(x.device.type == "cuda" and x.dtype == torch.float32
           and x.is_contiguous(), "contiguous CUDA float32")
    out = torch.empty_like(x)
    rc = _build.load().rt_kde_expf(
        x.data_ptr(), out.data_ptr(), x.numel(),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "kde_exp")
    return out
