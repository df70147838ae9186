"""Masked Gaussian-kernel row sums: wrapper of ``csrc/kde_score.cu``.

Replaces ``repro/kernels/kde_score.py::kde_rowsums``, the KDE measure's
training phase (paper Section 4.1). One thread per output sum adds the
kept columns strictly left to right, so a row's bits depend neither on
``m`` nor on the launch; at the fit's shapes the kernel is bound by the
``(2p + 5)`` flops of the fused distance, exp and sum of each same-label
pair, which it alone visits (the launch groups the columns by label on
the device). Without ``y_A`` it returns every label's sum of each row,
``(m, n_labels)``: a read's candidate scores from one pass over the
training set. See the source for its design and its two layouts.

On a CPU tensor the wrapper runs the plain version (``ref.kde_rowsums``);
on a CUDA tensor it launches the kernel or raises.
``kde_rowsums.launches`` counts kernel launches.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build, ref

# Fewer rows than this take the kernel's wide layout (one block per row),
# more its grouped layout: where their times cross on an H100 at n =
# 100,000, p = 30, two labels, in both output forms (``python -m
# repro_torch.launch.profile --kde-layouts``: at 4,000 rows 14.1 / 14.4
# ms in the fit's form, 15.5 / 14.4 ms in the read's). The wide layout's
# time grows with the rows; the grouped layout's barely moves until the
# SMs fill, since each block runs its rows against all of their label's
# columns in order.
WIDE_ROWS = 4000
MAX_LABELS = 256  # the per-label form's limit; the fit form groups these
MAX_P_WIDE = 11776  # the wide layout's p (KW_MAX_P)
MAX_P_GROUPED = 25600  # the grouped layout's p (KS_A_SMEM / (KS_R * 4))


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"kde_rowsums kernel: {what}")


def exact_reciprocal(den: float) -> float | None:
    """``1 / f32(den)`` when ``f32(den)`` is a power of two whose
    reciprocal is a normal float32, else None. Then ``x * (1 / den)`` and
    ``x / den`` round the same real number once, so the kernel may
    multiply and keep the plain version's IEEE-division bits (h = 1: den
    = 2)."""
    d = torch.tensor(den, dtype=torch.float32).item()
    if not (d > 0.0 and math.isfinite(d)):
        return None
    frac, e = math.frexp(d)  # d = frac * 2**e, frac in [0.5, 1)
    if frac != 0.5 or not -126 <= 1 - e <= 127:
        return None
    return math.ldexp(1.0, 1 - e)


def kde_rowsums(A: torch.Tensor, B: torch.Tensor, y_A: torch.Tensor | None,
                y_B: torch.Tensor, h: float, exclude_diag: bool = False,
                n_labels: int | None = None, *,
                layout: str | None = None) -> torch.Tensor:
    """``A (m, p)``, ``B (n, p)`` f32 contiguous, ``y_A (m,)``, ``y_B
    (n,)`` int32 -> ``(m,)`` f32; with ``y_A=None``, every label's sum
    ``(m, n_labels)``. In the ``(m,)`` form ``n_labels`` (optional) lets
    the grouped layout visit each row's label alone; labels outside ``[0,
    n_labels)`` (all of them without it) are compared column by column.
    ``layout`` ("grouped" or "wide") overrides the choice by ``m``
    (``WIDE_ROWS``), to time one layout against the other; the bits are
    the same."""
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
    _check(layout in (None, "grouped", "wide"),
           "layout grouped, wide or None")
    wide = p <= MAX_P_WIDE and (layout == "wide" or (
        layout is None and m < WIDE_ROWS))
    _check(wide or p <= MAX_P_GROUPED, f"p at most {MAX_P_GROUPED} "
           f"(or {MAX_P_WIDE} below {WIDE_ROWS} rows)")
    L = n_labels if per_label else min(n_labels or 0, MAX_LABELS)
    den = 2.0 * h * h
    inv = exact_reciprocal(den)
    lib = _build.load()
    out = torch.empty((m, L) if per_label else (m,), dtype=torch.float32,
                      device=A.device)
    scratch = torch.empty(
        lib.rt_kde_scratch_bytes(m, n, p, L, int(not per_label), int(wide)),
        dtype=torch.uint8, device=A.device)
    stream = torch.cuda.current_stream(A.device).cuda_stream
    with torch.cuda.device(A.device):  # the launch goes to the current device
        rc = lib.rt_kde_rowsums(
            A.data_ptr(), B.data_ptr(), None if per_label else y_A.data_ptr(),
            y_B.data_ptr(), scratch.data_ptr(), out.data_ptr(), m, n, p, L,
            den if inv is None else inv, int(inv is not None),
            int(exclude_diag), int(wide), stream)
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
    with torch.cuda.device(x.device):  # the launch goes to the current device
        rc = _build.load().rt_kde_expf(
            x.data_ptr(), out.data_ptr(), x.numel(),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "kde_exp")
    return out
