"""p-value machinery shared by the port's conformal predictors.

Counterpart of ``repro/core/pvalues.py``. A full-CP p-value for a
candidate with training scores ``alphas (..., n)`` and its own score
``alpha (...)`` is ``(#{i: alphas[i] >= alpha} + 1) / (n + 1)``; the
smoothed form breaks ties with ``tau ~ U[0, 1]``. Every division is by a
device scalar, so it is IEEE on the card too (``kernels.ref.div_k``).
"""
from __future__ import annotations

import torch


def _div(num: torch.Tensor, den: float) -> torch.Tensor:
    return num / num.new_full((), den)


def count_ge(alphas: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Partial count ``#{alphas >= alpha}`` as int32."""
    return (alphas >= alpha[..., None]).sum(-1, dtype=torch.int32)


def pvalue_from_counts(counts: torch.Tensor, n: int) -> torch.Tensor:
    """``(counts + 1) / (n + 1)`` in float32."""
    return _div(counts.to(torch.float32) + 1.0, n + 1.0)


def pvalue(alphas: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """p-value from per-training-example scores; broadcasts over leading
    dims. ``alphas (..., n)``, ``alpha (...)``."""
    return pvalue_from_counts(count_ge(alphas, alpha), alphas.shape[-1])


def smoothed_pvalue(alphas: torch.Tensor, alpha: torch.Tensor,
                    tau: torch.Tensor) -> torch.Tensor:
    """Smoothed p-value: ties broken by ``tau``; exactly uniform."""
    n = alphas.shape[-1]
    gt = (alphas > alpha[..., None]).sum(-1, dtype=torch.int32)
    eq = (alphas == alpha[..., None]).sum(-1, dtype=torch.int32)
    return _div(gt + tau * (eq + 1.0), n + 1.0)


def prediction_sets(pvalues: torch.Tensor, epsilon: float) -> torch.Tensor:
    """Membership ``(m, l)``: label in the set iff ``p > epsilon``."""
    return pvalues > epsilon


def fuzziness(pvalues: torch.Tensor) -> torch.Tensor:
    """Sum of each row's p-values but the largest (lower is better)."""
    return pvalues.sum(-1) - pvalues.max(-1).values


def coverage(pvalues: torch.Tensor, y_true: torch.Tensor, epsilon: float):
    """Empirical coverage of the epsilon-prediction set and the mean set
    size."""
    sets = prediction_sets(pvalues, epsilon)
    hit = sets.gather(1, y_true.to(torch.int64)[:, None])[:, 0]
    return hit.float().mean(), sets.sum(-1).float().mean()


__all__ = ["pvalue", "smoothed_pvalue", "prediction_sets", "fuzziness",
           "coverage", "count_ge", "pvalue_from_counts"]
