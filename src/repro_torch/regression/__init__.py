"""Multi-tenant streaming k-NN regression CP on PyTorch/CUDA.

* ``stream``  — the batched ``RegStreamState``: exact incremental learn,
  decremental eviction, arrival-ordered views;
* ``session`` — the sliding tick and the ``intervals`` / ``pvalues``
  reads;
* ``engine``  — ``RegressionServingEngine``: every tenant advanced per
  tick by one launch of the reg-mode ``stream_update`` kernel, intervals
  through the pairwise and ``interval_sweep`` kernels.
"""
from repro_torch.regression.engine import RegressionServingEngine

__all__ = ["RegressionServingEngine"]
