"""Multi-tenant online CP serving on PyTorch/CUDA.

* ``session`` — tenant-batched capacity-padded CP state with exact
  decremental eviction and capacity growth;
* ``engine``  — ``ServingEngine``: every tenant advanced per tick by one
  launch of each kernel; read-only ``predict``;
* ``registry`` — ``ConformalPredictor`` over the paper's batch measures
  (fit / observe / evict / pvalues);
* ``convert`` — the JAX engines' and measures' states carried across as
  numpy leaves.
"""
from repro_torch.serving.engine import ServingEngine

__all__ = ["ServingEngine"]
