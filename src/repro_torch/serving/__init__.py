"""Multi-tenant online CP serving on PyTorch/CUDA.

* ``session`` — tenant-batched capacity-padded CP state with exact
  decremental eviction and capacity growth;
* ``engine``  — ``ServingEngine``: every tenant advanced per tick by one
  launch of each kernel; read-only ``predict``;
* ``registry`` — ``ConformalPredictor`` over the paper's batch measures
  (fit / observe / evict / pvalues);
* ``convert`` — the JAX engines' and measures' states carried across as
  numpy leaves;
* ``snapshot`` — crash-safe snapshot and restore of an engine's state (the
  JAX package's format), and the asynchronous sharded saver;
* ``fleet`` — tenant lifecycle (admit, retire, migrate) over
  capacity-bucketed engine pools.
"""
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.fleet import Fleet
from repro_torch.serving.snapshot import AsyncShardedSaver, SessionStore

__all__ = ["ServingEngine", "SessionStore", "AsyncShardedSaver", "Fleet"]
