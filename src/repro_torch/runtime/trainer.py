"""The fault-tolerant training loop, the port's copy of
``repro/runtime/trainer.py``, on one card or sharded over a mesh:

* checkpoint / restart: the parameters and the optimizer state as one
  flat leaf list (``state_leaves``: the parameters in the module's order,
  ``mu``, ``nu`` by leaf name, ``step``) in the port's
  ``CheckpointStore`` every ``ckpt_every`` steps, in the background; on
  start the latest committed step is restored (its ``treedef`` and
  ``extra`` checked against this model) and the deterministic
  ``TokenStream`` resumes at that step;
* preemption: SIGTERM / SIGINT set a flag; the loop finishes the step,
  saves with ``blocking=True`` and returns ``preempted`` (the previous
  handlers are put back when ``run`` returns). On a mesh the ranks agree
  on it after every step (a max all-reduce of the flag), so a signal seen
  by one rank stops them all after the same step;
* stragglers: a step slower than ``straggler_factor`` times the EWMA of
  the step times is logged; one slower than ``step_timeout_s`` raises;
* a non-finite loss raises ``FloatingPointError``.

Each step runs inside ``compressed_boundaries()``, as the reference's
runs under ``activation_mesh``: the block boundaries round their
cotangents to bf16. The final state is saved blocking at the end, or, if
the last periodic save was of that step, that write is waited for;
``ckpt_every <= 0`` saves nothing.

With a ``mesh`` (a ``DeviceMesh`` over the caller's process group, one
process a device) the parameters and the optimizer state
are DTensors placed by the sharding rules (``param_pspecs``), each step
is ``make_train_step``'s mesh branch under ``activation_mesh(mesh)``,
and every rank draws the whole global batch from the one ``TokenStream``
(the reference's single-host stream; a stream per host would draw other
tokens) and keeps its block (``batch_pspecs``), so a sharded run trains
on the reference's batches. A checkpoint holds whole leaves, gathered
from every rank and written by rank 0 in the store's format; a restore
reads them whole and places them on the *current* mesh, so a step saved
on one mesh resumes on another (the reference's elastic restore).
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import signal
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch._device import resolve
from repro_torch.checkpoint import CheckpointStore
from repro_torch.configs.base import ArchConfig
from repro_torch.data.lm_pipeline import TokenStream
from repro_torch.launch.steps import make_train_step
from repro_torch.models import lm
from repro_torch.models.boundary import compressed_boundaries
from repro_torch.optim import OptimizerConfig, init_opt_state
from repro_torch.sharding import rules
from repro_torch.sharding.activation import activation_mesh

TREEDEF = "repro_torch.runtime.trainer:params+adamw"


def _default_ckpt_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = dataclasses.field(default_factory=_default_ckpt_dir)
    log_every: int = 10
    seed: int = 0
    batch: int = 8
    seq_len: int = 256
    microbatches: int = 1
    straggler_factor: float = 3.0
    step_timeout_s: float = 600.0
    keep_ckpts: int = 3


def state_leaves(params, opt_state: dict) -> list:
    """The flat leaf list a checkpoint holds, in its fixed order."""
    out = [p for _, p in params.named_parameters()]
    out += list(opt_state["mu"].values())
    for v in opt_state["nu"].values():
        out += [v[k] for k in sorted(v)]
    return out + [opt_state["step"]]


def state_names(params, opt_state: dict) -> list:
    """The name of each of ``state_leaves``."""
    out = [n for n, _ in params.named_parameters()]
    out += [f"mu.{n}" for n in opt_state["mu"]]
    for n, v in opt_state["nu"].items():
        out += [f"nu.{n}.{k}" for k in sorted(v)]
    return out + ["step"]


class Trainer:
    """``Trainer(cfg, tcfg, mesh=None, opt_cfg=None, *, device=None)``, the
    reference's argument order; ``mesh`` a ``DeviceMesh`` (``launch.mesh.
    device_mesh``) or None for one device."""

    def __init__(self, cfg: ArchConfig, tcfg: TrainerConfig, mesh=None,
                 opt_cfg: OptimizerConfig | None = None, *, device=None):
        if mesh is not None and not hasattr(mesh, "mesh_dim_names"):
            raise ValueError(f"mesh must be a torch.distributed DeviceMesh, "
                             f"got {type(mesh).__name__}")
        self.mesh = mesh
        self.cfg = cfg
        self.tcfg = tcfg
        if mesh is None:
            self.device = resolve(device)
        elif mesh.device_type == "cuda":
            self.device = torch.device("cuda", torch.cuda.current_device())
        else:
            self.device = torch.device(mesh.device_type)
        self.rank = 0 if mesh is None else dist.get_rank()
        self.opt_cfg = opt_cfg or OptimizerConfig(
            total_steps=tcfg.steps, warmup_steps=max(1, tcfg.steps // 20))
        self.store = CheckpointStore(tcfg.ckpt_dir, keep=tcfg.keep_ckpts)
        self.stream = TokenStream(cfg, tcfg.batch, tcfg.seq_len,
                                  seed=tcfg.seed)
        self._preempted = False
        self._ewma = None
        self.stats_log: list = []
        self.step_seconds: list = []

    # -- lifecycle -----------------------------------------------------------

    def _install_signal_handlers(self) -> dict:
        def handler(signum, frame):  # noqa: ARG001
            self._preempted = True

        previous = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                previous[sig] = signal.signal(sig, handler)
            except ValueError:  # not the main thread
                pass
        return previous

    def init_params(self) -> lm.LmParams:
        """Random weights from ``tcfg.seed`` on the trainer's device."""
        return lm.init_lm(self.tcfg.seed, self.cfg, device=self.device)

    def init_state(self):
        params = self.init_params()
        params.requires_grad_(True)
        return params, init_opt_state(params, self.opt_cfg)

    def place(self, params, opt_state):
        """The whole state placed on the mesh by the rules (the state
        itself without a mesh)."""
        if self.mesh is None:
            return params, opt_state
        return rules.distribute_state(params, opt_state, self.mesh)

    def _extra(self, params, opt_state) -> dict:
        return {"arch": self.cfg.name, "factored": self.opt_cfg.factored,
                "names": state_names(params, opt_state)}

    def _builder(self, params, opt_state):
        """The restore builder: checks the step's manifest against this
        model and optimizer, then loads its leaves into ``params`` (in
        place) and a new optimizer state."""
        extra = self._extra(params, opt_state)
        live = state_leaves(params, opt_state)

        def build(manifest):
            if manifest["treedef"] != TREEDEF or manifest["extra"] != extra:
                raise ValueError(
                    f"checkpoint step {manifest['step']} holds another "
                    f"state ({manifest['treedef']}, "
                    f"{manifest['extra'].get('arch')}) than this trainer's")

            def load(leaves):
                for t, want in zip(leaves, live):
                    if t.shape != want.shape or t.dtype != want.dtype:
                        raise ValueError("a restored leaf's shape or dtype "
                                         "disagrees with the model's")
                n = len(list(params.parameters()))
                with torch.no_grad():
                    for p, t in zip(params.parameters(), leaves[:n]):
                        p.copy_(t)
                it = iter(leaves[n:])
                mu = {k: next(it) for k in opt_state["mu"]}
                nu = {k: {s: next(it) for s in sorted(v)}
                      for k, v in opt_state["nu"].items()}
                return params, {"mu": mu, "nu": nu, "step": next(it)}
            return load
        return build

    def restore_or_init(self):
        params, opt_state = self.init_state()
        start = 0
        latest = self.store.latest_step()
        if latest is not None:
            (params, opt_state), _ = self.store.restore(
                self._builder(params, opt_state), latest, device=self.device)
            start = latest
            if self.rank == 0:
                print(f"[trainer] restored step {latest} from "
                      f"{self.tcfg.ckpt_dir}")
        params, opt_state = self.place(params, opt_state)
        return params, opt_state, start

    def save(self, step: int, params, opt_state, blocking: bool = False):
        leaves = state_leaves(params, opt_state)
        if self.mesh is not None:  # whole leaves, written by rank 0
            leaves = [t.full_tensor() for t in leaves]
            if self.rank != 0:
                return
        self.store.save(step, leaves, treedef=TREEDEF, blocking=blocking,
                        extra=self._extra(params, opt_state))

    def _saved(self, step: int) -> None:
        """Wait for a save of ``step`` on rank 0, then for every rank (a
        restore on any rank must find it committed)."""
        if self.rank == 0:
            self.store.flush()
        if self.mesh is not None:
            dist.barrier()

    def batch_at(self, step: int) -> dict:
        """The global batch of ``step`` on the trainer's device; on a mesh,
        this rank's block of it."""
        batch = {k: torch.from_numpy(v).to(self.device)
                 for k, v in self.stream.batch_at(step).items()}
        if self.mesh is None:
            return batch
        return rules.distribute(batch,
                                rules.batch_pspecs(batch, self.mesh),
                                self.mesh)

    def _preempt_agreed(self) -> bool:
        """Whether any rank was asked to stop (this one's flag without a
        mesh): every rank calls it after every step."""
        if self.mesh is None:
            return self._preempted
        flag = torch.tensor([int(self._preempted)], dtype=torch.int32,
                            device=self.device)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        self._preempted = bool(flag.item())
        return self._preempted

    # -- the loop ------------------------------------------------------------

    def run(self) -> dict:
        previous = self._install_signal_handlers()
        placed = (contextlib.nullcontext() if self.mesh is None
                  else activation_mesh(self.mesh))
        try:
            with compressed_boundaries(), placed:
                return self._run()
        finally:
            for sig, h in previous.items():
                if h is not None:
                    signal.signal(sig, h)

    def _run(self) -> dict:
        t = self.tcfg
        params, opt_state, start = self.restore_or_init()
        step_fn = make_train_step(self.cfg, self.opt_cfg, t.microbatches,
                                  mesh=self.mesh)
        every = t.ckpt_every if t.ckpt_every > 0 else None
        losses, saved = [], None
        for step in range(start, t.steps):
            batch = self.batch_at(step)
            t0 = time.perf_counter()
            params, opt_state, stats = step_fn(params, opt_state, batch)
            loss = float(stats["loss"])  # the step's synchronisation
            dt = time.perf_counter() - t0
            self.step_seconds.append(dt)
            if not np.isfinite(loss):
                raise FloatingPointError(
                    f"non-finite loss at step {step}: {loss}")
            losses.append(loss)

            if self._ewma is None:
                self._ewma = dt
            if dt > t.straggler_factor * self._ewma and step > start + 3:
                print(f"[trainer] STRAGGLER step {step}: {dt:.2f}s vs "
                      f"EWMA {self._ewma:.2f}s")
            if dt > t.step_timeout_s:
                raise TimeoutError(f"step {step} exceeded "
                                   f"{t.step_timeout_s}s")
            self._ewma = 0.9 * self._ewma + 0.1 * dt

            if step % t.log_every == 0 or step == t.steps - 1:
                rec = {"step": step, "loss": loss,
                       "lr": float(stats["lr"]),
                       "grad_norm": float(stats["grad_norm"]),
                       "sec": round(dt, 3)}
                self.stats_log.append(rec)
                if self.rank == 0:
                    print(f"[trainer] {rec}")

            if every and (step + 1) % every == 0:
                self.save(step + 1, params, opt_state)
                saved = step + 1

            if self._preempt_agreed():
                print(f"[trainer] preemption: checkpointing step "
                      f"{step + 1} and exiting")
                if saved != step + 1:
                    self.save(step + 1, params, opt_state, blocking=True)
                self._saved(step + 1)
                return {"losses": losses, "preempted": True,
                        "stop_step": step + 1}

        if every:
            if saved != t.steps:
                self.save(t.steps, params, opt_state, blocking=True)
            self._saved(t.steps)
        return {"losses": losses, "preempted": False, "stop_step": t.steps,
                "final_params": params, "opt_state": opt_state}


__all__ = ["Trainer", "TrainerConfig", "state_leaves", "state_names",
           "TREEDEF"]
