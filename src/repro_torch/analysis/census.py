"""Per-device traffic, collectives, ops and temporaries of a PyTorch
step: the port's ``repro/analysis/hlo.py``.

The reference compiles the sharded step and reads the partitioned HLO:
``collective_bytes`` (each collective's result bytes by kind, per
device), ``hbm_bytes`` (operand plus result bytes of every top-level op
after fusion, per device; ``flash_adjusted`` drops the attention score
tiles the TPU kernel keeps in VMEM), ``count_ops`` (a census of
interesting ops) and ``memory_analysis()``'s temp bytes; then
``roofline_terms`` and ``model_flops_per_step`` turn them into times.

The port has no compiler. A sharded step is a DTensor program, one
process a device (``launch/steps.py``), and ``Census`` is a
``TorchDispatchMode`` over one rank's run of it: DTensor hands every op
it desugars to the mode as the local op it runs, and every
redistribution as a functional collective (``_c10d_functional.*``) on
the local tensors, so what the mode sees is that rank's program, as
post-SPMD HLO is one device's. Over a fake process group on ``meta``
(``launch.mesh.fake_device_mesh``) the same run counts without a card or
memory. The counterparts:

* ``hlo.collective_bytes`` -> ``Census.collective_bytes``: each
  collective's result bytes, under the reference's kind names
  (``all-gather``, ``all-reduce``, ``reduce-scatter``, ``all-to-all``,
  ``collective-permute``); DTensor's redistribution from one sharded
  dimension to another runs as its own op, ``_dtensor.
  shard_dim_alltoall``, and counts as an all-to-all;
* ``hlo.hbm_bytes`` -> ``Census.hbm_bytes``: operand plus result bytes
  of each dispatched op that is not a view (eager PyTorch runs every op
  as its own kernel, so this is its traffic model: the counterpart of
  the reference's post-fusion model, not a copy of it), collectives
  apart; ``flash_adjusted`` counts ``ops.flash_attention`` at the
  kernel's boundary (q, k, v read, the output written) in place of the
  plain version's score tiles, as ``hlo.py`` subtracts them;
* ``hlo.count_ops`` -> ``Census.ops``: dispatched ops by ATen name,
  ``flash_attention`` once a call (not its plain version's ops), the
  adjusted traffic by op beside it (``bytes_by_op``);
* ``memory_analysis().temp_size_in_bytes`` -> ``Census.temp_bytes``: the
  peak of the bytes the step allocated and still held (its arguments
  never count), less its outputs live at that peak; ``peak_bytes`` keeps
  them in, the figure a card's ``max_memory_allocated`` less its
  arguments shows. A storage counts from the op that made it until it is
  freed (a finalizer on its Python object, which PyTorch keeps alive as
  long as the storage: ``Census`` checks that it does, once a process);
* ``hlo.roofline_terms`` and ``hlo.model_flops_per_step`` ->
  ``roofline_terms`` and ``model_flops_per_step`` below, with the card's
  rates as arguments.

DTensor's sharding propagation runs ops on fake tensors; the census skips
them. What the census counts is the same for a real NCCL or gloo run and
for the fake group on ``meta`` at the same mesh and device type.
"""
from __future__ import annotations

import contextlib
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.analysis.flops import _MetaMemo

# NVIDIA H100 80GB HBM3 (SXM5, 700 W) datasheet figures: dense bf16 tensor
# cores, HBM3 bandwidth, NVLink 4 (900 GB/s both directions together)
PEAK_FLOPS_BF16 = 989e12  # FLOP/s a card
HBM_BW = 3.35e12  # bytes/s a card
LINK_BW = 450e9  # bytes/s a direction, a card

# functional collectives by the reference's kind names
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
    "broadcast_": "collective-permute",
}
# DTensor's own shard-to-shard op (``_dtensor.shard_dim_alltoall``), the
# all-to-all of a redistribution from one sharded dimension to another
_DTENSOR_COLLECTIVES = {"shard_dim_alltoall": "all-to-all"}
# not counted: a collective's wait, and ``scalar_tensor``, a 0-d constant
# (the reference's literal; ``meta`` kernels make more of them than the
# CPU's or the card's do)
_FREE = {"wait_tensor", "_wrap_tensor_autograd", "scalar_tensor"}


def _bytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) \
        else 0


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _storages(ts) -> set:
    return {t.untyped_storage()._cdata for t in ts}


def _is_fake(ts) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor

    return any(isinstance(t, FakeTensor) for t in ts)


_FINALIZERS_CHECKED: list = []


def _check_finalizers() -> None:
    """Raise unless a finalizer on a storage's Python object runs when the
    storage is freed (PyTorch keeps the object alive with the storage, so
    the census follows frees by finalizers); checked once a process."""
    if _FINALIZERS_CHECKED:
        return
    fired = []
    t = torch.empty(1)
    weakref.finalize(t.untyped_storage(), fired.append, 1)
    del t
    if not fired:
        raise RuntimeError(
            f"torch {torch.__version__} frees a storage without finalizing "
            "its Python object: the census cannot follow frees")
    _FINALIZERS_CHECKED.append(True)


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


class Census(TorchDispatchMode):
    """Counts one rank's ops inside ``with Census() as c:``; ``c.result()``
    gives the dry run's keys."""

    counts_attention = True  # ``kops.attention_observers()`` finds it

    def __init__(self):
        super().__init__()
        self.collective_bytes: dict[str, float] = {}
        self.hbm_bytes = 0.0
        self.hbm_bytes_flash_adjusted = 0.0
        self.ops: dict[str, float] = {}
        self.bytes_by_op: dict[str, float] = {}  # the adjusted traffic
        self._quiet = 0
        self._mult = 1.0
        _check_finalizers()
        # storages the step made and still held: key -> (bytes, allocation
        # seq); a storage's finalizer takes it out
        self._live: dict = {}
        self._seq = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self._peak_seq = 0
        # a repeat of a meta op runs no meta kernel (storages stay apart)
        self._meta = _MetaMemo(fresh_only=True)

    # -- storages ------------------------------------------------------------

    def _freed(self, key, seq: int) -> None:
        """A tracked storage's finalizer: it no longer counts."""
        entry = self._live.get(key)
        if entry is not None and entry[1] == seq:
            del self._live[key]
            self.live_bytes -= entry[0]

    def _track(self, t: torch.Tensor, made_by_args: set) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live or key in made_by_args or st.nbytes() == 0:
            return
        self._seq += 1
        self._live[key] = (st.nbytes(), self._seq)
        weakref.finalize(st, self._freed, key, self._seq).atexit = False
        self.live_bytes += st.nbytes()
        if self.live_bytes > self.peak_bytes:
            self.peak_bytes, self._peak_seq = self.live_bytes, self._seq

    def outputs_at_peak(self) -> int:
        """Bytes of the storages still held now (the step's outputs, read
        after it returns) that were allocated by the peak."""
        return sum(b for b, seq in self._live.values()
                   if seq <= self._peak_seq)

    # -- counting ------------------------------------------------------------

    @contextlib.contextmanager
    def repeat(self, n: int):
        """Multiply the traffic, collectives and ops counted inside by
        ``n``: the one run of a body a loop repeats ``n`` times (the train
        step's microbatches); its storages count once."""
        self._mult *= n
        try:
            yield
        finally:
            self._mult /= n

    def _op(self, name: str) -> None:
        self.ops[name] = self.ops.get(name, 0.0) + self._mult

    @contextlib.contextmanager
    def attention(self, q, k, v, **kw):
        """``ops.flash_attention``'s boundary on this rank's blocks: the
        plain version's ops inside count in ``hbm_bytes`` only; the
        adjusted traffic and the op census take one kernel call, q, k, v
        read and the output written. It yields a list that receives the
        output."""
        from repro_torch.sharding.activation import is_dtensor

        loc = [t.to_local() if is_dtensor(t) else t for t in (q, k, v)]
        held = []
        self._quiet += 1
        try:
            yield held
        finally:
            self._quiet -= 1
        self._op("flash_attention")
        res = _bytes(loc[0])  # the output: q's shape and dtype
        self.hbm_bytes_flash_adjusted += self._mult * (
            sum(map(_bytes, loc)) + res)
        for t in held:
            self._track(t, set())

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # let DTensor desugar it first
        out = self._meta.run(func, args, kwargs)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if _is_fake(ins) or _is_fake(outs):
            return out  # DTensor's sharding propagation
        name = func.overloadpacket.__name__
        if func.namespace == "_c10d_functional" or (
                func.namespace == "_dtensor" and name in _DTENSOR_COLLECTIVES):
            kind = (_COLLECTIVES if func.namespace == "_c10d_functional"
                    else _DTENSOR_COLLECTIVES).get(name)
            if kind is not None:
                self.collective_bytes[kind] = (
                    self.collective_bytes.get(kind, 0.0)
                    + self._mult * sum(map(_bytes, outs)))
                self._op(kind)
            for t in outs:
                self._track(t, _storages(ins))
            return out
        if name in _FREE or _is_view(func):
            return out
        traffic = self._mult * (sum(map(_bytes, ins))
                                + sum(map(_bytes, outs)))
        self.hbm_bytes += traffic
        if not self._quiet:
            self.hbm_bytes_flash_adjusted += traffic
            self.bytes_by_op[name] = self.bytes_by_op.get(name, 0.0) \
                + traffic
            self._op(name)
            made = _storages(ins)
            for t in outs:
                self._track(t, made)
        return out

    def result(self) -> dict:
        """The dry run's keys: ``device_hbm_bytes``,
        ``device_hbm_bytes_flash_adjusted``, ``collective_bytes``,
        ``hlo_ops`` (the ATen census) with ``bytes_by_op`` (the adjusted
        traffic by op) and ``temp_bytes`` / ``peak_bytes``
        (read after the step returned, its outputs still held)."""
        return {"device_hbm_bytes": float(self.hbm_bytes),
                "device_hbm_bytes_flash_adjusted":
                    float(self.hbm_bytes_flash_adjusted),
                "collective_bytes": dict(sorted(
                    self.collective_bytes.items())),
                "hlo_ops": dict(sorted(self.ops.items())),
                "bytes_by_op": dict(sorted(self.bytes_by_op.items())),
                "temp_bytes": int(self.peak_bytes - self.outputs_at_peak()),
                "peak_bytes": int(self.peak_bytes)}


def roofline_terms(global_flops: float, device_hbm_bytes: float,
                   coll_bytes: dict, n_chips: int, *,
                   peak_flops: float = PEAK_FLOPS_BF16,
                   hbm_bw: float = HBM_BW,
                   link_bw: float = LINK_BW) -> dict:
    """Three per-step roofline times in seconds, as ``hlo.
    roofline_terms``: ``global_flops`` (the whole program's) over
    ``n_chips`` cards at ``peak_flops``; ``device_hbm_bytes`` and
    ``coll_bytes`` are one device's, at ``hbm_bw`` and ``link_bw`` (an
    all-reduce moves about twice its buffer on a ring, the rest once)."""
    t_compute = global_flops / (n_chips * peak_flops)
    t_memory = device_hbm_bytes / hbm_bw
    cb = 0.0
    for kind, b in coll_bytes.items():
        cb += (2.0 if kind == "all-reduce" else 1.0) * b
    t_coll = cb / link_bw
    dominant = max((("compute", t_compute), ("memory", t_memory),
                    ("collective", t_coll)), key=lambda kv: kv[1])[0]
    return {"t_compute_s": t_compute, "t_memory_s": t_memory,
            "t_collective_s": t_coll, "dominant": dominant}


def model_flops_per_step(n_active_params: int, tokens_per_step: int,
                         kind: str = "train") -> float:
    """6ND for train (forward and backward), 2ND for inference."""
    c = 6.0 if kind == "train" else 2.0
    return c * n_active_params * tokens_per_step


__all__ = ["Census", "roofline_terms", "model_flops_per_step",
           "PEAK_FLOPS_BF16", "HBM_BW", "LINK_BW"]
