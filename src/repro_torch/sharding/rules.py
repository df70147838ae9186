"""Sharding rules: parameter, batch and cache leaves -> placements on a
mesh, the port's copy of ``repro/sharding/rules.py``.

Axis roles on the production mesh (``launch.mesh.make_production_mesh``):

    pod    pure data parallelism across pods (parameters and optimizer
           state replicated a pod)
    data   batch parallelism + FSDP: weight matrices also shard their
           d_model-ish dimension here, so optimizer state divides by the
           full 256-way device count
    model  tensor parallelism: attention heads (or head_dim for MQA),
           MLP hidden, MoE experts (EP) or expert-hidden (TP), vocab

Rules are name+shape driven over the reference's leaf paths, with
divisibility guards: a dimension shards only if the mesh axis divides it
(gemma3's 4 heads cannot split 16 ways, so its 256-dim head_dim shards
instead; internvl's 92,553 vocab stays replicated).

The port runs no partitioner: a spec is a tuple with one entry a
dimension, ``None``, an axis name or a tuple of axes sharded jointly, and
``Placement`` (the counterpart of ``jax.sharding.NamedSharding``) turns
it into a per-device shape and bytes by arithmetic. The dry run
(``launch/dryrun.py``) counts each cell's per-device argument and output
bytes that way. Leaves are keyed by the reference's paths, dotted:
``LmParams.reference_leaves()`` gives a model's (a stacked leaf is the
list of its layers), ``reference_cache_leaves`` a decode cache's, and an
optimizer state's are ``mu.<leaf>``, ``nu.<leaf>.(full|row|col)`` and
``step``.

A sharded program (``launch/steps.py``, ``runtime/trainer.py``) holds
its leaves as DTensors on a ``torch.distributed.DeviceMesh`` with the
same axis names: ``dtensor_placements`` turns a spec into one placement a
mesh dimension (an axis that shards a tensor dimension ``d`` is
``Shard(d)``; a tuple of axes is ``Shard(d)`` on each, in mesh order,
the reference's row-major joint sharding; every other axis, and an axis
of size 1, is ``Replicate()``), ``distribute`` places a leaf tree and
``distribute_params`` a model's parameters in place. Every function here
takes either kind of mesh (``axis_sizes``).
"""
from __future__ import annotations

import math
import re
from dataclasses import dataclass

import torch


def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` of a ``core.distributed.Mesh`` or a
    ``DeviceMesh``."""
    if isinstance(mesh.shape, dict):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def dp_axes(mesh) -> tuple:
    return ("pod", "data") if "pod" in axis_sizes(mesh) else ("data",)


def _axsize(mesh, name) -> int:
    return axis_sizes(mesh)[name]


def _div(dim: int, size: int) -> bool:
    return dim % size == 0 and dim >= size


class Rules:
    def __init__(self, mesh, strategy: str = "tp_sp"):
        self.mesh = mesh
        self.strategy = strategy
        self.model = _axsize(mesh, "model")
        self.data = _axsize(mesh, "data")

    # -- helpers -----------------------------------------------------------

    def m(self, dim: int):
        """'model' if divisible else None."""
        return "model" if _div(dim, self.model) else None

    def d(self, dim: int):
        return "data" if _div(dim, self.data) else None

    def dp(self, dim: int):
        """Full data-parallel axes tuple if divisible, else best effort."""
        axes = dp_axes(self.mesh)
        if self.strategy == "fsdp":
            axes = axes + ("model",)
            total = math.prod(_axsize(self.mesh, a) for a in axes)
            if _div(dim, total):
                return axes
            axes = dp_axes(self.mesh)
        total = math.prod(_axsize(self.mesh, a) for a in axes)
        if _div(dim, total):
            return axes
        if _div(dim, self.data):
            return ("data",)
        return None

    # -- parameter rules ----------------------------------------------------

    def param_spec(self, path: str, shape: tuple) -> tuple:
        """The spec of one parameter. ``path`` is '/'-joined keys with
        stacked layer-run axes already stripped by the caller."""
        name = path.split("/")[-1]
        nd = len(shape)

        if name == "embed":
            return (self.m(shape[0]), self.d(shape[1]))
        if name == "lm_head":
            return (self.d(shape[0]), self.m(shape[1]))
        if name == "pos_embed_dec":
            return (None, self.d(shape[1]))

        # attention projections
        if name == "wq" and nd == 3:
            d, h, hd = shape
            if self.m(h):
                return (self.d(d), "model", None)
            return (self.d(d), None, self.m(hd))
        if name in ("wk", "wv") and nd == 3:
            d, kv, hd = shape
            if self.m(kv):
                return (self.d(d), "model", None)
            return (self.d(d), None, self.m(hd))
        if name == "wo" and nd == 3:
            h, hd, d = shape
            if self.m(h):
                return ("model", None, self.d(d))
            return (None, self.m(hd), self.d(d))
        if name in ("bq", "bk", "bv") and nd == 2:
            h, hd = shape
            if self.m(h):
                return ("model", None)
            return (None, self.m(hd))

        # MLA
        if name == "wq_a":
            return (self.d(shape[0]), None)
        if name == "wq_b":
            return (None, self.m(shape[1]), None)
        if name == "wkv_a":
            return (self.d(shape[0]), None)
        if name in ("wk_b", "wv_b"):
            return (None, self.m(shape[1]), None)

        # MoE (expert tensors are (E, D, F) / (E, F, D))
        if name == "router":
            return (self.d(shape[0]), None)
        if re.search(r"moe/(w_gate|w_up)$", path) and nd == 3:
            e, d, f = shape
            if self.m(e):
                return ("model", self.d(d), None)
            return (None, self.d(d), self.m(f))
        if re.search(r"moe/w_down$", path) and nd == 3:
            e, f, d = shape
            if self.m(e):
                return ("model", None, self.d(d))
            return (None, self.m(f), self.d(d))

        # dense MLP / shared experts
        if name in ("w_gate", "w_up", "w_ff1") and nd == 2:
            return (self.d(shape[0]), self.m(shape[1]))
        if name in ("w_down", "w_ff2") and nd == 2:
            return (self.m(shape[0]), self.d(shape[1]))

        # recurrent families
        if name in ("w_in", "w_gate_in") and nd == 2:
            return (self.d(shape[0]), self.m(shape[1]))
        if name in ("w_rg", "w_ig") and nd == 2:
            return (self.m(shape[0]), None)
        if name == "w_out" and nd == 2:
            return (self.m(shape[0]), self.d(shape[1]))
        if name in ("wq", "wk", "wv") and nd == 2:  # mlstm projections
            return (self.d(shape[0]), self.m(shape[1]))
        if name == "w_if":
            return (self.d(shape[0]), None)
        if name == "w_zifo":
            return (self.d(shape[0]), self.m(shape[1]))
        if name == "r_zifo":
            return (None, None, self.m(shape[2]))
        if name == "lam" or name == "skip":
            return (self.m(shape[0]),)
        if path.endswith("conv/w"):
            return (None, self.m(shape[1]))
        if path.endswith("conv/b"):
            return (self.m(shape[0]),)

        # norms, biases, everything small: replicate
        return (None,) * nd

    # -- batch / cache rules -------------------------------------------------

    def batch_spec(self, name: str, shape: tuple) -> tuple:
        nd = len(shape)
        b = self.dp(shape[0])
        if name in ("tokens", "labels", "mask"):
            if b is None and nd == 2 and shape[1] > 1:
                # long-context single-sequence: shard sequence instead
                return (None, self.dp(shape[1]))
            return (b,) + (None,) * (nd - 1)
        if name in ("patch_embeds", "frames"):
            return (b, None, None)
        return (None,) * nd

    def cache_spec(self, path: str, shape: tuple) -> tuple:
        """Cache entries carry a leading stacked-layer axis L.

        KV caches (L, B, S, Kv, hd): batch over dp when divisible, else
        sequence over dp (context parallelism for the 500k cell); heads
        over model.
        """
        name = path.split("/")[-1]
        nd = len(shape)
        if name in ("k", "v") and nd == 5:
            L, B, S, kv, hd = shape
            b = self.dp(B)
            s = None if b else self.dp(S)
            return (None, b, s, self.m(kv) if self.m(kv) else None,
                    None if self.m(kv) else self.m(hd))
        if name in ("k", "v") and nd == 4:  # unstacked
            B, S, kv, hd = shape
            b = self.dp(B)
            s = None if b else self.dp(S)
            return (b, s, self.m(kv) if self.m(kv) else None,
                    None if self.m(kv) else self.m(hd))
        if name in ("c_kv", "k_rope") and nd == 4:
            L, B, S, r = shape
            b = self.dp(B)
            s = None if b else self.dp(S)
            return (None, b, s, None)
        if name == "C" and nd == 5:  # mlstm matrix memory (L,B,H,dh,dh)
            return (None, self.dp(shape[1]), self.m(shape[2]), None, None)
        if nd >= 2:
            return (None, self.dp(shape[1])) + (None,) * (nd - 2)
        return (None,) * nd


# ---------------------------------------------------------------------------
# leaves: the reference's paths and shapes
# ---------------------------------------------------------------------------


def _shape(leaf) -> tuple:
    """A leaf's shape: a tensor's, a stacked list's ``(L, *layer)``, or a
    Python int's ``()`` (a scalar)."""
    if isinstance(leaf, int):
        return ()
    if isinstance(leaf, list):
        return (len(leaf),) + tuple(leaf[0].shape)
    return tuple(leaf.shape)


def leaves(tree, prefix: str = "") -> dict:
    """``{dotted path: leaf}`` of ``tree``: a module with
    ``reference_leaves()`` (``LmParams``), or nested dicts whose leaves are
    tensors, lists of stacked tensors or Python ints."""
    if hasattr(tree, "reference_leaves"):
        tree = tree.reference_leaves()
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(leaves(v, path + "."))
        else:
            out[path] = v
    return out


def reference_cache_leaves(cache: dict) -> dict:
    """A decode cache (``lm.init_cache``) as the reference stacks it:
    ``{"self.<run>.<name>": [each layer's tensor]}`` and the encoder-
    decoder's ``{"cross.k", "cross.v"}`` (already stacked)."""
    out = {}
    for i, run in enumerate(cache["self"]):
        for name in run[0]:
            out[f"self.{i}.{name}"] = [layer[name] for layer in run]
    for name, t in cache.get("cross", {}).items():
        out[f"cross.{name}"] = t
    return out


# ---------------------------------------------------------------------------
# tree-level API
# ---------------------------------------------------------------------------


def param_pspecs(params, mesh) -> dict:
    """``{path: spec}`` for a model's leaves, or an optimizer state's (its
    moments shard like their parameters)."""
    rules = Rules(mesh)

    def one(path, leaf):
        p = path.replace(".", "/")
        # optimizer state prefixes shard identically to the parameter
        for pre in ("mu/", "nu/"):
            if p.startswith(pre):
                p = p[len(pre):]
        p = re.sub(r"/(row|col|full)$", "", p)
        shape = _shape(leaf)
        if p == "step" or not shape:
            return ()
        if re.fullmatch(r"(layers|encoder)/\d+/.*", p) or \
                p.startswith("cross/"):
            inner = tuple(rules.param_spec(p, shape[1:]))
            # factored moments may have dropped trailing dims vs the param
            return (None,) + inner[:len(shape) - 1]
        return tuple(rules.param_spec(p, shape))[:len(shape)]

    return {path: one(path, leaf) for path, leaf in leaves(params).items()}


def batch_pspecs(batch, mesh, strategy: str = "tp_sp") -> dict:
    rules = Rules(mesh, strategy)
    return {path: rules.batch_spec(path.split(".")[-1],
                                   _shape(leaf))[:len(_shape(leaf))]
            for path, leaf in leaves(batch).items()}


def cache_pspecs(cache, mesh, strategy: str = "tp_sp") -> dict:
    """``{path: spec}`` of a cache in the reference's stacked form
    (``reference_cache_leaves``)."""
    rules = Rules(mesh, strategy)
    return {path: rules.cache_spec(path.replace(".", "/"),
                                   _shape(leaf))[:len(_shape(leaf))]
            for path, leaf in leaves(cache).items()}


@dataclass(frozen=True)
class Placement:
    """A spec on a mesh, the counterpart of ``jax.sharding.
    NamedSharding``: ``shard_shape`` is one device's block of a global
    shape."""

    mesh: object
    spec: tuple

    def shard_shape(self, shape: tuple) -> tuple:
        out = list(shape)
        for i, entry in enumerate(self.spec):
            if entry is None:
                continue
            axes = entry if isinstance(entry, tuple) else (entry,)
            n = math.prod(_axsize(self.mesh, a) for a in axes)
            if out[i] % n:
                raise ValueError(f"dim {i} of {tuple(shape)} does not "
                                 f"divide over {axes} ({n})")
            out[i] //= n
        return tuple(out)

    def nbytes(self, shape: tuple, dtype: torch.dtype) -> int:
        """One device's bytes of a ``shape`` leaf of ``dtype``."""
        return math.prod(self.shard_shape(shape)) * dtype.itemsize


def named(tree_specs: dict, mesh) -> dict:
    """``{path: Placement}`` of ``{path: spec}`` on ``mesh``."""
    return {path: Placement(mesh, spec) for path, spec in tree_specs.items()}


def leaf_dtype(leaf) -> torch.dtype:
    """A leaf's dtype: a tensor's, a stacked list's first layer's; a Python
    int is the reference's int32 scalar (the decode step's ``index``)."""
    if isinstance(leaf, list):
        return leaf[0].dtype
    if isinstance(leaf, int):
        return torch.int32
    return leaf.dtype


def device_bytes(tree, specs: dict, mesh) -> int:
    """One device's bytes of ``tree``'s leaves placed by ``specs``."""
    places = named(specs, mesh)
    return sum(places[path].nbytes(_shape(leaf), leaf_dtype(leaf))
               for path, leaf in leaves(tree).items())


# ---------------------------------------------------------------------------
# DTensor placements
# ---------------------------------------------------------------------------


def dtensor_placements(spec: tuple, mesh) -> tuple:
    """One DTensor placement a dimension of the ``DeviceMesh`` ``mesh``
    for ``spec``: ``Shard(d)`` on the mesh dims whose axes shard tensor
    dimension ``d``, ``Replicate()`` on the rest and on any axis of size
    1. A tuple of axes must be in mesh order (DTensor shards a dimension
    over several mesh dims in that order)."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"axes {axes} are not in the mesh's order "
                             f"{names}")
        for i in idx:
            if mesh.size(i) > 1:
                out[i] = Shard(d)
    return tuple(out)


def _place(t: torch.Tensor, spec: tuple, mesh):
    """``t`` (whole, the same on every rank) as a DTensor placed by
    ``spec``: each rank keeps its block, nothing is sent."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t.detach(), mesh, dtensor_placements(spec,
                                                                  mesh),
                             src_data_rank=None)


def distribute(tree, specs: dict, mesh) -> dict:
    """``{path: leaf}`` of ``tree`` (``leaves``) with each leaf placed by
    its spec as a DTensor on ``mesh``; a stacked leaf (a list of layers)
    stays a list, each layer placed by the spec without its layer axis;
    a Python int stays itself."""
    out = {}
    for path, leaf in leaves(tree).items():
        spec = specs[path]
        if isinstance(leaf, int):
            out[path] = leaf
        elif isinstance(leaf, list):
            out[path] = [_place(t, spec[1:], mesh) for t in leaf]
        else:
            out[path] = _place(leaf, spec, mesh)
    return out


def distribute_params(params, mesh):
    """Replace each parameter of ``params`` (an ``LmParams``) by a
    DTensor parameter placed by ``param_pspecs`` on ``mesh``, keeping its
    ``requires_grad``; returns ``params``."""
    specs = param_pspecs(params, mesh)
    placed = distribute(params, specs, mesh)
    by_id = {}
    for path, leaf in leaves(params).items():
        if isinstance(leaf, list):
            by_id.update({id(t): d for t, d in zip(leaf, placed[path])})
        else:
            by_id[id(leaf)] = placed[path]
    for mod in params.modules():
        for name, p in list(mod._parameters.items()):
            if p is not None:
                mod._parameters[name] = torch.nn.Parameter(
                    by_id[id(p)], requires_grad=p.requires_grad)
    return params


def distribute_state(params, opt_state: dict, mesh) -> tuple:
    """A model's parameters (in place) and its AdamW state (``mu``,
    ``nu``, ``step``) placed on ``mesh`` by ``param_pspecs``."""
    distribute_params(params, mesh)
    placed = iter(distribute(opt_state, param_pspecs(opt_state, mesh),
                             mesh).values())
    mu = {k: next(placed) for k in opt_state["mu"]}
    nu = {k: {s: next(placed) for s in v}
          for k, v in opt_state["nu"].items()}
    return params, {"mu": mu, "nu": nu, "step": next(placed)}


def local_bytes(tree) -> int:
    """Bytes of this rank's blocks of ``tree``'s leaves (a DTensor's local
    tensor, any other tensor whole; a Python int the reference's int32)."""
    from torch.distributed.tensor import DTensor

    total = 0
    for leaf in leaves(tree).values():
        for t in (leaf if isinstance(leaf, list) else [leaf]):
            if isinstance(t, int):
                total += 4
                continue
            t = t.to_local() if isinstance(t, DTensor) else t
            total += t.numel() * t.element_size()
    return total


__all__ = ["Rules", "param_pspecs", "batch_pspecs", "cache_pspecs", "named",
           "dp_axes", "Placement", "leaves", "reference_cache_leaves",
           "device_bytes", "axis_sizes", "dtensor_placements", "distribute",
           "distribute_params", "distribute_state", "local_bytes"]
