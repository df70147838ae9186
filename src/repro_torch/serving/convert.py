"""Engine states carried across, as numpy arrays.

The JAX classification engine's state is an 8-leaf pytree whose
``tree_flatten`` order is ``X, y, best, n, D, head, aid, wrap``
(``repro/serving/session.py`` and ``repro/core/online.py``); the
regression engine's is the 10-leaf ``X, y, D, nbr_d, nbr_y, n, head,
aid, wrap, nbr_a`` (``repro/regression/stream.py``). Each leaf has the
leading tenant axis. These functions move them into the port and back,
so both engines can start from one state and be compared leaf by leaf.

The batch measures' states carry across the same way (``batch_state_from_
numpy`` / ``batch_state_to_numpy``), in the JAX classes' ``tree_flatten``
order: ``KnnState (X, y, best_same, best_diff)``, ``KdeState (X, y,
prelim, class_counts)``, ``LssvmState (Phi, Y, w, C, rho)``,
``IcpKnnState (X_train, y_train, calib_scores)``, ``IcpKdeState
(X_train, y_train, class_counts, calib_scores)``, ``IcpLssvmState (w,
calib_scores)``; ``rff_params_from_numpy`` carries the JAX ``rff`` feature
map's ``W, b`` (drawn with ``jax.random``) into ``lssvm.feature_map``.

A language model's parameters carry across with ``lm_params_from_numpy``
/ ``lm_params_to_numpy``: the JAX ``init_lm`` tree (``embed``, ``layers``
as a list of runs whose leaves have a leading layer axis, ``final_norm``,
``lm_head`` when untied; an encoder-decoder's ``encoder`` runs, its
``cross`` tree stacked over the decoder's layers and ``pos_embed_dec``) as
numpy arrays, each run or stack split into its layers; the MoE's (``moe``
with ``shared``), MLA's and the recurrent blocks' nested trees carry
across as they are, and each leaf keeps the reference's dtype (in a bf16
model an MoE router, the RG-LRU's ``lam``, the mLSTM's ``w_if`` and
``b_if`` and the sLSTM's ``b_zifo`` are f32). ``lm_params_to_numpy(params,
grads=True)`` lays the parameters' gradients out in the same tree.

The optimizer state carries across with ``opt_state_from_numpy`` /
``opt_state_to_numpy``: the JAX ``init_opt_state`` tree (``mu`` and
``nu`` shaped like the ``init_lm`` tree, ``nu``'s leaves ``{"full"}`` or
``{"row", "col"}``, an int32 ``step``) against the port's, whose leaves
are keyed by the reference's dotted paths
(``LmParams.reference_leaves()``) and already hold its stacked shapes.
"""
from __future__ import annotations

from dataclasses import fields

import numpy as np
import torch

from repro_torch._device import resolve
from repro_torch.core import icp
from repro_torch.core.measures import kde, knn, lssvm
from repro_torch.models import blocks as blk
from repro_torch.models import lm
from repro_torch.models.common import frozen
from repro_torch.optim import param_leaves
from repro_torch.regression.stream import RegStreamState
from repro_torch.serving.session import Session

# dtype of each leaf in tree_flatten order; None keeps the float type
_LEAF_DTYPES = (None, torch.int32, None, torch.int32, None, torch.int32,
                torch.int32, torch.int32)
_REG_LEAF_DTYPES = (None, None, None, None, None, torch.int32, torch.int32,
                    torch.int32, torch.int32, torch.int32)


def _from_numpy(leaves, dtypes, names: str, device):
    if len(leaves) != len(dtypes):
        raise ValueError(f"expected {len(dtypes)} leaves ({names}), got "
                         f"{len(leaves)}")
    dev = resolve(device)
    return [torch.as_tensor(np.array(a), device=dev, dtype=dt)
            for a, dt in zip(leaves, dtypes)]


def session_from_numpy(leaves, device=None) -> Session:
    """Port state from the JAX engine's eight leaves (numpy arrays)."""
    return Session.from_leaves(_from_numpy(
        leaves, _LEAF_DTYPES, "X, y, best, n, D, head, aid, wrap", device))


def session_to_numpy(state: Session) -> list[np.ndarray]:
    """The eight leaves of ``state`` as numpy arrays, JAX order."""
    return [t.detach().cpu().numpy() for t in state.leaves()]


def reg_state_from_numpy(leaves, device=None) -> RegStreamState:
    """Port regression state from the JAX engine's ten leaves."""
    return RegStreamState.from_leaves(_from_numpy(
        leaves, _REG_LEAF_DTYPES,
        "X, y, D, nbr_d, nbr_y, n, head, aid, wrap, nbr_a", device))


def reg_state_to_numpy(state: RegStreamState) -> list[np.ndarray]:
    """The ten leaves of ``state`` as numpy arrays, JAX order."""
    return [t.detach().cpu().numpy() for t in state.leaves()]


_I32 = torch.int32
# each batch state class and its leaves' dtypes; None keeps the float type
_BATCH_STATES = {
    knn.KnnState: (None, _I32, None, None),
    kde.KdeState: (None, _I32, None, _I32),
    lssvm.LssvmState: (None, None, None, None, None),
    icp.IcpKnnState: (None, _I32, None),
    icp.IcpKdeState: (None, _I32, _I32, None),
    icp.IcpLssvmState: (None, None),
}


def batch_state_from_numpy(cls, leaves, device=None):
    """A batch measure's state of class ``cls`` (``knn.KnnState``, ...,
    ``icp.IcpLssvmState``) from the JAX state's leaves."""
    names = ", ".join(f.name for f in fields(cls))
    return cls(*_from_numpy(leaves, _BATCH_STATES[cls], names, device))


def batch_state_to_numpy(state) -> list[np.ndarray]:
    """The leaves of a batch measure's state as numpy arrays, JAX order."""
    return [t.detach().cpu().numpy() for t in state.leaves()]


def rff_params_from_numpy(W, b, device=None):
    """The ``rff`` map's ``W (p, q)``, ``b (q,)`` as f32 tensors, for
    ``lssvm.feature_map("rff", ..., params=...)``."""
    return tuple(_from_numpy([W, b], (torch.float32, torch.float32), "W, b",
                             device))


def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _keyed_map(fn, tree, key: str = ""):
    """``fn(leaf, key)`` over a nested dict, ``key`` the leaf's name."""
    if isinstance(tree, dict):
        return {k: _keyed_map(fn, v, k) for k, v in tree.items()}
    return fn(tree, key)


# leaves that the reference keeps in f32 whatever ``param_dtype`` is:
# the MoE router (``repro/models/mlp.py::init_moe``), the RG-LRU's ``lam``
# and the xLSTM gates' ``w_if``, ``b_if``, ``b_zifo``
# (``repro/models/recurrent.py``)
_F32_LEAVES = ("router", "lam", "w_if", "b_if", "b_zifo")


def lm_params_from_numpy(tree, cfg, device=None) -> lm.LmParams:
    """The port's ``LmParams`` from the JAX ``init_lm`` tree as numpy
    arrays on ``device`` (cuda unless given), each leaf in the dtype the
    reference gives it: ``cfg.param_dtype``, f32 for ``_F32_LEAVES``."""
    dev = resolve(device)
    dtype = lm.dtype_of(cfg.param_dtype)

    def t(a, key=""):
        dt = torch.float32 if key in _F32_LEAVES else dtype
        return torch.as_tensor(np.array(a, dtype=np.float32), device=dev
                               ).to(dt)

    def layer_stack(runs_tree, pattern):
        runs = blk.pattern_runs(pattern)
        if len(runs_tree) != len(runs):
            raise ValueError(f"{len(runs_tree)} runs for the pattern's "
                             f"{len(runs)}")
        return torch.nn.ModuleList(
            split_layers(run, length) for (_, length), run in
            zip(runs, runs_tree))

    def split_layers(stacked, length):
        return torch.nn.ModuleList(
            frozen(_keyed_map(lambda a, key, i=i: t(a[i], key), stacked))
            for i in range(length))

    head = t(tree["lm_head"]) if "lm_head" in tree else None
    extra = {}
    if cfg.is_encoder_decoder:
        extra = dict(
            encoder=layer_stack(tree["encoder"],
                                lm._encoder_cfg(cfg).pattern),
            cross=split_layers(tree["cross"], cfg.n_layers),
            pos_embed_dec=t(tree["pos_embed_dec"]))
    return lm.LmParams(t(tree["embed"]), layer_stack(tree["layers"],
                                                     cfg.pattern),
                       _tree_map(t, tree["final_norm"]), head, **extra)


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _grad_numpy(t: torch.Tensor) -> np.ndarray:
    """A parameter's gradient (zeros where none reached it)."""
    return (np.zeros(t.shape, np.float32) if t.grad is None
            else _numpy(t.grad))


def _module_tree(mod, leaf=_numpy) -> dict:
    return {k: _module_tree(v, leaf) if isinstance(v, torch.nn.Module)
            else leaf(v) for k, v in mod.items()}


def _stacked(layers, leaf=_numpy) -> dict:
    """Per-layer modules as one tree, each leaf stacked on a leading
    axis."""
    return _tree_map(lambda *xs: np.stack(xs),
                     *(_module_tree(m, leaf) for m in layers))


def lm_params_to_numpy(params: lm.LmParams, grads: bool = False) -> dict:
    """The JAX ``init_lm`` tree of ``params`` (float32 numpy arrays, each
    run's layers stacked on a leading axis, as is an encoder-decoder's
    ``cross``); with ``grads``, of the parameters' gradients instead."""
    leaf = _grad_numpy if grads else _numpy
    out = {"embed": leaf(params["embed"]),
           "layers": [_stacked(run, leaf) for run in params["layers"]],
           "final_norm": _module_tree(params["final_norm"], leaf)}
    if "lm_head" in params:
        out["lm_head"] = leaf(params["lm_head"])
    if "encoder" in params:
        out["encoder"] = [_stacked(run, leaf) for run in params["encoder"]]
        out["cross"] = _stacked(params["cross"], leaf)
        out["pos_embed_dec"] = leaf(params["pos_embed_dec"])
    return out


def _at(tree, path: str):
    """The node of a nested dict / list tree at a dotted path (integer
    parts index lists)."""
    for part in path.split("."):
        tree = tree[int(part)] if isinstance(tree, list) else tree[part]
    return tree


def _put(tree: dict, path: str, value) -> None:
    """``tree`` at ``path`` set to ``value``, making dicts and lists on
    the way (a list grows to the index asked for)."""
    parts = path.split(".")
    for part, nxt in zip(parts[:-1], parts[1:]):
        make = list if nxt.isdigit() else dict
        if isinstance(tree, list):
            i = int(part)
            while len(tree) <= i:
                tree.append(make())
            tree = tree[i]
        else:
            tree = tree.setdefault(part, make())
    tree[parts[-1]] = value


def opt_state_to_numpy(opt_state: dict) -> dict:
    """The JAX ``init_opt_state`` tree of the port's optimizer state
    (numpy arrays in the moments' dtype, ``step`` int32)."""
    host = lambda t: t.detach().cpu().numpy()  # noqa: E731
    mu, nu = {}, {}
    for name, m in opt_state["mu"].items():
        _put(mu, name, host(m))
        _put(nu, name, {k: host(v) for k, v in
                        opt_state["nu"][name].items()})
    return {"mu": mu, "nu": nu,
            "step": np.asarray(host(opt_state["step"]), np.int32)}


def opt_state_from_numpy(tree: dict, params, device=None) -> dict:
    """The port's optimizer state for ``params`` from the JAX
    ``init_opt_state`` tree (numpy arrays), on ``device`` (cuda unless
    given)."""
    dev = resolve(device)
    t = lambda a: torch.as_tensor(np.array(a), device=dev)  # noqa: E731
    names = list(param_leaves(params))
    return {"mu": {n: t(_at(tree["mu"], n)) for n in names},
            "nu": {n: {k: t(v) for k, v in _at(tree["nu"], n).items()}
                   for n in names},
            "step": t(np.asarray(tree["step"], np.int32))}


__all__ = ["lm_params_from_numpy", "lm_params_to_numpy",
           "opt_state_from_numpy", "opt_state_to_numpy",
           "session_from_numpy", "session_to_numpy", "reg_state_from_numpy",
           "reg_state_to_numpy", "batch_state_from_numpy",
           "batch_state_to_numpy", "rff_params_from_numpy"]
