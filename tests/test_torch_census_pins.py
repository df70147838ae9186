"""The layouts the port pins where the reference leaves them to XLA, and
the committed census record (``launch/census_16x16.json``), on the CPU.

Left to DTensor's sharding propagation, a partial sum that an op cannot
take, or a cotangent that reaches an op in another placement, is
redistributed by a collective the PyTorch build chooses (2.11 all-reduces
where 2.13 reduce-scatters). Each such site now redistributes explicitly
(``sharding.activation``: ``reduce_partial``, ``gather_dims``,
``reshard``, ``grad_like``, or ``constrain``). Each test below runs one
site at reduced size on a 4-rank fake group on ``meta`` and holds the
collectives the census counts at that site (by the model code's line)
to the bytes its placements give.

The record: a fresh dry-run census of the cheap 16 x 16 decode cells
equals the committed one, key by key.
"""
import inspect
import math
import traceback
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import repro_torch.configs as cfgs  # noqa: E402
from repro_torch.analysis import census as census_m  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import fake_device_mesh  # noqa: E402
from repro_torch.models import attention, common, lm, recurrent  # noqa: E402
from repro_torch.sharding import rules  # noqa: E402
from repro_torch.sharding.activation import (activation_mesh,  # noqa: E402
                                             grad_like, reduce_partial)

B, S = 4, 32  # rows and keys; the (data, model) mesh is (2, 2)
F32, BF16 = 4, 2


@pytest.fixture(scope="module")
def mesh():
    return fake_device_mesh((2, 2), ("data", "model"), "cuda")


def _dt(shape, placements, mesh, dtype=torch.float32, grad=False):
    """A ``meta`` DTensor of global ``shape`` placed by ``placements``."""
    from torch.distributed.tensor import DTensor

    local = list(shape)
    for i, p in enumerate(placements):
        if p.is_shard():
            local[p.dim] //= mesh.size(i)
    t = DTensor.from_local(torch.empty(local, dtype=dtype, device="meta"),
                           mesh, placements, run_check=False)
    return t.requires_grad_(grad) if grad else t


def _placed(t, spec, mesh):
    return rules._place(t, spec, mesh)


class SiteCensus(census_m.Census):
    """``Census`` with ``by_line``: each collective's bytes by kind, filed
    under ``(file name, line)`` of the innermost frame of the port's model
    code that issued it (``"?"`` outside it, as in a backward)."""

    def __init__(self):
        super().__init__()
        self.by_line: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        table = {"_c10d_functional": census_m._COLLECTIVES,
                 "_dtensor": census_m._DTENSOR_COLLECTIVES}.get(
                     func.namespace, {})
        kind = table.get(func.overloadpacket.__name__)
        outs = census_m._tensors(out)
        if out is NotImplemented or kind is None or census_m._is_fake(outs):
            return out
        ours = [f for f in traceback.extract_stack()
                if "repro_torch/models/" in f.filename]
        site = (Path(ours[-1].filename).name, ours[-1].lineno) if ours \
            else "?"
        by = self.by_line.setdefault(site, {})
        by[kind] = by.get(kind, 0) + self._mult * sum(
            map(census_m._bytes, outs))
        return out


def line_of(fn, text: str) -> tuple:
    """``(file name, line)`` of the one line of ``fn``'s source holding
    ``text``."""
    src, first = inspect.getsourcelines(fn)
    hits = [first + i for i, ln in enumerate(src) if text in ln]
    assert len(hits) == 1, (text, hits)
    return Path(inspect.getsourcefile(fn)).name, hits[0]


def _attn_cfg(n_heads, n_kv):
    base = cfgs.get("granite_34b").reduced()
    import dataclasses

    return dataclasses.replace(base, n_heads=n_heads, n_kv_heads=n_kv,
                               head_dim=16)


def _decode_args(cfg, mesh):
    from repro_torch.models.lm import dtype_of

    dt = dtype_of(cfg.dtype)
    p = attention.init_attention(common.META_DRAWS, cfg, dt)
    r = rules.Rules(mesh)
    for name in list(p.keys()):
        p[name] = _placed(p[name], r.param_spec(f"attn/{name}",
                                                tuple(p[name].shape)), mesh)
    cache = attention.init_kv_cache(cfg, B, S, dt, "meta")
    for name in ("k", "v"):
        cache[name] = _placed(cache[name], r.cache_spec(
            name, tuple(cache[name].shape)), mesh)
    x = _placed(torch.empty((B, 1, cfg.d_model), dtype=dt, device="meta"),
                ("data", None, None), mesh)
    return p, x, cache


@pytest.mark.parametrize("n_heads,route", [(4, "heads"), (3, "keys")])
def test_decode_scores_pinned(mesh, n_heads, route):
    """With one kv head the cache splits its head_dim over "model", so
    the decode scores are a partial sum. Four heads divide over the two
    model ranks: the scores are reduce-scattered onto them, and the
    probabilities and the cache's values then moved onto the keys by two
    all-to-alls. Three do not: the scores are reduce-scattered onto the
    keys and gathered for the softmax. Never an all-reduce of the
    scores."""
    cfg = _attn_cfg(n_heads, 1)
    p, x, cache = _decode_args(cfg, mesh)
    r = cfg.n_heads  # one kv group
    with activation_mesh(mesh), SiteCensus() as c:
        attention.attention_decode(p, x, cfg, cache, 3)
    b = B // 2
    scores = line_of(attention.attention_decode, "reduce_partial(logits")
    gather = line_of(attention.attention_decode,
                     "torch.softmax(gather_dims(")
    if route == "heads":
        assert c.by_line[scores] == {"reduce-scatter": b * r // 2 * S * F32}
        assert gather not in c.by_line
        moved = line_of(attention.attention_decode, "reshard(probs, 2, 3)")
        # probs (b, 1, r/2, S) -> (b, 1, r, S/2) f32; v (b, S, 1, hd/2)
        # -> (b, S/2, 1, hd) in the cache's dtype
        assert c.by_line[moved] == {"all-to-all": b * r * S // 2 * F32
                                  + b * S // 2 * 16
                                  * cache["v"].element_size()}
    else:
        assert c.by_line[scores] == {"reduce-scatter": b * r * S // 2 * F32}
        assert c.by_line[gather] == {"all-gather": b * r * S * F32}
    assert not any("all-reduce" in by for by in c.by_line.values())


def test_decode_residual_all_reduced_in_the_activation_dtype(mesh):
    """The decode block's attention output (a partial sum over the two
    model ranks' heads) is all-reduced at the residual, once, in the
    activation dtype (2.13 all-reduced the sum later, in the norm's
    f32)."""
    from repro_torch.models import blocks

    cfg = cfgs.get("qwen3_1_7b").reduced()  # 4 heads, 2 kv heads
    params = lm.init_lm(0, cfg, device="meta")
    rules.distribute_params(params, mesh)
    cache, _ = _placed_cache(cfg, mesh)
    x = _placed(torch.empty((B, 1, cfg.d_model),
                            dtype=lm.dtype_of(cfg.dtype), device="meta"),
                ("data", None, None), mesh)
    with activation_mesh(mesh), SiteCensus() as c:
        blocks.apply_block_decode(params["layers"][0][0], x, cfg, "attn",
                                  cache["self"][0][0], 3)
    site = line_of(blocks.apply_block_decode, "a = constrain(a, SP_SPEC)")
    assert c.by_line[site] == {"all-reduce": B // 2 * cfg.d_model
                               * x.element_size()}


def _placed_cache(cfg, mesh):
    """``lm.init_cache`` of ``B`` rows and ``S`` positions, each leaf placed
    by the rules, in place; returns ``(cache, placed leaves)``."""
    cache = lm.init_cache(cfg, B, S, "meta")
    leaves = rules.reference_cache_leaves(cache)
    placed = rules.distribute(leaves, rules.cache_pspecs(leaves, mesh), mesh)
    for i, run in enumerate(cache["self"]):
        for j, layer in enumerate(run):
            for name in layer:
                layer[name] = placed[f"self.{i}.{name}"][j]
    return cache, placed


def test_rglru_gates_reduce_scattered_onto_the_channels(mesh):
    """The RG-LRU gate products, partial sums over the channels' split,
    are reduce-scattered onto the channels (the scan's layout), bf16."""
    from torch.distributed.tensor import Shard

    W = 64
    p = {"w_rg": _placed(torch.empty((W, W), dtype=torch.bfloat16,
                                     device="meta"), ("model", None), mesh),
         "w_ig": _placed(torch.empty((W, W), dtype=torch.bfloat16,
                                     device="meta"), ("model", None), mesh),
         "b_rg": torch.zeros(W, dtype=torch.bfloat16, device="meta"),
         "b_ig": torch.zeros(W, dtype=torch.bfloat16, device="meta")}
    from repro_torch.sharding.activation import replicated_like

    u = _dt((B, S, W), (Shard(0), Shard(2)), mesh, torch.bfloat16)
    p["b_rg"] = replicated_like(p["b_rg"], u)
    p["b_ig"] = replicated_like(p["b_ig"], u)
    with activation_mesh(mesh), SiteCensus() as c:
        r, i = recurrent._rglru_gates(p, u)
    site = line_of(recurrent._rglru_gates, "return torch.sigmoid(")
    assert c.by_line == {site: {"reduce-scatter":
                              2 * B // 2 * S * W // 2 * BF16}}
    assert tuple(r.placements) == tuple(i.placements) == (Shard(0),
                                                          Shard(2))


def test_mlstm_decode_step_keeps_the_memory_on_each_rank(mesh):
    """The mLSTM decode step updates its (batch, heads) state blocks on
    each rank: no collective carries the (B, H, Dh, Dh) memory (2.13's
    propagation all-reduced it every step). One head: like the full
    model's 4 heads over 16 model ranks, the heads do not divide."""
    import dataclasses

    cfg = dataclasses.replace(cfgs.get("xlstm_125m").reduced(), n_heads=1)
    params = lm.init_lm(0, cfg, device="meta")
    rules.distribute_params(params, mesh)
    cache, _ = _placed_cache(cfg, mesh)
    state = cache["self"][0][0]
    x = _placed(torch.empty((B, 1, cfg.d_model),
                            dtype=lm.dtype_of(cfg.dtype), device="meta"),
                ("data", None, None), mesh)
    with activation_mesh(mesh), SiteCensus() as c:
        recurrent.mlstm_block_step(params["layers"][0][0]["block"], x, cfg,
                                   state)
    _, nh, dh = recurrent._mlstm_dims(cfg)
    memory = B // 2 * nh * dh * dh * F32
    src, first = inspect.getsourcelines(recurrent._mlstm_update)
    update = {("recurrent.py", first + i) for i in range(len(src))}
    update.add(line_of(recurrent.mlstm_block_step, 'state["C"].copy_'))
    assert c.by_line and not update & set(c.by_line)
    assert sum(by.get("all-reduce", 0) for by in c.by_line.values()) < memory


def test_lse_all_reduces_and_keeps_the_gradient_vocab_sharded(mesh):
    """The cross entropy's logsumexp over vocab-sharded logits all-reduces
    its max and its sum explicitly, and the logits' gradient comes back
    vocab-sharded: no collective in the backward (2.13 scattered the sum
    over the sequence, and the head's backward then gathered the logits'
    gradient)."""
    from torch.distributed.tensor import Shard

    V = 256
    logits = _dt((B, S, V), (Shard(0), Shard(2)), mesh, grad=True)
    with activation_mesh(mesh), SiteCensus() as c:
        lse = lm._lse(logits)
        fwd = dict(c.collective_bytes)
        lse.sum().backward()
    assert fwd == {"all-reduce": 2 * B // 2 * S * F32}
    assert c.collective_bytes == fwd
    assert tuple(logits.grad.placements) == (Shard(0), Shard(2))


def test_embedding_scale_reduce_scatters_the_lookup(mesh):
    """gemma's scaled embedding: the vocab-sharded lookup (a partial sum)
    is reduce-scattered onto the features before the scale, then gathered
    to the (batch, -, -) layout."""
    cfg = cfgs.get("gemma3_1b").reduced()
    params = lm.init_lm(0, cfg, device="meta")
    rules.distribute_params(params, mesh)
    tokens = _placed(torch.empty((B, S), dtype=torch.int32, device="meta"),
                     ("data", None), mesh)
    with activation_mesh(mesh), SiteCensus() as c:
        lm.embed_tokens(params, cfg, tokens)
    site = line_of(lm.embed_tokens, "x = reduce_partial(x, 2)")
    assert c.by_line[site] == {"reduce-scatter": B // 2 * S * cfg.d_model
                             // 2 * lm.dtype_of(cfg.dtype).itemsize}


def test_grad_like_reduce_scatters_a_partial_cotangent(mesh):
    """A norm's output cotangent that arrives as a partial sum is
    reduce-scattered onto the output's own shards before the norm's
    backward (``grad_like``)."""
    from torch.distributed.tensor import DTensor, Partial, Shard

    D = 64
    x = _dt((B, S, D), (Shard(0), Shard(1)), mesh, grad=True)
    w = torch.ones(D, device="meta")
    from repro_torch.sharding.activation import replicated_like

    with activation_mesh(mesh), SiteCensus() as c:
        y = common.rms_norm(x, replicated_like(w, x))
        g = DTensor.from_local(torch.empty((B // 2, S, D), device="meta"),
                               mesh, (Shard(0), Partial()), run_check=False)
        y.backward(g)
    assert c.collective_bytes == {"reduce-scatter":
                                  B // 2 * S // 2 * D * F32}
    assert tuple(x.grad.placements) == (Shard(0), Shard(1))


def test_reduce_partial_passes_the_gradient_through(mesh):
    """``reduce_partial``'s gradient is the incoming one, in the placement
    it arrives in (no gather), and a spec places only the partial mesh
    dims."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    from repro_torch.sharding.activation import BATCH_AXES

    x = _dt((B, S, 64), (Shard(0), Partial()), mesh, grad=True)
    with activation_mesh(mesh), census_m.Census() as c:
        y = reduce_partial(x, (BATCH_AXES, None, "model"))
        assert tuple(y.placements) == (Shard(0), Shard(2))
        y.sum().backward()
    assert c.collective_bytes == {"reduce-scatter": B // 2 * S * 32 * F32}
    z = _dt((B, S, 64), (Shard(0), Partial()), mesh)
    assert tuple(reduce_partial(z, None).placements) == (Shard(0),
                                                         Replicate())
    local = z.to_local()
    assert reduce_partial(local, 1) is local  # a plain tensor is whole
    assert grad_like(z) is z  # no gradient: nothing to place


# the cheap 16 x 16 cells (decode: a few seconds each) whose fresh census
# must equal the committed record
RECORD_CELLS = ("qwen2_1_5b decode_32k", "qwen3_1_7b decode_32k",
                "gemma3_1b decode_32k", "granite_34b decode_32k",
                "recurrentgemma_9b decode_32k", "xlstm_125m decode_32k",
                "whisper_base decode_32k")


@pytest.mark.parametrize("cell", RECORD_CELLS)
def test_fresh_census_equals_the_record(cell):
    arch, shape = cell.split()
    got = dryrun.run_cell(arch, shape, multi_pod=False, verbose=False)
    import json

    with open(dryrun.RECORD) as f:
        record = json.load(f)
    key = f"{arch} x {shape}"
    one = {**record, "cells": {key: record["cells"][key]}}
    assert dryrun.record_diff([got], one) == []


def test_record_covers_every_ok_cell():
    import json

    with open(dryrun.RECORD) as f:
        record = json.load(f)
    grid = {f"{a} x {s}" for a in cfgs.names()
            for s in cfgs.get(a).shapes}
    assert set(record["cells"]) == grid and len(grid) == 34
    for c in record["cells"].values():
        assert set(c) == set(dryrun.CENSUS_KEYS) | set(
            dryrun.RECORD_MEMORY) | {"decomposed_bytes"}
        assert set(c["decomposed_bytes"]) == set(dryrun.BUILD_DECOMPOSED)
        assert math.isfinite(c["device_hbm_bytes"])
