"""The port's MoE and MLA families against the JAX package.

The reduced configs of granite-34b (dense, MQA), mixtral-8x22b (token-
choice MoE, sliding window) and deepseek-v2-236b (MLA, MoE with a shared
expert, a dense first layer), float32, with the JAX ``init_lm`` weights
carried across by ``lm_params_from_numpy``: the MoE's dispatch and dense
mixture (out 1e-5, aux 1e-6, the routed experts and the dropped ``(token,
k)`` pairs exactly outside flagged router near-ties, at ``reduced()``'s
lossless capacity and at 1.25, which drops pairs), JAX's top-k tie rule,
MLA full and decode (1e-5), the blocks, the parameters both ways (an MoE
router stays f32 in a bf16 model), logits of the forward and of
teacher-forced decode steps (1e-4), sequence embeddings (1e-5), the OOD
p-values (as counts, exactly, outside flagged near-ties) and the slice
end to end. Inside the port: decode == forward, the combine's fixed
order bitwise, one expert's f32 draw at a time in ``init_lm``, the
launcher's LM mode and its refusal of weights the card cannot hold.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jcfgs  # noqa: E402
from repro.core import lm_conformal as jlmc  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import blocks as jblk  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
import repro_torch.configs as cfgs  # noqa: E402
from repro_torch.core import lm_conformal as lmc  # noqa: E402
from repro_torch.data.lm_pipeline import TokenStream  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention, blocks, common, lm, mlp  # noqa: E402
from repro_torch.models.common import frozen  # noqa: E402
from repro_torch.serving import convert  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FAMILIES = ["granite-34b", "mixtral-8x22b", "deepseek-v2-236b"]
MOE_ARCHS = ["mixtral-8x22b", "deepseek-v2-236b"]
TIE = 1e-5  # router probabilities this close may order apart
CUT = {"deepseek-v2-236b": 4}  # dense_ffn_attn + 3 attn, the smoke's cut


def _reduced(get, arch):
    """``reduced()``, cut to ``CUT`` layers where that keeps 60: the
    reference reduces a pattern without a period (deepseek-v2's dense
    first layer) to all its layers."""
    c = get(arch).reduced()
    n = CUT.get(arch)
    return c.replace(n_layers=n, layer_pattern=c.pattern[:n]) if n else c


def _cfgs(arch, capacity=None):
    jc, c = _reduced(jcfgs.get, arch), _reduced(cfgs.get, arch)
    if capacity is not None:
        jc = jc.replace(moe=dataclasses.replace(jc.moe,
                                                capacity_factor=capacity))
        c = c.replace(moe=dataclasses.replace(c.moe,
                                              capacity_factor=capacity))
    return jc, c


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _to_torch(tree):
    return {k: _to_torch(v) if isinstance(v, dict) else
            torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _to_jax(tree):
    return {k: _to_jax(v) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in tree.items()}


def _moe_params(jc, seed=0):
    """The JAX ``init_moe`` weights (numpy) and the same as the port's."""
    tree = jax.tree.map(np.asarray, jmlp.init_moe(jax.random.PRNGKey(seed),
                                                  jc, jnp.float32))
    return tree, frozen(_to_torch(tree))


def _skewed(c, B, S, seed):
    """Activations sharing one offset, so the router favours a few experts
    and a capacity of 1.25 drops pairs."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, c.d_model))
            + 1.5 * rng.standard_normal(c.d_model)).astype(np.float32)


def _models(arch, seed=0):
    jc, c = _cfgs(arch)
    jp = jlm.init_lm(jax.random.PRNGKey(seed), jc)
    p = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp), c,
                                     device="cpu")
    return jc, jp, c, p


def _tokens(c, B, S, seed):
    return np.random.default_rng(seed).integers(
        0, c.vocab_size, (B, S)).astype(np.int32)


# ---------------------------------------------------------------------------
# the MoE
# ---------------------------------------------------------------------------


def _near_tie_tokens(probs, K):
    """Tokens with two of their K + 1 largest router probabilities within
    ``TIE``: the top-K set or its order may differ between frameworks."""
    top = np.sort(np.asarray(probs), -1)[:, ::-1][:, :K + 1]
    return (np.diff(top, axis=1) >= -TIE).any(1)


def _kept_pairs(slot_tok, cap, T):
    """``{(token, expert)}`` of the pairs that got one of the ``E * cap``
    slots."""
    return {(int(t), s // cap) for s, t in enumerate(np.asarray(slot_tok))
            if t < T}


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("capacity", [None, 1.25])
def test_moe_dispatch_matches_the_reference(arch, capacity):
    jc, c = _cfgs(arch, capacity)
    tree, p = _moe_params(jc)
    x = _skewed(c, 3, 40, 1)
    got, aux = mlp.moe(p, torch.from_numpy(x), c)
    want, jaux = jmlp.moe(_to_jax(tree), jnp.asarray(x), jc)
    _close(got, want, 1e-5)
    _close(aux, jaux, 1e-6)

    mo = c.moe
    E, K, T = mo.n_experts, mo.n_experts_per_token, x.shape[0] * x.shape[1]
    cap = max(1, int(T * K * mo.capacity_factor / E))
    xt = x.reshape(T, -1)
    probs, top_p, top_e = mlp.route(p, torch.from_numpy(xt), K)
    jprobs = jax.nn.softmax(jnp.asarray(xt) @ jnp.asarray(tree["router"]),
                            axis=-1)
    jtop_p, jtop_e = jax.lax.top_k(jprobs, K)
    jtop_p = jtop_p / jnp.maximum(jnp.sum(jtop_p, -1, keepdims=True), 1e-9)
    ties = _near_tie_tokens(probs.numpy(), K)
    assert ties.mean() < 0.05, f"{ties.sum()} of {T} flagged"
    np.testing.assert_array_equal(top_e.numpy()[~ties],
                                  np.asarray(jtop_e)[~ties])
    _close(top_p, jtop_p, 1e-6)

    slot_tok, slot_w, pair_slot = mlp._dispatch_one(
        top_p, top_e, cap, torch.float32, mlp._buckets(top_e, E))
    jslot_tok, jslot_w = jmlp._dispatch_one(
        jnp.asarray(xt), jtop_p, jtop_e, E, K, cap, jnp.float32)
    # a pair's slot depends on the pairs before it in (token, k) order:
    # compare up to the first flagged token
    first = int(np.argmax(ties)) if ties.any() else T
    kept = {pt for pt in _kept_pairs(slot_tok.numpy(), cap, T)
            if pt[0] < first}
    jkept = {pt for pt in _kept_pairs(np.asarray(jslot_tok)[:-1], cap, T)
             if pt[0] < first}
    assert kept == jkept
    routed = {(t, int(e)) for t in range(first) for e in top_e[t]}
    dropped = routed - kept
    dropped_at = {(t, e) for (t, k), s in np.ndenumerate(pair_slot.numpy())
                  if s == E * cap and t < first
                  for e in [int(top_e[t, k])]}
    assert dropped == dropped_at
    if capacity is None:  # reduced(): capacity E / K, lossless
        assert cap == T and not dropped
    else:
        assert dropped, "capacity 1.25 should drop pairs here"
    if not ties.any():
        np.testing.assert_array_equal(slot_tok.numpy(),
                                      np.asarray(jslot_tok)[:-1])
        _close(slot_w, np.asarray(jslot_w)[:-1], 1e-6)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_dense_mixture_matches_the_reference(arch):
    jc, c = _cfgs(arch)
    tree, p = _moe_params(jc, seed=2)
    x = _skewed(c, 2, 24, 3)
    got, aux = mlp.moe_dense_mixture(p, torch.from_numpy(x), c)
    want, jaux = jmlp.moe_dense_mixture(_to_jax(tree), jnp.asarray(x), jc)
    _close(got, want, 1e-5)
    _close(aux, jaux, 1e-6)
    # the "dense" partition routes there, for decode steps too
    cd = c.replace(moe=dataclasses.replace(c.moe, partition="ep",
                                           partition_decode="dense"))
    assert torch.equal(mlp.moe(p, torch.from_numpy(x), cd, decode=True)[0],
                       got)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_router_ties_pick_the_lower_expert_ids(arch):
    """A zero router gives every expert the same probability: both
    packages route every token to experts 0..K-1 (``jax.lax.top_k``'s
    rule; the port's stable descending sort)."""
    jc, c = _cfgs(arch, 1.25)
    tree, _ = _moe_params(jc)
    tree["router"] = np.zeros_like(tree["router"])
    p = frozen(_to_torch(tree))
    K, E = c.moe.n_experts_per_token, c.moe.n_experts
    x = _skewed(c, 2, 8, 4)
    _, _, top_e = mlp.route(p, torch.from_numpy(x.reshape(16, -1)), K)
    jtop_e = jax.lax.top_k(jnp.full((16, E), 1.0 / E), K)[1]
    want = np.tile(np.arange(K), (16, 1))
    np.testing.assert_array_equal(top_e.numpy(), want)
    np.testing.assert_array_equal(np.asarray(jtop_e), want)
    got, _ = mlp.moe(p, torch.from_numpy(x), c)
    jgot, _ = jmlp.moe(_to_jax(tree), jnp.asarray(x), jc)
    _close(got, jgot, 1e-5)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_combine_adds_in_expert_order(arch):
    """Each token's output is its kept contributions ``y[s] * w[s]`` added
    to zero in ascending expert id, bitwise, and two calls agree
    bitwise."""
    _, c = _cfgs(arch, 1.25)
    p = mlp.init_moe(torch.Generator().manual_seed(5), c, torch.float32)
    x = torch.from_numpy(_skewed(c, 2, 30, 6))
    mo = c.moe
    E, K, T = mo.n_experts, mo.n_experts_per_token, 60
    cap = max(1, int(T * K * mo.capacity_factor / E))
    xt = x.reshape(T, -1)
    _, top_p, top_e = mlp.route(p, xt, K)
    slot_tok, slot_w, pair_slot = mlp._dispatch_one(
        top_p, top_e, cap, x.dtype, mlp._buckets(top_e, E))
    y = mlp._experts(p, mlp._gather(xt, slot_tok, E, cap), c.act)
    want = torch.zeros_like(xt)
    for t in range(T):
        for s in sorted(int(s) for s in pair_slot[t] if s < E * cap):
            want[t] = want[t] + y[s] * slot_w[s]
    out, _ = mlp.moe(p, x, c)
    shared = mlp.mlp(p["shared"], x, c.act) if mo.n_shared_experts else 0
    assert torch.equal(out, want.reshape(x.shape) + shared)
    assert torch.equal(out, mlp.moe(p, x, c)[0])


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------


def _mla_params(jc, seed=7):
    tree = jax.tree.map(np.asarray, jattn.init_mla(jax.random.PRNGKey(seed),
                                                   jc, jnp.float32))
    rng = np.random.default_rng(seed)
    for k in ("q_norm", "kv_norm"):  # off the unit init
        tree[k] = (1 + 0.2 * rng.standard_normal(tree[k].shape)).astype(
            np.float32)
    return tree


def test_mla_full():
    jc, c = _cfgs("deepseek-v2-236b")
    tree = _mla_params(jc)
    x = np.random.default_rng(8).standard_normal((2, 24, c.d_model)).astype(
        np.float32)
    pos = np.tile(np.arange(24, dtype=np.int32), (2, 1))
    got = attention.mla_full(frozen(_to_torch(tree)), torch.from_numpy(x), c,
                             positions=torch.from_numpy(pos),
                             theta=c.rope_theta)
    want = jattn.mla_full(_to_jax(tree), jnp.asarray(x), jc,
                          positions=jnp.asarray(pos), theta=jc.rope_theta)
    _close(got, want, 1e-5)


def test_mla_decode_with_the_latent_cache():
    jc, c = _cfgs("deepseek-v2-236b")
    tree = _mla_params(jc, seed=9)
    rng = np.random.default_rng(10)
    B, S_max, index = 2, 12, 7
    m = c.mla
    x = rng.standard_normal((B, 1, c.d_model)).astype(np.float32)
    cache = {"c_kv": rng.standard_normal((B, S_max, m.kv_lora_rank)),
             "k_rope": rng.standard_normal((B, S_max, m.qk_rope_head_dim))}
    cache = {k: v.astype(np.float32) for k, v in cache.items()}
    tcache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    got, out_cache = attention.mla_decode(frozen(_to_torch(tree)),
                                          torch.from_numpy(x), c, tcache,
                                          index, theta=c.rope_theta)
    want, jcache = jattn.mla_decode(_to_jax(tree), jnp.asarray(x), jc,
                                    _to_jax(cache), index,
                                    theta=jc.rope_theta)
    _close(got, want, 1e-5)
    for k in cache:
        assert out_cache[k] is tcache[k]  # written in place
        _close(tcache[k], jcache[k], 1e-5)
    c0 = lm.init_cache(c, B, S_max, "cpu")["self"][0][0]
    assert set(c0) == {"c_kv", "k_rope"}
    assert c0["c_kv"].shape == (B, S_max, m.kv_lora_rank)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

BLOCKS = [("deepseek-v2-236b", "dense_ffn_attn"), ("deepseek-v2-236b", "attn"),
          ("mixtral-8x22b", "attn_local"), ("granite-34b", "attn")]


def _shapes(tree):
    return {k: _shapes(v) if isinstance(v, dict) else tuple(v.shape)
            for k, v in tree.items()}


@pytest.mark.parametrize("arch,kind", BLOCKS)
def test_blocks(arch, kind):
    """``init_block``'s tree has the reference's keys and shapes (MLA or
    GQA, MoE or the dense MLP); ``apply_block_full`` and
    ``apply_block_decode`` on the reference's weights agree (1e-5)."""
    jc, c = _cfgs(arch)
    jp = jblk.init_block(jax.random.PRNGKey(11), jc, kind, jnp.float32)
    tree = jax.tree.map(np.asarray, jp)
    mine = blocks.init_block(torch.Generator().manual_seed(0), c, kind,
                             torch.float32)
    assert _shapes(convert._module_tree(mine)) == _shapes(tree)
    assert ("moe" in mine) == (kind != "dense_ffn_attn" and
                               c.moe.n_experts > 0)
    p = frozen(_to_torch(tree))
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 16, c.d_model)).astype(np.float32)
    pos = np.tile(np.arange(16, dtype=np.int32), (2, 1))
    got, aux = blocks.apply_block_full(p, torch.from_numpy(x), c, kind,
                                       torch.from_numpy(pos))
    want, jaux, _ = jblk.apply_block_full(jp, jnp.asarray(x), jc, kind,
                                          jnp.asarray(pos))
    _close(got, want, 1e-5)
    _close(aux, jaux, 1e-6)
    cache = blocks.init_block_cache(c, kind, 2, 16, torch.float32, "cpu")
    jcache = jblk.init_block_cache(jc, kind, 2, 16, jnp.float32)
    for i in range(16):
        got, cache = blocks.apply_block_decode(
            p, torch.from_numpy(x[:, i:i + 1]), c, kind, cache, i)
        want, jcache = jblk.apply_block_decode(
            jp, jnp.asarray(x[:, i:i + 1]), jc, kind, jcache, i)
        _close(got, want, 1e-5)


def test_recurrent_kinds_still_raise():
    """Since the recurrent kinds are ported, the name is historical: each
    initialises with the reference's layout (``rglru``: ``ln1, rec, ln2,
    mlp``; ``mlstm`` and ``slstm``: ``ln1, block``) and its cache, and an
    unknown kind raises ``ValueError``."""
    for arch, kinds in (("recurrentgemma-9b", ("rglru",)),
                        ("xlstm-125m", ("mlstm", "slstm"))):
        c = cfgs.get(arch).reduced()
        for kind in kinds:
            p = blocks.init_block(torch.Generator(), c, kind, torch.float32)
            assert list(p.keys()) == (["ln1", "rec", "ln2", "mlp"]
                                      if kind == "rglru" else
                                      ["ln1", "block"])
            assert blocks.init_block_cache(c, kind, 2, 8, torch.float32,
                                           "cpu")
    c = cfgs.get("granite-34b").reduced()
    for fn in (lambda: blocks.init_block(torch.Generator(), c, "conv",
                                         torch.float32),
               lambda: blocks.init_block_cache(c, "conv", 2, 8,
                                               torch.float32, "cpu")):
        with pytest.raises(ValueError):
            fn()


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", FAMILIES)
def test_params_carry_across_both_ways(arch):
    jc, jp, c, p = _models(arch)
    tree = jax.tree.map(np.asarray, jp)
    back = convert.lm_params_to_numpy(p)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)
    assert sum(t.numel() for t in p.parameters()) == sum(
        a.size for a in jax.tree.leaves(tree))
    assert not any(t.requires_grad for t in p.parameters())


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_bf16_model_keeps_the_router_f32(arch):
    """``lm_params_from_numpy`` on a bf16 config gives every leaf the
    reference's dtype: the router f32, the rest bf16; ``init_lm`` in the
    port does the same."""
    jc, c = (cf.replace(dtype="bfloat16", param_dtype="bfloat16")
             for cf in _cfgs(arch))
    jp = jlm.init_lm(jax.random.PRNGKey(0), jc)
    want = {jax.tree_util.keystr(k).split("'")[-2]: a.dtype.name for k, a in
            jax.tree_util.tree_leaves_with_path(jp)}
    assert want["router"] == "float32"
    for params in (convert.lm_params_from_numpy(
            jax.tree.map(np.asarray, jp), c, device="cpu"),
            lm.init_lm(0, c, device="cpu")):
        dtypes = {n.split(".")[-1]: t.dtype for n, t in
                  params.named_parameters()}
        assert dtypes["router"] == torch.float32
        assert all(dt == torch.bfloat16 for n, dt in dtypes.items()
                   if n != "router")


def test_init_lm_draws_one_expert_at_a_time(monkeypatch):
    """No f32 draw in ``init_lm`` has an expert tensor's ``(E, d, f)``
    shape; each expert is drawn alone, at the reference's fan-in (``E *
    d``, ``E * f``)."""
    _, c = _cfgs("deepseek-v2-236b")
    drawn = []
    kept = common.dense_init

    def recording(shape, dtype, generator, scale=None):
        drawn.append((tuple(shape), scale))
        return kept(shape, dtype, generator, scale)

    for mod in (common, mlp, attention, lm):
        monkeypatch.setattr(mod, "dense_init", recording)
    p = lm.init_lm(0, c, device="cpu")
    mo, d = c.moe, c.d_model
    E, f = mo.n_experts, mo.d_ff
    assert not {(E, d, f), (E, f, d)} & {s for s, _ in drawn}
    n_moe = sum(kind != "dense_ffn_attn" for kind in c.pattern)
    per_expert = [(s, sc) for s, sc in drawn if sc is not None]
    assert len(per_expert) == 3 * E * n_moe
    assert {s for s, _ in per_expert} == {(d, f), (f, d)}
    assert {sc for _, sc in per_expert} == {(E * d) ** -0.5, (E * f) ** -0.5}
    moe = p["layers"][1][0]["moe"]  # run 1 (attn), its first layer
    assert moe["w_gate"].shape == (E, d, f)
    assert float(moe["w_gate"].abs().max()) <= 2 * (E * d) ** -0.5


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_and_decode_logits(arch):
    jc, jp, c, p = _models(arch)
    toks = _tokens(c, 2, 20, 6)
    want, _, _ = jlm.forward(jp, jc, {"tokens": jnp.asarray(toks)})
    _close(lm.forward(p, c, {"tokens": torch.from_numpy(toks)}), want, 1e-4)
    jcache = jlm.init_cache(jc, 2, 20)
    cache = lm.init_cache(c, 2, 20, "cpu")
    for i in range(20):
        jl, jcache = jlm.decode_step(jp, jc, jnp.asarray(toks[:, i:i + 1]),
                                     jcache, i)
        tl, cache = lm.decode_step(p, c, torch.from_numpy(toks[:, i:i + 1]),
                                   cache, i)
        _close(tl, jl, 1e-4)


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_equals_forward_inside_the_port(arch):
    c = _reduced(cfgs.get, arch)
    p = lm.init_lm(3, c, device="cpu")
    toks = torch.from_numpy(_tokens(c, 2, 24, 7))
    full = lm.forward(p, c, {"tokens": toks})
    cache = lm.init_cache(c, 2, 24, "cpu")
    steps = [lm.decode_step(p, c, toks[:, i:i + 1], cache, i)[0][:, 0]
             for i in range(24)]
    _close(torch.stack(steps, 1), full, 1e-4)


@pytest.mark.parametrize("arch", FAMILIES)
def test_sequence_embedding(arch):
    jc, jp, c, p = _models(arch)
    toks = _tokens(c, 3, 17, 8)
    got = lmc.sequence_embedding(p, c, {"tokens": torch.from_numpy(toks)})
    want = jlmc.sequence_embedding(jp, jc, {"tokens": jnp.asarray(toks)},
                                   jlm)
    assert got.shape == (3, c.d_model)
    _close(got, want, 1e-5)


# ---------------------------------------------------------------------------
# the slice end to end
# ---------------------------------------------------------------------------


def _counts(p, n):
    return np.rint(np.asarray(p, np.float64) * (n + 1)).astype(np.int64)


def _near_ties(alphas, alpha, tol=1e-5):
    """Queries with a calibration score within ``tol`` (relative) of their
    own without equalling it (as ``tests/test_torch_lm.py`` flags them)."""
    alphas, alpha = np.asarray(alphas), np.asarray(alpha)[..., None]
    diff = np.abs(alphas - alpha)
    return ((diff > 0) & (diff <= tol * np.maximum(
        np.abs(alphas), np.abs(alpha)) + 1e-7)).any(-1)


@pytest.mark.parametrize("arch", FAMILIES)
def test_slice_token_stream_to_request_pvalues(arch):
    """Calibration sequences from the token stream, embedded by both
    models on the same weights, fit both OOD heads; requests (half from
    another seed's stream, half uniform tokens) get the same p-values."""
    jc, jp, c, p = _models(arch, seed=1)
    n, S, B = 48, 16, 8
    calib = TokenStream(c, n, S, seed=0).batch_at(0)["tokens"]
    req = TokenStream(c, B, S, seed=1).batch_at(0)["tokens"]
    req[B // 2:] = np.random.default_rng(2).integers(0, c.vocab_size,
                                                     (B - B // 2, S))
    emb = lmc.sequence_embedding(p, c, {"tokens": torch.from_numpy(calib)})
    jemb = jlmc.sequence_embedding(jp, jc, {"tokens": jnp.asarray(calib)},
                                   jlm)
    _close(emb, jemb, 1e-5)
    det = lmc.ConformalOodDetector(k=7, device="cpu").fit(emb)
    jdet = jlmc.ConformalOodDetector(k=7).fit(jemb)
    q = lmc.sequence_embedding(p, c, {"tokens": torch.from_numpy(req)})
    jq = jlmc.sequence_embedding(jp, jc, {"tokens": jnp.asarray(req)}, jlm)
    _close(q, jq, 1e-5)
    got = det.pvalues(q).numpy()
    want = np.asarray(jdet.pvalues(jq))
    ties = _near_ties(*(t.numpy() for t in det.scores(q)))
    assert ties.mean() < 0.2, f"{ties.sum()} of {ties.size} flagged"
    np.testing.assert_array_equal(_counts(got, n)[~ties],
                                  _counts(want, n)[~ties])
    assert ((got > 0) & (got <= 1)).all()


def test_launcher_lm_mode_serves_deepseek_on_the_cpu():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "deepseek-v2-236b", "--reduced", "--device", "cpu", "--calib", "64",
         "--requests", "4", "--gen-tokens", "4"],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "deepseek-v2-236b (60 layers, d 64, float32)" in out.stdout
    assert "conformal OOD head fit on 64 sequences" in out.stdout
    assert "mean p in-dist=" in out.stdout
    assert "req  3" in out.stdout


def test_launcher_refuses_weights_the_card_cannot_hold(monkeypatch):
    """At full width the weights of deepseek-v2-236b (471 GB in bf16) do
    not fit an 80 GB card: ``lm_model`` raises before any allocation,
    naming ``--reduced``; a depth cut that fits goes on to ``init_lm``."""
    free = 79 * 2**30
    monkeypatch.setattr(serve, "resolve", lambda d: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda d: (free, free))
    calls = []
    monkeypatch.setattr(lm, "init_lm", lambda *a, **k: calls.append(a))
    with pytest.raises(ValueError, match="--reduced"):
        serve.lm_model("deepseek-v2-236b", False, 0, "cuda")
    assert not calls
    pat = cfgs.get("deepseek-v2-236b").pattern
    serve.lm_model("deepseek-v2-236b", False, 0, "cuda", n_layers=4,
                   layer_pattern=pat[:4])
    assert len(calls) == 1
