"""The port's LM conformal-OOD slice against the JAX package.

The reduced configs of qwen2-1.5b, qwen3-1.7b and gemma3-1b (float32) with
the JAX ``init_lm`` weights carried across by ``lm_params_from_numpy``:
module by module (1e-5), logits of the full forward and of teacher-forced
decode steps (1e-4), the token stream (bitwise), sequence embeddings
(1e-5), the conformal heads' p-values (as counts, exactly, outside
flagged near-ties) and the slice as a whole, token stream to request
p-values. Inside the port: decode == forward at 1e-4, and the launcher's
LM mode runs to its end on the CPU.
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
from repro.data.lm_pipeline import TokenStream as JTokenStream  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
import repro_torch.configs as cfgs  # noqa: E402
from repro_torch.core import lm_conformal as lmc  # noqa: E402
from repro_torch.core.measures import knn  # noqa: E402
from repro_torch.data.lm_pipeline import TokenStream  # noqa: E402
from repro_torch.models import attention, common, lm, mlp  # noqa: E402
from repro_torch.models.common import frozen  # noqa: E402
from repro_torch.serving import convert  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["qwen2-1.5b", "qwen3-1.7b", "gemma3-1b"]


def _cfgs(arch):
    return jcfgs.get(arch).reduced(), cfgs.get(arch).reduced()


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _models(arch, seed=0):
    jc, c = _cfgs(arch)
    jp = jlm.init_lm(jax.random.PRNGKey(seed), jc)
    p = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp), c,
                                     device="cpu")
    return jc, jp, c, p


def _tokens(c, B, S, seed):
    return np.random.default_rng(seed).integers(
        0, c.vocab_size, (B, S)).astype(np.int32)


def _attn_params(c, rng):
    """Random attention weights, biases and qk-norm scales (numpy)."""
    d, h, kv, hd = c.d_model, c.n_heads, c.n_kv_heads, c.resolved_head_dim
    shapes = {"wq": (d, h, hd), "wk": (d, kv, hd), "wv": (d, kv, hd),
              "wo": (h, hd, d)}
    if c.qkv_bias:
        shapes.update(bq=(h, hd), bk=(kv, hd), bv=(kv, hd))
    if c.qk_norm:
        shapes.update(q_norm=(hd,), k_norm=(hd,))
    return {k: (0.2 * rng.standard_normal(s)).astype(np.float32)
            for k, s in shapes.items()}


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


def _port_config(jc):
    """The reference's config as the port's dataclasses, field for field
    (``moe`` and ``mla`` included)."""
    kw = {f: getattr(jc, f) for f in cfgs.base.ArchConfig.__dataclass_fields__}
    kw["moe"] = cfgs.MoeConfig(**dataclasses.asdict(jc.moe))
    kw["mla"] = None if jc.mla is None else cfgs.MlaConfig(
        **dataclasses.asdict(jc.mla))
    return cfgs.base.ArchConfig(**kw)


@pytest.mark.parametrize("arch", ARCHS + [
    "granite-34b", "mixtral-8x22b", "deepseek-v2-236b", "recurrentgemma-9b",
    "xlstm-125m", "whisper-base", "internvl2-26b"])
def test_config_matches_the_reference(arch):
    jc, c = jcfgs.get(arch), cfgs.get(arch)
    for name in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
                 "vocab_size", "resolved_head_dim", "padded_vocab_size",
                 "pattern", "qk_norm", "qkv_bias", "window", "rope_theta",
                 "rope_theta_local", "rms_offset", "act", "post_norms",
                 "embed_scale", "tie_embeddings", "norm_eps", "dtype"):
        assert getattr(c, name) == getattr(jc, name), name
    assert dataclasses.asdict(c.moe) == dataclasses.asdict(jc.moe)
    assert (c.mla is None and jc.mla is None) or (
        dataclasses.asdict(c.mla) == dataclasses.asdict(jc.mla))
    assert c.n_params() == jc.n_params()
    assert c == _port_config(jc)
    assert c.reduced() == _port_config(jc.reduced())


def test_unported_archs_raise():
    """Since every architecture is ported, the name is historical: each of
    ``ARCH_NAMES`` (and its dashed alias) resolves to its config, the
    registry lists them all, and an unknown name still raises
    ``KeyError``."""
    for name in cfgs.ARCH_NAMES:
        c = cfgs.get(name)
        assert cfgs.get(name.replace("_", "-")) is c
        assert c.name == jcfgs.get(name).name
    assert cfgs.names() == cfgs.ARCH_NAMES == jcfgs.ARCH_NAMES
    with pytest.raises(KeyError):
        cfgs.get("no-such-arch")


# ---------------------------------------------------------------------------
# modules, 1e-5
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("offset", [0.0, 1.0])
def test_rms_norm(offset):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    _close(common.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6,
                           offset=offset),
           jcommon.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6,
                            offset=offset), 1e-5)


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope_interleaved_pairs(theta):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    pos = np.tile(np.arange(7, dtype=np.int32) * 37, (2, 1))
    _close(common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                             theta),
           jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta), 1e-5)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp(act):
    rng = np.random.default_rng(3)
    p = {k: (0.2 * rng.standard_normal(s)).astype(np.float32) for k, s in
         (("w_gate", (64, 128)), ("w_up", (64, 128)), ("w_down", (128, 64)))}
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    _close(mlp.mlp(frozen({k: torch.from_numpy(v) for k, v in p.items()}),
                   torch.from_numpy(x), act),
           jmlp.mlp({k: jnp.asarray(v) for k, v in p.items()},
                    jnp.asarray(x), act), 1e-5)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("window", [0, 5])
def test_attention_full(arch, window):
    jc, c = _cfgs(arch)
    rng = np.random.default_rng(4)
    p = _attn_params(c, rng)
    x = rng.standard_normal((2, 24, c.d_model)).astype(np.float32)
    pos = np.tile(np.arange(24, dtype=np.int32), (2, 1))
    got = attention.attention_full(
        frozen({k: torch.from_numpy(v) for k, v in p.items()}),
        torch.from_numpy(x), c, positions=torch.from_numpy(pos),
        window=window, theta=c.rope_theta)
    want = jattn.attention_full(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), jc,
        positions=jnp.asarray(pos), window=window, theta=jc.rope_theta)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("window", [0, 4])
def test_attention_decode_with_the_cache(arch, window):
    jc, c = _cfgs(arch)
    rng = np.random.default_rng(5)
    p = _attn_params(c, rng)
    B, S_max, index = 2, 12, 7
    x = rng.standard_normal((B, 1, c.d_model)).astype(np.float32)
    kv = (B, S_max, c.n_kv_heads, c.resolved_head_dim)
    cache = {n: rng.standard_normal(kv).astype(np.float32) for n in "kv"}
    tcache = {n: torch.from_numpy(a.copy()) for n, a in cache.items()}
    got, out_cache = attention.attention_decode(
        frozen({k: torch.from_numpy(v) for k, v in p.items()}),
        torch.from_numpy(x), c, tcache, index, window=window,
        theta=c.rope_theta)
    want, jcache = jattn.attention_decode(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), jc,
        {n: jnp.asarray(a) for n, a in cache.items()}, index,
        window=window, theta=jc.rope_theta)
    _close(got, want, 1e-5)
    for n in "kv":
        assert out_cache[n] is tcache[n]  # written in place
        _close(tcache[n], jcache[n], 1e-5)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
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


@pytest.mark.parametrize("arch", ARCHS)
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


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_equals_forward_inside_the_port(arch):
    c = cfgs.get(arch).reduced()
    p = lm.init_lm(3, c, device="cpu")
    toks = torch.from_numpy(_tokens(c, 2, 24, 7))
    full = lm.forward(p, c, {"tokens": toks})
    cache = lm.init_cache(c, 2, 24, "cpu")
    steps = [lm.decode_step(p, c, toks[:, i:i + 1], cache, i)[0][:, 0]
             for i in range(24)]
    _close(torch.stack(steps, 1), full, 1e-4)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("index", [0, 5])
def test_token_stream_batches_bitwise(arch, index):
    for jc, c in ((jcfgs.get(arch), cfgs.get(arch)), _cfgs(arch)):
        got = TokenStream(c, 4, 33, seed=11).batch_at(index)
        want = JTokenStream(jc, 4, 33, seed=11).batch_at(index)
        assert got.keys() == want.keys()
        for k in got:
            assert got[k].dtype == want[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("arch", ARCHS)
def test_sequence_embedding(arch):
    jc, jp, c, p = _models(arch)
    toks = _tokens(c, 3, 17, 8)
    got = lmc.sequence_embedding(p, c, {"tokens": torch.from_numpy(toks)})
    want = jlmc.sequence_embedding(jp, jc, {"tokens": jnp.asarray(toks)},
                                   jlm)
    assert got.shape == (3, c.d_model)
    _close(got, want, 1e-5)


def test_sequence_embedding_means_in_f32_then_rounds_to_bf16(monkeypatch):
    h = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (2, 300, 8)).astype(np.float32)).to(torch.bfloat16)
    monkeypatch.setattr(lmc, "hidden_states", lambda *args: h)
    got = lmc.sequence_embedding(None, None, None)
    assert got.dtype == torch.bfloat16
    want = jnp.mean(jnp.asarray(h.float().numpy(), jnp.bfloat16), axis=1)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


# ---------------------------------------------------------------------------
# the conformal heads
# ---------------------------------------------------------------------------


def _counts(p, n):
    return np.rint(np.asarray(p, np.float64) * (n + 1)).astype(np.int64)


def _near_ties(alphas, alpha, tol=1e-5):
    """True where some calibration score is within ``tol`` (relative) of
    the candidate's without equalling it: there the two frameworks'
    roundings may order them differently. Exact ties are not flagged: at
    k = 1 the query's nearest calibration point ties with it by
    construction (``kth - kth + d == d``), in both frameworks."""
    alphas, alpha = np.asarray(alphas), np.asarray(alpha)[..., None]
    diff = np.abs(alphas - alpha)
    return ((diff > 0) & (diff <= tol * np.maximum(
        np.abs(alphas), np.abs(alpha)) + 1e-7)).any(-1)


def _assert_ood_pvalues(det, jdet, queries, n):
    got = det.pvalues(queries).numpy()
    want = np.asarray(jdet.pvalues(jnp.asarray(queries)))
    ties = _near_ties(*(t.numpy() for t in det.scores(queries)))
    assert ties.mean() < 0.1, f"{ties.sum()} of {ties.size} flagged"
    np.testing.assert_array_equal(_counts(got, n)[~ties],
                                  _counts(want, n)[~ties])
    return got


@pytest.mark.parametrize("k", [1, 7])
def test_ood_detector_pvalues(k):
    rng = np.random.default_rng(10)
    calib = rng.standard_normal((80, 16)).astype(np.float32)
    queries = np.concatenate([
        rng.standard_normal((30, 16)), 3.0 + rng.standard_normal((10, 16))
    ]).astype(np.float32)
    det = lmc.ConformalOodDetector(k=k, device="cpu").fit(calib)
    jdet = jlmc.ConformalOodDetector(k=k).fit(jnp.asarray(calib))
    _close(det._best, jdet._best, 1e-5)
    p = _assert_ood_pvalues(det, jdet, queries, 80)
    assert p[30:].max() <= 1.0 / 81 + 1e-7  # the shifted queries stand out


def test_lm_classifier_pvalues():
    rng = np.random.default_rng(12)
    emb = rng.standard_normal((70, 12)).astype(np.float32)
    y = rng.integers(0, 3, 70).astype(np.int32)
    emb += y[:, None].astype(np.float32)
    queries = rng.standard_normal((9, 12)).astype(np.float32)
    clf = lmc.ConformalLmClassifier(n_labels=3, k=5, device="cpu").fit(
        emb, y)
    jclf = jlmc.ConformalLmClassifier(n_labels=3, k=5).fit(
        jnp.asarray(emb), jnp.asarray(y))
    got = clf.pvalues(queries).numpy()
    want = np.asarray(jclf.pvalues(jnp.asarray(queries)))
    ties = np.array([[_near_ties(*(t.numpy() for t in knn.scores_optimized(
        clf._state, torch.from_numpy(q), lbl, k=5, simplified=False)))
        for lbl in range(3)] for q in queries])
    assert ties.mean() < 0.1
    np.testing.assert_array_equal(_counts(got, 70)[~ties],
                                  _counts(want, 70)[~ties])
    assert torch.equal(clf.prediction_sets(queries, 0.2),
                       torch.from_numpy(got > 0.2))
    # a mesh of one device takes the plain path (the reference's rule);
    # sharded meshes: tests/test_torch_distributed.py
    from repro_torch.core import distributed as dist
    one = lmc.ConformalLmClassifier(n_labels=3, k=5).fit(
        emb, y, mesh=dist.make_mesh((1, 1), ("data", "model"), ["cpu"]))
    assert one._sharded_fn is None
    assert torch.equal(one.pvalues(queries), clf.pvalues(queries))


@pytest.mark.parametrize("arch", ARCHS)
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


def test_launcher_lm_mode_runs_on_the_cpu():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen2-1.5b", "--reduced", "--device", "cpu"], capture_output=True,
        text=True, cwd=ROOT, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "conformal OOD head fit on 256 sequences" in out.stdout
    assert "mean p in-dist=" in out.stdout
    assert "req  7" in out.stdout
