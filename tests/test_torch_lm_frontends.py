"""The port's front-end families against the JAX package.

The reduced configs of whisper-base (encoder-decoder; LayerNorm, attention
biases, the audio front end a stub of precomputed frames) and
internvl2-26b (the vision stub: precomputed patch embeddings prepended),
float32, with the JAX ``init_lm`` weights carried across by
``lm_params_from_numpy``: the sinusoidal positions, the token stream's
stub inputs (bitwise), ``encode``, ``forward_encdec``,
``prefill_cross_cache`` and the encoder-decoder's decode steps,
``hidden_forward`` with patches, the parameters both ways, logits of the
forward and of teacher-forced decode steps (1e-4), sequence embeddings
(1e-5: they read the tokens only, as the reference's do), the OOD
p-values (as counts, exactly, outside flagged near-ties), the slice end to
end and the launcher's LM mode. Inside the port: decode with the cross
cache == ``forward_encdec``.

Tolerances are 1e-5 except where a test says why.
"""
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
from repro.models import common as jcommon  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
import repro_torch.configs as cfgs  # noqa: E402
from repro_torch.core import lm_conformal as lmc  # noqa: E402
from repro_torch.data.lm_pipeline import TokenStream  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import common, lm  # noqa: E402
from repro_torch.serving import convert  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["whisper-base", "internvl2-26b"]
WHISPER, VLM = ARCHS


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _cfgs(arch):
    return jcfgs.get(arch).reduced(), cfgs.get(arch).reduced()


def _tokens(c, B, S, seed):
    return np.random.default_rng(seed).integers(
        0, c.vocab_size, (B, S)).astype(np.int32)


def _stub(c, B, n, seed):
    """Front-end embeddings ``(B, n, d)`` at the stream's 0.02 scale."""
    return (np.random.default_rng(seed).standard_normal((B, n, c.d_model))
            * 0.02).astype(np.float32)


@pytest.fixture(scope="module")
def models():
    """``{arch: (jc, jp, c, p)}``: the JAX model and the port's on its
    weights."""
    out = {}
    for arch in ARCHS:
        jc, c = _cfgs(arch)
        jp = jlm.init_lm(jax.random.PRNGKey(0), jc)
        out[arch] = (jc, jp, c, convert.lm_params_from_numpy(
            jax.tree.map(np.asarray, jp), c, device="cpu"))
    return out


# ---------------------------------------------------------------------------
# configs and the token stream
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("index", [0, 3])
@pytest.mark.parametrize("arch", ARCHS)
def test_token_stream_stub_inputs_bitwise(arch, index):
    """``batch_at`` draws the stub inputs from the same generator in the
    same order as the reference: internvl's ``patch_embeds`` and the text
    cut by them, whisper's ``frames``; every array equal bit for bit."""
    jc, c = _cfgs(arch)
    got = TokenStream(c, 3, 24, seed=5).batch_at(index)
    want = JTokenStream(jc, 3, 24, seed=5).batch_at(index)
    assert set(got) == set(want)
    extra = "frames" if arch == WHISPER else "patch_embeds"
    assert extra in got
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k])
    text = 24 - (c.n_frontend_tokens if arch == VLM else 0)
    assert got["tokens"].shape == (3, text)
    assert got[extra].shape == (3, c.n_frontend_tokens, c.d_model)


def test_sinusoidal_positions():
    """The f32 table (whisper's encoder positions) at 1e-6: sin and cos of
    the same f32 angles, one rounding apart between the two libraries."""
    for n, d in ((8, 64), (1500, 512)):
        _close(common.sinusoidal_positions(n, d),
               jcommon.sinusoidal_positions(n, d), 1e-6)


# ---------------------------------------------------------------------------
# the encoder-decoder
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def encdec(models):
    """The JAX encoder-decoder's outputs on one batch, jitted and shared:
    ``(tokens (2, 20), frames (2, T, d), encode, forward_encdec logits,
    prefill_cross_cache, decode-step logits (2, 20, V))``."""
    jc, jp, c, _ = models[WHISPER]
    toks = _tokens(c, 2, 20, 3)
    frames = _stub(c, 2, c.n_frontend_tokens, 4)
    jt, jf = jnp.asarray(toks), jnp.asarray(frames)
    enc = jlm.encode(jp, jc, jf)
    logits, _ = jax.jit(lambda p, b: jlm.forward_encdec(p, jc, b))(
        jp, {"tokens": jt, "frames": jf})
    cross = jlm.prefill_cross_cache(jp, jc, jf)
    step = jax.jit(lambda p, t, cache, i: jlm.decode_step(p, jc, t, cache, i))
    cache = jlm.init_cache(jc, 2, 20)
    cache["cross"] = cross
    dec = []
    for i in range(20):
        lg, cache = step(jp, jt[:, i:i + 1], cache, i)
        dec.append(np.asarray(lg)[:, 0])
    return (toks, frames, np.asarray(enc), np.asarray(logits),
            jax.tree.map(np.asarray, cross), np.stack(dec, 1))


def test_encode(models, encdec):
    """Frames plus sinusoidal positions through the non-causal encoder."""
    _, _, c, p = models[WHISPER]
    _, frames, want, _, _, _ = encdec
    got = lm.encode(p, c, torch.from_numpy(frames))
    assert got.shape == frames.shape
    _close(got, want)


def test_forward_encdec(models, encdec):
    """The teacher-forced encoder-decoder pass: logits at 1e-4 (sums over
    the model width of outputs that agree at 1e-5)."""
    _, _, c, p = models[WHISPER]
    toks, frames, _, want, _, _ = encdec
    got = lm.forward_encdec(p, c, {"tokens": torch.from_numpy(toks),
                                   "frames": torch.from_numpy(frames)})
    _close(got, want, 1e-4)


def test_prefill_cross_cache(models, encdec):
    """Every decoder layer's cross keys and values, stacked ``(L, B, T,
    Kv, hd)``; ``init_cache`` holds zeros of that shape until then."""
    _, _, c, p = models[WHISPER]
    _, frames, _, _, want, _ = encdec
    got = lm.prefill_cross_cache(p, c, torch.from_numpy(frames))
    shape = (c.n_layers, 2, c.n_frontend_tokens, c.n_kv_heads,
             c.resolved_head_dim)
    for k in ("k", "v"):
        assert got[k].shape == shape
        _close(got[k], want[k])
    zero = lm.init_cache(c, 2, 20, "cpu")["cross"]
    assert all(zero[k].shape == shape and not zero[k].any()
               for k in ("k", "v"))


def test_encdec_decode_steps(models, encdec):
    """20 teacher-forced decode steps against the filled cross cache equal
    JAX's (logits 1e-4) and, inside the port, ``forward_encdec``'s."""
    _, _, c, p = models[WHISPER]
    toks, frames, _, fwd, _, want = encdec
    cache = lm.init_cache(c, 2, 20, "cpu")
    cache["cross"] = lm.prefill_cross_cache(p, c, torch.from_numpy(frames))
    got = torch.stack([lm.decode_step(
        p, c, torch.from_numpy(toks[:, i:i + 1]), cache, i)[0][:, 0]
        for i in range(20)], 1)
    _close(got, want, 1e-4)
    _close(got, lm.forward_encdec(p, c, {
        "tokens": torch.from_numpy(toks),
        "frames": torch.from_numpy(frames)}), 1e-4)
    _close(got, fwd, 1e-4)


def test_decode_equals_forward_encdec_inside_the_port():
    """On the port's own weights, decode with the cross cache ==
    ``forward_encdec`` at 1e-4, and a zero cross cache gives another
    answer (the steps do read it)."""
    c = _cfgs(WHISPER)[1]
    p = lm.init_lm(3, c, device="cpu")
    toks = torch.from_numpy(_tokens(c, 2, 24, 7))
    frames = torch.from_numpy(_stub(c, 2, c.n_frontend_tokens, 8))
    full = lm.forward_encdec(p, c, {"tokens": toks, "frames": frames})
    for fill in (True, False):
        cache = lm.init_cache(c, 2, 24, "cpu")
        if fill:
            cache["cross"] = lm.prefill_cross_cache(p, c, frames)
        dec = torch.stack([lm.decode_step(p, c, toks[:, i:i + 1], cache,
                                          i)[0][:, 0] for i in range(24)], 1)
        if fill:
            _close(dec, full, 1e-4)
        else:
            assert float((dec - full).abs().max()) > 1e-3


def test_decoder_must_be_one_run(models):
    _, _, c, p = models[WHISPER]
    two = c.replace(layer_pattern=("attn", "attn_local"))
    with pytest.raises(ValueError, match="one run"):
        lm.forward_encdec(lm.init_lm(0, two, device="cpu"), two, {
            "tokens": torch.zeros((1, 4), dtype=torch.int32),
            "frames": torch.zeros((1, c.n_frontend_tokens, c.d_model))})


# ---------------------------------------------------------------------------
# the vision stub
# ---------------------------------------------------------------------------


def test_hidden_forward_with_patches(models):
    """``hidden_forward`` prepends a batch's ``patch_embeds`` (cast to the
    activation dtype) to the text's embeddings, as the reference does:
    ``(B, Np + S_txt, D)`` at 1e-5; without them it runs the text alone."""
    jc, jp, c, p = models[VLM]
    batch = TokenStream(c, 3, 24, seed=2).batch_at(0)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    got, _ = lm.hidden_forward(p, c, tb)
    want, _, _ = jlm.hidden_forward(
        jp, jc, {k: jnp.asarray(v) for k, v in batch.items()})
    assert got.shape == (3, 24, c.d_model)
    _close(got, want)
    text, _ = lm.hidden_forward(p, c, {"tokens": tb["tokens"]})
    assert text.shape == (3, 24 - c.n_frontend_tokens, c.d_model)


@pytest.mark.parametrize("arch", ARCHS)
def test_hidden_states_ignore_the_front_end_inputs(arch, models):
    """The served embedding reads the tokens alone, as the reference's
    ``hidden_states`` does: internvl's patches are not prepended, and
    whisper runs its decoder's self-attention stack without the encoder
    or the learned positions. Equal to JAX's at 1e-5 and to the same
    batch without the stub inputs, bitwise."""
    jc, jp, c, p = models[arch]
    batch = TokenStream(c, 3, 24, seed=4).batch_at(1)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = lmc.hidden_states(p, c, tb)
    want = jlmc.hidden_states(jp, jc, {k: jnp.asarray(v) for k, v in
                                       batch.items()}, jlm)
    _close(got, want)
    assert torch.equal(got, lmc.hidden_states(p, c,
                                              {"tokens": tb["tokens"]}))
    assert got.shape[1] == batch["tokens"].shape[1]


# ---------------------------------------------------------------------------
# parameters and the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_params_carry_across_both_ways(arch, models):
    """Every leaf both ways bitwise: whisper's ``encoder`` runs, its
    ``cross`` tree stacked over the decoder's layers and
    ``pos_embed_dec``, internvl's untied head."""
    _, jp, c, p = models[arch]
    tree = jax.tree.map(np.asarray, jp)
    back = convert.lm_params_to_numpy(p)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)
    assert sum(t.numel() for t in p.parameters()) == sum(
        a.size for a in jax.tree.leaves(tree))
    assert not any(t.requires_grad for t in p.parameters())
    if arch == WHISPER:
        assert len(p["cross"]) == c.n_layers
        assert p["pos_embed_dec"].shape == (lm.POS_DEC, c.d_model)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_lm_matches_the_reference_tree(arch):
    """The port's own ``init_lm`` gives the reference's tree: keys,
    shapes and, in a bf16 model, every leaf bf16."""
    jc, c = (cf.replace(dtype="bfloat16", param_dtype="bfloat16")
             for cf in _cfgs(arch))
    want = jax.eval_shape(lambda k: jlm.init_lm(k, jc),
                          jax.random.PRNGKey(0))
    p = lm.init_lm(0, c, device="cpu")
    got = convert.lm_params_to_numpy(p)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.shape == b.shape
    assert all(t.dtype == torch.bfloat16 for t in p.parameters())
    assert {b.dtype.name for b in jax.tree.leaves(want)} == {"bfloat16"}


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_decode_logits(arch, models):
    """The decoder-only entry points (whisper's decoder without its
    encoder, as the reference's ``forward`` runs it): logits of the
    forward and of 20 teacher-forced decode steps at 1e-4. Whisper's
    decode reads a zero cross cache in both packages."""
    jc, jp, c, p = models[arch]
    toks = _tokens(c, 2, 20, 6)
    want, _, _ = jax.jit(lambda p, t: jlm.forward(p, jc, {"tokens": t}))(
        jp, jnp.asarray(toks))
    _close(lm.forward(p, c, {"tokens": torch.from_numpy(toks)}), want, 1e-4)
    step = jax.jit(lambda p, t, cache, i: jlm.decode_step(p, jc, t, cache, i))
    jcache = jlm.init_cache(jc, 2, 20)
    cache = lm.init_cache(c, 2, 20, "cpu")
    for i in range(20):
        jl, jcache = step(jp, jnp.asarray(toks[:, i:i + 1]), jcache, i)
        tl, cache = lm.decode_step(p, c, torch.from_numpy(toks[:, i:i + 1]),
                                   cache, i)
        _close(tl, jl, 1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_sequence_embedding(arch, models):
    jc, jp, c, p = models[arch]
    toks = _tokens(c, 3, 17, 8)
    got = lmc.sequence_embedding(p, c, {"tokens": torch.from_numpy(toks)})
    want = jlmc.sequence_embedding(jp, jc, {"tokens": jnp.asarray(toks)},
                                   jlm)
    assert got.shape == (3, c.d_model)
    _close(got, want)


# ---------------------------------------------------------------------------
# the slice end to end
# ---------------------------------------------------------------------------


def _counts(p, n):
    return np.rint(np.asarray(p, np.float64) * (n + 1)).astype(np.int64)


def _near_ties(alphas, alpha, tol=1e-5):
    """Queries with a calibration score within ``tol`` (relative) of their
    own without equalling it."""
    alphas, alpha = np.asarray(alphas), np.asarray(alpha)[..., None]
    diff = np.abs(alphas - alpha)
    return ((diff > 0) & (diff <= tol * np.maximum(
        np.abs(alphas), np.abs(alpha)) + 1e-7)).any(-1)


@pytest.mark.parametrize("arch", ARCHS)
def test_slice_token_stream_to_request_pvalues(arch, models):
    """Stream batches with their stub inputs, embedded by both models on
    the same weights, fit both OOD heads; requests (half from another
    seed's stream, half uniform tokens) get the same p-values."""
    jc, jp, c, p = models[arch]
    n, S, B = 48, 24, 8
    calib = TokenStream(c, n, S, seed=0).batch_at(0)
    req = TokenStream(c, B, S, seed=1).batch_at(0)
    req["tokens"][B // 2:] = np.random.default_rng(2).integers(
        0, c.vocab_size, req["tokens"][B // 2:].shape)
    emb_fn = jax.jit(lambda p, b: jlmc.sequence_embedding(p, jc, b, jlm))

    def both(batch):
        got = lmc.sequence_embedding(
            p, c, {k: torch.from_numpy(v) for k, v in batch.items()})
        want = emb_fn(jp, {k: jnp.asarray(v) for k, v in batch.items()})
        _close(got, want)
        return got, want

    emb, jemb = both(calib)
    det = lmc.ConformalOodDetector(k=7, device="cpu").fit(emb)
    jdet = jlmc.ConformalOodDetector(k=7).fit(jemb)
    q, jq = both(req)
    got = det.pvalues(q).numpy()
    want = np.asarray(jdet.pvalues(jq))
    ties = _near_ties(*(t.numpy() for t in det.scores(q)))
    assert ties.mean() < 0.2, f"{ties.sum()} of {ties.size} flagged"
    np.testing.assert_array_equal(_counts(got, n)[~ties],
                                  _counts(want, n)[~ties])
    assert ((got > 0) & (got <= 1)).all()


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_lm_mode_serves_on_the_cpu(arch):
    """``launch.serve --arch`` end to end: whisper's requests carry their
    frames (the encoder fills the cross cache before the decode steps),
    internvl's prompt holds its patch positions."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
         "--reduced", "--device", "cpu", "--calib", "64", "--requests", "4",
         "--gen-tokens", "4"],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    c = _cfgs(arch)[1]
    assert f"{arch} ({c.n_layers} layers, d 64, float32)" in out.stdout
    assert "conformal OOD head fit on 64 sequences" in out.stdout
    assert "mean p in-dist=" in out.stdout
    assert "req  3" in out.stdout


def test_generate_reads_the_request_frames(models):
    """``serve.generate`` fills whisper's cross cache from the request
    frames (``request_frames``: the batch of ``TokenStream(seed + 1)`` the
    request tokens come from) and refuses to decode without them; other
    models take no frames."""
    _, _, c, p = models[WHISPER]
    tokens = serve.request_tokens(c, 2, 12, 0, "cpu")
    frames = serve.request_frames(c, 2, 12, 0, "cpu")
    np.testing.assert_array_equal(
        frames.numpy(), TokenStream(c, 2, 12, seed=1).batch_at(0)["frames"])
    gen = serve.generate(p, c, tokens, 3, frames)
    assert gen.shape == (2, 3)
    with pytest.raises(ValueError, match="frames"):
        serve.generate(p, c, tokens, 3)
    assert serve.request_frames(_cfgs(VLM)[1], 2, 12, 0, "cpu") is None


def test_launcher_refuses_a_prompt_without_text():
    """internvl's ``--prompt-len`` counts its 256 patch positions: a
    shorter prompt is refused before any weight is drawn."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", VLM,
         "--device", "cpu", "--prompt-len", "16"],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=120)
    assert out.returncode == 2
    assert "leaves no text" in out.stderr
