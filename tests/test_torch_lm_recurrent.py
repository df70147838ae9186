"""The port's recurrent families against the JAX package.

The reduced configs of recurrentgemma-9b (RG-LRU blocks and local
attention) and xlstm-125m (mLSTM and sLSTM blocks), float32, with the JAX
``init_lm`` weights carried across by ``lm_params_from_numpy``: the causal
conv1d, each recurrent block's full-sequence form (S 40, one chunk, and S
300, two chunks with a ragged tail) and its decode step, the blocks, the
parameters both ways (the reference's f32 leaves stay f32 in a bf16
model), logits of the forward and of teacher-forced decode steps (1e-4),
sequence embeddings (1e-5), the OOD p-values (as counts, exactly, outside
flagged near-ties), the slice end to end and the launcher's LM mode.
Inside the port: decode == forward, a decode phase continues the state a
full pass leaves, and decode writes every state leaf in place.

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
from repro.models import blocks as jblk  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import recurrent as jrec  # noqa: E402
import repro_torch.configs as cfgs  # noqa: E402
from repro_torch.core import lm_conformal as lmc  # noqa: E402
from repro_torch.data.lm_pipeline import TokenStream  # noqa: E402
from repro_torch.models import blocks, lm, recurrent  # noqa: E402
from repro_torch.models.common import frozen  # noqa: E402
from repro_torch.serving import convert  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["recurrentgemma-9b", "xlstm-125m"]
# each recurrent kind's arch
KINDS = {"rglru": "recurrentgemma-9b", "mlstm": "xlstm-125m",
         "slstm": "xlstm-125m"}


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _cfgs(arch):
    return jcfgs.get(arch).reduced(), cfgs.get(arch).reduced()


def _to_torch(tree):
    return {k: _to_torch(v) if isinstance(v, dict) else
            torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _tokens(c, B, S, seed):
    return np.random.default_rng(seed).integers(
        0, c.vocab_size, (B, S)).astype(np.int32)


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
# the recurrences, block by block
# ---------------------------------------------------------------------------


def _block_params(kind, seed=3):
    """The JAX recurrent block's weights (numpy) and the port's."""
    arch = KINDS[kind]
    jc, c = _cfgs(arch)
    init = getattr(jrec, f"init_{kind}_block")
    tree = jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed), jc,
                                         jnp.float32))
    return jc, c, tree, frozen(_to_torch(tree))


def _x(c, B, S, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, S, c.d_model)).astype(np.float32)


def test_conv1d_full_and_step():
    """The causal depthwise conv, full (S 40) and step by step from a zero
    state: both equal JAX's, the steps equal the full pass, and the state
    is written in place."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((4, 24)).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32)
    x = rng.standard_normal((2, 40, 24)).astype(np.float32)
    jp = {"w": jnp.asarray(w), "b": jnp.asarray(b)}
    p = frozen({"w": torch.from_numpy(w), "b": torch.from_numpy(b)})
    full = recurrent.conv1d_full(p, torch.from_numpy(x))
    _close(full, jrec.conv1d_full(jp, jnp.asarray(x)))
    st = torch.zeros((2, 3, 24))
    jst = jnp.zeros((2, 3, 24))
    for t in range(40):
        y, out = recurrent.conv1d_step(p, torch.from_numpy(x[:, t:t + 1]), st)
        jy, jst = jrec.conv1d_step(jp, jnp.asarray(x[:, t:t + 1]), jst)
        assert out is st
        _close(y, jy)
        _close(st, jst)
        _close(y[:, 0], full[:, t])


@pytest.mark.parametrize("S", [40, 300])
@pytest.mark.parametrize("kind", list(KINDS))
def test_block_full_matches_the_reference(kind, S):
    """Each recurrent block's full pass (``y`` and the state it leaves) at
    S 40 (one chunk) and S 300 (two chunks, a ragged tail: the mLSTM pads
    ``log_i`` with -1e30) equals JAX's; nothing is NaN. The RG-LRU's scan
    adds in another tree than ``lax.associative_scan`` (log-step
    Hillis-Steele), yet stays within 1e-5 here (1.8e-7 at S 300)."""
    jc, c, tree, p = _block_params(kind)
    x = _x(c, 2, S, S)
    fn = getattr(recurrent, f"{kind}_block_full")
    y, st = fn(p, torch.from_numpy(x), c)
    jy, jst = getattr(jrec, f"{kind}_block_full")(tree, jnp.asarray(x), jc)
    assert bool(torch.isfinite(y).all())
    _close(y, jy)
    assert set(st) == set(jst)
    for name in st:
        _close(st[name], jst[name])


@pytest.mark.parametrize("kind", list(KINDS))
def test_block_step_matches_the_reference(kind):
    """20 decode steps from the initial state equal JAX's, output and
    every state leaf (sequential in both packages: 1e-5)."""
    jc, c, tree, p = _block_params(kind)
    x = _x(c, 2, 20, 5)
    init = getattr(recurrent, f"init_{kind}_state")
    jinit = getattr(jrec, f"init_{kind}_state")
    if kind == "slstm":
        st, jst = init(c, 2, "cpu"), jinit(jc, 2)
    else:
        st, jst = init(c, 2, torch.float32, "cpu"), jinit(jc, 2, jnp.float32)
    step = getattr(recurrent, f"{kind}_block_step")
    jstep = getattr(jrec, f"{kind}_block_step")
    for t in range(20):
        y, _ = step(p, torch.from_numpy(x[:, t:t + 1]), c, st)
        jy, jst = jstep(tree, jnp.asarray(x[:, t:t + 1]), jc, jst)
        _close(y, jy)
    for name in st:
        _close(st[name], jst[name])


@pytest.mark.parametrize("kind", list(KINDS))
def test_decode_continues_the_full_pass_state(kind):
    """Inside the port: a full pass over the first 270 steps leaves the
    state from which 30 decode steps give the full pass's last 30 outputs
    (the chunked scan's carry against the step-wise recurrence)."""
    _, c, _, p = _block_params(kind)
    x = torch.from_numpy(_x(c, 2, 300, 9))
    full = getattr(recurrent, f"{kind}_block_full")
    step = getattr(recurrent, f"{kind}_block_step")
    y_all, _ = full(p, x, c)
    _, st = full(p, x[:, :270], c)
    ys = [step(p, x[:, t:t + 1], c, st)[0][:, 0] for t in range(270, 300)]
    _close(torch.stack(ys, 1), y_all[:, 270:])


def test_scan_is_the_sequential_recurrence():
    """``_rglru_scan`` == the loop ``h_t = a_t h_{t-1} + g_t`` in float64
    (1e-5 relative in f32) over 600 steps, three chunks, from a nonzero
    ``h0``; the closed form would lose precision here (``exp(-L_s)`` past
    e^27)."""
    rng = np.random.default_rng(1)
    log_a = -rng.uniform(0.0, 0.25, (2, 600, 8))
    g = rng.standard_normal((2, 600, 8))
    h0 = rng.standard_normal((2, 8))
    hs, h_last = recurrent._rglru_scan(
        *(torch.from_numpy(t.astype(np.float32)) for t in (log_a, g, h0)))
    h, want = h0, []
    for t in range(600):
        h = np.exp(log_a[:, t]) * h + g[:, t]
        want.append(h)
    want = np.stack(want, 1)
    _close(hs, want, 1e-5)
    np.testing.assert_array_equal(h_last.numpy(), hs[:, -1].numpy())


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def _shapes(tree):
    return {k: _shapes(v) if isinstance(v, dict) else tuple(v.shape)
            for k, v in tree.items()}


@pytest.mark.parametrize("kind", list(KINDS))
def test_blocks(kind):
    """``init_block``'s tree has the reference's keys and shapes
    (``rglru``: ``ln1, rec, ln2, mlp``; ``mlstm`` / ``slstm``: ``ln1,
    block``); ``apply_block_full`` and ``apply_block_decode`` on the
    reference's weights agree, the decode cache from
    ``init_block_cache``."""
    arch = KINDS[kind]
    jc, c = _cfgs(arch)
    jp = jblk.init_block(jax.random.PRNGKey(11), jc, kind, jnp.float32)
    tree = jax.tree.map(np.asarray, jp)
    mine = blocks.init_block(torch.Generator().manual_seed(0), c, kind,
                             torch.float32)
    assert _shapes(convert._module_tree(mine)) == _shapes(tree)
    p = frozen(_to_torch(tree))
    x = _x(c, 2, 16, 12)
    pos = np.tile(np.arange(16, dtype=np.int32), (2, 1))
    got, _ = blocks.apply_block_full(p, torch.from_numpy(x), c, kind,
                                     torch.from_numpy(pos))
    want, _, _ = jblk.apply_block_full(jp, jnp.asarray(x), jc, kind,
                                       jnp.asarray(pos))
    _close(got, want)
    cache = blocks.init_block_cache(c, kind, 2, 16, torch.float32, "cpu")
    jcache = jblk.init_block_cache(jc, kind, 2, 16, jnp.float32)
    for i in range(16):
        got, cache = blocks.apply_block_decode(
            p, torch.from_numpy(x[:, i:i + 1]), c, kind, cache, i)
        want, jcache = jblk.apply_block_decode(
            jp, jnp.asarray(x[:, i:i + 1]), jc, kind, jcache, i)
        _close(got, want)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

F32_LEAVES = {"recurrentgemma-9b": {"lam"},
              "xlstm-125m": {"w_if", "b_if", "b_zifo"}}


@pytest.mark.parametrize("arch", ARCHS)
def test_params_carry_across_both_ways(arch, models):
    _, jp, _, p = models[arch]
    tree = jax.tree.map(np.asarray, jp)
    back = convert.lm_params_to_numpy(p)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)
    assert sum(t.numel() for t in p.parameters()) == sum(
        a.size for a in jax.tree.leaves(tree))
    assert not any(t.requires_grad for t in p.parameters())


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_model_keeps_the_reference_f32_leaves(arch):
    """In a bf16 model the reference keeps ``lam`` (RG-LRU) and ``w_if``,
    ``b_if``, ``b_zifo`` (xLSTM gates) in f32; ``lm_params_from_numpy``
    and the port's ``init_lm`` give every leaf the reference's dtype, and
    the carried leaves are bitwise the reference's."""
    jc, c = (cf.replace(dtype="bfloat16", param_dtype="bfloat16")
             for cf in _cfgs(arch))
    jp = jlm.init_lm(jax.random.PRNGKey(0), jc)
    want = {}
    for k, a in jax.tree_util.tree_leaves_with_path(jp):
        want.setdefault(jax.tree_util.keystr(k).split("'")[-2],
                        set()).add(a.dtype.name)
    f32 = {n for n, dts in want.items() if dts == {"float32"}}
    assert f32 == F32_LEAVES[arch]
    carried = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp), c,
                                           device="cpu")
    for params in (carried, lm.init_lm(0, c, device="cpu")):
        for n, t in params.named_parameters():
            name = n.split(".")[-1]
            assert t.dtype == (torch.float32 if name in f32 else
                               torch.bfloat16), n
    back = convert.lm_params_to_numpy(carried)
    for a, b in zip(jax.tree.leaves(jax.tree.map(
            lambda a: np.asarray(a, np.float32), jp)), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)


def test_init_lm_fan_ins():
    """The port's ``init_lm`` draws the reference's scales: ``r_zifo`` at
    ``dh ** -0.5``, conv1d at ``width ** -0.5`` (truncated at 2 std), and
    ``lam`` so that ``sigmoid(lam) ** 8`` lies in [0.9, 0.999]."""
    c = _cfgs("xlstm-125m")[1]
    p = lm.init_lm(0, c, device="cpu")
    dh = c.d_model // c.n_heads
    sl = p["layers"][1][0]["block"]  # the slstm run
    assert sl["r_zifo"].shape == (c.n_heads, dh, 4 * dh)
    assert float(sl["r_zifo"].abs().max()) <= 2 * dh ** -0.5
    assert float(sl["r_zifo"].std()) > 0.5 * dh ** -0.5
    conv = p["layers"][0][0]["block"]["conv"]
    assert float(conv["w"].abs().max()) <= 2 * c.conv1d_width ** -0.5
    assert float(conv["w"].std()) > 0.5 * c.conv1d_width ** -0.5
    rg = cfgs.get("recurrentgemma-9b").reduced()
    lam = lm.init_lm(0, rg, device="cpu")["layers"][0][0]["rec"]["lam"]
    a = torch.sigmoid(lam.double()) ** 8
    assert bool(((a >= 0.9 - 1e-6) & (a <= 0.999 + 1e-6)).all())


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def logits(models):
    """``{arch: (tokens (2, 40), JAX forward logits, JAX decode logits)}``,
    the JAX calls jitted and shared."""
    out = {}
    for arch, (jc, jp, c, _) in models.items():
        toks = _tokens(c, 2, 40, 6)
        fwd = jax.jit(lambda p, t, jc=jc: jlm.forward(p, jc, {"tokens": t})[0])
        step = jax.jit(lambda p, t, cache, i, jc=jc:
                       jlm.decode_step(p, jc, t, cache, i))
        cache = jlm.init_cache(jc, 2, 40)
        dec = []
        for i in range(40):
            lg, cache = step(jp, jnp.asarray(toks[:, i:i + 1]), cache, i)
            dec.append(np.asarray(lg)[:, 0])
        out[arch] = (toks, np.asarray(fwd(jp, jnp.asarray(toks))),
                     np.stack(dec, 1))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_decode_logits(arch, models, logits):
    """Logits of the full forward and of 40 teacher-forced decode steps
    equal JAX's within 1e-4: a logit sums the model width's products of
    hidden states that agree within 1e-5."""
    _, _, c, p = models[arch]
    toks, want_fwd, want_dec = logits[arch]
    _close(lm.forward(p, c, {"tokens": torch.from_numpy(toks)}), want_fwd,
           1e-4)
    cache = lm.init_cache(c, 2, 40, "cpu")
    got = [lm.decode_step(p, c, torch.from_numpy(toks[:, i:i + 1]), cache,
                          i)[0][:, 0] for i in range(40)]
    _close(torch.stack(got, 1), want_dec, 1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_equals_forward_inside_the_port(arch):
    """Teacher-forced decode == forward over 300 tokens, past one 256-step
    chunk of the RG-LRU scan and the mLSTM, at 1e-4 as for the logits
    against JAX (xlstm's differ by 1.1e-4 absolute at logits up to 3.8:
    the mLSTM's step and chunkwise forms order their sums apart)."""
    c = _cfgs(arch)[1]
    p = lm.init_lm(3, c, device="cpu")
    toks = torch.from_numpy(_tokens(c, 2, 300, 7))
    full = lm.forward(p, c, {"tokens": toks})
    cache = lm.init_cache(c, 2, 300, "cpu")
    steps = [lm.decode_step(p, c, toks[:, i:i + 1], cache, i)[0][:, 0]
             for i in range(300)]
    _close(torch.stack(steps, 1), full, 1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_writes_every_state_leaf_in_place(arch):
    """A decode step keeps every recurrent state leaf's storage (``h``,
    ``conv``; ``C``, ``n``, ``m``; ``c``, ``n``, ``h``, ``m``) and changes
    its values, as ``attention_decode`` keeps the KV cache's."""
    c = _cfgs(arch)[1]
    p = lm.init_lm(4, c, device="cpu")
    cache = lm.init_cache(c, 2, 4, "cpu")
    toks = torch.from_numpy(_tokens(c, 2, 2, 8))
    lm.decode_step(p, c, toks[:, :1], cache, 0)
    leaves = [(kind, name, t) for (kind, _), run in
              zip(blocks.pattern_runs(c.pattern), cache["self"])
              for st in run for name, t in st.items() if kind != "attn_local"]
    assert {kind for kind, _, _ in leaves} == set(c.pattern) - {"attn_local"}
    before = [(t.data_ptr(), t.clone()) for _, _, t in leaves]
    lm.decode_step(p, c, toks[:, 1:], cache, 1)
    for (kind, name, t), (ptr, old) in zip(leaves, before):
        assert t.data_ptr() == ptr, (kind, name)
        assert not torch.equal(t, old), (kind, name)


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
    """Calibration sequences from the token stream, embedded by both
    models on the same weights, fit both OOD heads; requests (half from
    another seed's stream, half uniform tokens) get the same p-values."""
    jc, jp, c, p = models[arch]
    n, S, B = 48, 16, 8
    calib = TokenStream(c, n, S, seed=0).batch_at(0)["tokens"]
    req = TokenStream(c, B, S, seed=1).batch_at(0)["tokens"]
    req[B // 2:] = np.random.default_rng(2).integers(0, c.vocab_size,
                                                     (B - B // 2, S))
    emb_fn = jax.jit(lambda p, t: jlmc.sequence_embedding(
        p, jc, {"tokens": t}, jlm))
    emb = lmc.sequence_embedding(p, c, {"tokens": torch.from_numpy(calib)})
    jemb = emb_fn(jp, jnp.asarray(calib))
    _close(emb, jemb)
    det = lmc.ConformalOodDetector(k=7, device="cpu").fit(emb)
    jdet = jlmc.ConformalOodDetector(k=7).fit(jemb)
    q = lmc.sequence_embedding(p, c, {"tokens": torch.from_numpy(req)})
    jq = emb_fn(jp, jnp.asarray(req))
    _close(q, jq)
    got = det.pvalues(q).numpy()
    want = np.asarray(jdet.pvalues(jq))
    ties = _near_ties(*(t.numpy() for t in det.scores(q)))
    assert ties.mean() < 0.2, f"{ties.sum()} of {ties.size} flagged"
    np.testing.assert_array_equal(_counts(got, n)[~ties],
                                  _counts(want, n)[~ties])
    assert ((got > 0) & (got <= 1)).all()


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_lm_mode_serves_on_the_cpu(arch):
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
