"""Training in the port against the JAX package, on the CPU.

The optimizer (``lr_schedule``; one ``apply_updates`` step, full and
factored, on a dict and on a model whose runs the reference stacks; the
reference's own optimizer checks restated), the loss (``cross_entropy``
with and without a mask, ``chunked_cross_entropy`` == the dense value),
``flash_attention``'s backward (against autograd through the plain
version and ``jax.vjp`` of the reference's plain attention), the bf16
cotangent rounding at the block boundaries, ``make_train_step`` (two
microbatches against one), the ``Trainer`` (restart, bitwise resume, a
raised SIGTERM, a non-finite loss, its losses against the JAX trainer's)
and the launcher. The gradient of ``train_step_loss`` for every
architecture is in ``test_torch_train_archs.py``. Inputs are made from
seeds with numpy; each test states its tolerance.
"""
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jcfgs  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
import repro_torch.configs as cfgs  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.data.lm_pipeline import TokenStream  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_bwd  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import boundary, lm  # noqa: E402
from repro_torch.runtime import trainer as tr  # noqa: E402
from repro_torch.serving import convert  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these models' ops are tiny, and several test
    workers each spinning up every core's thread run them 10-50x
    slower."""
    kept = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(kept)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _models(arch, seed=0, **replace):
    jc = jcfgs.get(arch).reduced().replace(**replace)
    c = cfgs.get(arch).reduced().replace(**replace)
    jp = jlm.init_lm(jax.random.PRNGKey(seed), jc)
    p = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp), c,
                                     device="cpu")
    return jc, jp, c, p


def _batch(c, B=2, S=24, index=0, seed=1):
    return TokenStream(c, B, S, seed=seed).batch_at(index)


def _t(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _j(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("step", [0, 1, 4, 5, 6, 50, 99, 100, 150])
def test_lr_schedule_against_jax(step):
    """Warm-up (steps below 5), the knee (5), the cosine and the end
    (past ``total_steps``), 1e-7 relative."""
    kw = dict(peak_lr=3e-4, end_lr=3e-5, warmup_steps=5, total_steps=100)
    got = optim.lr_schedule(optim.OptimizerConfig(**kw), step)
    want = joptim.lr_schedule(joptim.OptimizerConfig(**kw),
                              jnp.asarray(step, jnp.int32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-7)


def _opt_tree(seed, shapes):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}


SHAPES = {"a": (16, 8), "b": (7,), "c": (3, 12, 9), "d": (9, 4)}


@pytest.mark.parametrize("factored", [False, True])
def test_apply_updates_one_step_against_jax(factored):
    """Two steps of ``apply_updates`` on a dict (the second from the
    first's moments): parameters, moments and stats against JAX's, atol
    1e-6 (the reference's own tolerance for one step)."""
    kw = dict(peak_lr=1e-2, warmup_steps=2, total_steps=10, factored=factored)
    p0 = _opt_tree(0, SHAPES)
    jp, jo = p0, joptim.init_opt_state(
        {k: jnp.asarray(v) for k, v in p0.items()}, joptim.OptimizerConfig(**kw))
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    to = optim.init_opt_state(tp, optim.OptimizerConfig(**kw))
    for s in (1, 2):
        g = _opt_tree(s, SHAPES)
        jp, jo, jst = joptim.apply_updates(
            {k: jnp.asarray(v) for k, v in jp.items()},
            {k: jnp.asarray(v) for k, v in g.items()}, jo,
            joptim.OptimizerConfig(**kw))
        tp, to, st = optim.apply_updates(
            tp, {k: torch.from_numpy(v) for k, v in g.items()}, to,
            optim.OptimizerConfig(**kw))
        for k in SHAPES:
            _close(tp[k], jp[k], 1e-6)
            _close(to["mu"][k], jo["mu"][k], 1e-6)
            assert set(to["nu"][k]) == set(jo["nu"][k])
            for n, v in to["nu"][k].items():
                _close(v, jo["nu"][k][n], 1e-6)
        assert int(to["step"]) == int(jo["step"]) == s
        for n in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(st[n]), float(jst[n]),
                                       rtol=1e-6)
    assert ("row" in to["nu"]["a"]) == factored
    assert "full" in to["nu"]["b"]


@pytest.mark.parametrize("factored", [False, True])
def test_apply_updates_on_a_model_against_jax(factored):
    """One step on a model whose runs the reference stacks: 8 layers, so
    a run's norm weights are 2-D ``(8, 64)`` there, take the decoupled
    decay and (factored) a row / column factoring across the layers. The
    port's state keeps those stacked leaves; parameters 1e-6, moments
    1e-6 (``opt_state_to_numpy``), and ``opt_state_from_numpy`` restores
    the JAX state exactly."""
    jc, jp, c, p = _models("qwen2_1_5b", seed=2, n_layers=8,
                           layer_pattern=("attn",) * 8)
    kw = dict(warmup_steps=0, total_steps=10, factored=factored,
              peak_lr=1e-2)
    jo = joptim.init_opt_state(jp, joptim.OptimizerConfig(**kw))
    o = optim.init_opt_state(p, optim.OptimizerConfig(**kw))
    rng = np.random.default_rng(3)
    grads = {n: torch.from_numpy(rng.standard_normal(t.shape)
                                 .astype(np.float32))
             for n, t in p.named_parameters()}
    for n, t in p.named_parameters():
        t.grad = grads[n]
    jg = jax.tree.map(jnp.asarray, convert.lm_params_to_numpy(p, grads=True))
    jp2, jo2, _ = joptim.apply_updates(jp, jg, jo,
                                       joptim.OptimizerConfig(**kw))
    p2, o2, _ = optim.apply_updates(p, grads, o,
                                    optim.OptimizerConfig(**kw))
    assert o["nu"]["layers.0.ln1.w"].keys() == (
        {"row", "col"} if factored else {"full"})
    assert o["mu"]["layers.0.ln1.w"].shape == (8, 64)
    got, want = convert.lm_params_to_numpy(p2), jax.tree.map(np.asarray,
                                                             jp2)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        _close(a, b, 1e-6)
    mine = convert.opt_state_to_numpy(o2)
    jax.tree.map(lambda a, b: _close(a, b, 1e-6), mine,
                 jax.tree.map(np.asarray, jo2))
    back = convert.opt_state_from_numpy(jax.tree.map(np.asarray, jo2), p,
                                        device="cpu")
    for (n, a), b in zip(back["mu"].items(), o2["mu"].values()):
        assert a.shape == b.shape, n
    np.testing.assert_array_equal(
        convert.opt_state_to_numpy(back)["mu"]["embed"],
        np.asarray(jo2["mu"]["embed"]))


def test_adamw_converges_quadratic():
    """The reference's check (``tests/test_substrate.py:25``): 200 steps
    on a quadratic reach its minimum within 2e-2."""
    cfg = optim.OptimizerConfig(peak_lr=0.1, end_lr=0.01, warmup_steps=5,
                                total_steps=200, weight_decay=0.0,
                                clip_norm=1e9)
    params = {"w": torch.tensor([3.0, -2.0, 5.0])}
    opt = optim.init_opt_state(params, cfg)
    tgt = torch.tensor([1.0, 1.0, 1.0])
    for _ in range(200):
        g = {"w": 2 * (params["w"] - tgt)}
        params, opt, _ = optim.apply_updates(params, g, opt, cfg)
    np.testing.assert_allclose(params["w"].numpy(), tgt.numpy(), atol=2e-2)


def test_adamw_matches_reference_step():
    """The reference's check (``tests/test_substrate.py:38``): one step
    against a hand-rolled AdamW, atol 1e-6."""
    cfg = optim.OptimizerConfig(peak_lr=1e-2, warmup_steps=0, total_steps=10,
                                b1=0.9, b2=0.99, eps=1e-8, weight_decay=0.1,
                                clip_norm=1e9)
    w0 = np.array([[1.0, -2.0], [0.5, 3.0]], np.float32)
    g = np.array([[0.1, 0.2], [-0.3, 0.4]], np.float32)
    params = {"w": torch.from_numpy(w0.copy())}
    opt = optim.init_opt_state(params, cfg)
    params, opt, _ = optim.apply_updates(params, {"w": torch.from_numpy(g)},
                                         opt, cfg)
    lr = float(optim.lr_schedule(cfg, 1))
    m, v = 0.1 * g, 0.01 * g * g
    want = w0 - lr * ((m / (1 - 0.9)) / (np.sqrt(v / (1 - 0.99)) + 1e-8)
                      + 0.1 * w0)
    np.testing.assert_allclose(params["w"].numpy(), want, atol=1e-6)


def test_factored_moments_memory_shape():
    """The reference's check (``tests/test_substrate.py:58``): row /
    column moments for a 2-D leaf, a full one for a 1-D leaf, and one
    step still descends."""
    cfg = optim.OptimizerConfig(factored=True)
    params = {"big": torch.zeros((64, 32)), "small": torch.zeros((7,))}
    opt = optim.init_opt_state(params, cfg)
    assert opt["nu"]["big"]["row"].shape == (64,)
    assert opt["nu"]["big"]["col"].shape == (32,)
    assert opt["nu"]["small"]["full"].shape == (7,)
    g = {"big": torch.ones((64, 32)), "small": torch.ones((7,))}
    p2, _, _ = optim.apply_updates(params, g, opt, cfg)
    assert float(p2["big"].sum()) < 0.0


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------


def _logits(seed, B=3, S=10, V=40):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, V)).astype(np.float32) * 3,
            rng.integers(0, V, (B, S)).astype(np.int32),
            (rng.random((B, S)) < 0.6).astype(np.float32))


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_against_jax(masked):
    """The z-loss cross entropy, plain mean and masked mean, 1e-6."""
    x, y, m = _logits(4)
    got = lm.cross_entropy(torch.from_numpy(x), torch.from_numpy(y),
                           torch.from_numpy(m) if masked else None)
    want = jlm.cross_entropy(jnp.asarray(x), jnp.asarray(y),
                             jnp.asarray(m) if masked else None)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert lm.Z_LOSS_COEF == jlm.Z_LOSS_COEF


@pytest.mark.parametrize("masked", [False, True])
def test_chunked_cross_entropy_equals_dense(monkeypatch, masked):
    """``train_step_loss`` past a lowered ``_CE_CHUNK_LIMIT`` takes the
    chunked loss (8-token chunks of 21, the last ragged): == the dense
    value within 1e-6 in the port, its gradient too (1e-6), and ==
    JAX's ``chunked_cross_entropy`` (1e-5)."""
    jc, jp, c, p = _models("qwen2_1_5b")
    b = _batch(c, 2, 21)
    if masked:
        b["mask"] = (np.random.default_rng(5).random((2, 21)) < 0.7
                     ).astype(np.float32)
    p.requires_grad_(True)
    dense = lm.train_step_loss(p, c, _t(b))
    dense.backward()
    g_dense = [t.grad.clone() for t in p.parameters()]
    p.zero_grad()
    calls = []
    real = lm.chunked_cross_entropy
    monkeypatch.setattr(lm, "chunked_cross_entropy",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setattr(lm, "_CE_CHUNK_LIMIT", 2 * 21 * 256 - 1)
    monkeypatch.setattr(lm, "_CE_CHUNK", 8)
    chunked = lm.train_step_loss(p, c, _t(b))
    chunked.backward()
    assert calls
    np.testing.assert_allclose(float(chunked.detach()), float(dense.detach()),
                               rtol=1e-6)
    for a, g in zip(p.parameters(), g_dense):
        _close(a.grad, g, 1e-6)
    h, _ = lm.hidden_forward(p, c, _t(b))
    jh, _, _ = jlm.hidden_forward(jp, jc, _j(b))
    got = lm.chunked_cross_entropy(p, c, h, torch.from_numpy(b["labels"]),
                                   _t(b).get("mask"))
    want = jlm.chunked_cross_entropy(jp, jc, jh, jnp.asarray(b["labels"]),
                                     _j(b).get("mask"))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)


# ---------------------------------------------------------------------------
# flash_attention's backward
# ---------------------------------------------------------------------------


BWD_CASES = [  # name, B, Sq, Skv, H, Hkv, D, causal, window, softcap, scale
    ("causal-gqa", 2, 16, 16, 4, 2, 8, True, None, None, None),
    ("window-mqa", 2, 16, 16, 4, 1, 8, True, 5, None, None),
    ("softcap-noncausal", 1, 12, 12, 2, 2, 16, False, None, 50.0, None),
    ("sq-below-skv", 2, 16, 80, 4, 2, 8, True, None, None, None),
    ("d192-scale", 1, 20, 20, 4, 4, 192, True, None, None, 192 ** -0.5),
    ("sq-above-skv", 1, 7, 3, 2, 1, 8, True, None, None, None),
    ("ragged-chunks", 1, 37, 53, 6, 2, 8, True, 9, 30.0, None),
]


def _qkv(case, seed=0):
    _, B, Sq, Skv, H, Hkv, D = case[:7]
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in
            ((B, Sq, H, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D),
             (B, Sq, H, D))]


@pytest.mark.parametrize("case", BWD_CASES, ids=[c[0] for c in BWD_CASES])
def test_flash_attention_bwd_against_autograd_and_jax(case):
    """``flash_attention_bwd`` == autograd through ``ref.flash_attention``
    (2e-6) and ``jax.vjp`` of ``repro.kernels.ref.flash_attention``
    (4e-6), with one query block (``limit`` past the scores) and with
    blocks of 5 rows (the last ragged)."""
    causal, window, cap, scale = case[7:]
    q, k, v, do = _qkv(case)
    kw = dict(causal=causal, window=window, scale=scale, softcap=cap)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = ref.flash_attention(tq, tk, tv, **kw)
    want = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    _, vjp = jax.vjp(lambda a, b, c: jref.flash_attention(a, b, c, **kw),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = vjp(jnp.asarray(do))
    for limit in (1 << 22, 5 * k.shape[1]):
        got = flash_attention_bwd(tq.detach(), tk.detach(), tv.detach(),
                                  torch.from_numpy(do), limit=limit, **kw)
        for g, w, jw in zip(got, want, jgrads):
            assert g.dtype == torch.float32
            _close(g, w, 2e-6)
            _close(g, jw, 4e-6)


def test_ops_flash_attention_is_differentiable(monkeypatch):
    """``ops.flash_attention`` under autograd: the forward is the plain
    version (bitwise), dense or chunked past ``_DENSE_SCORE_LIMIT``, and
    the backward is ``flash_attention_bwd`` (bitwise) on query blocks of
    at most the limit's scores."""
    case = BWD_CASES[-1]
    q, k, v, do = _qkv(case, 1)
    kw = dict(causal=True, window=9, softcap=30.0)
    for limit in (ops._DENSE_SCORE_LIMIT, 5 * k.shape[1]):
        monkeypatch.setattr(ops, "_DENSE_SCORE_LIMIT", limit)
        tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                      for a in (q, k, v))
        out = ops.flash_attention(tq, tk, tv, **kw)
        plain = (ref.flash_attention if q.shape[1] * k.shape[1] <= limit
                 else ref.chunked_attention)
        assert torch.equal(out, plain(*(torch.from_numpy(a)
                                        for a in (q, k, v)), **kw))
        got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
        want = flash_attention_bwd(
            *(torch.from_numpy(a) for a in (q, k, v)), torch.from_numpy(do),
            limit=limit, scale=None, **kw)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def _bf16_excess(got, want):
    """How far ``|got - want|`` goes past 4 bf16 ulps of ``want``, over
    the largest ``|want|``."""
    w = want.float()
    ulp = torch.ldexp(torch.ones_like(w), torch.frexp(w).exponent - 8)
    return float(((got.float() - w).abs() - 4 * ulp).max() / w.abs().max())


@pytest.mark.parametrize("D,window,scale", [(128, None, None),
                                            (192, None, 192 ** -0.5),
                                            (256, 64, None)])
def test_ops_flash_attention_bf16_backward(D, window, scale):
    """A bf16 call's gradients come back in bf16, each element within 4
    bf16 ulps of autograd through the plain version on the same inputs
    (which rounds once, from f32) plus 1e-5 of the largest gradient (f32
    sums in another order, where an element nearly cancels): the row sums
    come from the recomputed f32 probabilities, not from the rounded bf16
    output, through which the gap reaches 1e-3 of the largest."""
    g = torch.Generator().manual_seed(D)
    mk = lambda *s: torch.randn(s, generator=g).bfloat16()  # noqa: E731
    q, k, v, do = mk(1, 300, 4, D), mk(1, 300, 2, D), mk(1, 300, 2, D), \
        mk(1, 300, 4, D)
    kw = dict(causal=True, window=window, scale=scale)
    ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
    got = torch.autograd.grad(ops.flash_attention(*ts, **kw), ts, do)
    ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(ref.flash_attention(*ts, **kw), ts, do)
    for a, w in zip(got, want):
        assert a.dtype == torch.bfloat16
        assert _bf16_excess(a, w) <= 1e-5


# ---------------------------------------------------------------------------
# the block boundary's cotangent rounding
# ---------------------------------------------------------------------------


def test_boundary_rounds_the_cotangent_only_inside_its_context():
    """Identity forward both ways; the cotangent rounded to bf16 (and
    back) inside ``compressed_boundaries()``, untouched outside."""
    x = torch.linspace(-3, 3, 11, dtype=torch.float32) / 7
    g = torch.linspace(1, 2, 11, dtype=torch.float32) / 3
    for inside in (False, True):
        t = x.clone().requires_grad_(True)
        if inside:
            with boundary.compressed_boundaries():
                y = boundary.grad_compressed_boundary(t)
        else:
            y = boundary.grad_compressed_boundary(t)
        assert torch.equal(y, x)
        y.backward(g)
        assert torch.equal(t.grad, g.bfloat16().float() if inside else g)
    assert not torch.equal(g.bfloat16().float(), g)


def test_trainer_boundaries_match_the_reference_under_activation_mesh():
    """``train_step_loss``'s gradients inside ``compressed_boundaries()``
    against JAX's inside ``activation_mesh`` on a 1x1 mesh: each leaf
    within 1e-4 of the reference's in norm (relative), while without the
    rounding the port's leaves lie more than 1e-3 away from those in
    norm (qwen2 reduced; the rounding's ties make an elementwise bound
    meaningless)."""
    from repro.launch.mesh import make_host_mesh
    from repro.sharding.activation import activation_mesh

    jc, jp, c, p = _models("qwen2_1_5b")
    b = _batch(c)
    mesh = make_host_mesh(1, 1)
    with mesh, activation_mesh(mesh):
        _, jg = jax.value_and_grad(
            lambda q: jlm.train_step_loss(q, jc, _j(b)))(jp)
    p.requires_grad_(True)
    with boundary.compressed_boundaries():
        lm.train_step_loss(p, c, _t(b)).backward()
    got = jax.tree.leaves(convert.lm_params_to_numpy(p, grads=True))
    p.zero_grad()
    lm.train_step_loss(p, c, _t(b)).backward()
    plain = jax.tree.leaves(convert.lm_params_to_numpy(p, grads=True))
    want = jax.tree.leaves(jax.tree.map(np.asarray, jg))

    def rel(a, w):
        return float(np.linalg.norm(a - w) / np.linalg.norm(w))

    assert max(rel(a, w) for a, w in zip(got, want)) < 1e-4
    assert max(rel(u, w) for u, w in zip(plain, want)) > 1e-3


# ---------------------------------------------------------------------------
# the train step and the trainer
# ---------------------------------------------------------------------------


def test_make_train_step_microbatches_equal_one_batch():
    """Two microbatches == one batch: loss and grad norm 1e-6, the
    updated parameters within 1e-5, 1 % of the learning rate (Adam's
    first step moves each weight by about the learning rate whatever the
    size of its gradient, so a flipped sign would show as 2e-3; granite
    reduced has no biases, whose gradients are zero in exact
    arithmetic)."""
    c = cfgs.get("granite_34b").reduced()
    kw = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    b = _t(_batch(c, 4, 16))
    out = []
    for mb in (1, 2):
        p = lm.init_lm(0, c, device="cpu").requires_grad_(True)
        o = optim.init_opt_state(p, optim.OptimizerConfig(**kw))
        step = make_train_step(c, optim.OptimizerConfig(**kw), mb)
        p, o, st = step(p, o, b)
        out.append((p, st))
    (p1, s1), (p2, s2) = out
    for n in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(s2[n]), float(s1[n]), rtol=1e-6)
    assert int(s1["step"]) == int(s2["step"]) == 1
    for a, w in zip(p2.parameters(), p1.parameters()):
        _close(a.detach(), w.detach(), 1e-5)
    with pytest.raises(ValueError):
        make_train_step(c, optim.OptimizerConfig(), 3)(
            p1, o, b)  # 4 rows in 3 slices
    with pytest.raises(ValueError):
        make_train_step(c, optim.OptimizerConfig(), mesh=object())


def _tcfg(d, steps, **kw):
    return tr.TrainerConfig(steps=steps, ckpt_every=2, ckpt_dir=str(d),
                            log_every=10, batch=2, seq_len=32, **kw)


def _leaves(out):
    return [t.detach().clone() for t in tr.state_leaves(
        out["final_params"], out["opt_state"])]


def test_trainer_restart_continues_bitwise(tmp_path):
    """The reference's restart check (``tests/test_substrate.py:139``,
    xlstm-125m reduced, 4 steps then 6): the second run resumes at step
    4 and runs 2 steps; its losses and its final parameters and
    optimizer state are bitwise those of one uninterrupted 6-step run."""
    cfg = cfgs.get("xlstm_125m").reduced()
    d = tmp_path / "tr"
    opt_cfg = optim.OptimizerConfig(total_steps=6, warmup_steps=1)
    out1 = tr.Trainer(cfg, _tcfg(d, 4), opt_cfg=opt_cfg, device="cpu").run()
    assert out1["stop_step"] == 4 and len(out1["losses"]) == 4
    out2 = tr.Trainer(cfg, _tcfg(d, 6), opt_cfg=opt_cfg, device="cpu").run()
    assert out2["stop_step"] == 6 and len(out2["losses"]) == 2
    straight = tr.Trainer(cfg, _tcfg(tmp_path / "one", 6), opt_cfg=opt_cfg,
                          device="cpu").run()
    assert straight["losses"][4:] == out2["losses"]
    for a, b in zip(_leaves(out2), _leaves(straight)):
        assert torch.equal(a, b)


def test_trainer_sigterm_saves_and_resumes(tmp_path):
    """A SIGTERM raised during step 2 lets the step finish, writes a
    blocking checkpoint at step 3 and returns ``preempted``; the next run
    resumes there and ends bitwise where an uninterrupted run does. The
    process's own SIGTERM handler is back afterwards."""
    cfg = cfgs.get("qwen2_1_5b").reduced()
    before = signal.getsignal(signal.SIGTERM)
    t = tr.Trainer(cfg, _tcfg(tmp_path / "a", 6, keep_ckpts=5), device="cpu")
    real = t.batch_at

    def batch_at(step):
        if step == 2:
            signal.raise_signal(signal.SIGTERM)
        return real(step)

    t.batch_at = batch_at
    out = t.run()
    assert out["preempted"] and out["stop_step"] == 3
    assert len(out["losses"]) == 3
    assert t.store.committed_steps() == [2, 3]
    assert signal.getsignal(signal.SIGTERM) is before
    rest = tr.Trainer(cfg, _tcfg(tmp_path / "a", 6), device="cpu").run()
    assert len(rest["losses"]) == 3
    straight = tr.Trainer(cfg, _tcfg(tmp_path / "b", 6), device="cpu").run()
    assert straight["losses"] == out["losses"] + rest["losses"]
    for a, b in zip(_leaves(rest), _leaves(straight)):
        assert torch.equal(a, b)


def test_trainer_refuses_another_models_checkpoint(tmp_path):
    """A step saved by another architecture's trainer is refused by the
    restore builder."""
    tr.Trainer(cfgs.get("qwen2_1_5b").reduced(), _tcfg(tmp_path, 2),
               device="cpu").run()
    with pytest.raises(ValueError, match="another state"):
        tr.Trainer(cfgs.get("gemma3_1b").reduced(), _tcfg(tmp_path, 4),
                   device="cpu").run()


def test_trainer_raises_on_a_non_finite_loss(tmp_path):
    """A NaN in the parameters makes the loss non-finite:
    ``FloatingPointError``."""
    cfg = cfgs.get("qwen2_1_5b").reduced()
    t = tr.Trainer(cfg, _tcfg(tmp_path, 3), device="cpu")
    real = t.init_params

    def poisoned():
        p = real()
        with torch.no_grad():
            p["final_norm"]["w"][0] = float("nan")
        return p

    t.init_params = poisoned
    with pytest.raises(FloatingPointError, match="step 0"):
        t.run()


@pytest.mark.parametrize("arch", ["qwen2_1_5b", "mixtral_8x22b"])
def test_trainer_losses_against_the_jax_trainer(tmp_path, arch):
    """Four steps of the port's ``Trainer`` from the JAX ``init_lm``
    weights against the JAX ``Trainer`` on a 1x1 host mesh (the same
    stream, schedule and boundary rounding): losses within 1e-5."""
    from repro.launch.mesh import make_host_mesh
    from repro.runtime import Trainer as JTrainer
    from repro.runtime import TrainerConfig as JTrainerConfig

    jc, jp, c, p = _models(arch)
    kw = dict(steps=4, ckpt_every=10, log_every=10, batch=2, seq_len=32)
    want = JTrainer(jc, JTrainerConfig(ckpt_dir=str(tmp_path / "j"), **kw),
                    make_host_mesh(1, 1)).run()["losses"]
    t = tr.Trainer(c, tr.TrainerConfig(ckpt_dir=str(tmp_path / "t"), **kw),
                   device="cpu")
    t.init_params = lambda: p
    got = t.run()["losses"]
    _close(got, want, 1e-5)


def test_train_launcher_runs_reduced_on_the_cpu(tmp_path):
    """``python -m repro_torch.launch.train --reduced --device cpu``
    trains, checkpoints and prints the reference's ``[train] done:``
    line; a mesh of more processes than visible cards is refused (this
    machine shows none)."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    base = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
            "qwen2-1.5b", "--reduced", "--steps", "4", "--batch", "2",
            "--seq-len", "16", "--ckpt-every", "2", "--device", "cpu",
            "--ckpt-dir", str(tmp_path / "ck")]
    out = subprocess.run(base, capture_output=True, text=True, cwd=ROOT,
                         timeout=300, env=env)
    assert out.returncode == 0, out.stderr
    assert "[train] done: steps=4 loss" in out.stdout
    assert (tmp_path / "ck" / "step_000000004" / "COMMITTED").exists()
    bad = subprocess.run(base + ["--device", "cuda", "--model-axis", "2"],
                         capture_output=True, text=True, cwd=ROOT,
                         timeout=300, env=env)
    assert bad.returncode != 0 and "visible card" in bad.stderr


def test_checkpoint_store_keeps_bf16_leaves_bitwise(tmp_path):
    """The port's store writes a bf16 leaf as its raw values (``|V2``,
    manifest dtype ``bfloat16``) and reads it back bit for bit, signed
    zero included; a bf16 leaf written by the JAX store restores in the
    port bit for bit too."""
    from repro.checkpoint import CheckpointStore as JStore
    from repro_torch.checkpoint import CheckpointStore

    g = torch.Generator().manual_seed(0)
    x = torch.randn((5, 3), generator=g).bfloat16()
    x[0, 0] = -0.0
    leaves = [x, torch.arange(4, dtype=torch.int32), torch.randn(2)]
    store = CheckpointStore(str(tmp_path / "port"))
    store.save(1, leaves, blocking=True)
    assert [e["dtype"] for e in store.read_manifest(1)["leaves"]] == [
        "bfloat16", "int32", "float32"]
    back, _ = store.restore(None, 1, device="cpu")
    assert back[0].dtype == torch.bfloat16
    assert torch.equal(back[0].view(torch.int16), x.view(torch.int16))
    for a, b in zip(back[1:], leaves[1:]):
        assert torch.equal(a, b)
    jx = jnp.asarray(np.random.default_rng(1).standard_normal((4, 6)),
                     jnp.bfloat16)
    JStore(str(tmp_path / "jax")).save(2, [jx], blocking=True)
    got, _ = CheckpointStore(str(tmp_path / "jax")).restore(None, 2,
                                                            device="cpu")
    np.testing.assert_array_equal(got[0].view(torch.int16).numpy(),
                                  np.asarray(jx).view(np.int16))
