"""The port's FLOP counter (``analysis/flops.py``) and its ``meta`` device
path, on the CPU.

The counter's conventions against the reference's own checks
(``tests/test_analysis.py``, ``tests/test_substrate.py``: a known matmul,
a repeated body, a transcendental); ``flash_attention`` counted by its
boundary formula alike on the CPU's dense and chunked routes and on
``meta``, the formula equal to ``repro.analysis.flops.flops_of`` of the
reference's plain attention (dense and chunked); the counter's ``meta``
memo exact; the train step's ``repeat`` count equal to its loop's;
``init_lm`` on ``meta`` with a CPU init's shapes, dtypes and names for all
ten architectures. Exact equality throughout: counts are integers.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import flops as jflops
from repro.kernels import ref as jref
import repro_torch.configs as cfgs
from repro_torch.analysis import flops
from repro_torch.analysis.flops import FlopCounter, attention_flops, flops_of
from repro_torch.configs.base import ShapeSpec
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention as _flash
from repro_torch.launch.steps import batch_struct, make_train_step
from repro_torch.models import lm
from repro_torch.optim import OptimizerConfig, init_opt_state


def _sds(*shape):
    return jax.ShapeDtypeStruct(shape, jnp.float32)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_known_matmul(device):
    a = torch.empty((8, 16), device=device)
    b = torch.empty((16, 4), device=device)
    out = flops_of(torch.mm, a, b)
    assert out == {"flops": 2.0 * 8 * 4 * 16, "transcendental": 0.0}
    assert flops_of(torch.einsum, "bmk,bkn->bmn", torch.empty(
        (3, 8, 16), device=device), torch.empty((3, 16, 4),
                                                device=device))["flops"] \
        == 2.0 * 3 * 8 * 4 * 16


def test_repeat_multiplies_by_length():
    """The reference's scan test: 5 steps of ``c + x @ x`` count 5 x
    (matmul + add), whether the loop runs or its body runs once under
    ``repeat(5)``."""
    xs = torch.randn(5, 8, 8)

    def loop():
        c = torch.zeros(8, 8)
        for x in xs:
            c = c + x @ x

    with FlopCounter() as looped:
        loop()
    with FlopCounter() as once:
        with once.repeat(5):
            xs[0] + xs[0] @ xs[0]
    want = 5 * (2.0 * 8 * 8 * 8 + 8 * 8)
    assert looped.flops == want and once.flops == want
    assert looped.matmul == once.matmul == 5 * 2.0 * 8 * 8 * 8


def test_transcendental_term():
    out = flops_of(torch.exp, torch.empty(10, device="meta"))
    assert out == {"flops": 10.0, "transcendental": 10.0}
    # an integer power is the reference's integer_pow, not a
    # transcendental; a softmax is its jnp composition
    x = torch.empty(4, 8, device="meta")
    assert flops_of(torch.pow, x, 2) == {"flops": 32.0,
                                         "transcendental": 0.0}
    assert flops_of(torch.softmax, x, -1) == {"flops": 5 * 32.0 + 4,
                                              "transcendental": 32.0}
    assert jflops.flops_of(lambda t: jax.nn.softmax(t, axis=-1),
                           _sds(4, 8)) == {"flops": 5 * 32.0 + 4,
                                           "transcendental": 32.0}


ATTN_CASES = [  # B, Sq, Skv, H, Hkv, D, causal, window, softcap, scale
    (1, 8, 8, 1, 1, 4, False, None, None, None),
    (2, 8, 8, 2, 1, 4, True, None, None, 0.5),
    (1, 8, 16, 2, 2, 4, True, 3, None, None),
    (1, 6, 7, 1, 1, 8, False, None, 5.0, 0.5),
    (2, 12, 12, 4, 2, 4, True, 5, 3.0, None),
]


@pytest.mark.parametrize("case", ATTN_CASES)
def test_attention_formula_is_the_reference_count(case):
    """``attention_flops`` == ``flops_of`` of the reference's plain
    attention: the dense version, and the chunked one (blocks of 4 at
    these shapes; ``dense_limit=0`` takes the chunked route)."""
    B, Sq, Skv, H, Hkv, D, causal, window, softcap, scale = case
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale)
    args = (_sds(B, Sq, H, D), _sds(B, Skv, Hkv, D), _sds(B, Skv, Hkv, D))
    dense = jflops.flops_of(lambda q, k, v: jref.flash_attention(
        q, k, v, **kw), *args)
    chunked = jflops.flops_of(lambda q, k, v: jref.chunked_attention(
        q, k, v, block_q=4, block_k=4, **kw), *args)
    got_d = attention_flops(B, Sq, Skv, H, D, **kw)
    got_c = attention_flops(B, Sq, Skv, H, D, dense_limit=0, block=4, **kw)
    for got, want in ((got_d, dense), (got_c, chunked)):
        assert {k: got[k] for k in want} == want


def test_flash_attention_counts_its_formula_on_every_route():
    """``ops.flash_attention`` counts ``attention_flops`` and nothing of
    its inside, on the CPU (dense, and chunked past the dense limit) and
    on ``meta`` (the plain route by an explicit branch: no kernel
    launch)."""
    g = torch.Generator().manual_seed(0)
    for B, S, H, Hkv, D, chunked in ((2, 64, 4, 2, 8, False),
                                     (1, 2100, 2, 1, 4, True)):
        assert (S * S > ops._DENSE_SCORE_LIMIT) == chunked
        want = attention_flops(B, S, S, H, D)
        for dev in ("cpu", "meta"):
            mk = lambda *s: torch.randn(s, generator=g).to(dev)  # noqa: E731
            q, k, v = mk(B, S, H, D), mk(B, S, Hkv, D), mk(B, S, Hkv, D)
            before = _flash.launches
            with FlopCounter() as c:
                out = ops.flash_attention(q, k, v)
            assert out.shape == q.shape and out.device.type == dev
            assert _flash.launches == before
            assert (c.flops, c.transcendental, c.matmul) == (
                want["flops"], want["transcendental"], want["matmul"])
            assert c.by_op == {"flash_attention": want["flops"]}


def test_meta_memo_is_exact():
    """A train step counted with the ``meta`` memo == without it: every
    op's count, for an MoE + MLA model and an xLSTM (reduced)."""
    for arch in ("deepseek-v2-236b", "xlstm-125m"):
        cfg = cfgs.get(arch).reduced()
        counts = []
        for memo in (True, False):
            p = lm.init_lm(0, cfg, device="meta").requires_grad_(True)
            batch = batch_struct(cfg, ShapeSpec("t", 32, 2, "train"))
            c = FlopCounter()
            if not memo:
                c._meta.run = lambda f, a, kw: f(*a, **kw)
            with c:
                make_train_step(cfg, OptimizerConfig())(
                    p, init_opt_state(p, OptimizerConfig()), batch)
            counts.append((c.flops, c.transcendental, c.matmul, c.by_op))
        assert counts[0] == counts[1], arch


def test_train_step_repeat_counts_the_loop():
    """``train_step(..., repeat=counter.repeat)`` (the body once, under
    ``repeat(microbatches)``) counts what the 4-microbatch loop counts."""
    cfg = cfgs.get("qwen2-1.5b").reduced()
    step = make_train_step(cfg, OptimizerConfig(), microbatches=4)
    got = []
    for once in (False, True):
        p = lm.init_lm(0, cfg, device="meta").requires_grad_(True)
        args = (p, init_opt_state(p, OptimizerConfig()),
                batch_struct(cfg, ShapeSpec("t", 16, 8, "train")))
        with FlopCounter() as c:
            step(*args, repeat=c.repeat if once else None)
        got.append((c.flops, c.transcendental, c.matmul, c.by_op))
    assert got[0] == got[1]


@pytest.mark.parametrize("arch", cfgs.names())
def test_meta_init_matches_cpu_init(arch):
    """``init_lm(..., device="meta")``: every leaf an empty ``meta``
    tensor with a CPU init's name, shape and dtype (reduced widths), and
    the reference's leaf paths alike."""
    cfg = cfgs.get(arch).reduced()
    meta = lm.init_lm(0, cfg, device="meta")
    cpu = lm.init_lm(0, cfg, device="cpu")
    m = dict(meta.named_parameters())
    c = dict(cpu.named_parameters())
    assert list(m) == list(c)
    for name, t in m.items():
        assert t.device.type == "meta", name
        assert (t.shape, t.dtype, t.requires_grad) == (
            c[name].shape, c[name].dtype, c[name].requires_grad), name
    assert list(meta.reference_leaves()) == list(cpu.reference_leaves())
    # the full-width build is shapes only, whatever its size
    full = lm.init_lm(0, cfgs.get(arch), device="meta")
    n = sum(t.numel() for t in full.parameters())
    assert n >= cfgs.get(arch).n_params() and all(
        t.device.type == "meta" for t in full.parameters())


def test_counter_on_a_train_step_sees_the_backward():
    """A train step on the CPU counts its backward and remat recompute:
    with ``remat="full"`` the forward products count twice."""
    cfg = cfgs.get("qwen2-1.5b").reduced()
    batch = {k: torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 16)), dtype=torch.int32)
        for k in ("tokens", "labels")}
    got = {}
    for remat in ("none", "full"):
        c = cfg.replace(remat=remat)
        p = lm.init_lm(0, c, device="cpu").requires_grad_(True)
        with FlopCounter() as fc:
            make_train_step(c, OptimizerConfig())(
                p, init_opt_state(p, OptimizerConfig()), batch)
        got[remat] = fc
    assert got["full"].matmul > got["none"].matmul
    assert got["full"].by_op["flash_attention"] == \
        2 * got["none"].by_op["flash_attention"]
    assert flops.ATTN_BLOCK == 1024
