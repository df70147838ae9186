"""The port's plain attention against the JAX Pallas kernel and oracle.

The same seeded numpy inputs go through ``repro.kernels`` (the Pallas
``flash_attention`` in interpret mode, ``ref.flash_attention``,
``ref.chunked_attention``) and ``repro_torch.kernels``, in float32 at the
shapes of ``tests/test_kernels.py``. Tolerances: 2e-3 against the Pallas
kernel (that test's own), 1e-5 against the JAX oracle (the same f32
arithmetic), 2e-4 chunked against dense (``tests/test_kernels.py``).
The CUDA kernel itself runs only on the card (``-m cuda``; the smoke
script holds it to this plain version there).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as fa_pallas  # noqa: E402,E501
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention as fa_wrapper  # noqa: E402,E501

SHAPES = [
    dict(B=1, Sq=64, Skv=64, H=4, Hkv=4, D=16, causal=True, window=None),
    dict(B=2, Sq=63, Skv=63, H=4, Hkv=1, D=32, causal=True, window=None),
    dict(B=1, Sq=128, Skv=128, H=2, Hkv=2, D=16, causal=True, window=17),
    dict(B=1, Sq=64, Skv=64, H=4, Hkv=2, D=16, causal=False, window=None),
    dict(B=1, Sq=16, Skv=80, H=2, Hkv=1, D=16, causal=True, window=None),
]


def _qkv(B, Sq, Skv, H, Hkv, D, seed, **_):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, H, D), dtype=np.float32)
    k = rng.standard_normal((B, Skv, Hkv, D), dtype=np.float32)
    v = rng.standard_normal((B, Skv, Hkv, D), dtype=np.float32)
    return q, k, v


def _port(fn, q, k, v, **kw):
    return fn(*(torch.from_numpy(a) for a in (q, k, v)), **kw).numpy()


@pytest.mark.parametrize("cfg", SHAPES, ids=lambda c: "-".join(
    f"{k}{v}" for k, v in c.items()))
@pytest.mark.parametrize("softcap", [None, 30.0])
def test_plain_matches_pallas_interpret(cfg, softcap):
    q, k, v = _qkv(seed=cfg["Sq"], **cfg)
    kw = dict(causal=cfg["causal"], window=cfg["window"], softcap=softcap)
    got = _port(ref.flash_attention, q, k, v, **kw)
    want = fa_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     block_q=32, block_k=32, interpret=True, **kw)
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("cfg", SHAPES, ids=lambda c: "-".join(
    f"{k}{v}" for k, v in c.items()))
@pytest.mark.parametrize("softcap", [None, 30.0])
def test_plain_matches_jax_oracle(cfg, softcap):
    q, k, v = _qkv(seed=cfg["Sq"] + 1, **cfg)
    kw = dict(causal=cfg["causal"], window=cfg["window"], softcap=softcap)
    got = _port(ref.flash_attention, q, k, v, **kw)
    want = jref.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), **kw)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("Sq,Skv,window", [(96, 96, None), (100, 100, 13),
                                           (64, 160, None)])
def test_chunked_matches_dense(Sq, Skv, window):
    q, k, v = _qkv(2, Sq, Skv, 4, 2, 16, seed=Sq + Skv)
    kw = dict(causal=True, window=window)
    got = _port(ref.chunked_attention, q, k, v, block_q=32, block_k=32, **kw)
    np.testing.assert_allclose(got, _port(ref.flash_attention, q, k, v,
                                          **kw), atol=2e-4, rtol=2e-4)
    want = jref.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), block_q=32, block_k=32,
                                  **kw)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=1e-5)


def test_bf16_is_the_f32_arithmetic_rounded_once():
    """bf16 inputs are upcast, every step runs in f32 and only the output
    is rounded: the result equals the f32 computation on the same values,
    cast to bf16."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(2, 40, 40, 4, 2, 32, seed=3))
    got = ref.flash_attention(q, k, v, causal=True, window=9, softcap=20.0)
    want = ref.flash_attention(q.float(), k.float(), v.float(), causal=True,
                               window=9, softcap=20.0).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


def test_ops_routes_cpu_to_the_plain_version_without_a_launch():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 48, 48, 4, 2, 16, 5))
    ops.reset_launch_counts()
    got = ops.flash_attention(q, k, v, causal=True, window=7)
    assert torch.equal(got, ref.flash_attention(q, k, v, causal=True,
                                                window=7))
    assert ops.launch_counts()["flash_attention"] == 0


def test_ops_takes_the_chunked_version_past_the_score_limit(monkeypatch):
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 80, 80, 4, 1, 16, 6))
    monkeypatch.setattr(ops, "_DENSE_SCORE_LIMIT", 64 * 64)
    got = ops.flash_attention(q, k, v, causal=True)
    assert torch.equal(got, ref.chunked_attention(q, k, v, causal=True))
    np.testing.assert_allclose(got.numpy(), ref.flash_attention(
        q, k, v, causal=True).numpy(), atol=2e-4, rtol=2e-4)
    monkeypatch.setattr(ops, "_DENSE_SCORE_LIMIT", 80 * 80)
    assert torch.equal(ops.flash_attention(q, k, v, causal=True),
                       ref.flash_attention(q, k, v, causal=True))


@pytest.mark.parametrize("bad,match", [
    (dict(dtype=torch.float64), "bfloat16 or float32"),
    (dict(H=6, Hkv=4), "H % Hkv"),
    (dict(D=264), "head dim"),
    (dict(transpose=True), "contiguous"),
])
def test_wrapper_raises_off_the_cpu_on_what_the_kernel_does_not_take(
        bad, match):
    """A tensor that is not on the CPU never falls back to the plain
    version: the wrapper checks and raises (meta tensors stand in for CUDA
    ones here)."""
    B, S, H, Hkv, D = 1, 8, bad.get("H", 4), bad.get("Hkv", 2), bad.get(
        "D", 16)
    dt = bad.get("dtype", torch.float32)
    q = torch.empty((B, S, H, D), dtype=dt, device="meta")
    k = torch.empty((B, S, Hkv, D), dtype=dt, device="meta")
    if bad.get("transpose"):
        q = torch.empty((B, H, S, D), dtype=dt, device="meta").transpose(1, 2)
    with pytest.raises(ValueError, match=match):
        fa_wrapper(q, k, k)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_on_the_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dt = getattr(torch, dtype)
    for cfg in SHAPES:
        q, k, v = (torch.from_numpy(a).cuda().to(dt)
                   for a in _qkv(seed=cfg["Sq"], **cfg))
        for softcap in (None, 30.0):
            kw = dict(causal=cfg["causal"], window=cfg["window"],
                      softcap=softcap)
            got = ops.flash_attention(q, k, v, **kw)
            want = ref.flash_attention(q, k, v, **kw)
            if dt == torch.float32:
                torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
            else:  # one bf16 ulp of the plain output + the f32 tolerance
                w = want.float()
                ulp = torch.ldexp(torch.ones_like(w),
                                  torch.frexp(w).exponent - 8)
                assert bool(((got.float() - w).abs() <= ulp + 1e-5).all())


# ---------------------------------------------------------------------------
# the arithmetic of the CUDA kernel's bf16 tensor-core body, emulated
# ---------------------------------------------------------------------------

EMU_CASES = [  # (e) and (f) of chip_smoke.FLASH_CASES in bf16, and GQA
    dict(B=3, Sq=100, Skv=100, H=4, Hkv=2, D=16, causal=True, window=5,
         softcap=None),
    dict(B=2, Sq=130, Skv=130, H=6, Hkv=3, D=72, causal=True, window=None,
         softcap=30.0),
    dict(B=2, Sq=96, Skv=160, H=8, Hkv=2, D=32, causal=True, window=None,
         softcap=None),
]
_L2E = 1.4426950408889634
_TILE = 64  # query rows of a warpgroup, keys of a tile


def bf16_close(got, want):
    """``chip_smoke.bf16_close``: within one bf16 ulp of the plain output
    plus 1e-5; also the share of elements more than one ulp apart."""
    w = want.float()
    ulp = torch.ldexp(torch.ones_like(w), torch.frexp(w).exponent - 8)
    d = (got.float() - w).abs()
    return bool((d <= ulp + 1e-5).all()), float((d > ulp).float().mean())


def split_p_emulation(q, k, v, *, causal, window, softcap, split=True):
    """The kernel's bf16 arithmetic in plain torch, f32 out: f32 logits of
    the bf16 inputs in log2 units, the online softmax per 64-key tile over
    64-row query tiles (tiles no row of the query tile sees are skipped;
    keys past Skv are zeros, masked), P split into ``bf16(P)`` and
    ``bf16(P - bf16(P))`` before the f32 product with V (``split=False``
    rounds P once), and ``acc * (1 / max(l, 1e-30))``."""
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    rep, scale = H // Hkv, D ** -0.5
    nk = -(-Skv // _TILE)
    pad = (0, 0, 0, 0, 0, nk * _TILE - Skv)
    kf = torch.nn.functional.pad(k.float(), pad).repeat_interleave(rep, 2)
    vf = torch.nn.functional.pad(v.float(), pad).repeat_interleave(rep, 2)
    out = torch.empty(B, Sq, H, D)
    for q0 in range(0, Sq, _TILE):
        r = min(_TILE, Sq - q0)
        qt = q[:, q0:q0 + r].float()
        pmin = q0 + Skv - Sq
        pos = torch.arange(pmin, pmin + r)[:, None]
        m = torch.full((B, H, r, 1), -1e30)
        l = torch.zeros(B, H, r, 1)
        acc = torch.zeros(B, H, r, D)
        for t in range(nk):
            k0 = t * _TILE
            live = not causal or k0 <= pmin + _TILE - 1
            if window:
                live = live and k0 + _TILE - 1 > pmin - window
            if not live:
                continue
            kt, vt = kf[:, k0:k0 + _TILE], vf[:, k0:k0 + _TILE]
            s = torch.einsum("bqhd,bkhd->bhqk", qt, kt)
            if softcap:
                s = softcap * torch.tanh(s * scale / softcap) * _L2E
            else:
                s = s * (scale * _L2E)
            kp = torch.arange(k0, k0 + _TILE)[None, :]
            keep = kp < Skv
            if causal:
                keep = keep & (kp <= pos)
            if window:
                keep = keep & (kp > pos - window)
            s = torch.where(keep, s, torch.tensor(-1e30))
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp2(s - m_new)
            alpha = torch.exp2(m - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            vh = vt.permute(0, 2, 1, 3)
            p_hi = p.to(torch.bfloat16).float()
            pv = p_hi @ vh
            if split:
                pv = pv + (p - p_hi).to(torch.bfloat16).float() @ vh
            acc = acc * alpha + pv
            m = m_new
        o = acc * (1.0 / torch.clamp(l, min=1e-30))
        out[:, q0:q0 + r] = o.permute(0, 2, 1, 3)
    return out


def _emu_inputs(cfg, seed):
    q, k, v = _qkv(seed=seed, **cfg)
    return tuple(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))


def _emu_id(cfg):
    return "-".join(f"{k}{v}" for k, v in cfg.items())


@pytest.mark.parametrize("cfg", EMU_CASES, ids=_emu_id)
def test_split_p_emulation_within_one_bf16_ulp_of_plain(cfg):
    """The kernel's arithmetic passes the smoke's bf16 rule against the
    plain version (f32 everywhere, cast once)."""
    q, k, v = _emu_inputs(cfg, 11)
    kw = dict(causal=cfg["causal"], window=cfg["window"],
              softcap=cfg["softcap"])
    got = split_p_emulation(q, k, v, **kw).to(torch.bfloat16)
    ok, beyond = bf16_close(got, ref.flash_attention(q, k, v, **kw))
    assert ok and beyond < 1e-2


@pytest.mark.parametrize("cfg", EMU_CASES, ids=_emu_id)
def test_split_p_emulation_matches_pallas_interpret(cfg):
    """... and against the Pallas kernel in interpret mode (bf16 in, P.V in
    f32, bf16 out)."""
    q, k, v = _emu_inputs(cfg, 12)
    kw = dict(causal=cfg["causal"], window=cfg["window"],
              softcap=cfg["softcap"])
    got = split_p_emulation(q, k, v, **kw).to(torch.bfloat16)
    want = fa_pallas(*(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                       for t in (q, k, v)),
                     block_q=32, block_k=32, interpret=True, **kw)
    ok, beyond = bf16_close(got, torch.from_numpy(
        np.array(want.astype(jnp.float32))))
    assert ok and beyond < 1e-2


@pytest.mark.parametrize("cfg", EMU_CASES, ids=_emu_id)
def test_split_p_keeps_f32_pv_where_one_rounding_does_not(cfg):
    """Before the output cast: the split P.V stays within 1e-5 of the plain
    f32 result; P rounded once to bf16 lands far further off."""
    q, k, v = _emu_inputs(cfg, 13)
    kw = dict(causal=cfg["causal"], window=cfg["window"],
              softcap=cfg["softcap"])
    want = ref.flash_attention(q.float(), k.float(), v.float(), **kw)
    err_split = float((split_p_emulation(q, k, v, **kw) - want).abs().max())
    err_once = float((split_p_emulation(q, k, v, split=False, **kw)
                      - want).abs().max())
    assert err_split <= 1e-5
    assert err_once >= 20 * err_split
