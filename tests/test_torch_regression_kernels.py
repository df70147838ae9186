"""The regression slice's plain kernel versions against the JAX kernels.

Seeded numpy inputs go through ``repro_torch.kernels`` (the plain
versions the wrappers run on CPU tensors) and through the Pallas kernels
in interpret mode plus ``repro.kernels.ref``. Tolerances are those of the
JAX package's own kernel tests: ``interval_sweep`` finite endpoints 1e-4
with the +-inf pattern exact; ``stream_update`` distances 1e-5 with BIG
patterns and labels exact. The CUDA kernels are held to these plain
versions on the card by ``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import regression as jreg  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.interval_sweep import interval_sweep as iv_pallas  # noqa: E402,E501
from repro.kernels.stream_update import stream_update as su_pallas  # noqa: E402,E501
from repro_torch.core.regression import topk_lowest  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

BIG = 1e29


def ill_conditioned(d, kth, live, a_prime, kth_label, a_test, k,
                    rel=1e-3):
    """``(.., m, n)`` live cells whose critical points f32 cannot pin
    down. The discriminant is a square: ``a_i^2`` when the test point
    does not enter row i's list (``b_i = 0``), ``(a_i + a/k)^2`` when it
    does (``b_i = -1/k``). Where that root is below f32 resolution of
    ``a`` the exact set is a point (or, at k == 1, where a test point and
    a training point are each other's nearest neighbours, the whole line
    reached through 0/0), and rounding alone decides what comes out. XLA
    contracts ``B1*B1 - A2*C0`` and ``a_i*a_i - a*a`` into FMAs; the port
    rounds every operation (as its CUDA kernel does), so there the two
    may disagree, and only there."""
    d, kth, live, a_prime, kth_label, a_test = (
        np.asarray(v) for v in (d, kth, live, a_prime, kth_label, a_test))
    lv = live[..., None, :]
    enters = lv & (d < kth[..., None, :])
    a = a_test.astype(np.float64)[..., :, None]
    ap = a_prime.astype(np.float64)[..., None, :]
    root = np.where(enters, ap + kth_label[..., None, :] / k + a / k, ap)
    return lv & (np.abs(root) <= rel * (1.0 + np.abs(a)))


def _assert_endpoints(got, want, name, skip=None):
    """+-inf pattern exact, finite values at 1e-4, outside ``skip``."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, name
    if skip is not None:
        got, want = got[~skip], want[~skip]
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin, err_msg=name)
    np.testing.assert_array_equal(got[~fin], want[~fin], err_msg=name)
    np.testing.assert_allclose(got[fin], want[fin], atol=1e-4, rtol=1e-4,
                               err_msg=name)


def _iv_inputs(seed, S, n, m, p, dead_tail):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    X = rng.standard_normal((S, n, p)).astype(f32)
    a_prime = rng.standard_normal((S, n)).astype(f32)
    kth = rng.uniform(0.5, 4.0, (S, n)).astype(f32)
    kth_label = rng.standard_normal((S, n)).astype(f32)
    live = np.broadcast_to(np.arange(n) < n - dead_tail, (S, n)).copy()
    Xt = rng.standard_normal((S, m, p)).astype(f32)
    a_test = rng.standard_normal((S, m)).astype(f32)
    return X, a_prime, kth, kth_label, live, Xt, a_test


@pytest.mark.parametrize("n,m,k,dead_tail", [
    (64, 4, 7, 0), (128, 7, 1, 17), (100, 33, 3, 5)])
def test_interval_endpoints_match_jax(n, m, k, dead_tail):
    """Per tenant: the port's batched plain version against the Pallas
    kernel (interpret mode) and the JAX plain version, on every cell but
    the few ill-conditioned ones (at most 2 %; see ``ill_conditioned``)."""
    S, p = 3, 6
    args = _iv_inputs(n + k, S, n, m, p, dead_tail)
    X, a_prime, kth, kth_label, live, Xt, a_test = args
    lo, hi = ops.interval_sweep(*[torch.from_numpy(a) for a in args], k)
    assert lo.shape == (S, m, n)
    d = torch.sqrt(torch.clamp(ref.sq_dists(torch.from_numpy(Xt),
                                            torch.from_numpy(X)), min=0.0))
    ill = ill_conditioned(d, kth, live, a_prime, kth_label, a_test, k)
    assert ill.mean() <= 0.02
    for s in range(S):
        one = [jnp.asarray(a[s]) for a in args]
        want = iv_pallas(*one, k=k, block_m=64, block_n=64, interpret=True)
        want_ref = jref.reg_interval_endpoints(*one, k)
        for got, w, wr, name in zip((lo[s], hi[s]), want, want_ref,
                                    ("lo", "hi")):
            _assert_endpoints(got.numpy(), w, name, skip=ill[s])
            _assert_endpoints(got.numpy(), wr, "ref " + name, skip=ill[s])
        assert bool(torch.isinf(lo[s, :, n - dead_tail:]).all())


@pytest.mark.parametrize("k", [1, 3, 7])
def test_interval_ge_matches_jax_on_every_branch(k):
    """Both branches of the root computation (quadratic for k > 1,
    linear for k == 1), empty sets and exact zeros, elementwise."""
    rng = np.random.default_rng(k)
    a_i = np.concatenate([rng.standard_normal(200), [0.0, 0.0, 1.0, -2.0]])
    a = np.concatenate([rng.standard_normal(200), [0.0, 1.0, 1.0, 2.0]])
    b_i = np.where(rng.random(204) < 0.5, -1.0 / k, 0.0)
    a_i, a, b_i = (v.astype(np.float32) for v in (a_i, a, b_i))
    want = jax.vmap(jreg._interval_ge)(a_i, b_i, a)
    got = ref.interval_ge(*map(torch.from_numpy, (a_i, b_i, a)))
    for g, w, name in zip(got, want, ("lo", "hi")):
        _assert_endpoints(g.numpy(), w, name)
    # k == 1 is the linear branch: half-lines, one end infinite
    assert bool((torch.isinf(got[0]) | torch.isinf(got[1])).any()) == (k == 1)


def test_interval_sweep_batched_equals_per_tenant_and_shared_queries():
    """A tenant's bits do not depend on the batch; a query batch shared
    by every tenant (tenant stride 0) is read as its copies."""
    S, n, m, p, k = 4, 40, 6, 5, 3
    args = [torch.from_numpy(a) for a in _iv_inputs(9, S, n, m, p, 3)]
    lo, hi = ops.interval_sweep(*args, k)
    for s in range(S):
        one = ops.interval_sweep(*[a[s:s + 1] for a in args], k)
        assert torch.equal(one[0][0], lo[s]) and torch.equal(one[1][0], hi[s])
    shared = args[5][:1].expand(S, m, p)
    got = ops.interval_sweep(*args[:5], shared, args[6], k)
    want = ops.interval_sweep(*args[:5], shared.contiguous(), args[6], k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert ops.launch_counts()["interval_sweep"] == 0  # plain on the CPU


def _su_reg_inputs(seed, S, cap, p, k):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    X = rng.standard_normal((S, cap, p)).astype(f32)
    y = rng.standard_normal((S, cap)).astype(f32)
    nbr_d = np.sort(rng.uniform(0.5, 4.5, (S, cap, k)), -1).astype(f32)
    short = rng.random((S, cap)) < 0.2  # lists not yet full: BIG tails
    nbr_d[..., k // 2:][short] = 1e30
    nbr_y = rng.standard_normal((S, cap, k)).astype(f32)
    x_new = rng.standard_normal((S, p)).astype(f32)
    y_new = rng.standard_normal(S).astype(f32)
    return X, y, nbr_d, nbr_y, x_new, y_new


@pytest.mark.parametrize("cap,k,wrap", [(128, 7, 128), (64, 3, 48),
                                        (40, 1, 40)])
def test_stream_update_reg_matches_jax_on_wrapped_rings(cap, k, wrap):
    """Batched reg mode (per-tenant heads, some rings wrapped past the
    block start, one empty) against the interpret-mode Pallas kernel per
    tenant: distances 1e-5 with BIG patterns exact, labels exact."""
    S, p = 5, 8
    args = _su_reg_inputs(cap + k, S, cap, p, k)
    head = np.array([0, wrap - 3, wrap // 2, 5, 1], np.int32)
    n = np.array([wrap, 9, wrap - 1, 0, wrap // 3], np.int32)
    wraps = np.full(S, wrap, np.int32)
    assert (head + n > wrap).any()
    t = [torch.from_numpy(a) for a in args]
    got = ops.stream_update(*t, torch.from_numpy(n), mode="reg",
                            head=torch.from_numpy(head),
                            wrap=torch.from_numpy(wraps))
    slow = ref.stream_update(*t, torch.from_numpy(n), mode="reg",
                             head=torch.from_numpy(head),
                             wrap=torch.from_numpy(wraps))
    for g, sl in zip(got, slow):
        assert torch.equal(g, sl)  # sortless form == sorting form
    for s in range(S):
        want = su_pallas(*[jnp.asarray(a[s]) for a in args],
                         jnp.int32(n[s]), mode="reg", block_n=32,
                         interpret=True, head=jnp.int32(head[s]),
                         wrap=jnp.int32(wrap))
        for i, name in ((0, "d_row"), (1, "nbr_d")):
            g, w = got[i][s].numpy(), np.asarray(want[i])
            big = w >= BIG
            np.testing.assert_array_equal(g >= BIG, big, err_msg=name)
            np.testing.assert_allclose(g[~big], w[~big], atol=1e-5,
                                       rtol=1e-5, err_msg=name)
        np.testing.assert_array_equal(got[2][s].numpy(), np.asarray(want[2]),
                                      err_msg="nbr_y")
        assert int((got[0][s] < BIG).sum()) == n[s]


def test_stream_update_reg_tie_case_exact():
    """One-hot rows at distance exactly 1.0 from the zero query and lists
    holding exact 1.0 entries: the strict gate keeps the incumbent and
    the labels follow bit for bit, batched as the engine calls it."""
    cap, p, k, n = 16, 8, 3, 12
    X = np.broadcast_to(np.eye(cap, p, dtype=np.float32), (2, cap, p))
    nbr_d = np.tile(np.float32([0.5, 1.0, 1.0]), (2, cap, 1))
    nbr_d[:, 5] = [1.0, 1.0, 2.0]
    nbr_d[:, 6] = [0.25, 0.5, 1e30]
    nbr_y = np.arange(2 * cap * k, dtype=np.float32).reshape(2, cap, k)
    y = np.tile(np.linspace(-1.0, 1.0, cap, dtype=np.float32), (2, 1))
    x_new, y_new = np.zeros((2, p), np.float32), np.float32([9.0, -9.0])
    args = (X, y, nbr_d, nbr_y, x_new, y_new)
    got = ops.stream_update(*[torch.from_numpy(a.copy()) for a in args],
                            torch.full((2,), n, dtype=torch.int32),
                            mode="reg",
                            head=torch.tensor([0, 9], dtype=torch.int32),
                            wrap=torch.full((2,), cap, dtype=torch.int32))
    for s, hd in enumerate((0, 9)):
        want = su_pallas(*[jnp.asarray(a[s]) for a in args], jnp.int32(n),
                         mode="reg", block_n=8, interpret=True,
                         head=jnp.int32(hd), wrap=jnp.int32(cap))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[s].numpy(), np.asarray(w))


@pytest.mark.parametrize("n,k", [(30, 5), (12, 12), (50, 1), (64, 7)])
def test_topk_lowest_breaks_ties_like_jax_top_k(n, k):
    """Quantized values with many exact ties and BIG padding: the port's
    selection picks the same indices as ``jax.lax.top_k(-d, k)``."""
    rng = np.random.default_rng(n + k)
    d = (np.round(rng.random((3, n)) * 8.0) / 8.0).astype(np.float32)
    d[:, : n // 3] = d[:, n // 3: 2 * (n // 3)][:, : n // 3]
    d[1, -4:] = 1e30
    neg, idx = jax.lax.top_k(-jnp.asarray(d), k)
    vals, got = topk_lowest(torch.from_numpy(d), k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(idx))
    np.testing.assert_array_equal(vals.numpy(), -np.asarray(neg))


def test_cuda_only_entry_points_are_routed_by_device():
    """On a CPU tensor every wrapper runs its plain version, float64
    included; the per-mode launch counts stay at zero."""
    S, cap, p, k = 2, 16, 3, 3
    args = [torch.from_numpy(a).double()
            for a in _su_reg_inputs(1, S, cap, p, k)]
    out = ops.stream_update(*args, torch.full((S,), 10, dtype=torch.int32),
                            mode="reg")
    assert all(o.dtype == torch.float64 for o in out)
    with pytest.raises(ValueError, match="mode"):
        ops.stream_update(*args, torch.full((S,), 10, dtype=torch.int32),
                          mode="rank")
    counts = ops.launch_counts()
    assert counts["stream_update_reg"] == counts["interval_sweep"] == 0


def _every_exponent(sign: float) -> torch.Tensor:
    """float32 values of one sign over every exponent (subnormals and 0
    at the bottom, infinity at the top, no NaN), each with several
    mantissas."""
    mant = np.array([0, 1, 2, 0x155555, 0x400000, 0x7ffffe, 0x7fffff],
                    np.int64)
    bits = (np.arange(255, dtype=np.int64)[:, None] << 23 | mant).ravel()
    bits = np.append(bits, 255 << 23)  # +inf
    x = torch.from_numpy(bits.astype(np.int32)).view(torch.float32)
    return x if sign > 0 else -x


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_division_by_minus_one_is_negation_bitwise(sign):
    """The kernel's rewrite where ``b_i = 0``: ``x / f32(-1) == -x`` bit for
    bit for every non-NaN float32 (every exponent, both signs, +-0, +-inf
    and subnormals), so the roots there are negations."""
    x = _every_exponent(sign)
    assert bool(torch.isfinite(x[:-1]).all()) and bool(torch.isinf(x[-1]))
    assert bool((x[:7] == 0).any()) and bool(((x != 0) & (x.abs() < 1.2e-38))
                                             .any())
    q = x / torch.tensor(-1.0, dtype=torch.float32)
    assert torch.equal(q.view(torch.int32), (-x).view(torch.int32))


def _interval_ge_negating(a_i, b_i, a, negate, eps=1e-12):
    """``ref.interval_ge`` as the CUDA kernel computes it: where ``negate``
    (the kernel: ``b_i == 0``, so ``A2 = -1``) ``A2 * C0`` is ``-C0`` and
    the roots are negations; elsewhere the divisions by ``A2``. Every
    other operation as the plain version, one rounding each."""
    inf = float("inf")
    A2 = b_i * b_i - 1.0
    B1 = a_i * b_i - a
    C0 = a_i * a_i - a * a
    disc = B1 * B1 - torch.where(negate, -C0, A2 * C0)
    sq = torch.sqrt(disc)  # NaN where not real, then unused
    n1, n2 = -B1 + sq, -B1 - sq
    r1 = torch.where(negate, -n1, n1 / A2)
    r2 = torch.where(negate, -n2, n2 / A2)
    real = disc >= 0.0
    lo = torch.where(real, torch.minimum(r1, r2), inf)
    hi = torch.where(real, torch.maximum(r1, r2), -inf)
    t0 = -C0 / (2.0 * B1)
    flat_lo = torch.where(C0 >= 0.0, -inf, inf)
    lin_lo = torch.where(B1 > eps, t0, torch.where(B1 < -eps, -inf, flat_lo))
    lin_hi = torch.where(B1 > eps, inf, torch.where(B1 < -eps, t0, -flat_lo))
    quad = A2.abs() >= eps
    return torch.where(quad, lo, lin_lo), torch.where(quad, hi, lin_hi)


def _sweep_kernel_schedule(X, a_prime, kth, kth_label, live, Xt, a_test, k):
    """``interval_sweep`` in the CUDA kernel's order, plain torch: every
    row's and column's norm once, the dot products over the features in
    order, ``d`` from the clamped ``(|x|^2 + |X|^2) - 2 x.X``, the column's
    update ``a' + kth_label / k`` and its products hoisted, then
    ``_interval_ge_negating`` where ``b_i = 0``."""
    a2, b2 = ref._sumsq(Xt), ref._sumsq(X)
    ab = torch.zeros(Xt.shape[:-1] + (X.shape[-2],))
    for f in range(X.shape[-1]):
        ab = ab + Xt[..., :, None, f] * X[..., None, :, f]
    d2 = (a2[..., :, None] + b2[..., None, :]) - 2.0 * ab
    d = torch.sqrt(torch.clamp(d2, min=0.0))
    lv = live[..., None, :]
    e = lv & (d < kth[..., None, :])
    upd = a_prime + ref.div_k(kth_label, k)
    a_i = torch.where(e, upd[..., None, :], a_prime[..., None, :])
    b_i = torch.where(e, torch.tensor(-1.0 / k), torch.tensor(0.0))
    lo, hi = _interval_ge_negating(a_i, b_i, a_test[..., :, None], b_i == 0)
    inf = float("inf")
    return torch.where(lv, lo, inf), torch.where(lv, hi, -inf)


def _sweep_ties(seed, S, n, m, p, dead_tail):
    """``_iv_inputs`` with ties: k-th distances set to a realised distance
    (the strict ``d < kth`` gate), ``a_test`` +0 and -0, one ``a'`` 0."""
    args = [torch.from_numpy(a) for a in _iv_inputs(seed, S, n, m, p,
                                                    dead_tail)]
    X, a_prime, kth, _, _, Xt, a_test = args
    d = torch.sqrt(torch.clamp(ref.sq_dists(Xt, X), min=0.0))
    kth[:, ::5] = d[:, 0, ::5]
    a_test[:, 1], a_test[:, 2] = 0.0, -0.0
    a_prime[:, 3] = 0.0
    return args


@pytest.mark.parametrize("n,m,k,dead_tail", [
    (64, 4, 7, 0), (130, 7, 1, 17), (100, 33, 3, 5), (129, 65, 2, 0)])
def test_interval_sweep_kernel_schedule_bitwise(n, m, k, dead_tail):
    """The kernel's order (norms once, hoisted column products, negations
    where ``b_i = 0``) gives ``ref.reg_interval_endpoints``' bits, signed
    zeros included, with ties, dead columns, k = 1's linear branch and a
    shared query batch."""
    S, p = 2, 6
    args = _sweep_ties(n + m + k, S, n, m, p, dead_tail)
    for Xt in (args[5], args[5][:1].expand(S, m, p)):
        a = args[:5] + [Xt, args[6]]
        want = ref.reg_interval_endpoints(*a, k)
        got = _sweep_kernel_schedule(*a, k)
        for g, w in zip(got, want):
            assert torch.equal(g.view(torch.int32), w.view(torch.int32))
        assert bool(torch.isfinite(want[0]).any())


def test_negation_rewrite_needs_b_zero_mutation():
    """The rewrite is exact only where ``b_i`` is 0: applied where ``b_i``
    is a small nonzero (``A2`` is then not -1), the emulation no longer
    gives ``ref.interval_ge``'s bits, while the kernel's condition does."""
    rng = np.random.default_rng(5)
    a_i = torch.from_numpy(rng.standard_normal(600).astype(np.float32))
    a = torch.from_numpy(rng.standard_normal(600).astype(np.float32))
    b_i = torch.from_numpy(rng.choice(
        np.float32([0.0, -1.0 / 7, 0.01, -0.01]), 600))
    want = ref.interval_ge(a_i, b_i, a)

    def same(negate):
        got = _interval_ge_negating(a_i, b_i, a, negate)
        return all(torch.equal(g.view(torch.int32), w.view(torch.int32))
                   for g, w in zip(got, want))

    assert same(b_i == 0)
    assert not same(b_i.abs() < 0.05)  # the mutation: b_i tiny, not 0


@pytest.mark.cuda
@pytest.mark.parametrize("S,m,n,p,k", [(64, 100, 1024, 30, 7),
                                       (3, 1, 130, 5, 1),
                                       (3, 65, 1023, 37, 7),
                                       (2, 129, 130, 30, 1)])
def test_interval_sweep_kernel_matches_plain_on_the_card(S, m, n, p, k):
    """The CUDA kernel == ``ref.reg_interval_endpoints`` bitwise: rows and
    columns around the 64 x 128 tiles, n a multiple of 4 (16-byte stores)
    or not, p around the 32-feature chunks, k = 1's linear branch, dead
    columns, a tenant stride of 0; and its square root == ``torch.sqrt``
    on every float32 exponent."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from repro_torch.kernels.interval_sweep import interval_sweep, sqd_sqrt

    args = [a.cuda() for a in _sweep_ties(S + m + n, S, n, m, p, n // 9)]
    for Xt in (args[5], args[5][:1].expand(S, m, p)):
        a = args[:5] + [Xt, args[6]]
        got = interval_sweep(*a, k=k)
        want = ref.reg_interval_endpoints(*a, k)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    x = torch.cat([_every_exponent(1.0), _every_exponent(-1.0)]).cuda()
    r, w = sqd_sqrt(x), torch.sqrt(x)
    assert torch.equal(r.isnan(), w.isnan())
    assert torch.equal(r[~w.isnan()].view(torch.int32),
                       w[~w.isnan()].view(torch.int32))
