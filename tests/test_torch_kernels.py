"""The port's plain kernel versions against the JAX kernels.

The same seeded numpy inputs go through ``repro_torch.kernels.ref`` and
through the Pallas kernels in interpret mode plus ``repro.kernels.ref``.
Tolerance 1e-5 on float outputs (the frameworks sum in different
orders); counts, BIG sentinels and the tie case match exactly. The CUDA
kernels themselves are held to these plain versions on the card by
``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.cp_update import cp_knn_counts as cp_pallas  # noqa: E402
from repro.kernels.pairwise_dist import pairwise_sq_dists  # noqa: E402
from repro.kernels.stream_update import stream_update as su_pallas  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

BIG = 1e29


def _assert_close_big(got, want, name):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, name
    big = want >= BIG
    np.testing.assert_array_equal(got[big], want[big], err_msg=name)
    np.testing.assert_allclose(got[~big], want[~big], atol=1e-5, rtol=1e-5,
                               err_msg=name)


def _su_inputs(seed, cap, p, k, mode):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((cap, p)).astype(np.float32)
    nbr_d = np.sort(rng.uniform(0.1, 3.0, (cap, k)), 1).astype(np.float32)
    nbr_y = rng.standard_normal((cap, k)).astype(np.float32)
    x_new = rng.standard_normal(p).astype(np.float32)
    if mode == "class":
        y, y_new = rng.integers(0, 3, cap).astype(np.int32), np.int32(1)
    else:
        y, y_new = rng.standard_normal(cap).astype(np.float32), np.float32(.25)
    return X, y, nbr_d, nbr_y, x_new, y_new


@pytest.mark.parametrize("cap,k,n,head,wrap", [
    (64, 5, 40, None, None),  # linear layout
    (32, 4, 0, None, None),   # empty window
    (64, 5, 40, 30, 64),      # wrapped over the full capacity
    (64, 3, 20, 15, 24),      # window-confined ring: slots >= wrap inert
    (70, 4, 24, 23, 24),      # full confined ring, head mid-block
])
@pytest.mark.parametrize("mode", ["class", "reg"])
def test_stream_update_matches_jax(cap, k, n, head, wrap, mode):
    args = _su_inputs(cap + k, cap, 6, k, mode)
    jkw, tkw = {}, {}
    if head is not None:
        jkw = dict(head=jnp.int32(head), wrap=jnp.int32(wrap))
        tkw = dict(head=torch.tensor(head, dtype=torch.int32),
                   wrap=torch.tensor(wrap, dtype=torch.int32))
    jargs = [jnp.asarray(a) for a in args] + [jnp.int32(n)]
    want = su_pallas(*jargs, mode=mode, block_n=32, interpret=True, **jkw)
    want_ref = jref.stream_update(*jargs, mode=mode, **jkw)
    targs = [torch.from_numpy(np.array(a)) for a in args]
    tn = torch.tensor(n, dtype=torch.int32)
    slow = ref.stream_update(*targs, tn, mode=mode, **tkw)
    fast = ref.stream_update_fast(*targs, tn, mode=mode, **tkw)
    for i, name in enumerate(["d_row", "nbr_d", "nbr_y"]):
        np.testing.assert_array_equal(fast[i].numpy(), slow[i].numpy(),
                                      err_msg="fast " + name)
        _assert_close_big(slow[i].numpy(), want[i], name)
        _assert_close_big(slow[i].numpy(), want_ref[i], "ref " + name)
    assert int((slow[0] < BIG).sum()) == n


@pytest.mark.parametrize("mode", ["class", "reg"])
def test_stream_update_tie_rule_exact(mode):
    """One-hot rows at distance exactly 1.0 from the zero query, lists
    stuffed with exact 1.0 entries: insert-after-equals, bit for bit."""
    cap, p, k, n = 16, 8, 3, 12
    X = np.eye(cap, p, dtype=np.float32)
    x_new = np.zeros(p, np.float32)
    nbr_d = np.tile(np.asarray([0.5, 1.0, 1.0], np.float32), (cap, 1))
    nbr_d[5] = [1.0, 1.0, 2.0]
    nbr_d[6] = [0.25, 0.5, 1e30]
    nbr_y = np.arange(cap * k, dtype=np.float32).reshape(cap, k)
    if mode == "class":
        y, y_new = np.zeros(cap, np.int32), np.int32(0)
    else:
        y = np.linspace(-1.0, 1.0, cap).astype(np.float32)
        y_new = np.float32(9.0)
    args = (X, y, nbr_d, nbr_y, x_new, y_new)
    want = su_pallas(*map(jnp.asarray, args), jnp.int32(n), mode=mode,
                     block_n=8, interpret=True)
    targs = [torch.from_numpy(np.array(a)) for a in args]
    for fn in (ref.stream_update, ref.stream_update_fast):
        got = fn(*targs, torch.tensor(n, dtype=torch.int32), mode=mode)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_stream_update_batched_equals_per_tenant():
    """The batched form (tenant axis written out, per-tenant ring
    scalars) gives each tenant the bits of its unbatched call."""
    S, cap, p, k = 4, 24, 5, 3
    per = [_su_inputs(40 + s, cap, p, k, "class") for s in range(S)]
    heads = np.array([0, 5, 23, 11], np.int32)
    ns = np.array([0, 9, 16, 16], np.int32)
    wrap = np.full(S, 16, np.int32)
    stack = [torch.from_numpy(np.stack([a[i] for a in per]))
             for i in range(6)]
    got = ops.stream_update(*stack[:4], stack[4], stack[5],
                            torch.from_numpy(ns), mode="class",
                            head=torch.from_numpy(heads),
                            wrap=torch.from_numpy(wrap))
    for s in range(S):
        one = ops.stream_update(
            *[torch.from_numpy(np.array(a))[None] for a in per[s][:5]],
            torch.tensor([per[s][5]]), torch.tensor([ns[s]]), mode="class",
            head=torch.tensor([heads[s]]), wrap=torch.tensor([wrap[s]]))
        for g, o in zip(got[:2], one[:2]):
            assert torch.equal(g[s], o[0])
    assert ops.launch_counts() == {"stream_update_class": 0,
                                   "stream_update_reg": 0,
                                   "pairwise_sq_dists": 0,
                                   "cp_knn_counts": 0,
                                   "interval_sweep": 0,
                                   "kde_rowsums": 0,
                                   "flash_attention": 0,
                                   "boot_fit_forest": 0,
                                   "boot_forest_predict": 0}


@pytest.mark.parametrize("m,n,p", [(8, 8, 4), (65, 33, 7), (128, 256, 30)])
def test_sq_dists_matches_jax(m, n, p):
    rng = np.random.default_rng(m * n)
    A = rng.standard_normal((m, p)).astype(np.float32)
    B = rng.standard_normal((n, p)).astype(np.float32)
    want = pairwise_sq_dists(jnp.asarray(A), jnp.asarray(B), block_m=64,
                             block_n=64, interpret=True)
    got = ops.sq_dists(torch.from_numpy(A)[None],
                       torch.from_numpy(B)[None])[0].numpy()
    scale = (A * A).sum(1)[:, None] + (B * B).sum(1)[None, :]
    assert np.abs(got - np.asarray(want)).max() <= 1e-5 * scale.max()
    np.testing.assert_allclose(got, np.asarray(jref.sq_dists(A, B)),
                               atol=1e-4, rtol=1e-5)
    # row-decomposable: a row computed alone is the same bits
    for i in (0, m // 2, m - 1):
        alone = ref.sq_dists(torch.from_numpy(A[i:i + 1]),
                             torch.from_numpy(B)).numpy()
        np.testing.assert_array_equal(alone[0], got[i])


@pytest.mark.parametrize("n,m,l,dead", [(64, 4, 2, 0), (130, 7, 3, 17)])
def test_cp_knn_counts_matches_jax(n, m, l, dead):
    """Exact counts; ``dead`` trailing columns carry the -1 / -BIG
    sentinels of non-live slots and are never counted."""
    rng = np.random.default_rng(n)
    X = rng.standard_normal((n, 5)).astype(np.float32)
    y = rng.integers(0, l, n).astype(np.int32)
    Xt = rng.standard_normal((m, 5)).astype(np.float32)
    sum_same = rng.uniform(1.0, 4.0, n).astype(np.float32)
    kth = rng.uniform(0.5, 2.0, n).astype(np.float32)
    alpha = rng.uniform(1.0, 3.0, (m, l)).astype(np.float32)
    if dead:
        y[-dead:], sum_same[-dead:], kth[-dead:] = -1, -1e30, -1e30
    args = (X, y, sum_same, kth, Xt, alpha)
    want = cp_pallas(*map(jnp.asarray, args), n_labels=l, interpret=True)
    np.testing.assert_array_equal(
        np.asarray(want), np.asarray(jref.cp_knn_counts(*args)))
    got = ops.cp_knn_counts(*[torch.from_numpy(a)[None] for a in args],
                            l)[0]
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the batched form over a leading tenant axis
    bat = ops.cp_knn_counts(*[torch.from_numpy(np.stack([a, a]))
                              for a in args], l)
    np.testing.assert_array_equal(bat[1].numpy(), np.asarray(want))


def _pairwise_tiled(A, B, BM=64, BN=128, PC=32):
    """The CUDA kernel's schedule in plain torch: every row's squared norm
    once (a first pass, ``ref._sumsq``'s order), then 64 x 128 output
    tiles whose dot products run over 32-feature chunks in feature order,
    each output combined as ``(|a|^2 + |b|^2) - 2 a.b``."""
    S, m, p = A.shape
    n = B.shape[1]
    a2, b2 = ref._sumsq(A), ref._sumsq(B)
    out = A.new_empty((S, m, n))
    for r0 in range(0, m, BM):
        for c0 in range(0, n, BN):
            a, b = A[:, r0:r0 + BM], B[:, c0:c0 + BN]
            acc = A.new_zeros((S, a.shape[1], b.shape[1]))
            for k0 in range(0, p, PC):
                for f in range(k0, min(k0 + PC, p)):
                    acc = acc + a[..., :, None, f] * b[..., None, :, f]
            out[:, r0:r0 + BM, c0:c0 + BN] = (
                a2[:, r0:r0 + BM, None] + b2[:, None, c0:c0 + BN]) - 2.0 * acc
    return out


@pytest.mark.parametrize("S,m,n,p", [(3, 100, 300, 30), (2, 65, 131, 37),
                                     (1, 1, 129, 5)])
def test_pairwise_norms_once_equals_plain_bitwise(S, m, n, p):
    """The norms computed once and the tiled, chunked products give
    ``ref.sq_dists``' bits; a row computed alone, and a query batch shared
    by every tenant (tenant stride 0), give the same bits."""
    rng = np.random.default_rng(S * m + n + p)
    A = torch.from_numpy(rng.standard_normal((S, m, p)).astype(np.float32))
    B = torch.from_numpy(rng.standard_normal((S, n, p)).astype(np.float32))
    want = ref.sq_dists(A, B)
    assert torch.equal(_pairwise_tiled(A, B), want)
    for i in (0, m // 2, m - 1):
        assert torch.equal(_pairwise_tiled(A[:, i:i + 1], B),
                           want[:, i:i + 1])
    shared = A[:1].expand(S, m, p)
    assert torch.equal(_pairwise_tiled(shared, B), ref.sq_dists(shared, B))


@pytest.mark.cuda
@pytest.mark.parametrize("S,m,n,p", [(64, 100, 1024, 30), (3, 2684, 4003, 30),
                                     (2, 65, 131, 37), (4, 1, 129, 5)])
def test_pairwise_kernel_matches_plain_on_the_card(S, m, n, p):
    """The CUDA kernel == ``ref.sq_dists`` bitwise, n a multiple of 4 (the
    16-byte stores) or not, rows alone and a tenant stride of 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from repro_torch.kernels.pairwise_dist import pairwise_sq_dists

    g = torch.Generator(device="cuda").manual_seed(S + m + n)
    A = torch.randn((S, m, p), generator=g, device="cuda")
    B = torch.randn((S, n, p), generator=g, device="cuda")
    got = pairwise_sq_dists(A, B)
    assert torch.equal(got, ref.sq_dists(A, B))
    for i in (0, m - 1):
        assert torch.equal(pairwise_sq_dists(A[:, i:i + 1], B),
                           got[:, i:i + 1])
    shared = A[:1].expand(S, m, p)
    assert torch.equal(pairwise_sq_dists(shared, B),
                       ref.sq_dists(shared, B))


def _cp_counts_blocked(X, y, sum_same, kth_same, X_test, alpha, BN=128,
                       LG=4):
    """``cp_knn_counts`` in the CUDA kernel's schedule, plain torch: the
    columns in chunks of 128, the last padded with label -1 and NaN sum
    and k-th distance (a NaN score never reaches ``>=``); the labels in
    groups of 4, each group's alphas NaN past L; every chunk's counts
    added (integers: any order is exact)."""
    S, n, p = X.shape
    L = alpha.shape[-1]
    pad = -n % BN
    nan = float("nan")
    Xp = torch.cat([X, X.new_zeros((S, pad, p))], 1)
    yp = torch.cat([y, y.new_full((S, pad), -1)], 1)
    sp = torch.cat([sum_same, sum_same.new_full((S, pad), nan)], 1)
    kp = torch.cat([kth_same, kth_same.new_full((S, pad), nan)], 1)
    counts = torch.zeros(alpha.shape, dtype=torch.int32)
    for l0 in range(0, L, LG):
        al = torch.full(alpha.shape[:-1] + (LG,), nan)
        al[..., :min(LG, L - l0)] = alpha[..., l0:l0 + LG]
        for c0 in range(0, n + pad, BN):
            sl = slice(c0, c0 + BN)
            d = torch.sqrt(torch.clamp(ref.sq_dists(X_test, Xp[:, sl]),
                                       min=0.0))  # (S, m, BN)
            v = torch.where(d < kp[:, None, sl], (sp - kp)[:, None, sl] + d,
                            sp[:, None, sl])
            for lg in range(min(LG, L - l0)):
                a = torch.where((yp[:, None, sl] - l0) == lg, v,
                                sp[:, None, sl])
                counts[..., l0 + lg] += (a >= al[..., lg:lg + 1]).sum(
                    -1, dtype=torch.int32)
    return counts


@pytest.mark.parametrize("n,m,L,dead", [(130, 7, 1, 9), (256, 65, 2, 0),
                                        (300, 5, 5, 30), (129, 3, 16, 4)])
def test_cp_counts_padded_grouped_schedule_exact(n, m, L, dead):
    """The kernel's schedule (128-column chunks padded with NaN scores,
    labels in groups of 4 with NaN alphas past L) counts exactly what
    ``ref.cp_knn_counts`` counts, with ties at the strict ``d < kth`` gate
    and at the ``>=`` of the counts, dead columns and a shared query
    batch."""
    rng = np.random.default_rng(n + m + L)
    S, p = 2, 6
    X = torch.from_numpy(rng.standard_normal((S, n, p)).astype(np.float32))
    Xt = torch.from_numpy(rng.standard_normal((S, m, p)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, L, (S, n)).astype(np.int32))
    kth = torch.from_numpy(rng.uniform(2.0, 4.0, (S, n)).astype(np.float32))
    sums = kth * 5 * torch.from_numpy(
        rng.uniform(0.7, 1.0, (S, n)).astype(np.float32))
    d = torch.sqrt(torch.clamp(ref.sq_dists(Xt, X), min=0.0))
    kth[:, ::7] = d[:, 0, ::7]  # the strict gate: d == kth never updates
    y[:, n - dead:], sums[:, n - dead:], kth[:, n - dead:] = -1, -1e30, -1e30
    alpha = torch.from_numpy(
        rng.uniform(14.0, 20.0, (S, m, L)).astype(np.float32))
    alpha[:, 0] = sums[:, 3:4]  # a realised score: the >= of the counts
    for Xq in (Xt, Xt[:1].expand(S, m, p)):
        want = ref.cp_knn_counts(X, y, sums, kth, Xq, alpha)
        assert 0 < int(want.max()) and int(want.min()) < n
        assert torch.equal(_cp_counts_blocked(X, y, sums, kth, Xq, alpha),
                           want)


@pytest.mark.cuda
@pytest.mark.parametrize("S,m,n,p,L", [(64, 100, 1024, 30, 2),
                                       (3, 1, 130, 5, 1),
                                       (3, 65, 1023, 37, 16),
                                       (2, 129, 130, 30, 5)])
def test_cp_counts_kernel_matches_plain_on_the_card(S, m, n, p, L):
    """The CUDA kernel == ``ref.cp_knn_counts`` exactly: rows and columns
    around the 64 x 128 tiles, p around the 32-feature chunks, L around
    the 4-label groups, dead columns, a tenant stride of 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from repro_torch.kernels.cp_update import cp_knn_counts

    g = torch.Generator(device="cuda").manual_seed(S + m + n + p + L)
    X = torch.randn((S, n, p), generator=g, device="cuda") * (30 / p) ** 0.5
    Xt = torch.randn((S, m, p), generator=g, device="cuda") * (30 / p) ** 0.5
    y = torch.randint(0, L, (S, n), generator=g, device="cuda",
                      dtype=torch.int32)
    kth = 6.0 + 3.0 * torch.rand((S, n), generator=g, device="cuda")
    sums = kth * 15 * (0.7 + 0.3 * torch.rand((S, n), generator=g,
                                              device="cuda"))
    dead = torch.rand((S, n), generator=g, device="cuda") < 0.1
    y, sums = torch.where(dead, -1, y), torch.where(dead, -1e30, sums)
    kth = torch.where(dead, -1e30, kth)
    alpha = 112.5 * (0.7 + 0.3 * torch.rand((S, m, L), generator=g,
                                             device="cuda"))
    for Xq in (Xt, Xt[:1].expand(S, m, p)):
        assert torch.equal(cp_knn_counts(X, y, sums, kth, Xq, alpha,
                                         n_labels=L),
                           ref.cp_knn_counts(X, y, sums, kth, Xq, alpha))
