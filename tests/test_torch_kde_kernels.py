"""The port's plain ``kde_rowsums`` against the JAX kernel and oracle.

The same seeded numpy inputs go through ``repro_torch.kernels.ref`` and
through the Pallas kernel in interpret mode (1e-4, the tolerance of
``tests/test_kernels.py``) and ``repro.kernels.ref.kde_rowsums`` (rtol
1e-5: the frameworks sum in different orders). The port clamps ``d^2`` at
0 as the KDE measure's ``_kvals`` does; the JAX oracle does not. The CUDA
kernel itself is held to the plain version, bit for bit, by
``chip_smoke.py`` on the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.kde_score import kde_rowsums as kde_pallas  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.kde_score import exact_reciprocal  # noqa: E402


def _inputs(seed, m, n, p=6, labels=3, square=False):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, p)).astype(np.float32)
    yA = rng.integers(0, labels, m).astype(np.int32)
    if square:
        return A, A, yA, yA
    B = rng.standard_normal((n, p)).astype(np.float32)
    return A, B, yA, rng.integers(0, labels, n).astype(np.int32)


def _port(A, B, yA, yB, h, diag):
    return ref.kde_rowsums(*map(torch.from_numpy, (A, B, yA, yB)), h,
                           diag).numpy()


CASES = [(16, 16, False), (16, 16, True), (65, 128, False),
         (130, 70, False), (65, 65, True)]


@pytest.mark.parametrize("m,n,diag", CASES)
def test_plain_matches_pallas_interpret(m, n, diag):
    A, B, yA, yB = _inputs(m + n, m, n, square=diag)
    want = kde_pallas(*map(jnp.asarray, (A, B, yA, yB)), h=1.3,
                      exclude_diag=diag, interpret=True)
    np.testing.assert_allclose(_port(A, B, yA, yB, 1.3, diag),
                               np.asarray(want), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("m,n,diag", CASES)
def test_plain_matches_jax_oracle(m, n, diag):
    A, B, yA, yB = _inputs(7 * m + n, m, n, square=diag)
    want = jref.kde_rowsums(*map(jnp.asarray, (A, B, yA, yB)), 1.3, diag)
    got = _port(A, B, yA, yB, 1.3, diag)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-7)
    assert (got > 0).any()


def test_duplicate_rows_clamp_where_the_jax_oracle_does_not():
    """Two rows one ulp apart whose ``d^2`` rounds below 0 in both
    packages. The port clamps (the pair contributes exactly 1, as in the
    measure's ``_kvals``); JAX's ``ref.kde_rowsums`` divides the negative
    value and returns a kernel value above 1."""
    rng = np.random.default_rng(0)
    for _ in range(500):
        a = (3 * rng.standard_normal(6)).astype(np.float32)
        b = a.copy()
        j = rng.integers(6)
        b[j] = np.nextafter(b[j], np.float32(10))
        A = np.stack([a, b])
        d2 = ref.sq_dists(torch.from_numpy(A), torch.from_numpy(A))[0, 1]
        if d2 < 0 and jref.sq_dists(jnp.asarray(A), jnp.asarray(A))[0, 1] < 0:
            break
    else:
        pytest.fail("no pair with a negative squared distance found")
    y = np.zeros(2, np.int32)
    got = _port(A, A, y, y, 1.0, True)
    np.testing.assert_array_equal(got, np.ones(2, np.float32))
    want = np.asarray(jref.kde_rowsums(*map(jnp.asarray, (A, A, y, y)), 1.0,
                                       True))
    assert (want > 1.0).all()  # exp of a positive argument: unclamped
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_rows_do_not_depend_on_the_batch():
    """A row computed alone, or inside a larger batch of rows, has the same
    bits; the sum over [B; b] with the new column last is the sum over B
    plus that column's kernel value (the order the KDE measure's exactness
    rests on)."""
    A, B, yA, yB = map(torch.from_numpy, _inputs(3, 40, 90))
    full = ref.kde_rowsums(A, B, yA, yB, 0.9)
    for i in (0, 17, 39):
        assert torch.equal(ref.kde_rowsums(A[i:i + 1], B, yA[i:i + 1], yB,
                                           0.9), full[i:i + 1])
    grown = ref.kde_rowsums(A, B[:-1], yA, yB[:-1], 0.9)
    kv = ref.kde_kvals(ref.sq_dists(A, B[-1:]), 0.9)[:, 0]
    assert torch.equal(torch.where(yA == yB[-1], grown + kv, grown), full)


def test_routed_on_cpu_without_a_launch():
    A, B, yA, yB = map(torch.from_numpy, _inputs(5, 12, 20))
    ops.reset_launch_counts()
    got = ops.kde_rowsums(A.double(), B.double(), yA, yB, 1.1)
    assert got.dtype == torch.float64
    want = ref.kde_rowsums(A.double(), B.double(), yA, yB, 1.1)
    assert torch.equal(got, want)
    assert ops.launch_counts()["kde_rowsums"] == 0


@pytest.mark.parametrize("m,n,diag", CASES)
def test_per_label_form_is_each_target_label_bitwise(m, n, diag):
    """Without ``y_A``, column ``l`` of the ``(m, L)`` sums is the one-label
    form with every target label ``l``, bit for bit (a column adds to its
    own label's sum only; the others would add 0), and agrees with the
    Pallas kernel in interpret mode run with that target label."""
    L = 3
    A, B, yA, yB = _inputs(11 * m + n, m, n, labels=L, square=diag)
    tA, tB, tyB = map(torch.from_numpy, (A, B, yB))
    every = ops.kde_rowsums(tA, tB, None, tyB, 1.3, diag, n_labels=L)
    assert every.shape == (m, L)
    for lbl in range(L):
        target = torch.full((m,), lbl, dtype=torch.int32)
        assert torch.equal(every[:, lbl],
                           ref.kde_rowsums(tA, tB, target, tyB, 1.3, diag))
        want = kde_pallas(*map(jnp.asarray, (A, B, target.numpy(), yB)),
                          h=1.3, exclude_diag=diag, interpret=True)
        np.testing.assert_allclose(every[:, lbl].numpy(), np.asarray(want),
                                   atol=1e-4, rtol=1e-4)
    assert (every > 0).any()


# ---------------------------------------------------------------------------
# the CUDA kernel's grouped schedule, emulated in plain torch
# ---------------------------------------------------------------------------


def _grouped(A, B, yA, yB, h, diag, L):
    """The grouped layout's arithmetic in plain torch: the columns grouped
    by label (a stable partition: each label keeps its column order; labels
    outside [0, L) in one extra group), each group padded to whole tiles
    with zero features and |B|^2 = +inf; each row visits its group's
    columns alone, left to right, skips the diagonal by position and, in
    the extra group, the columns of another label; a multiply by the exact
    reciprocal where ``f32(2 h^2)`` is a power of two. ``yA=None``: every
    label's sum, one group at a time."""
    per_label = yA is None
    m, p = A.shape
    KT = 64 if p <= 32 else 16  # KS_KT, KS_C
    den = 2.0 * h * h
    inv = exact_reciprocal(den)
    a2 = ref._sumsq(A)
    out = A.new_zeros((m, L) if per_label else (m,))
    gB = torch.where((yB >= 0) & (yB < L), yB, L)
    gA = None if per_label else torch.where((yA >= 0) & (yA < L), yA, L)
    for g in range(L if per_label else L + 1):
        cols = torch.nonzero(gB == g).flatten()
        pad = -len(cols) % KT
        Bg = torch.cat([B[cols], B.new_zeros((pad, p))])
        b2g = torch.cat([ref._sumsq(B[cols]),
                         B.new_full((pad,), float("inf"))])
        yg = torch.cat([yB[cols], yB.new_full((pad,), -1)])
        jg = torch.cat([cols, cols.new_full((pad,), -1)])
        rows = (torch.arange(m) if per_label
                else torch.nonzero(gA == g).flatten())
        if len(rows) == 0 or len(jg) == 0:
            continue
        ab = A.new_zeros((len(rows), len(jg)))
        for f in range(p):
            ab = ab + A[rows, f, None] * Bg[None, :, f]
        x = -torch.clamp((a2[rows, None] + b2g[None]) - 2.0 * ab, min=0.0)
        v = torch.exp(x * inv if inv is not None
                      else x / x.new_full((), den))
        keep = ~((jg[None] == rows[:, None]) & diag)
        if g == L:
            keep &= yg[None] == yA[rows, None]
        acc = A.new_zeros(len(rows))
        for j in range(len(jg)):
            acc = torch.where(keep[:, j], acc + v[:, j], acc)
        if per_label:
            out[rows, g] = acc
        else:
            out[rows] = acc
    return out


def _labelled(seed, m, n, p, values, square):
    """Inputs with labels drawn from ``values``."""
    rng = np.random.default_rng(seed)
    A = torch.from_numpy((0.4 * rng.standard_normal((m, p)))
                         .astype(np.float32))
    vals = np.asarray(values, np.int32)
    yA = torch.from_numpy(rng.choice(vals, m))
    if square:
        return A, A, yA, yA
    B = torch.from_numpy((0.4 * rng.standard_normal((n, p)))
                         .astype(np.float32))
    return A, B, yA, torch.from_numpy(rng.choice(vals, n))


# name: m, n, p, L, label values, square, diagonal excluded, per-label form
GROUPED_CASES = {
    "fit, diagonal": (150, 150, 30, 2, (0, 1), True, True, False),
    "fit, no diagonal": (150, 150, 30, 3, (0, 1, 2), True, False, False),
    "icp, m != n, A != B": (70, 160, 30, 2, (0, 1), False, False, False),
    "a label absent": (140, 140, 30, 4, (0, 1, 3), True, True, False),
    "labels -1 and L": (140, 140, 30, 3, (-1, 0, 1, 2, 3), True, True,
                        False),
    "p 37, chunked": (90, 90, 37, 2, (0, 1), True, True, False),
    "per-label form": (60, 170, 30, 3, (-1, 0, 1, 2, 3), False, False, True),
    "per-label form, diagonal": (130, 130, 30, 2, (0, 1, 2), True, True,
                                 True),
}


@pytest.mark.parametrize("h", [1.0, 0.7, 0.5**0.5])
@pytest.mark.parametrize("case", list(GROUPED_CASES))
def test_grouped_schedule_equals_plain_bitwise(case, h):
    """The kernel's grouped schedule (only the same-label columns, in
    their order; padding that adds +0; the multiply where the divisor is a
    power of two: h = 1 gives 2, h = 0.5**0.5 gives f32(1.0000000000000002)
    = 1) has the plain version's bits."""
    m, n, p, L, values, square, diag, per_label = GROUPED_CASES[case]
    A, B, yA, yB = _labelled(m + 7 * n + p, m, n, p, values, square)
    if per_label:
        yA = None
    want = ref.kde_rowsums(A, B, yA, yB, h, diag, n_labels=L)
    got = _grouped(A, B, yA, yB, h, diag, L)
    assert torch.equal(got, want)
    assert (want > 0).any()


def _f32_grid():
    """Float32 values over every exponent, the denormals, both zeros and
    both infinities."""
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2**31 - 1, 200_000, dtype=np.int64)
    x = bits.astype(np.uint32).view(np.float32)
    x = x[np.isfinite(x)]
    tiny = (rng.integers(1, 2**23, 20_000).astype(np.uint32)
            .view(np.float32))  # denormals
    special = np.array([0.0, -0.0, np.inf, -np.inf, 1.0, -1.0],
                       np.float32)
    x = np.concatenate([x, -x, tiny, -tiny, special])
    return torch.from_numpy(x)


@pytest.mark.parametrize("den", [2.0, 1.0, 0.5, 2.0**-20, 2.0**40,
                                 2.0**126, 2.0**-126, 2.0 * (0.5**0.5)**2])
def test_exact_reciprocal_multiply_is_the_division(den):
    """Where ``exact_reciprocal`` allows it, ``x * (1 / den)`` is ``x /
    den`` bit for bit over every exponent of x, denormal results
    included."""
    inv = exact_reciprocal(den)
    assert inv is not None
    x = _f32_grid()
    d = torch.tensor(den, dtype=torch.float32)
    assert torch.equal(x * torch.tensor(inv, dtype=torch.float32), x / d)
    assert torch.equal(-torch.clamp(x, min=0.0) * inv,
                       -torch.clamp(x, min=0.0) / d)


@pytest.mark.parametrize("den", [2.0 * 0.7**2, 1.28, 3.0, 2.0**127,
                                 2.0**-140, 0.0, float("inf")])
def test_exact_reciprocal_refuses_other_divisors(den):
    """A divisor that is not a power of two, or whose reciprocal is not a
    normal float32, keeps the IEEE division: for the first kind a multiply
    by the rounded reciprocal gives other bits for some x."""
    assert exact_reciprocal(den) is None
    d = torch.tensor(den, dtype=torch.float32)
    if 0.0 < float(d) < float("inf") and den < 2.0**100 and den > 1e-30:
        x = _f32_grid()
        x = x[torch.isfinite(x)]
        r = torch.tensor(1.0, dtype=torch.float32) / d
        assert not torch.equal(x * r, x / d)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["fit", "fit h 0.7", "labels -1 and L",
                                  "icp", "per-label", "per-label diag",
                                  "p 37", "p 784", "wide fit",
                                  "wide per-label"])
def test_kernel_matches_plain_on_the_card(case):
    """The CUDA kernel == the plain version, bitwise, in both layouts and
    both forms (the smoke repeats this at the full sizes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from repro_torch.kernels.kde_score import kde_rowsums

    h = 0.7 if case == "fit h 0.7" else 1.0
    p = {"p 37": 37, "p 784": 784}.get(case, 30)
    values = (-1, 0, 1, 2, 3) if case == "labels -1 and L" else (0, 1, 2)
    square = case not in ("icp", "per-label", "wide per-label")
    L = 2 if case == "per-label diag" else 3  # labels >= L: no sum
    A, B, yA, yB = (t.cuda() for t in _labelled(3, 700, 1500, p, values,
                                                  square))
    layout = "wide" if case.startswith("wide") else "grouped"
    if "per-label" in case:
        yA = None
    diag = square
    got = kde_rowsums(A, B, yA, yB, h, diag, L, layout=layout)
    want = ref.kde_rowsums(A, B, yA, yB, h, diag, L)
    assert torch.equal(got, want)
    assert bool((want > 0).any())
