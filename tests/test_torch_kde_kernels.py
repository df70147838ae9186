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
