"""Bootstrap nonconformity measure (paper Section 6, Algorithm 3), streaming.

Counterpart of ``repro/core/measures/bootstrap.py``, with its names and
its host-side bookkeeping: the random draws (``numpy.random.default_rng``
keyed by ``(seed, tag, id)``), the sample pool, the assignment lists and
the p-value arithmetic stay numpy int64 / float64 on the host, as in the
reference, so a state and its p-values are reproduced bit for bit. Only
the forest runs on the device the state carries (``fit(device=...)``,
``cuda`` by default): every fit and prediction goes through
``kernels.ops.boot_fit_forest`` / ``boot_forest_predict``.

Standard bootstrap CP trains a fresh B-classifier ensemble for every LOO
entry: O(S_g(n) B n l m). The paper's optimization pre-samples bootstrap
draws of the augmented set Z* = Z u {*} (with * a placeholder for the test
point) until every example has >= B samples *not containing it* (footnote 1:
per-example lists are capped at B); samples without * are pre-trained at fit
time. At prediction only the samples that do contain * are trained — a
(1 - e^{-1}) ~ 0.632x predict cost, and shared classifiers make the
effective number of trainings B' << B n.

This module extends Algorithm 3 to the serving setting with exact
incremental (``incremental_add``) and decremental (``decremental_remove``)
updates over a *shared sample pool*:

* Every bootstrap sample is stored as a multiplicity vector over the
  current training points (``W``), a placeholder count (``star``), and an
  **eligibility epoch** (``elig``): a sample drawn at time t is a draw from
  Z*_t, so it may only serve points that were in the pool when it was drawn
  (points born later could never have appeared in it).
* ``incremental_add`` oversamples: fresh draws over the enlarged Z* until
  the new point has B clean samples (existing points are untouched — their
  lists stay at the cap).
* ``decremental_remove`` retires every sample containing the removed point
  (their training multisets no longer exist), backfills damaged per-point
  lists from the earliest surviving eligible samples, and only then
  oversamples; samples no longer referenced by any list are pruned.

**Exactness contract.** All derived structures (assignment lists ``E`` /
``E_i``, per-point counts, pre-trained trees, cached predictions and vote
counts) are maintained so that after ANY interleaving of observe/evict the
state is bit-identical to ``fit_from_samples`` — a from-scratch batch build
on the same effective sample set (``rebuild``); ``fit`` itself is
draw-then-``fit_from_samples``, so batch and streaming share one code
path. Randomness is keyed, never sequential: bootstrap draws by draw id
(``DrawStream``), pre-trained trees by (seed, draw id), predict-time
star trees by (seed, test index, label) consumed over *sorted* sample ids
— repeated ``pvalues_optimized`` calls are bit-identical (the seed
implementation iterated an unordered ``set``, making p-values depend on
Python hash order).

The base learner is a vectorized extra-tree ensemble (random split feature
+ random threshold, majority leaves), fitted as stacked ``(S, n_nodes)``
arrays in one call of ``kernels.ops.boot_fit_forest`` (the per-tree
oracle is ``kernels.ref.boot_fit_tree``). The bootstrap machinery is learner-agnostic;
the paper's Random-Forest instantiation differs only in the tree fitting
rule.
"""
from __future__ import annotations

from bisect import insort
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch._device import resolve
from repro_torch.kernels import ops as kops
from repro_torch.kernels.boot_forest import n_nodes

# rng stream tags: every random quantity is keyed, never sequential
_DRAW_TAG = 0  # bootstrap index draws (DrawStream)
_TREE_TAG = 1  # pre-trained trees, by draw id
_STAR_TAG = 2  # predict-time star trees, by (test index, label)
_STD_TAG = 3  # the naive path, by (test index, label)


class DrawStream:
    """Keyed RNG stream for bootstrap draws (the registry ``ctx``).

    ``draw(d, n)`` is a pure function of ``(seed, d)``: draw d of Z* for a
    pool of n training points — n+1 indices in ``[0, n]``, value n being
    the placeholder *. Keying by draw id (instead of consuming one
    sequential generator) keeps every draw reproducible independently of
    the call history, which is what lets ``rebuild`` verify a streamed
    state against a from-scratch build.
    """

    def __init__(self, seed: int):
        self.seed = int(seed)

    def draw(self, draw_id: int, n: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, _DRAW_TAG, draw_id))
        return rng.integers(0, n + 1, size=n + 1)


def _node_rand(rng, S, n_nodes, p):
    """Pre-drawn per-node randomness for S trees: feature ids + uniforms."""
    fc = rng.integers(0, p, size=(S, n_nodes)).astype(np.int32)
    u = rng.random(size=(S, n_nodes), dtype=np.float32)
    return fc, u


def _tree_rand(seed, draw_ids, n_nodes, p):
    """Per-sample keyed randomness: tree of draw d is a function of d only."""
    fc = np.empty((len(draw_ids), n_nodes), np.int32)
    u = np.empty((len(draw_ids), n_nodes), np.float32)
    for r, d in enumerate(draw_ids):
        rng = np.random.default_rng((seed, _TREE_TAG, int(d)))
        fc[r] = rng.integers(0, p, size=n_nodes)
        u[r] = rng.random(size=n_nodes, dtype=np.float32)
    return fc, u


def _validate_labels(y, n_labels):
    if y.size and (int(y.min()) < 0 or int(y.max()) >= n_labels):
        raise ValueError(
            f"labels must lie in [0, {n_labels}); got range "
            f"[{int(y.min())}, {int(y.max())}]")


@dataclass
class BootstrapState:
    """Algorithm 3 state over a shared, epoch-tagged sample pool.

    Sample rows are kept in ascending ``draw_ids`` order (the canonical
    replay order of ``fit_from_samples``). ``E`` / ``E_i`` hold draw ids,
    sorted ascending, capped at B; the invariant after every successful
    update is ``counts == B`` everywhere and ``len(E) == B``. ``feat`` /
    ``thresh`` / ``leaf`` are the stacked pre-trained extra-trees (star
    rows are deterministic fill: feat -1, thresh 0, leaf 0); ``pre_pred``
    caches their predictions on every current training point (star rows
    -1), and ``pre_votes`` the per-point pre-trained vote count — the
    cached half of the score that ``pvalues_optimized`` never recomputes.
    ``device`` is where every forest of this state is fitted and read.
    """

    X: np.ndarray  # (n, p) f32 training points
    y: np.ndarray  # (n,) i32 labels
    n_labels: int
    B: int
    depth: int
    seed: int
    uids: np.ndarray  # (n,) i64 birth ids, ascending (arrival order)
    next_uid: int
    draw_ids: list  # (S,) sample draw ids, ascending
    next_draw: int
    W: np.ndarray  # (S, n) i32 multiplicity of each point in each sample
    star: np.ndarray  # (S,) i32 multiplicity of the placeholder *
    elig: np.ndarray  # (S,) i64 epoch: sample serves i iff uids[i] < elig
    E: list  # draw ids without * (pre-trained; score the candidate)
    E_i: list  # per point: draw ids without that point (capped at B)
    counts: np.ndarray  # (n,) i64 == len(E_i[i])
    feat: np.ndarray  # (S, n_nodes) i32
    thresh: np.ndarray  # (S, n_nodes) f32
    leaf: np.ndarray  # (S, n_nodes) i32
    pre_pred: np.ndarray  # (S, n) i32 pre-trained predictions (-1 on star)
    pre_votes: np.ndarray  # (n,) i64 cached pre-trained vote counts
    device: torch.device  # where the forests run

    @property
    def n(self) -> int:
        return self.X.shape[0]

    @property
    def b_prime(self) -> int:
        """Live shared-sample count B' (paper Figure 5: B' << B n)."""
        return len(self.draw_ids)

    def leaves(self) -> list[np.ndarray]:
        """``X`` and ``y``, the leading arrays (``ConformalPredictor.n``
        reads the first)."""
        return [self.X, self.y]


def _train_rows(X, y, W_rows, dids, seed, n_labels, depth, device):
    """Fit the pre-trained trees of the given sample rows (one call) and
    cache their predictions on every current training point."""
    fc, u = _tree_rand(seed, dids, n_nodes(depth), X.shape[1])
    feat, thresh, leaf = kops.boot_fit_forest(
        X, y, W_rows, fc, u, n_labels=n_labels, depth=depth, device=device)
    pre_pred = kops.boot_forest_predict(feat, thresh, leaf, X,
                                        device=device)
    return feat, thresh, leaf, pre_pred.astype(np.int32)


def _pre_votes_of(E_i, draw_ids, star, pre_pred, y):
    """pre_votes[i] = #{pre-trained d in E_i[i] : tree_d(x_i) == y_i}."""
    row_of = {d: r for r, d in enumerate(draw_ids)}
    votes = np.zeros(len(E_i), np.int64)
    for i, lst in enumerate(E_i):
        for d in lst:
            r = row_of[d]
            if star[r] == 0 and pre_pred[r, i] == y[i]:
                votes[i] += 1
    return votes


def _starved_error(B, names, counts, context):
    return ValueError(
        f"bootstrap {context} starved: entries {names} have fewer than "
        f"B={B} clean samples (counts {counts}); raise max_bprime/"
        f"max_draws or lower B")


def fit_from_samples(X, y, draw_ids, W, star, elig, uids, *, n_labels, B,
                     depth, seed, next_uid=None, next_draw=None,
                     device=None) -> BootstrapState:
    """From-scratch batch build on an explicit sample set (replay).

    The canonical assignment rule: samples in ascending draw order; each
    sample joins ``E_i[i]`` for every point it is absent from and eligible
    for (``uids[i] < elig``) whose list is below B — points in ascending
    position, the placeholder last. Raises ``ValueError`` naming any point
    (or ``'*'``) left with fewer than B clean samples — the guard that
    used to be a division-by-zero crash at predict time.

    ``fit`` routes through this builder, and ``rebuild`` re-invokes it on
    a streamed state's sample set: the exactness tests assert streamed ==
    rebuilt, bit for bit. The forests run on ``device`` (``cuda`` by
    default).
    """
    device = resolve(device)
    X = np.asarray(X, np.float32)
    y = np.asarray(y, np.int32)
    n = X.shape[0]
    _validate_labels(y, n_labels)
    S = len(draw_ids)
    W = np.asarray(W, np.int32).reshape(S, n)
    star = np.asarray(star, np.int32)
    elig = np.asarray(elig, np.int64)
    uids = np.asarray(uids, np.int64)
    counts = np.zeros(n, np.int64)
    E_i = [[] for _ in range(n)]
    E = []
    for s in range(S):
        d = int(draw_ids[s])
        for i in np.flatnonzero((W[s] == 0) & (uids < elig[s])
                                & (counts < B)):
            E_i[i].append(d)
            counts[i] += 1
        if star[s] == 0 and len(E) < B:
            E.append(d)
    starved = np.flatnonzero(counts < B).tolist()
    names = [int(i) for i in starved] + (["*"] if len(E) < B else [])
    if names:
        got = [int(counts[i]) for i in starved] + (
            [len(E)] if len(E) < B else [])
        raise _starved_error(B, names, got, "fit")

    nn = n_nodes(depth)
    feat = np.full((S, nn), -1, np.int32)
    thresh = np.zeros((S, nn), np.float32)
    leaf = np.zeros((S, nn), np.int32)
    pre_pred = np.full((S, n), -1, np.int32)
    pre_rows = np.flatnonzero(star == 0)
    if pre_rows.size:
        f, t, lf, pp = _train_rows(
            X, y, W[pre_rows], [draw_ids[r] for r in pre_rows], seed,
            n_labels, depth, device)
        feat[pre_rows], thresh[pre_rows] = f, t
        leaf[pre_rows], pre_pred[pre_rows] = lf, pp
    pre_votes = _pre_votes_of(E_i, draw_ids, star, pre_pred, y)
    if next_uid is None:
        next_uid = int(uids.max()) + 1 if n else 0
    if next_draw is None:
        next_draw = int(draw_ids[-1]) + 1 if S else 0
    return BootstrapState(
        X, y, n_labels, B, depth, int(seed), uids, int(next_uid),
        [int(d) for d in draw_ids], int(next_draw), W, star, elig, E, E_i,
        counts, feat, thresh, leaf, pre_pred, pre_votes, device)


def rebuild(state: BootstrapState) -> BootstrapState:
    """From-scratch build on the state's effective sample set.

    The exactness oracle: a streamed state must equal its rebuild, bit
    for bit (trees, assignment lists, cached votes, p-values).
    """
    return fit_from_samples(
        state.X, state.y, state.draw_ids, state.W, state.star, state.elig,
        state.uids, n_labels=state.n_labels, B=state.B, depth=state.depth,
        seed=state.seed, next_uid=state.next_uid,
        next_draw=state.next_draw, device=state.device)


def fit(X, y, *, n_labels, B=10, depth=5, seed=0, max_bprime=100000,
        stream=None, device=None) -> BootstrapState:
    """Algorithm 3 TRAIN: oversample until every point has B clean samples,
    then build the state through ``fit_from_samples``. The state's
    forests run on ``device`` (``cuda`` by default; raises without a
    GPU)."""
    device = resolve(device)
    X = np.asarray(X, np.float32)
    y = np.asarray(y, np.int32)
    n = X.shape[0]
    if n < 1:
        raise ValueError("bootstrap fit needs at least one training point")
    _validate_labels(y, n_labels)
    if stream is None:
        stream = DrawStream(seed)
    counts = np.zeros(n + 1, np.int64)  # clean-sample counts; last is *
    draw_ids, W_rows, star_cts = [], [], []
    d = 0
    # max_bprime bounds B' — ACCEPTED shared samples, not attempted draws
    # (rejected draws are free: no tree is ever trained for them). The
    # attempt backstop only guards the measure-zero never-useful spin.
    max_attempts = max(100 * max_bprime, 10000)
    while counts.min() < B and len(draw_ids) < max_bprime \
            and d < max_attempts:
        idx = stream.draw(d, n)
        w = np.bincount(idx[idx < n], minlength=n).astype(np.int32)
        st = int(np.sum(idx == n))
        absent = np.concatenate([w == 0, [st == 0]])
        helped = absent & (counts < B)
        if helped.any():  # footnote 1: keep a draw only if it helps someone
            counts += helped
            draw_ids.append(d)
            W_rows.append(w)
            star_cts.append(st)
        d += 1
    if counts.min() < B:
        starved = np.flatnonzero(counts < B)
        names = ["*" if i == n else int(i) for i in starved]
        raise _starved_error(B, names, counts[starved].tolist(),
                             f"fit (max_bprime={max_bprime})")
    S = len(draw_ids)
    return fit_from_samples(
        X, y, draw_ids,
        np.asarray(W_rows, np.int32).reshape(S, n),
        np.asarray(star_cts, np.int32), np.full(S, n, np.int64),
        np.arange(n, dtype=np.int64), n_labels=n_labels, B=B, depth=depth,
        seed=seed, next_uid=n, next_draw=d, device=device)


# ---------------------------------------------------------------------------
# incremental / decremental updates (the serving path)
# ---------------------------------------------------------------------------


def incremental_add(state: BootstrapState, x, y_new, *, stream=None,
                    max_draws=100000) -> BootstrapState:
    """Learn one example: oversample fresh draws over the enlarged Z* until
    the new point has B clean samples. Existing points' lists are already
    at the cap and old samples are ineligible for the new point (it was
    not in the pool when they were drawn), so only the new point's list,
    the new trees, and one cached-prediction column change."""
    x = np.asarray(x, np.float32).reshape(-1)
    if x.shape[0] != state.X.shape[1]:
        raise ValueError(
            f"x has {x.shape[0]} features, state has {state.X.shape[1]}")
    y_new = int(y_new)
    _validate_labels(np.asarray([y_new]), state.n_labels)
    if stream is None:
        stream = DrawStream(state.seed)
    B, n_old = state.B, state.n
    n = n_old + 1
    uid = state.next_uid

    X = np.concatenate([state.X, x[None]], axis=0)
    y = np.append(state.y, np.int32(y_new))
    uids = np.append(state.uids, np.int64(uid))
    S_old = len(state.draw_ids)
    W = np.concatenate([state.W, np.zeros((S_old, 1), np.int32)], axis=1)
    # cached predictions of every pre-trained tree on the new point
    if S_old:
        col = kops.boot_forest_predict(
            state.feat, state.thresh, state.leaf, x[None],
            device=state.device)[:, 0]
        col = np.where(state.star > 0, -1, col).astype(np.int32)
    else:
        col = np.zeros(0, np.int32)
    pre_pred = np.concatenate([state.pre_pred, col[:, None]], axis=1)

    draw_ids = list(state.draw_ids)
    E_i = [list(lst) for lst in state.E_i] + [[]]
    d = state.next_draw
    new_W, new_star, new_ids = [], [], []
    attempts = 0
    while len(E_i[-1]) < B:
        if attempts >= max_draws:
            raise _starved_error(B, [n_old], [len(E_i[-1])],
                                 f"incremental_add (max_draws={max_draws})")
        idx = stream.draw(d, n)
        w = np.bincount(idx[idx < n], minlength=n).astype(np.int32)
        if w[-1] == 0:  # clean for the new point — the only deficient entry
            draw_ids.append(d)
            new_ids.append(d)
            new_W.append(w)
            new_star.append(int(np.sum(idx == n)))
            E_i[-1].append(d)
        d += 1
        attempts += 1

    R = len(new_ids)
    W = np.concatenate([W, np.asarray(new_W, np.int32).reshape(R, n)])
    star = np.append(state.star, np.asarray(new_star, np.int32))
    elig = np.append(state.elig, np.full(R, uid + 1, np.int64))
    nn = state.feat.shape[1]
    feat = np.concatenate([state.feat, np.full((R, nn), -1, np.int32)])
    thresh = np.concatenate([state.thresh, np.zeros((R, nn), np.float32)])
    leaf = np.concatenate([state.leaf, np.zeros((R, nn), np.int32)])
    pre_pred = np.concatenate([pre_pred, np.full((R, n), -1, np.int32)])
    new_pre = np.flatnonzero(np.asarray(new_star, np.int32) == 0)
    if new_pre.size:
        rows = S_old + new_pre
        f, t, lf, pp = _train_rows(
            X, y, W[rows], [new_ids[r] for r in new_pre], state.seed,
            state.n_labels, state.depth, state.device)
        feat[rows], thresh[rows], leaf[rows], pre_pred[rows] = f, t, lf, pp

    counts = np.append(state.counts, np.int64(B))
    pre_votes = np.append(state.pre_votes, 0)
    row_of = {dd: r for r, dd in enumerate(draw_ids)}
    for dd in E_i[-1]:
        r = row_of[dd]
        if star[r] == 0 and pre_pred[r, -1] == y_new:
            pre_votes[-1] += 1
    return BootstrapState(
        X, y, state.n_labels, B, state.depth, state.seed, uids, uid + 1,
        draw_ids, d, W, star, elig, list(state.E), E_i, counts, feat,
        thresh, leaf, pre_pred, pre_votes, state.device)


def decremental_remove(state: BootstrapState, i: int, *, stream=None,
                       max_draws=100000) -> BootstrapState:
    """Forget training point ``i``: retire every sample containing it,
    backfill damaged lists from the earliest surviving eligible samples
    (the replay rule), oversample only if those run out, and prune samples
    no longer referenced by any list."""
    n_old = state.n
    if n_old < 2:
        raise ValueError("cannot evict from a 1-point bootstrap state")
    if not -n_old <= i < n_old:
        raise IndexError(
            f"index {i} out of range for {n_old} training points")
    i %= n_old
    if stream is None:
        stream = DrawStream(state.seed)
    B = state.B
    n = n_old - 1

    retired_rows = state.W[:, i] > 0
    keep = ~retired_rows
    retired = {state.draw_ids[r] for r in np.flatnonzero(retired_rows)}
    col_keep = np.arange(n_old) != i
    draw_ids = [dd for dd, k in zip(state.draw_ids, keep) if k]
    W = state.W[keep][:, col_keep]
    star, elig = state.star[keep], state.elig[keep]
    feat, thresh = state.feat[keep], state.thresh[keep]
    leaf = state.leaf[keep]
    pre_pred = state.pre_pred[keep][:, col_keep]
    X = state.X[col_keep]
    y = state.y[col_keep]
    uids = state.uids[col_keep]
    E_i = [[dd for dd in lst if dd not in retired]
           for j, lst in enumerate(state.E_i) if j != i]
    E = [dd for dd in state.E if dd not in retired]

    # backfill from surviving samples, earliest first — restores each list
    # to "the B earliest eligible clean samples", which is what the replay
    # in fit_from_samples produces
    member = [set(lst) for lst in E_i]
    Eset = set(E)
    if any(len(lst) < B for lst in E_i) or len(E) < B:
        for s, dd in enumerate(draw_ids):
            for j in np.flatnonzero((W[s] == 0) & (uids < elig[s])):
                if len(E_i[j]) < B and dd not in member[j]:
                    insort(E_i[j], dd)
                    member[j].add(dd)
            if star[s] == 0 and len(E) < B and dd not in Eset:
                insort(E, dd)
                Eset.add(dd)

    # oversample for whatever is still deficient
    d = state.next_draw
    new_W, new_star, new_ids = [], [], []
    attempts = 0
    while any(len(lst) < B for lst in E_i) or len(E) < B:
        if attempts >= max_draws:
            names = [j for j, lst in enumerate(E_i) if len(lst) < B]
            got = [len(E_i[j]) for j in names]
            if len(E) < B:
                names, got = names + ["*"], got + [len(E)]
            raise _starved_error(
                B, names, got, f"decremental_remove (max_draws={max_draws})")
        idx = stream.draw(d, n)
        w = np.bincount(idx[idx < n], minlength=n).astype(np.int32)
        st = int(np.sum(idx == n))
        helped = False
        for j in np.flatnonzero(w == 0):
            if len(E_i[j]) < B:
                E_i[j].append(d)  # d exceeds every existing id: stays sorted
                member[j].add(d)
                helped = True
        if st == 0 and len(E) < B:
            E.append(d)
            Eset.add(d)
            helped = True
        if helped:
            draw_ids.append(d)
            new_ids.append(d)
            new_W.append(w)
            new_star.append(st)
        d += 1
        attempts += 1

    R = len(new_ids)
    nn = state.feat.shape[1]
    if R:
        W = np.concatenate([W, np.asarray(new_W, np.int32).reshape(R, n)])
        star = np.append(star, np.asarray(new_star, np.int32))
        elig = np.append(elig, np.full(R, state.next_uid, np.int64))
        feat = np.concatenate([feat, np.full((R, nn), -1, np.int32)])
        thresh = np.concatenate([thresh, np.zeros((R, nn), np.float32)])
        leaf = np.concatenate([leaf, np.zeros((R, nn), np.int32)])
        pre_pred = np.concatenate([pre_pred, np.full((R, n), -1, np.int32)])
        new_pre = np.flatnonzero(np.asarray(new_star, np.int32) == 0)
        if new_pre.size:
            rows = (len(draw_ids) - R) + new_pre
            f, t, lf, pp = _train_rows(
                X, y, W[rows], [new_ids[r] for r in new_pre], state.seed,
                state.n_labels, state.depth, state.device)
            feat[rows], thresh[rows] = f, t
            leaf[rows], pre_pred[rows] = lf, pp

    # prune samples referenced by no list (their only subscriber left)
    referenced = set().union(Eset, *member) if member else set(Eset)
    live = np.array([dd in referenced for dd in draw_ids], bool)
    draw_ids = [dd for dd, k in zip(draw_ids, live) if k]
    W, star, elig = W[live], star[live], elig[live]
    feat, thresh, leaf = feat[live], thresh[live], leaf[live]
    pre_pred = pre_pred[live]

    counts = np.asarray([len(lst) for lst in E_i], np.int64)
    pre_votes = _pre_votes_of(E_i, draw_ids, star, pre_pred, y)
    return BootstrapState(
        X, y, state.n_labels, B, state.depth, state.seed, uids,
        state.next_uid, draw_ids, d, W, star, elig, E, E_i, counts, feat,
        thresh, leaf, pre_pred, pre_votes, state.device)


# ---------------------------------------------------------------------------
# p-values
# ---------------------------------------------------------------------------


def pvalues_optimized(state: BootstrapState, X_test) -> np.ndarray:
    """Algorithm 3 COMPUTE_PVALUE for each test point x label: (m, l).

    Per (test point, label) only the *-containing samples referenced by
    some ``E_i`` list are trained, in sorted-draw-id order under a keyed
    rng — deterministic across repeated calls. Pre-trained contributions
    come entirely from the cached ``pre_votes``.
    """
    X_test = np.asarray(X_test, np.float32)
    if X_test.ndim == 1:
        X_test = X_test[None]
    n, p = state.X.shape
    n_labels = state.n_labels
    if not len(state.E) or (state.counts == 0).any():
        bad = np.flatnonzero(state.counts == 0).tolist()
        raise _starved_error(state.B, bad + ([] if state.E else ["*"]),
                             [], "pvalues (corrupt state)")
    row_of = {dd: r for r, dd in enumerate(state.draw_ids)}
    star_ref = sorted({dd for lst in state.E_i for dd in lst
                       if state.star[row_of[dd]] > 0})
    srows = np.asarray([row_of[dd] for dd in star_ref], np.int64)
    S_star = len(star_ref)
    member = np.zeros((n, S_star), bool)
    star_pos = {dd: j for j, dd in enumerate(star_ref)}
    for i, lst in enumerate(state.E_i):
        for dd in lst:
            j = star_pos.get(dd)
            if j is not None:
                member[i, j] = True
    W_star = (np.concatenate([state.W[srows], state.star[srows][:, None]],
                             axis=1) if S_star else None)
    erows = np.asarray([row_of[dd] for dd in state.E], np.int64)
    nn = state.feat.shape[1]
    denom = state.counts.astype(np.float64)
    out = np.zeros((X_test.shape[0], n_labels))
    # candidate scores come entirely from pre-trained trees: one batched
    # dispatch over the whole test set
    cpred_all = kops.boot_forest_predict(
        state.feat[erows], state.thresh[erows], state.leaf[erows], X_test,
        device=state.device)
    for t in range(X_test.shape[0]):
        x_t = X_test[t]
        Xa = np.concatenate([state.X, x_t[None]], axis=0)
        cpred = cpred_all[:, t]
        for lbl in range(n_labels):
            star_votes = np.zeros(n, np.int64)
            if S_star:
                ya = np.append(state.y, np.int32(lbl))
                rng = np.random.default_rng(
                    (state.seed, _STAR_TAG, t, lbl))
                fc, u = _node_rand(rng, S_star, nn, p)
                f_, t_, l_ = kops.boot_fit_forest(
                    Xa, ya, W_star, fc, u, n_labels=n_labels,
                    depth=state.depth, device=state.device)
                preds = kops.boot_forest_predict(f_, t_, l_, state.X,
                                                 device=state.device)
                star_votes = np.sum(
                    member & (preds.T == state.y[:, None]), axis=1)
            alphas = -(state.pre_votes + star_votes) / denom
            alpha = -float(np.sum(cpred == lbl)) / len(state.E)
            out[t, lbl] = (np.sum(alphas >= alpha) + 1.0) / (n + 1.0)
    return out


# per-dispatch tree-batch bound for the naive path: bounds host/device
# memory at O(chunk * n) instead of O(n^2 * B) when n is large
_STD_CHUNK_TREES = 4096


def pvalues_standard(X, y, X_test, *, n_labels, B=10, depth=5, seed=0,
                     device=None):
    """Naive bootstrap CP: a fresh ensemble per LOO entry, O(S_g(n) B n l m).

    The B (n+1) trees of one (test point, label) candidate are fitted as
    stacked dispatches of at most ``_STD_CHUNK_TREES`` trees (the same
    vectorized base learner as the optimized path; chunking over LOO
    entries keeps the multiplicity matrix at O(chunk * n) memory).
    Randomness is keyed per (t, lbl, LOO entry), so repeated calls are
    deterministic AND the chunk size is pure batching — tuning
    ``_STD_CHUNK_TREES`` to a runner's memory cannot change a p-value.
    The forests run on ``device`` (``cuda`` by default)."""
    device = resolve(device)
    X = np.asarray(X, np.float32)
    y = np.asarray(y, np.int32)
    X_test = np.asarray(X_test, np.float32)
    if X_test.ndim == 1:
        X_test = X_test[None]
    _validate_labels(y, n_labels)
    n, p = X.shape
    m = X_test.shape[0]
    nn = n_nodes(depth)
    loo_chunk = max(1, _STD_CHUNK_TREES // B)
    out = np.zeros((m, n_labels))
    for t in range(m):
        Xa = np.concatenate([X, X_test[t][None]], axis=0)
        for lbl in range(n_labels):
            ya = np.append(y, np.int32(lbl))
            alphas = np.zeros(n + 1)
            for lo in range(0, n + 1, loo_chunk):
                hi = min(lo + loo_chunk, n + 1)
                c = hi - lo
                idx = np.empty((c, B, n), np.int64)
                fc = np.empty((c * B, nn), np.int32)
                u = np.empty((c * B, nn), np.float32)
                for j, i in enumerate(range(lo, hi)):
                    rng = np.random.default_rng(
                        (seed, _STD_TAG, t, lbl, i))
                    idx[j] = rng.integers(0, n, size=(B, n))
                    fc[j * B:(j + 1) * B], u[j * B:(j + 1) * B] = \
                        _node_rand(rng, B, nn, p)
                # bootstrap of size n over each LOO keep-set: keep-set
                # position k of entry i is augmented row k + (k >= i)
                rows = idx + (idx >= np.arange(lo, hi)[:, None, None])
                S = c * B
                W = np.zeros((S, n + 1), np.int32)
                np.add.at(W, (np.repeat(np.arange(S), n),
                              rows.reshape(S, n).ravel()), 1)
                f_, t_, l_ = kops.boot_fit_forest(
                    Xa, ya, W, fc, u, n_labels=n_labels, depth=depth,
                    device=device)
                preds = kops.boot_forest_predict(f_, t_, l_, Xa[lo:hi],
                                                 device=device)
                own = preds.reshape(c, B, c)[
                    np.arange(c), :, np.arange(c)]  # (c, B)
                alphas[lo:hi] = -np.mean(own == ya[lo:hi, None], axis=1)
            out[t, lbl] = (np.sum(alphas[:n] >= alphas[n]) + 1.0) / (n + 1.0)
    return out
