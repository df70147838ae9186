"""Multi-device full CP and tenant sharding, counterpart of
``repro/core/distributed.py``.

JAX runs one controller over a mesh and ``shard_map``s each body; the
port runs one process over a grid of ``torch.device``s and launches each
shard's work on its own device, asynchronously. No process group and no
NCCL: what crosses devices is an explicit, ordered ``.to(device)`` copy.

**Calibration-row sharding.** The paper's optimized predict is, per
(test point, label), an O(n) vector of distances, an O(1)-per-row score
update and a rank count, all row-parallel: each row shard holds n/D rows
and computes locally. The candidate's own score needs the *global* k
nearest neighbours: a local top-k, a copy of the D·k candidates to the
query's device and a top-k there. The count is a sum of int32 counts
copied the same way. Counts are integers and the global top-k is a
selection, so the k-NN p-values do not depend on the shard count (bitwise,
tested). The KDE's kernel sum is a float sum: it runs as a fixed halving
tree over 256-row blocks whose boundaries every shard count shares, so
it does not depend on the shard count either. Test queries split along
the ``query_axis`` of the mesh (data x query 2-D parallelism).

Distances are the reference's direct difference ``sqrt(max(sum((X -
x)^2), 0))``, summed over the features in a fixed left-to-right order,
not the ``pairwise_sq_dists`` kernel: it rounds differently from the
single-device ``pvalues_optimized`` (``kops.sq_dists``), so the two agree
only as the reference's do (within 1e-6 on its test data).

**Tenant sharding.** A multi-tenant tick is embarrassingly parallel
across tenants: ``put_tenant_sharded`` splits every state leaf's leading
axis into contiguous slices, one a device, and ``shard_tenant_chunk``
runs each shard's unmodified per-lane step on its own device, moving no
byte between shards; results are bitwise the single-device engine's.

**Placement.** By default N shards need N visible cards (``cuda:0 ...
cuda:N-1``) and ``tenant_mesh`` raises where there are fewer. A caller
may pass an explicit ``devices=`` list, which may name one device several
times: the port's counterpart of XLA's forced host device count, used by
the CPU tests and the one-card smoke. Shards never share a device unless
the caller asked for it.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch.utils import _pytree

from repro_torch._device import resolve, row_blocks
from repro_torch.core import pvalues as pv
from repro_torch.core.measures.knn import KnnState

BIG = 1e30  # the inert-row sentinel, as ``repro.core.distributed.BIG``

TENANT_AXIS = "tenants"

#: elements of one (queries, labels, rows) block of the row-sharded reads
BLOCK_ELEMS = 2**26

#: rows a KDE block sum covers (row shards split at its multiples)
KDE_BLOCK = 256


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------


@dataclass(frozen=True, eq=False)
class Mesh:
    """A grid of ``torch.device``s with one name an axis (the port's
    ``jax.sharding.Mesh``; not ``torch.distributed.DeviceMesh``, which
    needs a process group). An entry may repeat a device."""

    devices: np.ndarray  # object array of torch.device
    axis_names: tuple

    def __post_init__(self):
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"a {self.devices.ndim}-d device grid with "
                             f"axes {self.axis_names}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def flat(self) -> list:
        """The devices in mesh order."""
        return list(self.devices.flat)


def _indexed(device) -> torch.device:
    """``device`` with its index: ``cuda`` names the current card."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(shape, axes, devices) -> Mesh:
    """``devices`` (at least ``prod(shape)``; ``cuda`` without an index is
    the current card) laid out row-major as a grid of ``shape`` with axis
    names ``axes``."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    need = int(np.prod(shape))
    devices = [_indexed(d) for d in devices]
    if len(devices) < need:
        raise ValueError(f"a {shape} mesh needs {need} devices, got "
                         f"{len(devices)}")
    grid = np.empty(need, dtype=object)
    grid[:] = devices[:need]
    return Mesh(grid.reshape(shape), axes)


def visible_devices(device=None) -> list:
    """The devices ``device``'s kind offers this process: every visible
    card for ``cuda`` (the default), else the one device."""
    dev = resolve(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def tenant_mesh(shards: int, devices=None) -> Mesh:
    """1-D ``("tenants",)`` mesh over the first ``shards`` of ``devices``
    (default: the visible cards). More shards than devices raises."""
    if shards < 1:
        raise ValueError(f"shards must be >= 1, got {shards}")
    devs = visible_devices() if devices is None else list(devices)
    if shards > len(devs):
        raise ValueError(
            f"shards={shards} exceeds the {len(devs)} visible device(s); "
            "to place several shards on one device pass an explicit "
            "devices= list (e.g. devices=[torch.device('cuda:0')] * N)")
    return make_mesh((shards,), (TENANT_AXIS,), devs)


# ---------------------------------------------------------------------------
# tenant-axis sharding (the serving engines' multi-device path)
# ---------------------------------------------------------------------------


def _flatten(tree):
    """``(leaves, rebuild)`` of a state (``leaves()`` / ``from_leaves``),
    a tensor, or a dict / list / tuple of tensors."""
    if hasattr(tree, "leaves") and hasattr(type(tree), "from_leaves"):
        return list(tree.leaves()), type(tree).from_leaves
    leaves, spec = _pytree.tree_flatten(tree)
    return leaves, lambda ls: _pytree.tree_unflatten(list(ls), spec)


class TenantSharded:
    """A tenant-stacked state split along its leading axis: ``parts[i]``
    (the same type as the whole) holds lanes ``cuts[i]:cuts[i + 1]`` on
    ``mesh.flat()[i]``."""

    def __init__(self, parts, mesh: Mesh):
        self.parts = list(parts)
        self.mesh = mesh
        sizes = [int(_flatten(p)[0][0].shape[0]) for p in self.parts]
        self.cuts = [0] + list(np.cumsum(sizes).tolist())

    @property
    def n_lanes(self) -> int:
        return self.cuts[-1]

    @property
    def capacity(self) -> int:
        return self.parts[0].capacity

    def clone(self) -> "TenantSharded":
        return TenantSharded([p.clone() for p in self.parts], self.mesh)

    def locate(self, lane: int) -> tuple:
        """``(part, local lane)`` of global lane ``lane``."""
        i = int(np.searchsorted(self.cuts, lane, side="right")) - 1
        if not 0 <= i < len(self.parts) or lane >= self.n_lanes:
            raise IndexError(f"lane {lane} outside [0, {self.n_lanes})")
        return self.parts[i], lane - self.cuts[i]

    def leaves(self) -> list:
        """Every part's leaves, part by part (storage checks read them)."""
        return [leaf for p in self.parts for leaf in _flatten(p)[0]]


def parts_of(state) -> list:
    """A state's shards: its parts, or the state itself."""
    return state.parts if isinstance(state, TenantSharded) else [state]


def put_tenant_sharded(tree, mesh: Mesh) -> TenantSharded:
    """Every leaf's leading axis split into contiguous slices, copied to
    the mesh's devices in order (each part owns its storage)."""
    leaves, rebuild = _flatten(tree)
    S, N = int(leaves[0].shape[0]), mesh.size
    cuts = [S * i // N for i in range(N + 1)]
    return TenantSharded(
        [rebuild([leaf[cuts[i]:cuts[i + 1]].to(
            dev, copy=True, memory_format=torch.contiguous_format)
            for leaf in leaves]) for i, dev in enumerate(mesh.flat())],
        mesh)


def gather_tenants(state, device=None):
    """A tenant-sharded state concatenated back onto ``device`` (default:
    the first shard's), leaf by leaf; any other state as it is."""
    if not isinstance(state, TenantSharded):
        return state
    dev = state.mesh.flat()[0] if device is None else torch.device(device)
    flat = [_flatten(p) for p in state.parts]
    return flat[0][1]([torch.cat([leaves[j].to(dev) for leaves, _ in flat])
                       for j in range(len(flat[0][0]))])


def pad_tenant_count(n: int, shards: int) -> int:
    """Smallest multiple of ``shards`` >= n (the padded lane count).

    Uneven tenant counts shard by padding with inactive lanes: padded
    lanes stay at their init state (``active`` masks them out of every
    tick), so the live lanes' results are unchanged (tested)."""
    if shards < 1:
        raise ValueError(f"shards must be >= 1, got {shards}")
    return -(-n // shards) * shards


def _lane_slice(t: torch.Tensor, lo: int, hi: int, axis: int, dev):
    return t.narrow(axis, lo, hi - lo).to(dev)


def shard_tenant_chunk(step, mesh: Mesh):
    """A chunk of ticks over a tenant-sharded state, one ``step`` a tick
    and a shard.

    ``step(part, x, y, tau, active) -> (part, p)`` is the engines'
    unmodified per-lane tick; the returned ``chunk(state, xs, ys, taus,
    actives) -> (state, p (T, S))`` slices the ``(T, S, ...)`` traffic
    along its tenant axis onto each shard's device and runs tick ``t`` of
    every shard before tick ``t + 1`` of any, so each device has work
    queued while the host enqueues the others. Nothing is copied between
    shards; the p-values come back as one ``(T, S)`` tensor on the first
    shard's device. The (JAX) chunk's per-shard tick statistics are
    recorded by the engine before the chunk (``telemetry.device``)."""
    devs = mesh.flat()

    def chunk(state: TenantSharded, xs, ys, taus, actives):
        cuts = state.cuts
        ins = [[_lane_slice(a, cuts[i], cuts[i + 1], 1, dev)
                for a in (xs, ys, taus, actives)]
               for i, dev in enumerate(devs)]
        parts = list(state.parts)
        ps = [[] for _ in devs]
        for t in range(xs.shape[0]):
            for i, (x, y, tau, act) in enumerate(ins):
                parts[i], p = step(parts[i], x[t], y[t], tau[t], act[t])
                ps[i].append(p)
        p = torch.cat([torch.stack(pi).to(devs[0]) for pi in ps], dim=1)
        return TenantSharded(parts, mesh), p

    return chunk


def shard_tenant_fn(fn, mesh: Mesh, in_tenant):
    """A read-path ``fn`` run shard by shard. ``in_tenant`` is one bool a
    positional argument: True splits it along its leading (tenant) axis
    (a ``TenantSharded`` state gives its parts), False copies it to each
    shard's device (a query grid). The outputs are concatenated along
    the tenant axis on the first shard's device."""
    devs = mesh.flat()

    def sharded(*args):
        cuts = next(a.cuts for a in args if isinstance(a, TenantSharded))
        outs = []
        for i, dev in enumerate(devs):
            local = []
            for a, tenant in zip(args, in_tenant):
                if isinstance(a, TenantSharded):
                    local.append(a.parts[i])
                else:
                    local.append(_lane_slice(a, cuts[i], cuts[i + 1], 0, dev)
                                 if tenant else a.to(dev))
            outs.append(fn(*local))
        return torch.cat([o.to(devs[0]) for o in outs])

    return sharded


# ---------------------------------------------------------------------------
# calibration-row sharding
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CpShardingConfig:
    """Mesh-axis assignment for sharded CP serving."""

    row_axes: tuple = ("data",)  # calibration rows shard here
    query_axis: str | None = "model"  # test queries shard here (None = repl.)


def pad_rows(arr: np.ndarray, n_padded: int, fill) -> np.ndarray:
    """Pad axis 0 to ``n_padded`` with an inert fill value."""
    pad = n_padded - arr.shape[0]
    if pad == 0:
        return arr
    widths = [(0, pad)] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, widths, constant_values=fill)


def _grid(mesh: Mesh, cfg: CpShardingConfig) -> np.ndarray:
    """The mesh's devices as a ``(row shards, query shards)`` grid; any
    other axis replicates, so its first entry stands for it."""
    names = list(mesh.axis_names)
    q = [cfg.query_axis] if cfg.query_axis else []
    missing = [a for a in (*cfg.row_axes, *q) if a not in names]
    if missing:
        raise ValueError(f"mesh axes {names} lack {missing}")
    rest = [a for a in names if a not in cfg.row_axes and a not in q]
    order = [names.index(a) for a in (*cfg.row_axes, *q, *rest)]
    g = mesh.devices.transpose(order)
    g = g[(Ellipsis,) + (0,) * len(rest)] if rest else g
    R = int(np.prod([mesh.shape[a] for a in cfg.row_axes]))
    return g.reshape(R, mesh.shape[cfg.query_axis] if q else 1)


class RowSharded:
    """Calibration leaves split by rows over a mesh's row shards:
    ``parts[r][q]`` holds row shard ``r``'s leaves on the device of grid
    cell ``(r, q)`` (a copy a query shard). ``n_live`` counts the real
    rows."""

    def __init__(self, parts, grid: np.ndarray, n_live: int):
        self.parts = parts
        self.grid = grid
        self.n_live = n_live


def shard_rows(mesh: Mesh, cfg: CpShardingConfig, leaves, fills,
               block: int = 1) -> RowSharded:
    """``leaves`` (tensors or arrays with one leading row axis; the first
    are the labels, ``y >= 0`` live) padded with ``fills`` to a multiple
    of the row shards (times ``block``) and placed on the grid."""
    grid = _grid(mesh, cfg)
    R, Q = grid.shape
    n = int(leaves[0].shape[0])
    n_pad = -(-n // (R * block)) * R * block
    host = [torch.as_tensor(np.asarray(pad_rows(np.asarray(
        a.cpu() if isinstance(a, torch.Tensor) else a), n_pad, f)))
        for a, f in zip(leaves, fills)]
    per = n_pad // R
    parts = [[[t[r * per:(r + 1) * per].to(grid[r, q]) for t in host]
              for q in range(Q)] for r in range(R)]
    n_live = int((host[0] >= 0).sum())
    return RowSharded(parts, grid, n_live)


def shard_knn_state(state: KnnState, mesh: Mesh,
                    cfg: CpShardingConfig = CpShardingConfig()
                    ) -> RowSharded:
    """Pad rows to the row-shard multiple and place them on the mesh.

    Padding rows get label -1 (matches no candidate label) and BIG
    distance lists, so they never enter any count: exactness is
    preserved. Each part holds ``(y, X, best_same, best_diff)``."""
    return shard_rows(mesh, cfg, (state.y, state.X, state.best_same,
                                  state.best_diff), (-1, 0.0, BIG, BIG))


def _sq_dists(X: torch.Tensor, Xq: torch.Tensor) -> torch.Tensor:
    """``max(sum_j (X - x)_j^2, 0)`` ``(b, n)``, the features summed left
    to right, so a row's bits do not depend on the rows beside it."""
    acc = torch.zeros((Xq.shape[0], X.shape[0]), dtype=X.dtype,
                      device=X.device)
    for j in range(X.shape[1]):
        diff = X[None, :, j] - Xq[:, None, j]
        acc += diff * diff
    return acc.clamp_(min=0.0)


def _k_smallest(cand: torch.Tensor, k: int) -> torch.Tensor:
    """The ``k`` smallest of the last axis, ascending, BIG-padded where it
    is shorter (values only: the tie order cannot change them)."""
    if cand.shape[-1] < k:
        cand = torch.cat([cand, cand.new_full(
            cand.shape[:-1] + (k - cand.shape[-1],), BIG)], -1)
    return torch.sort(torch.topk(cand, k, largest=False,
                                 sorted=False).values, -1).values


def _global_k_best(local, k: int, home) -> torch.Tensor:
    """Global k smallest masked distances across the row shards: the
    shards' local ``(.., k)`` bests copied to ``home`` in shard order,
    then the k smallest of those ``D * k`` candidates, ascending."""
    return _k_smallest(torch.cat([c.to(home) for c in local], -1), k)


def _fsum(a: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis, left to right (0 over an empty axis)."""
    acc = a.new_zeros(a.shape[:-1])
    for j in range(a.shape[-1]):
        acc = acc + a[..., j]
    return acc


def _query_cuts(m: int, Q: int) -> list:
    return [m * i // Q for i in range(Q + 1)]


def make_knn_pvalues_fn(mesh: Mesh, *, k: int, simplified: bool,
                        n_labels: int,
                        cfg: CpShardingConfig = CpShardingConfig()):
    """Sharded k-NN full-CP p-values: ``pvalues(state, X_test) -> (m,
    n_labels)`` for a ``state`` from ``shard_knn_state``, on the mesh's
    first device. Queries split along ``cfg.query_axis`` and go in blocks
    of at most ``BLOCK_ELEMS`` (queries x labels x local rows); neither the
    blocks nor the shard counts change a bit."""

    def per_block(cells, Xq, home):
        """One block of queries ``Xq`` on query shard ``cells``' devices
        (``cells[r]`` row shard r's leaves and device)."""
        L = n_labels
        local, upd = [], []
        for (y, X, bs, bd), dev in cells:
            labels = torch.arange(L, dtype=y.dtype, device=dev)
            x = Xq.to(dev)
            d = torch.sqrt(_sq_dists(X, x))[:, None, :]  # (b, 1, n)
            same = (y[None, :] == labels[:, None])[None]  # (1, L, n)
            live = y >= 0
            num = _k_smallest(torch.where(same, d, BIG), k)
            den = (None if simplified else
                   _k_smallest(torch.where(~same & live, d, BIG), k))
            local.append((num, den))
            upd.append((d, same, live, y, bs, bd))
        num = _global_k_best([c[0] for c in local], k, home)
        alpha = _fsum(num)
        if not simplified:
            alpha = alpha / _fsum(_global_k_best([c[1] for c in local], k,
                                                 home))
        cnt = 0
        for (d, same, live, y, bs, bd), (_, dev) in zip(upd, cells):
            # cancellation-safe: base (k - 1 best) + (kth or d)
            kth_s = bs[:, -1]
            alphas = _fsum(bs[:, :-1]) + torch.where(
                same & (d < kth_s), d, kth_s)
            if not simplified:
                kth_d = bd[:, -1]
                alphas = alphas / (_fsum(bd[:, :-1]) + torch.where(
                    ~same & live & (d < kth_d), d, kth_d))
            hit = live & (alphas >= alpha.to(dev)[..., None])
            cnt = cnt + hit.sum(-1, dtype=torch.int32).to(home)
        return cnt

    def pvalues(state: RowSharded, X_test) -> torch.Tensor:
        grid = state.grid
        R, Q = grid.shape
        home0 = grid[0, 0]
        X_test = torch.as_tensor(X_test, dtype=torch.float32)
        qc = _query_cuts(X_test.shape[0], Q)
        n_loc = state.parts[0][0][0].shape[0]
        out = []
        for q in range(Q):
            home = grid[0, q]
            Xs = X_test[qc[q]:qc[q + 1]].to(home)
            cells = [(state.parts[r][q], grid[r, q]) for r in range(R)]
            for b0, b1 in row_blocks(Xs.shape[0], n_labels * n_loc,
                                     BLOCK_ELEMS):
                cnt = per_block(cells, Xs[b0:b1], home)
                out.append(pv.pvalue_from_counts(cnt, state.n_live)
                           .to(home0))
        return torch.cat(out) if out else X_test.new_zeros(
            (0, n_labels), device=home0)

    return pvalues


def _tree_sum(a: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (a power of two long) as a fixed halving
    tree: each level adds the upper half onto the lower."""
    while a.shape[-1] > 1:
        h = a.shape[-1] // 2
        a = a[..., :h] + a[..., h:]
    return a[..., 0]


def _pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def make_kde_pvalues_fn(mesh: Mesh, *, h: float, p_dim: int, n_labels: int,
                        cfg: CpShardingConfig = CpShardingConfig()):
    """Sharded KDE full CP: ``pvalues(X, y, prelim, X_test) -> (m,
    n_labels)`` on the mesh's first device. ``X``, ``y`` and ``prelim``
    (the fit's same-label kernel sums) are split by rows on each call;
    the class counts and the rank count are int32 sums across the shards,
    and the candidate's kernel sum adds ``KDE_BLOCK``-row block sums (one
    halving tree a block) in one halving tree over the blocks of the
    unpadded rows, so it is the same for every row-shard count."""
    hp = h ** p_dim
    two_h2 = 2.0 * h * h
    L = n_labels

    def per_block(cells, Xq, counts, home, nb):
        local, sums = [], []
        for (y, X, prelim), dev in cells:
            labels = torch.arange(L, dtype=y.dtype, device=dev)
            d2 = _sq_dists(X, Xq.to(dev))
            kv = torch.exp(-d2 / d2.new_full((), two_h2))[:, None, :]
            same = (y[None, :] == labels[:, None])[None]  # (1, L, n)
            masked = torch.where(same, kv, 0.0)
            blocks = masked.view(masked.shape[0], L, -1, KDE_BLOCK)
            sums.append(_tree_sum(blocks).to(home))  # (b, L, blocks)
            local.append((kv, same, y, prelim))
        ksum = torch.cat(sums, -1)[..., :nb]  # past nb: padding, all 0
        if ksum.shape[-1] < nb:
            ksum = torch.cat([ksum, ksum.new_zeros(
                ksum.shape[:-1] + (nb - ksum.shape[-1],))], -1)
        c = counts[None, :]
        alpha = -torch.where(c > 0, _tree_sum(ksum) / (c * hp), 0.0)
        cnt = 0
        for (kv, same, y, prelim), (_, dev) in zip(local, cells):
            cc = counts.to(dev)
            sums_i = torch.where(same, prelim + kv, prelim)
            n_y = cc[y.clamp(min=0).long()] - 1 + same.to(torch.int32)
            alphas = -torch.where(n_y > 0, sums_i / (n_y * hp), 0.0)
            hit = (y >= 0) & (alphas >= alpha.to(dev)[..., None])
            cnt = cnt + hit.sum(-1, dtype=torch.int32).to(home)
        return cnt

    def pvalues(X, y, prelim, X_test) -> torch.Tensor:
        st = shard_rows(mesh, cfg, (y, X, prelim), (-1, 0.0, 0.0),
                        block=KDE_BLOCK)
        grid = st.grid
        R, Q = grid.shape
        home0 = grid[0, 0]
        nb = _pow2(-(-int(y.shape[0]) // KDE_BLOCK))
        X_test = torch.as_tensor(X_test, dtype=torch.float32)
        qc = _query_cuts(X_test.shape[0], Q)
        out = []
        for q in range(Q):
            home = grid[0, q]
            cells = [(st.parts[r][q], grid[r, q]) for r in range(R)]
            counts = 0
            for (yr, _, _), dev in cells:
                labels = torch.arange(L, dtype=yr.dtype, device=dev)
                counts = counts + (yr[None, :] == labels[:, None]).sum(
                    -1, dtype=torch.int32).to(home)
            Xs = X_test[qc[q]:qc[q + 1]].to(home)
            n_loc = cells[0][0][0].shape[0]
            for b0, b1 in row_blocks(Xs.shape[0], L * n_loc, BLOCK_ELEMS):
                cnt = per_block(cells, Xs[b0:b1], counts, home, nb)
                out.append(pv.pvalue_from_counts(cnt, st.n_live).to(home0))
        return torch.cat(out) if out else X_test.new_zeros(
            (0, L), device=home0)

    return pvalues


__all__ = [
    "BIG", "CpShardingConfig", "Mesh", "RowSharded", "TENANT_AXIS",
    "TenantSharded", "gather_tenants", "make_kde_pvalues_fn",
    "make_knn_pvalues_fn", "make_mesh", "pad_rows", "pad_tenant_count",
    "parts_of", "put_tenant_sharded", "shard_knn_state", "shard_rows",
    "shard_tenant_chunk", "shard_tenant_fn", "tenant_mesh",
    "visible_devices",
]
