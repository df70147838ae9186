"""Routing for the port's kernels, counterpart of ``repro/kernels/ops.py``.

A CUDA float32 tensor goes to the hand-written kernel; a CPU tensor goes
to the plain version in ``ref.py``. A CUDA tensor the kernel does not take
(float64, k above the kernel's maximum) raises: nothing on CUDA quietly
runs the plain version. The device decision itself sits in each kernel's
wrapper; this module takes the batched form (leading tenant axis) the
callers use, brings ``stream_update``'s ring scalars to the wrapper's
per-tenant form and keeps the launch counts, ``stream_update``'s per mode
(its fused serving-tick form, ``stream_tick``, counts there too).
``kde_rowsums`` takes the unbatched ``(m, p)`` form of the batch measures;
``flash_attention`` the ``(B, S, H, D)`` layout of the LM substrate (bf16
or f32 on the card), through a ``torch.autograd.Function`` whose forward
is the kernel's single launch (the plain version on the CPU and on
``meta``, the dry run's device) and whose backward is
``flash_attention_bwd`` on every device. DTensor operands (a sharded
program's) placed over batch and heads only run that Function on each
rank's block (``_local_route``): no row or head needs another rank's, so
the result is exact; where the rules shard q's heads but replicate k and
v (GQA with fewer kv heads than the model axis), a rank passes the kv
heads its global q heads map to. Any other placement raises on the card
and runs the plain version on the DTensors on the CPU and ``meta``.

The bootstrap measure's forest (``boot_fit_forest``, ``boot_forest_predict``)
is plain PyTorch on the device it is given (``boot_forest.py``): numpy in
and out, as the measure keeps its state on the host. Each call on the
card counts one call (``forest_calls()``; it runs many CUDA kernels) and
the bytes it copies to the card.
"""
from __future__ import annotations

import contextlib

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

from repro_torch._device import resolve
from repro_torch.kernels import boot_forest as _boot
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.cp_update import cp_knn_counts as _cp_knn_counts
from repro_torch.kernels.flash_attention import (DENSE_SCORE_LIMIT,
                                                 flash_attention_bwd)
from repro_torch.kernels.flash_attention import flash_attention as _flash
from repro_torch.kernels.interval_sweep import interval_sweep as _sweep
from repro_torch.kernels.kde_score import kde_rowsums as _kde_rowsums
from repro_torch.kernels.pairwise_dist import pairwise_sq_dists
from repro_torch.kernels.stream_update import stream_update as _stream_update
from repro_torch.kernels.stream_update import (stream_update_class,
                                               stream_update_reg)

KERNELS = {
    "stream_update_class": stream_update_class,
    "stream_update_reg": stream_update_reg,
    "pairwise_sq_dists": pairwise_sq_dists,
    "cp_knn_counts": _cp_knn_counts,
    "interval_sweep": _sweep,
    "kde_rowsums": _kde_rowsums,
    "flash_attention": _flash,
}

# past this many score elements per (batch, head), a CPU or meta tensor
# takes the chunked online-softmax version, so long sequences stay
# memory-bounded
_DENSE_SCORE_LIMIT = DENSE_SCORE_LIMIT
# the devices on which flash_attention runs its plain version: the CPU, and
# ``meta`` (the dry run's shapes-only tensors), where no kernel can launch
_PLAIN_DEVICES = ("cpu", "meta")


def attention_observers() -> list:
    """The active dispatch modes that count a flash_attention call at its
    boundary (``analysis.flops.FlopCounter``, ``analysis.census.Census``:
    the kernel's launch is invisible to them), innermost last. Dispatch
    modes, so the autograd engine's device threads (a checkpoint's
    recomputation on the card) see them too."""
    return [mode for mode in _get_current_dispatch_mode_stack()
            if getattr(mode, "counts_attention", False)]


def kernel_launches() -> dict[str, int]:
    """Launches of each hand-written kernel since the last reset."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def forest_calls() -> dict[str, int]:
    """The bootstrap forest's calls on the card since the last reset, each
    a plain PyTorch function that runs many CUDA kernels (not one launch),
    and under ``h2d_bytes`` the bytes those calls copied to the card."""
    calls = {name: fn.launches for name, fn in FOREST.items()}
    calls["h2d_bytes"] = sum(fn.h2d_bytes for fn in FOREST.values())
    return calls


def launch_counts() -> dict[str, int]:
    """``kernel_launches()`` and the forest's calls on the card (calls, not
    kernel launches: ``forest_calls()``), one count a wrapper."""
    return {name: fn.launches for name, fn in {**KERNELS, **FOREST}.items()}


def reset_launch_counts() -> None:
    for fn in (*KERNELS.values(), *FOREST.values()):
        fn.launches = 0
    for fn in FOREST.values():
        fn.h2d_bytes = 0


def sq_dists(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Squared distances ``(S, m, n)``."""
    return pairwise_sq_dists(A, B)


def cp_knn_counts(X, y, sum_same, kth_same, X_test, alpha, n_labels):
    """Fused score update + counts ``(S, m, L)``."""
    return _cp_knn_counts(X, y, sum_same, kth_same, X_test, alpha,
                          n_labels=n_labels)


def interval_sweep(X, a_prime, kth_dist, kth_label, live, X_test, a_test,
                   k):
    """Regression-CP critical points ``lo, hi (S, m, n)``."""
    return _sweep(X, a_prime, kth_dist, kth_label, live, X_test, a_test,
                  k=k)


def kde_rowsums(A, B, y_A, y_B, h: float, exclude_diag: bool = False,
                n_labels: int | None = None):
    """Masked Gaussian row sums ``(m,)`` of ``A (m, p)`` against ``B (n,
    p)`` (unbatched, as the KDE measure calls it); with ``y_A=None``,
    every label's sums ``(m, n_labels)``."""
    return _kde_rowsums(A, B, y_A, y_B, h, exclude_diag, n_labels)


def _scalars(v, S: int, device) -> torch.Tensor:
    return _ref.on_device(v, device).expand(S).contiguous()


def stream_update(X, y, nbr_d, nbr_y, x_new, y_new, n, *, mode, head=None,
                  wrap=None):
    """Distance row + gated ordered k-best merge for one new point per
    tenant. ``head=None`` is the linear layout; ``wrap`` defaults to the
    capacity. ``nbr_y=None`` (classification keeps no label lists) is
    passed through. Returns ``(d_row, nbr_d', nbr_y')``. Reg mode runs
    the tick's one form with zero arrival ids, whose merge it drops."""
    ids = {}
    if mode == "reg":
        ids = dict(nbr_a=torch.zeros(nbr_d.shape, dtype=torch.int32,
                                     device=nbr_d.device),
                   new_aid=torch.zeros(X.shape[0], dtype=torch.int32,
                                       device=X.device))
    return stream_tick(X, y, nbr_d, nbr_y, x_new, y_new, n, mode=mode,
                       head=head, wrap=wrap, **ids)[:3]


def stream_tick(X, y, nbr_d, nbr_y, x_new, y_new, n, *, mode, head=None,
                wrap=None, D=None, ev=None, aid=None, nbr_a=None,
                new_aid=None):
    """``stream_update`` with the serving tick's extras, one launch: with
    ``ev (S,)`` the lists of the evicting tenants are first repaired in
    place for the point at slot ``head - 1`` (``D``, and ``aid`` in reg
    mode), ``(head, n)`` being the window after the eviction; reg mode
    merges the arrival-id lists ``nbr_a`` with the new points' ids
    ``new_aid`` too. Returns ``(d_row, nbr_d', nbr_y', nbr_a', lsum)``:
    ``lsum`` the repaired lists' fixed-order sum (``fsum(nbr_d[...,
    :-1])`` in class mode, ``fsum(nbr_y)`` in reg mode)."""
    S, cap = X.shape[:2]
    dev = X.device
    head = _scalars(0 if head is None else head, S, dev)
    wrap = _scalars(cap if wrap is None else wrap, S, dev)
    # class labels are int32; the regression state's labels are floats
    y_new = (_scalars(y_new, S, dev) if mode == "class" else
             _ref.on_device(y_new, dev, y.dtype).expand(S).contiguous())
    return _stream_update(X, y, nbr_d, nbr_y, x_new, y_new,
                          _scalars(n, S, dev), mode=mode, head=head,
                          wrap=wrap, D=D, ev=ev, aid=aid, nbr_a=nbr_a,
                          new_aid=new_aid)


def _plain_attention(q, k, v, **kw):
    """The plain version's route off the card: dense, or past
    ``_DENSE_SCORE_LIMIT`` score elements chunked; on ``meta``, which holds
    no memory to bound, as one block of every query and key."""
    if q.shape[1] * k.shape[1] <= _DENSE_SCORE_LIMIT:
        return _ref.flash_attention(q, k, v, **kw)
    if q.device.type == "meta":
        kw = dict(kw, block_q=q.shape[1], block_k=k.shape[1])
    return _ref.chunked_attention(q, k, v, **kw)


class _FlashAttention(torch.autograd.Function):
    """The kernel (or on the CPU and ``meta`` the plain version) forward;
    ``flash_attention_bwd`` backward, from the saved operands. Each of
    ``attention_observers()`` counts the forward at its boundary, whichever
    route runs (one that yields a list gets the output appended)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, softcap):
        kw = dict(causal=causal, window=window, scale=scale, softcap=softcap)
        with contextlib.ExitStack() as stack:
            held = [stack.enter_context(m.attention(q, k, v, **kw))
                    for m in attention_observers()]
            if q.device.type in _PLAIN_DEVICES:
                out = _plain_attention(q, k, v, **kw)
            else:  # the kernel, or it raises
                out = _flash(q, k, v, **kw)
            for h in held:
                if isinstance(h, list):
                    h.append(out)
        if any(ctx.needs_input_grad[:3]):
            ctx.save_for_backward(q, k, v)
            ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, dout.contiguous(),
                                         limit=_DENSE_SCORE_LIMIT, **ctx.kw)
        return dq, dk, dv, None, None, None, None


def _local_plan(q, k, v):
    """How each rank computes a DTensor attention from its own blocks:
    ``(kv_heads, k_grad_placements)``, ``kv_heads`` the ``(start, stop)``
    of the local kv heads its local q heads read (None: all of them), or
    None where the placements split a sequence or the head dim (or mix
    in a partial sum). q's heads may shard over one mesh dim where k and
    v stay whole: that dim's kv gradient is then a partial sum."""
    from torch.distributed.tensor import DTensor, Partial

    if not (isinstance(k, DTensor) and isinstance(v, DTensor)) or \
            k.device_mesh != q.device_mesh or k.placements != v.placements:
        return None
    H, Hkv = q.shape[2], k.shape[2]
    grad, sliced = list(k.placements), None
    for i, (pq, pk) in enumerate(zip(q.placements, k.placements)):
        if pq == pk and (pq.is_replicate() or pq.is_shard(0)
                         or pq.is_shard(2)):
            continue
        if pq.is_shard(2) and pk.is_replicate() and sliced is None:
            sliced, grad[i] = i, Partial()
            continue
        return None
    if sliced is None:
        return None, tuple(grad)
    if any(p.is_shard(2) for j, p in enumerate(q.placements) if j != sliced):
        return None
    mesh = q.device_mesh
    heads = local_kv_heads(H, Hkv, mesh.size(sliced),
                           mesh.get_local_rank(sliced))
    return None if heads is None else (heads, tuple(grad))


def local_kv_heads(H: int, Hkv: int, shards: int, index: int):
    """The ``(start, stop)`` of the kv heads that block ``index`` of
    ``shards`` equal blocks of ``H`` q heads reads under the global GQA map
    (q head ``h`` reads kv head ``h * Hkv // H``), such that the kernel's
    own map on the block (local q head ``j`` reads local kv head ``j *
    (stop - start) // (H / shards)``) is the global one; None where no
    slice does that."""
    rep = H // Hkv
    n_local = H // shards
    h0 = index * n_local
    if n_local % rep == 0:
        return h0 // rep, (h0 + n_local) // rep
    if rep % n_local == 0:  # every local q head reads one kv head
        return h0 // rep, h0 // rep + 1
    return None


def _local_route(q, k, v, plan, kw):
    """``_FlashAttention`` on this rank's blocks, the result a DTensor
    placed as q."""
    from torch.distributed.tensor import DTensor

    heads, grad = plan
    kl = k.to_local(grad_placements=grad)
    vl = v.to_local(grad_placements=grad)
    if heads is not None:
        kl = kl[:, :, heads[0]:heads[1]].contiguous()
        vl = vl[:, :, heads[0]:heads[1]].contiguous()
    out = _FlashAttention.apply(q.to_local(), kl, vl, kw["causal"],
                                kw["window"], kw["scale"], kw["softcap"])
    # the global stride from the local output's (the plain version's
    # output is not contiguous)
    return DTensor.from_local(out, q.device_mesh, q.placements,
                              run_check=False)


def flash_attention(q, k, v, *, causal=True, window=None, scale=None,
                    softcap=None):
    """Attention ``(B, Sq, H, D)`` over ``k, v (B, Skv, Hkv, D)``, as
    ``repro/kernels/ops.py::flash_attention`` routes it: the kernel on the
    card; on the CPU and on ``meta`` the plain dense version, or the
    chunked one past ``_DENSE_SCORE_LIMIT`` score elements.
    Differentiable in ``q, k, v`` (``flash_attention_bwd``). DTensors
    placed over batch and heads run on each rank's blocks (any ``Sq`` and
    ``Skv``, any head dim the kernel takes, one kv head on every block);
    other placements raise on the card."""
    from repro_torch.sharding.activation import is_dtensor

    if is_dtensor(q):
        kw = dict(causal=causal, window=window, scale=scale, softcap=softcap)
        plan = _local_plan(q, k, v)
        if plan is not None:
            return _local_route(q, k, v, plan, kw)
        if q.device.type not in _PLAIN_DEVICES:
            raise ValueError(
                "flash_attention kernel: DTensor placements q "
                f"{tuple(q.placements)}, k {tuple(k.placements)} split a "
                "sequence or the head dim; shard batch and heads only")
    return _FlashAttention.apply(q, k, v, causal, window, scale, softcap)


def _on(a, dtype, dev, counter) -> torch.Tensor:
    """``a`` (numpy or tensor) as a ``dtype`` tensor on ``dev``; a copy to
    the card adds its bytes to ``counter.h2d_bytes``."""
    t = torch.as_tensor(a, dtype=dtype)
    if t.device != dev:
        if dev.type == "cuda":
            counter.h2d_bytes += t.nbytes
        t = t.to(dev)
    return t


def boot_fit_forest(X, y, W, feat_choice, thr_u, *, n_labels, depth,
                    device=None):
    """Stacked weighted extra-tree fits for the bootstrap measure on
    ``device`` (``cuda`` by default): ``X (m, p)``, ``y (m,)``, ``W (S,
    m)`` multiplicities, ``feat_choice``, ``thr_u (S, n_nodes)``. Returns
    numpy ``(feat, thresh, leaf)``, each ``(S, n_nodes)``."""
    dev = resolve(device)
    f32, i32 = torch.float32, torch.int32
    on = lambda a, dt: _on(a, dt, dev, boot_fit_forest)  # noqa: E731
    out = _boot.fit_forest(on(X, f32), on(y, i32), on(W, i32),
                           on(feat_choice, i32), on(thr_u, f32),
                           n_labels=n_labels, depth=depth)
    if dev.type == "cuda":
        boot_fit_forest.launches += 1
    return tuple(t.cpu().numpy() for t in out)


def boot_forest_predict(feat, thresh, leaf, Xq, *, device=None):
    """Labels ``(S, q)`` (numpy int32) of ``S`` stacked extra-trees on the
    query rows ``Xq (q, p)``, on ``device`` (``cuda`` by default)."""
    dev = resolve(device)
    f32, i32 = torch.float32, torch.int32
    on = lambda a, dt: _on(a, dt, dev, boot_forest_predict)  # noqa: E731
    out = _boot.forest_predict(on(feat, i32), on(thresh, f32),
                               on(leaf, i32), on(Xq, f32))
    if dev.type == "cuda":
        boot_forest_predict.launches += 1
    return out.cpu().numpy()


FOREST = {"boot_fit_forest": boot_fit_forest,
          "boot_forest_predict": boot_forest_predict}
boot_fit_forest.launches = boot_fit_forest.h2d_bytes = 0
boot_forest_predict.launches = boot_forest_predict.h2d_bytes = 0
