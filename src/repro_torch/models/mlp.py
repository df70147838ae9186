"""Feed-forward layers: gated MLP (SwiGLU / GeGLU) and token-choice MoE.

Counterpart of ``repro/models/mlp.py``. The MoE keeps the reference's
sort-based capacity dispatch, group-local as the reference's is: the
tokens split into ``G = dispatch_groups()`` groups (the active mesh's
data-parallel shards; 1 without a mesh, or where ``B % G``), each routed
into its own expert slots at capacity ``cap = max(1, int(T_g * K * cf /
E))`` of its ``T_g = B * S / G`` tokens:

    1. router logits in f32 (``x.float() @ router``), softmax, top-K as
       ``jax.lax.top_k`` picks it (the lower expert id first on a tie: the
       first K of a stable descending sort), weights ``top_p / max(sum,
       1e-9)`` cast to the activation dtype;
    2. a stable sort of the group's flat ``(T_g * K,)`` expert ids groups
       the slots by expert; a slot's rank in its bucket is its position
       minus the bucket's start; slots past ``cap`` are dropped, so the
       later ``(token, k)`` pairs of a full bucket drop;
    3. the expert inputs ``(E, cap, D)`` are gathered (unused slots read a
       zero row), the experts run as three batched products;
    4. each token adds its kept contributions in ascending slot order
       (expert id) to zero, as the reference's scatter-add does on the
       CPU: K gathered adds, no atomics, so two passes are bitwise equal
       on the card.

The load-balancing loss takes its expert counts and mean router
probabilities over every group (the reference's means over ``(G, T, K)``
and ``(G, T)``). Without a mesh ``G = 1``: one group of every token. A
sharded program's DTensors run steps 1-3 on each rank's own groups
(``on_blocks``: the sort, gather and combine never cross ranks), then
the expert products and the combine on each rank's blocks of the
reference's layouts: ``"ep"`` the experts over ``"model"`` (a rank takes
its own experts' slots), ``"tp"`` the expert hidden dimension over
``"model"``. Each model rank's combine is a partial sum of the output,
reduced over ``"model"`` where the block reduce-scatters it.

Nothing of this synchronises with the host (no boolean masks, no
``bincount``), so a decode step stays free of host synchronisation, and
nothing updates a tensor in place, so autograd differentiates it (the
router through the top-K weights and the load-balancing loss, as the
reference's ``jax.grad`` does).
Routing, dispatch and the expert products are plain PyTorch and cuBLAS:
the reference runs them as XLA outside any Pallas kernel.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import act_fn, dense_init, expert_init, frozen
from repro_torch.sharding.activation import (BATCH_AXES, Out, constrain,
                                            dispatch_groups, gathered,
                                            grad_like, is_dtensor, on_blocks,
                                            reduce_partial)

_HIDDEN_TP = (BATCH_AXES, None, "model")  # the MLP hidden over "model"


# ---------------------------------------------------------------------------
# dense gated MLP
# ---------------------------------------------------------------------------


def init_mlp(generator: torch.Generator, d_model: int, d_ff: int,
             dtype) -> nn.ParameterDict:
    return frozen({
        "w_gate": dense_init((d_model, d_ff), dtype, generator),
        "w_up": dense_init((d_model, d_ff), dtype, generator),
        "w_down": dense_init((d_ff, d_model), dtype, generator),
    })


def mlp(p, x, act: str = "silu"):
    x = constrain(x, (BATCH_AXES, None, None))  # the SP all-gather
    g = act_fn(act)(constrain(
        torch.einsum("bsd,df->bsf", x, gathered(p["w_gate"])), _HIDDEN_TP))
    u = constrain(torch.einsum("bsd,df->bsf", x, gathered(p["w_up"])),
                  _HIDDEN_TP)
    # a sharded program's cotangent of the product placed as the product
    # is (one redistribution of it, not of the saved g and u)
    return torch.einsum("bsf,fd->bsd", grad_like(g * u),
                        gathered(p["w_down"]))


# ---------------------------------------------------------------------------
# mixture of experts
# ---------------------------------------------------------------------------


def init_moe(generator: torch.Generator, cfg: ArchConfig,
             dtype) -> nn.Module:
    """Router ``(d, E)`` in f32 whatever ``dtype`` is, experts ``w_gate,
    w_up (E, d, f)``, ``w_down (E, f, d)`` and, with shared experts, a
    dense MLP of width ``f * n_shared`` under ``shared``."""
    mo = cfg.moe
    d, E, f = cfg.d_model, mo.n_experts, mo.d_ff
    p = {
        "router": dense_init((d, E), torch.float32, generator),
        "w_gate": expert_init((E, d, f), dtype, generator),
        "w_up": expert_init((E, d, f), dtype, generator),
        "w_down": expert_init((E, f, d), dtype, generator),
    }
    if mo.n_shared_experts:
        p["shared"] = init_mlp(generator, d, f * mo.n_shared_experts, dtype)
    return frozen(p)


def route(p, xt, K: int):
    """``xt (T, D)`` -> ``(probs (T, E) f32, top_p (T, K) f32, top_e (T,
    K) int64)``: the router's softmax, and its K largest entries with the
    lower expert id first on a tie, renormalised to sum to 1."""
    probs = torch.softmax(xt.float() @ p["router"], dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :K], top_e[:, :K]
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return probs, top_p, top_e


def _buckets(top_e, E: int):
    """The flat ``(T * K,)`` expert ids stably sorted: ``(order,
    sorted_e, start (E,), count (E,))``, each bucket's first position and
    size found by binary search (no atomics, no host synchronisation)."""
    flat_e = top_e.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    ids = torch.arange(E, device=flat_e.device)
    start = torch.searchsorted(sorted_e, ids)
    count = torch.searchsorted(sorted_e, ids, right=True) - start
    return order, sorted_e, start, count


def _aux(probs, count, coef: float):
    """The load-balancing loss ``mean(density * mean_prob * E) * coef``;
    ``density`` is each expert's share of the ``(token, k)`` pairs times
    ``E``."""
    E = count.shape[0]
    density = count.float() / count.sum().float() * E
    return torch.mean(density * probs.mean(0) * E) * coef


def moe_dense_mixture(p, x, cfg: ArchConfig):
    """Every token runs every expert; the top-K weights combine them
    (exactly token-choice top-K, no capacity drops). Returns ``(out,
    aux)``."""
    mo = cfg.moe
    B, S, D = x.shape
    E, K = mo.n_experts, mo.n_experts_per_token
    xt = x.reshape(B * S, D)
    probs, top_p, top_e = route(p, xt, K)
    combine = torch.zeros_like(probs).scatter(1, top_e, top_p)  # (T, E)
    aux = _aux(probs, _buckets(top_e, E)[3], mo.router_aux_coef)
    g = act_fn(cfg.act)(torch.matmul(xt, p["w_gate"]))
    g = g * torch.matmul(xt, p["w_up"])
    y = torch.bmm(g, p["w_down"])  # (E, T, D)
    out = torch.einsum("etd,te->td", y, combine.to(y.dtype))
    out = out.reshape(B, S, D)
    if mo.n_shared_experts:
        out = out + mlp(p["shared"], x, cfg.act)
    return out, aux


def _dispatch_one(top_p, top_e, cap: int, dtype, buckets):
    """Sort-based slot assignment of one group, from ``_buckets(top_e,
    E)``. Returns ``(slot_tok (E * cap,) int64, slot_w (E * cap,) dtype,
    pair_slot (T, K) int64)``: each slot's token (``T`` for an unused
    slot) and weight (0 there), and each ``(token, k)`` pair's slot,
    ``E * cap`` where it was dropped."""
    T, K = top_e.shape
    order, sorted_e, start, count = buckets
    E = count.shape[0]
    dev = top_e.device
    # expert e's slot r holds the pair at sorted position start[e] + r
    r = torch.arange(cap, device=dev)
    used = r[None, :] < count[:, None]  # (E, cap)
    pair = order[torch.clamp(start[:, None] + r[None, :], max=T * K - 1)]
    slot_tok = torch.where(used, pair // K, T).reshape(-1)
    slot_w = torch.where(used, top_p.reshape(-1).to(dtype)[pair],
                         0).reshape(-1)
    # each pair's slot: its rank in its bucket, the trash slot past cap
    rank = torch.arange(T * K, device=dev) - start[sorted_e]
    slot_sorted = torch.where(rank < cap, sorted_e * cap + rank, E * cap)
    pair_slot = torch.empty_like(slot_sorted)
    pair_slot[order] = slot_sorted  # a permutation: no index repeats
    return slot_tok, slot_w, pair_slot.reshape(T, K)


def _gather(xt, slot_tok, E: int, cap: int):
    """The expert inputs ``(E, cap, D)``: each slot's token row, a zero row
    for an unused slot."""
    D = xt.shape[1]
    return torch.cat([xt, xt.new_zeros((1, D))])[slot_tok].view(E, cap, D)


def _experts(p, x_exp, act: str):
    """The batched expert FFN ``(E, cap, D) -> (E * cap, D)``, one row a
    slot."""
    E, cap, D = x_exp.shape
    g = act_fn(act)(torch.bmm(x_exp, p["w_gate"]))
    g = g * torch.bmm(x_exp, p["w_up"])
    return torch.bmm(g, p["w_down"]).view(E * cap, D)


def _combine(y, slot_w, pair_slot, lo: int = 0):
    """``out (T, D)``: each token's kept contributions ``y[s] * w[s]``
    added to zero in ascending slot order; a dropped pair (slot ``E *
    cap``) adds +0, which changes no sum that starts from +0. Out of
    place, one ``(T, D)`` gather a rank: no ``(E * cap, D)`` copy.
    ``y`` and ``slot_w`` may hold the slots from ``lo`` on only (one
    rank's experts): a pair whose slot lies outside them adds +0 too."""
    n = slot_w.shape[0]
    # expert id ascending, as slots of this rank's block
    ordered = torch.sort(pair_slot, dim=1).values - lo
    out = torch.zeros((pair_slot.shape[0], y.shape[1]), dtype=y.dtype,
                      device=y.device)
    for j in range(ordered.shape[1]):
        s = ordered[:, j]
        kept = ((s >= 0) & (s < n))[:, None]
        s = torch.clamp(s, min=0, max=n - 1)
        out = out + torch.where(kept, y[s] * slot_w[s, None], 0)
    return out


def moe(p, x, cfg: ArchConfig, decode: bool = False):
    """Token-choice top-K MoE. ``x (B, S, D)`` -> ``(out, aux)``. The
    partition is ``partition_decode`` (or ``partition``) for a decode
    step, ``partition`` otherwise: ``"dense"`` is the mixture, ``"ep"``
    and ``"tp"`` the group-local dispatch (``G = dispatch_groups()``
    groups; one of ``T = B * S`` tokens outside a mesh)."""
    mo = cfg.moe
    part = (mo.partition_decode or mo.partition) if decode \
        else mo.partition
    if part == "dense":
        return moe_dense_mixture(p, x, cfg)
    B, S, D = x.shape
    G = dispatch_groups()
    if B % G:
        G = 1
    T = B * S // G
    K, E = mo.n_experts_per_token, mo.n_experts
    cap = max(1, int(T * K * mo.capacity_factor / E))
    out, aux = _grouped(p, x, cfg, part, G, cap)
    if mo.n_shared_experts:
        out = out + mlp(p["shared"], x, cfg.act)
    return out, aux


def _dispatch_local(xg, router, K: int, E: int, cap: int):
    """Steps 1-3 of ``moe`` on each of ``xg``'s groups ``(G, T, D)``:
    ``(x_exp (G, E, cap, D), slot_w (G, E * cap), pair_slot (G, T, K),
    count (G, E), mean_prob (G, E))``, each group's ``_dispatch_one`` and
    its load-balancing statistics."""
    outs = []
    for xt in xg:
        probs, top_p, top_e = route({"router": router}, xt, K)
        buckets = _buckets(top_e, E)
        slot_tok, slot_w, pair_slot = _dispatch_one(top_p, top_e, cap,
                                                    xg.dtype, buckets)
        outs.append((_gather(xt, slot_tok, E, cap), slot_w, pair_slot,
                     buckets[3], probs.mean(0)))
    return tuple(_stacked(t) for t in zip(*outs))


def _stacked(ts):
    """``ts`` stacked along a new first dimension; one tensor as a view
    (one group copies nothing: its ``(E, cap, D)`` expert inputs are a
    prefill's largest temporary)."""
    return ts[0][None] if len(ts) == 1 else torch.stack(ts)


def _experts_local(x_exp, slot_w, pair_slot, w_gate, w_up, w_down, *,
                   act: str, lo: int, S: int):
    """Each group's experts on this rank's block of ``x_exp (G, E_r, cap,
    D)`` (``E_r`` experts from the one whose first slot is ``lo``; the
    weights' matching experts, or their hidden block) and its combine into
    ``(G * T / S, S, D)``: the output, or this rank's partial sum of it."""
    p = {"w_gate": w_gate, "w_up": w_up, "w_down": w_down}
    out = _stacked([
        _combine(_experts(p, xe, act), sw, ps, lo)
        for xe, sw, ps in zip(x_exp, slot_w, pair_slot)])
    G, T, D = out.shape
    return out.reshape(G * T // S, S, D)


def _block_start(t, dim: int) -> int:
    """The global index of this rank's first element of ``t`` along
    ``dim`` (0 for a plain tensor): ``dim``'s blocks are row-major over
    the mesh dims that shard it, in mesh order."""
    if not is_dtensor(t):
        return 0
    mesh, size, start = t.device_mesh, t.shape[dim], 0
    for i, pl in enumerate(t.placements):
        if pl.is_shard(dim):
            size //= mesh.size(i)
            start += mesh.get_local_rank(i) * size
    return start


def _grouped(p, x, cfg: ArchConfig, part: str, G: int, cap: int):
    """The dispatch of ``G`` groups, the reference's ``_grouped_dispatch``:
    the groups over the data axes, the expert layouts ``exp_spec`` of
    the partition. Returns ``(out (B, S, D), aux)``."""
    mo = cfg.moe
    B, S, D = x.shape
    K, E = mo.n_experts_per_token, mo.n_experts
    x = constrain(x, (BATCH_AXES, None, None))  # the SP all-gather
    xg = constrain(x.reshape(G, B * S // G, D), (BATCH_AXES, None, None))
    x_exp, slot_w, pair_slot, count, mean_prob = on_blocks(
        lambda xl, r: _dispatch_local(xl, r, K, E, cap),
        (xg, gathered(p["router"])), (None, None),
        tuple(Out(0, (0,) + (None,) * n) for n in (3, 1, 2, 1, 1)))
    # density over every group's (token, k) pairs, mean probability over
    # every group's tokens
    # (a sharded program's sums over the data axes' groups all-reduced
    # explicitly, before anything else takes them)
    total = reduce_partial(count.sum(0), None)
    density = total.float() / total.sum().float() * E
    aux = torch.mean(density * reduce_partial(mean_prob.mean(0), None)
                     * E) * mo.router_aux_coef
    # the partition's layouts: "ep" the experts over "model" (the expert
    # inputs and slots too), "tp" the expert hidden dimension; the weights
    # whole over the data axes
    ep = "model" if part == "ep" else None
    hid = None if ep else "model"
    x_exp = constrain(x_exp, (BATCH_AXES, ep, None, None))
    slot_w = constrain(slot_w, (BATCH_AXES, ep))
    lo = _block_start(x_exp, 1) * cap
    out = on_blocks(
        lambda xe, sw, ps, wg, wu, wd: _experts_local(
            xe, sw, ps, wg, wu, wd, act=cfg.act, lo=lo, S=S),
        (x_exp, slot_w, pair_slot, p["w_gate"], p["w_up"], p["w_down"]),
        (None, None, None, (ep, None, hid), (ep, None, hid),
         (ep, hid, None)),
        (Out(2, (0, None, None), partial=True),))
    return out, aux


__all__ = ["init_mlp", "mlp", "init_moe", "moe", "moe_dense_mixture",
           "route"]
