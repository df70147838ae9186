"""Multi-tenant online CP serving on the port's engines.

    python -m repro_torch.launch.serve --sessions 1024 --steps 2048 \\
        --window 1024 --capacity 1024 --dim 30 --k 15
    python -m repro_torch.launch.serve --regression --sessions 1024 \\
        --steps 2112 --window 1024 --capacity 1024 --dim 30 --k 7
    python -m repro_torch.launch.serve --measure kde --sessions 4 \\
        --steps 60 --window 32 --dim 4
    python -m repro_torch.launch.serve --sessions 4 --measure bootstrap \\
        --steps 48 --window 24 --boot-b 5 --tree-depth 3

Serves ``--sessions`` concurrent sliding-window CP sessions, one
``observe`` per tick (``--device cuda`` by default), on synthetic drift
traffic made with numpy from ``--seed``: odd tenants shift by ``--drift``
at half time. Classification goes through
``repro_torch.serving.ServingEngine``; ``--regression`` through
``repro_torch.regression.RegressionServingEngine`` on per-tenant linear
labels. Reports session-steps/s, tick p50/p99 (CUDA events on the card),
the launches of each kernel and the tenants flagged by their
simple-mixture martingale; then one read over ``--queries`` points per
tenant: ``predict`` p-values, or ``--regression`` prediction intervals at
``--eps`` with their coverage and median width on fresh labelled points.

``--measure NAME`` (knn, simplified_knn, kde, lssvm, bootstrap) serves
each tenant through its own registry ``ConformalPredictor`` instead, on
the same classification traffic: ``fit`` on a warm-up prefix, then per
tick ``pvalues`` of the new point, ``observe`` it, and ``evict(0)`` once
the window is full. Reports session-steps/s, per-operation ms, the
kernel launches and the bootstrap forest's calls on the card (each call
many CUDA kernels) apart, and the tenants flagged by the running maximum
of their martingale. This is how the measures without a fixed-shape
engine (bootstrap, Algorithm 3, with ``--boot-b`` trees and
``--tree-depth``) are served. The registry's regression measure
(``knn_regression``) is refused, as the JAX launcher refuses it: regression
is served by ``--regression``.

Without ``--sessions`` the launcher serves the language model ``--arch``
(qwen2-1.5b by default; full width unless ``--reduced``) with a conformal
OOD head, as the JAX launcher's LM mode does: random weights from
``--seed``, ``--calib`` calibration sequences of ``--prompt-len`` tokens
from the synthetic token stream embedded (mean final hidden state) to fit
``ConformalOodDetector(k=7)``; then ``--requests`` requests, the second
half replaced by uniform random tokens, prefilled by teacher-forced
decode steps and extended greedily by ``--gen-tokens``; prints tok/s, each
request's conformal p-value and the in-distribution / corrupted means.

    python -m repro_torch.launch.serve --arch qwen2-1.5b --calib 256 \\
        --prompt-len 512 --requests 16 --gen-tokens 32
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core.lm_conformal import (ConformalOodDetector,
                                          sequence_embedding)
from repro_torch.core.online import simple_mixture_log_martingale
from repro_torch.data.lm_pipeline import TokenStream
from repro_torch.kernels import ops
from repro_torch.models import lm
from repro_torch.regression import RegressionServingEngine
from repro_torch.serving import ServingEngine, registry


def class_drift_traffic(seed: int, S: int, T: int, dim: int, drift: float):
    """``xs (T, S, dim)`` f32, ``ys (T, S)`` int32, ``taus (T, S)`` f32
    and the ``(S,)`` drifted mask: label-shifted Gaussian features around a
    per-tenant centre; odd tenants move by ``drift`` from tick ``T // 2``
    (the change-detection workload of the paper's App. C.5)."""
    rng = np.random.default_rng(seed)
    ys = rng.integers(0, 2, (T, S), dtype=np.int32)
    xs = rng.standard_normal((T, S, dim), dtype=np.float32)
    xs += (np.arange(S, dtype=np.float32) * 0.1)[None, :, None]
    xs += ys[..., None]
    drifted = np.arange(S) % 2 == 1
    late = np.arange(T) >= T // 2
    xs[late[:, None] & drifted[None, :]] += np.float32(drift)
    taus = rng.random((T, S), dtype=np.float32)
    return xs, ys, taus, drifted


def reg_drift_traffic(seed: int, S: int, T: int, dim: int, drift: float):
    """``xs (T, S, dim)``, ``ys (T, S)``, ``taus (T, S)`` f32, the
    ``(S,)`` drifted mask and the tenants' weights ``w (S, dim)``: the
    JAX launcher's regression workload, per-tenant linear labels ``y =
    <w_s, x> + 0.1 noise``; odd tenants add ``drift`` to ``y`` from tick
    ``T // 2``."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((S, dim), dtype=np.float32)
    xs = rng.standard_normal((T, S, dim), dtype=np.float32)
    ys = np.einsum("sd,tsd->ts", w, xs)
    ys += 0.1 * rng.standard_normal((T, S), dtype=np.float32)
    drifted = np.arange(S) % 2 == 1
    late = np.arange(T) >= T // 2
    ys[late[:, None] & drifted[None, :]] += np.float32(drift)
    taus = rng.random((T, S), dtype=np.float32)
    return xs, ys, taus, drifted, w


def reg_queries(seed: int, w, m: int, shift):
    """Fresh labelled points from each tenant's current function: ``Xq
    (S, m, dim)``, ``yq (S, m)`` with ``yq = <w_s, x> + shift_s + 0.1
    noise`` (``shift (S,)``: the drift in force)."""
    rng = np.random.default_rng(seed)
    S, dim = w.shape
    Xq = rng.standard_normal((S, m, dim), dtype=np.float32)
    yq = np.einsum("sd,smd->sm", w, Xq) + np.asarray(shift)[:, None]
    yq += 0.1 * rng.standard_normal((S, m), dtype=np.float32)
    return Xq, yq.astype(np.float32)


def interval_coverage(iv, yq):
    """``(S,)`` share of ``yq (S, m)`` inside ``iv (S, m, 2)`` (an empty
    interval covers nothing) and the ``(S, m)`` widths."""
    iv = torch.as_tensor(iv).cpu().numpy()
    hit = (iv[..., 0] <= yq) & (yq <= iv[..., 1])
    return hit.mean(-1), iv[..., 1] - iv[..., 0]


def serve_sessions(args) -> int:
    S, T, dim = args.sessions, args.steps, args.dim
    if T < 2:
        raise SystemExit("--steps must be >= 2 (tick 0 is the warm-up)")
    kind = "regression" if args.regression else "classification"
    if args.regression:
        eng = RegressionServingEngine(
            n_sessions=S, capacity=args.capacity, dim=dim, k=args.k,
            window=args.window, device=args.device)
        xs, ys, taus, drifted, w = reg_drift_traffic(args.seed, S, T, dim,
                                                     args.drift)
    else:
        eng = ServingEngine(n_sessions=S, capacity=args.capacity, dim=dim,
                            k=args.k, n_labels=2, window=args.window,
                            device=args.device)
        xs, ys, taus, drifted = class_drift_traffic(args.seed, S, T, dim,
                                                    args.drift)
    on_card = eng.device.type == "cuda"
    print(f"[serve] {kind} engine: {S} sessions x cap {args.capacity} "
          f"(window={args.window}, k={args.k}, dim={dim}) on {eng.device}")
    state = eng.init_state()
    pvals = np.full((T, S), np.nan, np.float32)
    state, p = eng.observe(state, xs[0], ys[0], taus[0])  # warm-up tick
    ops.reset_launch_counts()
    ticks_ms = []
    t0 = time.perf_counter()
    for t in range(1, T):
        if on_card:
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in "ab")
            e0.record()
        else:
            h0 = time.perf_counter()
        state, p = eng.observe(state, xs[t], ys[t], taus[t])
        if on_card:
            e1.record()
            e1.synchronize()
            ticks_ms.append(e0.elapsed_time(e1))
        else:
            ticks_ms.append((time.perf_counter() - h0) * 1e3)
        pvals[t] = p.cpu().numpy()
    dt = time.perf_counter() - t0
    clock = "CUDA events" if on_card else "host clock, CPU"
    print(f"[serve] {S * (T - 1) / dt:.1f} session-steps/s over {T - 1} "
          f"ticks; tick p50 {np.percentile(ticks_ms, 50):.3f} ms, p99 "
          f"{np.percentile(ticks_ms, 99):.3f} ms ({clock})")

    logm = simple_mixture_log_martingale(torch.from_numpy(pvals[1:].T))
    flagged = (logm[:, -1] > args.log_threshold).numpy()
    print(f"[serve] drift flags: {int(flagged[drifted].sum())}/"
          f"{int(drifted.sum())} drifted tenants, "
          f"{int(flagged[~drifted].sum())}/{int((~drifted).sum())} others")

    if args.regression:
        # the last tick is past T // 2: drifted tenants are shifted
        Xq, yq = reg_queries(args.seed + 1, w, args.queries,
                             np.where(drifted, args.drift, 0.0))
        iv = eng.intervals(state, Xq, epsilon=args.eps)
        cov, width = interval_coverage(iv, yq)
        print(f"[serve] intervals at eps={args.eps}: {tuple(iv.shape)}, "
              f"coverage {cov.mean():.4f} (non-drifted "
              f"{cov[~drifted].mean():.4f}; target >= {1 - args.eps:g}), "
              f"median width {np.nanmedian(width):.4f}, empty share "
              f"{np.isnan(width).mean():.4f}")
    else:
        rng = np.random.default_rng(args.seed + 1)
        Xq = rng.standard_normal((S, args.queries, dim), dtype=np.float32)
        pv = eng.predict(state, Xq)
        print(f"[serve] predict: p-values {tuple(pv.shape)}, finite "
              f"{bool(torch.isfinite(pv).all())}")
    print(f"[serve] kernel launches: {ops.kernel_launches()}")
    return 0


def serve_registry(args) -> int:
    """Multi-tenant sliding-window serving through the measure registry
    (the counterpart of the JAX launcher's registry mode): a Python loop
    over tenants, one exact-shape ``ConformalPredictor`` each. Drift is
    flagged on the running maximum of the log martingale, since a measure
    that retrains on its window re-conforms within a few ticks."""
    spec = registry.get(args.measure)
    if spec.intervals is not None:
        raise SystemExit(
            f"--measure {args.measure} is a regression measure; use "
            "--regression for the engine-served regression path")
    S, T, dim, w = args.sessions, args.steps, args.dim, args.window
    warm = min(w, max(8, T // 4))
    if T <= warm + 2:
        raise SystemExit(f"--steps must exceed the warm-up ({warm + 2})")
    hp = {k: v for k, v in {"k": args.k, "n_labels": 2, "B": args.boot_b,
                            "depth": args.tree_depth}.items()
          if k in spec.defaults}
    xs, ys, _, drifted = class_drift_traffic(args.seed, S, T, dim,
                                             args.drift)
    xs, ys = xs.swapaxes(0, 1), ys.T  # (S, T, dim), (S, T)
    ms = {"fit": [], "pvalues": [], "observe": [], "evict": []}
    on_card = torch.device(args.device).type == "cuda"

    def timed(op, fn):
        h0 = time.perf_counter()
        out = fn()
        if on_card:
            torch.cuda.synchronize()
        ms[op].append((time.perf_counter() - h0) * 1e3)
        return out

    ops.reset_launch_counts()
    pvals = np.full((S, T - warm), np.nan, np.float32)
    t0 = time.perf_counter()
    for s in range(S):
        cp = registry.ConformalPredictor(args.measure, device=args.device,
                                         **hp)
        timed("fit", lambda: cp.fit(xs[s, :warm], ys[s, :warm]))
        for t in range(warm, T):
            p = timed("pvalues", lambda: cp.pvalues(xs[s, t][None]))
            pvals[s, t - warm] = float(p[0, ys[s, t]])
            timed("observe", lambda: cp.observe(xs[s, t], int(ys[s, t])))
            if cp.n > w:
                timed("evict", lambda: cp.evict(0))
    dt = time.perf_counter() - t0
    print(f"[serve] registry {args.measure}: {S} sessions, window {w}, "
          f"dim {dim}, warm-up {warm} on {args.device}: "
          f"{S * (T - warm) / dt:.1f} session-steps/s; per-operation ms "
          + ", ".join(f"{op} p50 {np.percentile(v, 50):.3f}"
                      for op, v in ms.items() if v)
          + (" (host clock, synchronised)" if on_card else
             " (host clock, CPU)"))
    logm = simple_mixture_log_martingale(torch.from_numpy(pvals))
    flagged = (logm.max(-1).values > args.log_threshold).numpy()
    print(f"[serve] drift flags (running max): "
          f"{int(flagged[drifted].sum())}/{int(drifted.sum())} drifted "
          f"tenants, {int(flagged[~drifted].sum())}/"
          f"{int((~drifted).sum())} others")
    print(f"[serve] kernel launches: {ops.kernel_launches()}")
    print(f"[serve] forest calls on the card (plain PyTorch, many CUDA "
          f"kernels each): {ops.forest_calls()}")
    return 0


OOD_K = 7  # the JAX launcher's ConformalOodDetector(k=7)


def lm_model(arch: str, reduced: bool, seed: int, device, **overrides):
    """``(cfg, params)``: ``arch`` (``reduced()`` if asked, then
    ``overrides``) with random weights drawn from ``seed`` on ``device``."""
    cfg = configs.get(arch)
    if reduced:
        cfg = cfg.reduced()
    if overrides:
        cfg = cfg.replace(**overrides)
    return cfg, lm.init_lm(seed, cfg, device=device)


def stream_tokens(cfg, batch: int, seq_len: int, seed: int, index: int,
                  device) -> torch.Tensor:
    """Batch ``index`` of ``TokenStream(seed)`` as an int32 tensor."""
    toks = TokenStream(cfg, batch, seq_len, seed=seed).batch_at(index)
    return torch.from_numpy(toks["tokens"]).to(device)


def request_tokens(cfg, batch: int, seq_len: int, seed: int,
                   device) -> torch.Tensor:
    """Requests from ``TokenStream(seed + 1)``, the second half replaced
    by uniform tokens drawn from a generator seeded ``seed + 2``."""
    tokens = stream_tokens(cfg, batch, seq_len, seed + 1, 0, device)
    g = torch.Generator(device=tokens.device).manual_seed(seed + 2)
    tail = tokens[batch // 2:]
    tail.copy_(torch.randint(0, cfg.vocab_size, tail.shape, generator=g,
                             device=tokens.device, dtype=tokens.dtype))
    return tokens


def embed(params, cfg, tokens) -> torch.Tensor:
    """Sequence embeddings ``(B, D)`` of ``tokens (B, S)``, one pass."""
    return sequence_embedding(params, cfg, {"tokens": tokens})


def generate(params, cfg, tokens, gen_tokens: int):
    """Teacher-forced decode steps over the prompt ``tokens (B, P)``, then
    ``gen_tokens`` greedy ones: the generated ``(B, gen_tokens)``."""
    B, P = tokens.shape
    cache = lm.init_cache(cfg, B, P + gen_tokens, tokens.device)
    logits = None
    for i in range(P):
        logits, cache = lm.decode_step(params, cfg, tokens[:, i:i + 1],
                                       cache, i)
    out = []
    cur = torch.argmax(logits[:, -1], dim=-1)[:, None]
    for g in range(gen_tokens):
        out.append(cur)
        logits, cache = lm.decode_step(params, cfg, cur, cache, P + g)
        cur = torch.argmax(logits[:, -1], dim=-1)[:, None]
    return torch.cat(out, dim=1)


def _timed(fn, device):
    """``(result, seconds)`` on the host clock, synchronised on a card."""
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def serve_lm(args) -> int:
    cfg, params = lm_model(args.arch, args.reduced, args.seed, args.device)
    dev = params["embed"].device
    B, P, G = args.requests, args.prompt_len, args.gen_tokens
    print(f"[serve] {cfg.name} ({cfg.n_layers} layers, d {cfg.d_model}, "
          f"{cfg.dtype}) on {dev}")
    ops.reset_launch_counts()

    calib = stream_tokens(cfg, args.calib, P, args.seed, 0, dev)
    calib_emb, t_emb = _timed(lambda: embed(params, cfg, calib), dev)
    ood, t_fit = _timed(
        lambda: ConformalOodDetector(k=OOD_K, device=dev).fit(calib_emb),
        dev)
    print(f"[serve] conformal OOD head fit on {args.calib} sequences "
          f"(embedding {t_emb * 1e3:.1f} ms, fit {t_fit * 1e3:.1f} ms)")

    tokens = request_tokens(cfg, B, P, args.seed, dev)
    gen, dt = _timed(lambda: generate(params, cfg, tokens, G), dev)
    req_emb = embed(params, cfg, tokens)
    pvals, t_p = _timed(lambda: ood.pvalues(req_emb), dev)
    print(f"[serve] {B} requests x {G} tokens in {dt:.2f}s "
          f"({B * G / dt:.1f} tok/s); p-values {t_p * 1e3:.2f} ms")
    pv, gen = pvals.cpu().numpy(), gen.cpu().numpy()
    for i in range(B):
        flag = "OOD!" if pv[i] <= args.eps else "ok  "
        print(f"  req {i:2d} [{flag}] p={pv[i]:.3f} "
              f"gen={[int(t) for t in gen[i][:6]]}")
    print(f"[serve] mean p in-dist={pv[:B // 2].mean():.3f} "
          f"corrupted={pv[B // 2:].mean():.3f}")
    peak = (f", peak {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} "
            "GiB" if dev.type == "cuda" else "")
    print(f"[serve] kernel launches: {ops.kernel_launches()}{peak}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sessions", type=int, default=0,
                    help="concurrent CP sessions (tenants); 0 serves the "
                    "language model --arch")
    ap.add_argument("--arch", default="qwen2-1.5b",
                    help="LM mode: the architecture (qwen2-1.5b, "
                    "qwen3-1.7b, gemma3-1b)")
    ap.add_argument("--reduced", action="store_true",
                    help="LM mode: the tiny same-family config")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-tokens", type=int, default=8)
    ap.add_argument("--calib", type=int, default=256,
                    help="LM mode: calibration sequences")
    ap.add_argument("--regression", action="store_true",
                    help="serve k-NN regression CP (linear-label traffic, "
                    "prediction intervals) instead of classification")
    ap.add_argument("--measure", default=None,
                    choices=registry.available(),
                    help="serve each tenant through a registry "
                    "ConformalPredictor of this measure")
    ap.add_argument("--boot-b", type=int, default=5,
                    help="bootstrap ensemble size B (--measure bootstrap)")
    ap.add_argument("--tree-depth", type=int, default=3,
                    help="bootstrap tree depth (--measure bootstrap)")
    ap.add_argument("--steps", type=int, default=128)
    ap.add_argument("--dim", type=int, default=8)
    ap.add_argument("--k", type=int, default=7)
    ap.add_argument("--capacity", type=int, default=128)
    ap.add_argument("--window", type=int, default=64)
    ap.add_argument("--queries", type=int, default=100,
                    help="read query points per tenant")
    ap.add_argument("--eps", type=float, default=0.1,
                    help="miscoverage of the regression intervals; the LM "
                    "mode's OOD flag level")
    ap.add_argument("--drift", type=float, default=2.0)
    ap.add_argument("--log-threshold", type=float, default=2.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    if args.sessions > 0:
        return serve_registry(args) if args.measure else serve_sessions(args)
    if args.regression or args.measure:
        raise SystemExit("--regression and --measure need --sessions N")
    return serve_lm(args)


if __name__ == "__main__":
    raise SystemExit(main())
