"""Where the device time of the port's serving goes, on the card.

    python -m repro_torch.launch.profile --trace tick_trace.json
    python -m repro_torch.launch.profile --regression

At a serving cell's shapes (1024 tenants, window 1024, dim 30; k 15 for
classification, k 7 for ``--regression``), fills every tenant's window
through the engine's ``observe_many`` (drift traffic as in
``launch.serve``), then traces 8 evicting ticks and one read of 100
points per tenant with ``torch.profiler``: ``predict``, or for
``--regression`` a steady-state ``intervals`` call (one untraced call
first). For each it prints the host wall time (synchronised), the summed
device time of every kernel and its share of the wall time (the device
busy share: one stream, so kernels do not overlap), and the kernels with
the most device time. Needs a GPU.
"""
from __future__ import annotations

import argparse
import time
from collections import defaultdict

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.launch.serve import class_drift_traffic, reg_drift_traffic
from repro_torch.regression import RegressionServingEngine
from repro_torch.serving import ServingEngine

S, W, P, QUERIES = 1024, 1024, 30, 100
K_CLASS, K_REG, EPS = 15, 7, 0.1
TICKS, CHUNK, TOP, SEED = 8, 32, 15, 0
HAND_KERNELS = ("stream_update_class_kernel", "stream_update_reg_kernel",
                "pairwise_sq_dists_kernel", "cp_knn_counts_kernel",
                "interval_sweep_kernel")


def device_breakdown(fn, label: str, trace: str | None) -> None:
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    per_name = defaultdict(lambda: [0, 0.0])
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            per_name[e.name][0] += 1
            per_name[e.name][1] += e.time_range.elapsed_us() / 1e3
    busy = sum(ms for _, ms in per_name.values())
    hand = sum(ms for name, (_, ms) in per_name.items()
               if any(h in name for h in HAND_KERNELS))
    print(f"[{label}] wall {wall_ms:.3f} ms, device {busy:.3f} ms "
          f"(busy {busy / wall_ms:.1%}), hand kernels {hand:.3f} ms "
          f"({hand / max(busy, 1e-9):.1%} of device), "
          f"{sum(c for c, _ in per_name.values())} kernels")
    if busy == 0.0:
        raise RuntimeError("the profiler saw no device time")
    rows = sorted(per_name.items(), key=lambda kv: -kv[1][1])[:TOP]
    for name, (count, ms) in rows:
        print(f"  {ms:10.3f} ms {ms / busy:6.1%} x{count:<6d} {name[:100]}")
    if trace:
        prof.export_chrome_trace(trace)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--regression", action="store_true",
                    help="the regression engine's tick and intervals read")
    ap.add_argument("--trace", default="",
                    help="write the tick trace (Chrome JSON) here")
    args = ap.parse_args(argv)
    T = W + 2 * TICKS
    if args.regression:
        k = K_REG
        eng = RegressionServingEngine(n_sessions=S, capacity=W, dim=P, k=k,
                                      window=W, device="cuda")
        xs, ys, taus, _, _ = reg_drift_traffic(SEED, S, T, P, 2.0)
        read = lambda q: eng.intervals(state, q, epsilon=EPS)  # noqa: E731
        read_name = f"intervals m={QUERIES} (steady state)"
    else:
        k = K_CLASS
        eng = ServingEngine(n_sessions=S, capacity=W, dim=P, k=k, window=W,
                            device="cuda")
        xs, ys, taus, _ = class_drift_traffic(SEED, S, T, P, 2.0)
        read = lambda q: eng.predict(state, q)  # noqa: E731
        read_name = f"predict m={QUERIES}"
    state = eng.init_state()
    for c0 in range(0, W + TICKS, CHUNK):
        c1 = min(c0 + CHUNK, W + TICKS)
        state, _ = eng.observe_many(state, xs[c0:c1], ys[c0:c1],
                                    taus[c0:c1])
    print(f"[profile] {torch.cuda.get_device_name(0)}: S={S} window={W} "
          f"dim={P} k={k}, windows full, {TICKS} evicting ticks")
    sl = slice(W + TICKS, T)
    device_breakdown(
        lambda: eng.observe_many(state, xs[sl], ys[sl], taus[sl]),
        f"observe_many x{TICKS}", args.trace or None)
    Xq = np.random.default_rng(SEED + 1).standard_normal(
        (S, QUERIES, P), dtype=np.float32)
    if args.regression:
        read(Xq)  # the first call grows the allocator's pools
    device_breakdown(lambda: read(Xq), read_name, None)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
