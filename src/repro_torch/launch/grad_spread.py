"""The first training step's gradients of one config under several
summation orders, leaf by leaf: how far rounding alone moves them.

AdamW's first step moves each weight by about ``lr`` times the sign of
its gradient, whatever the gradient's size, so where rounding decides
that sign the second loss moves with it. Each RUN is ``T`` (one process
on the CPU at ``T`` intra-op threads, the plain trainer) or ``DxM`` (the
sharded step on a ``(D, M)`` mesh, a gloo process a rank); the first RUN
is the reference. Printed: each run's first loss and gradient norm, then
for each leaf (a run's layers summed into one row) the relative L2 gap
of its gradient to the reference's and the share of its elements whose
first update flips: the gradient's sign differs from the reference's
where either exceeds AdamW's ``eps`` (below it the update is near 0).

    python -m repro_torch.launch.grad_spread --arch xlstm-125m --layers 6 \\
        --batch 8 --seq-len 512 8 2 1x4
"""
from __future__ import annotations

import argparse
import contextlib
import os
import re
import sys
import tempfile

import numpy as np
import torch


def first_grads(args, threads: int, shape=None, rank: int = 0,
                meet: str | None = None) -> dict | None:
    """The step-0 loss (``"__loss"``) and each leaf's gradient, whole, as
    numpy arrays (None on a rank other than 0), computed at ``threads``
    intra-op threads (the process's count restored after)."""
    before = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        return _first_grads(args, shape, rank, meet)
    finally:
        torch.set_num_threads(before)


def _first_grads(args, shape, rank: int, meet: str | None) -> dict | None:
    from repro_torch.launch import steps
    from repro_torch.launch.train import model_config
    from repro_torch.models import lm
    from repro_torch.models.boundary import compressed_boundaries
    from repro_torch.optim import OptimizerConfig
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    from repro_torch.sharding.activation import activation_mesh

    cfg = model_config(args.arch, args.reduced, args.layers)
    if args.float32:
        cfg = cfg.replace(dtype="float32", param_dtype="float32")
    tcfg = TrainerConfig(steps=1, ckpt_every=0, seed=args.seed,
                         batch=args.batch, seq_len=args.seq_len,
                         ckpt_dir=os.path.join(meet or tempfile.gettempdir(),
                                               "ck"))
    mesh = None
    if shape is not None:
        from repro_torch.core.distributed import make_mesh
        from repro_torch.launch.mesh import device_mesh

        mesh = device_mesh(make_mesh(shape, ("data", "model"),
                                     [torch.device("cpu")] * rank_count(
                                         shape)))
    tr = Trainer(cfg, tcfg, mesh, OptimizerConfig(), device="cpu")
    params, opt = tr.place(*tr.init_state())
    batch = tr.batch_at(0)
    with compressed_boundaries(), (contextlib.nullcontext() if mesh is None
                                   else activation_mesh(mesh)):
        loss = lm.train_step_loss(params, cfg, batch)
        if mesh is not None:
            loss = steps._replicated(loss)
        loss.backward()
        grads = steps._grads(params)
        if mesh is not None:
            grads = steps.shard_like_params(params, grads)
    whole = {n: (g.full_tensor() if hasattr(g, "full_tensor") else g)
             for n, g in grads.items()}
    if rank:
        return None
    out = {n: g.detach().float().numpy() for n, g in whole.items()}
    if mesh is not None:
        loss = loss.full_tensor()
    out["__loss"] = np.array(float(loss.detach()))
    return out


def rank_count(shape) -> int:
    return shape[0] * shape[1]


def _rank(rank: int, args, shape, meet: str, out: str) -> None:
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_group

    init_group(rank, rank_count(shape), meet, "cpu")
    try:
        got = first_grads(args, max(1, (os.cpu_count() or 1)
                                    // rank_count(shape)), shape, rank, meet)
        if got is not None:
            np.savez(out, **got)
    finally:
        dist.destroy_process_group()


def run(args, spec: str, tmp: str) -> dict:
    """One RUN's ``first_grads``."""
    if "x" not in spec:
        return first_grads(args, int(spec), meet=tmp)
    import torch.multiprocessing as mp

    shape = tuple(int(v) for v in spec.split("x"))
    meet = tempfile.mkdtemp(dir=tmp)
    out = os.path.join(tmp, f"{spec}.npz")
    mp.spawn(_rank, args=(args, shape, meet, out), nprocs=rank_count(shape))
    with np.load(out) as f:
        return dict(f)


def spread(ref: dict, got: dict) -> dict:
    """Per leaf, the layer index dropped (``layers.0.3.block.wq`` ->
    ``block.wq``): ``(elements, relative L2 gap, share of first updates
    that flip)`` of ``got``'s gradients against ``ref``'s."""
    from repro_torch.optim import OptimizerConfig

    eps = OptimizerConfig().eps
    acc = {}
    for name, a in ref.items():
        if name == "__loss":
            continue
        key = re.sub(r"^layers\.\d+\.\d+\.", "", name)
        a, b = a.astype(np.float64), got[name].astype(np.float64)
        n, d2, r2, flips = acc.get(key, (0, 0.0, 0.0, 0))
        acc[key] = (n + a.size, d2 + float(((a - b) ** 2).sum()),
                    r2 + float((a ** 2).sum()),
                    flips + int(((np.sign(a) != np.sign(b))
                                 & (np.maximum(abs(a), abs(b)) > eps)).sum()))
    return {k: (n, (d2 / r2) ** 0.5 if r2 else float(d2 > 0), flips / n)
            for k, (n, d2, r2, flips) in sorted(acc.items())}


def grad_norm(got: dict) -> float:
    return float(sum((v.astype(np.float64) ** 2).sum()
                     for k, v in got.items() if k != "__loss")) ** 0.5


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--float32", action="store_true",
                    help="weights and activations in f32: the spread that "
                    "is not bf16's")
    ap.add_argument("runs", nargs="+", metavar="RUN",
                    help="T (threads, one process) or DxM (a gloo mesh)")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="grad_spread_") as tmp:
        got = [run(args, spec, tmp) for spec in args.runs]
    for spec, g in zip(args.runs, got):
        print(f"[grad_spread] {spec}: loss {float(g['__loss'])!r}, "
              f"gradient norm {grad_norm(g)!r}")
    for spec, g in zip(args.runs[1:], got[1:]):
        for leaf, (n, gap, flips) in spread(got[0], g).items():
            print(f"[grad_spread] {spec} vs {args.runs[0]} {leaf}: "
                  f"{n} elements, gap {gap:.3e}, first updates flipped "
                  f"{flips:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
