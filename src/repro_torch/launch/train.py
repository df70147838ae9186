"""Training launcher, the port's copy of ``repro/launch/train.py``.

    python -m repro_torch.launch.train --arch qwen2-1.5b --steps 100 \\
        --batch 8 --seq-len 512

``--reduced`` swaps in the same family's smoke-scale config (``--device
cpu`` runs it here); ``--layers N`` keeps the first N layers of its
pattern (the width whole: a model cut to what one card holds). Without ``--data-axis`` / ``--model-axis`` the
trainer runs in this process on one device. With them it runs sharded on
a ``(data, model)`` mesh: ``data * model`` processes, one a device (gloo
on the CPU, NCCL on the cards, card ``r`` for rank ``r``; more processes
than visible cards is refused; one rank is this process), meeting at a
``FileStore`` under the checkpoint directory. ``--ckpt-every 0`` writes no checkpoint. The
trainer gives checkpoint / restart, preemption handling and straggler
logging (``runtime/``); rank 0 prints the losses, ``[train] losses``
followed by a JSON list, and the hand-written kernels' launches,
``[train] launches``. ``--census-out FILE`` runs one more step of the
sharded trainer under ``analysis.census.Census`` and has rank 0 write
its census there as JSON.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="keep the first N layers of the pattern")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None,
                    help="default: repro_torch_ckpt in the temp directory")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--data-axis", type=int, default=None)
    ap.add_argument("--model-axis", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="cuda unless given (cpu runs the plain path)")
    ap.add_argument("--census-out", default=None,
                    help="sharded: write one more step's census (JSON)")
    args = ap.parse_args(argv)
    if args.census_out and args.data_axis is None and \
            args.model_axis is None:
        ap.error("--census-out needs --data-axis / --model-axis")
    if args.data_axis is None and args.model_axis is None:
        _train(args)
        return 0
    data, model = args.data_axis or 1, args.model_axis or 1
    if data < 1 or model < 1:
        ap.error("--data-axis and --model-axis must be >= 1")
    world = data * model
    kind = "cpu" if args.device == "cpu" else "cuda"
    if kind == "cuda":
        import torch

        cards = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        if world > cards:
            ap.error(f"a ({data}, {model}) mesh needs {world} processes, "
                     f"one a card: {cards} visible card(s)")
    import torch.multiprocessing as mp

    root = args.ckpt_dir or _ckpt_root()
    os.makedirs(root, exist_ok=True)
    meet = tempfile.mkdtemp(prefix=".rendezvous-", dir=root)
    print(f"[train] ({data}, {model}) mesh: {world} process(es), "
          f"{'nccl' if kind == 'cuda' else 'gloo'}", flush=True)
    try:
        if world == 1:  # the one rank is this process
            _worker(0, args, (data, model), kind, meet)
        else:
            mp.spawn(_worker, args=(args, (data, model), kind, meet),
                     nprocs=world)
    finally:
        shutil.rmtree(meet, ignore_errors=True)
    return 0


def _ckpt_root() -> str:
    from repro_torch.runtime.trainer import _default_ckpt_dir

    return _default_ckpt_dir()


def _train(args, mesh=None) -> None:
    from repro_torch.optim import OptimizerConfig
    from repro_torch.runtime import Trainer, TrainerConfig

    cfg = model_config(args.arch, args.reduced, args.layers)
    tcfg = TrainerConfig(
        steps=args.steps, ckpt_every=args.ckpt_every,
        log_every=args.log_every, seed=args.seed, batch=args.batch,
        seq_len=args.seq_len, microbatches=args.microbatches,
        **({} if args.ckpt_dir is None else {"ckpt_dir": args.ckpt_dir}))
    ocfg = OptimizerConfig(peak_lr=args.lr, end_lr=args.lr / 10,
                           warmup_steps=max(1, args.steps // 20),
                           total_steps=args.steps)
    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    if mesh is None:
        out = Trainer(cfg, tcfg, opt_cfg=ocfg, device=args.device).run()
        launches = ops.kernel_launches()
    else:
        import torch.distributed as dist

        trainer = Trainer(cfg, tcfg, mesh, ocfg)
        out = trainer.run()
        launches = ops.kernel_launches()
        if args.census_out:
            _census(trainer, out, args.census_out)
        if dist.get_rank() != 0:
            return
    print(f"[train] losses {json.dumps(out['losses'])}")
    print(f"[train] launches {json.dumps(launches)}")
    print(f"[train] done: steps={out['stop_step']} "
          f"loss {out['losses'][0]:.4f} -> {out['losses'][-1]:.4f}",
          flush=True)


def model_config(arch: str, reduced: bool = False, layers=None):
    """``arch``'s config, reduced, and cut to its first ``layers`` layers
    (every width kept)."""
    import repro_torch.configs as cfgs

    cfg = cfgs.get(arch)
    if reduced:
        cfg = cfg.reduced()
    if layers is not None:
        if not 1 <= layers <= cfg.n_layers:
            raise ValueError(f"--layers {layers}: {cfg.name} has "
                             f"{cfg.n_layers}")
        cfg = cfg.replace(n_layers=layers,
                          layer_pattern=cfg.pattern[:layers])
    return cfg


def _census(trainer, out, path: str) -> None:
    """One more step of ``trainer``'s sharded program (the next batch, the
    final state) under a ``Census``; rank 0 writes its result to
    ``path``."""
    import torch.distributed as dist

    from repro_torch.analysis.census import Census
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.boundary import compressed_boundaries
    from repro_torch.sharding.activation import activation_mesh

    t = trainer.tcfg
    step = make_train_step(trainer.cfg, trainer.opt_cfg, t.microbatches,
                           mesh=trainer.mesh)
    batch = trainer.batch_at(t.steps)
    with compressed_boundaries(), activation_mesh(trainer.mesh), \
            Census() as c:
        res = step(out["final_params"], out["opt_state"], batch)
    got = c.result()
    del res
    if dist.get_rank() == 0:
        with open(path, "w") as f:
            json.dump(got, f)


def _worker(rank: int, args, shape: tuple, kind: str, meet: str) -> None:
    """One rank of the sharded trainer: join the group, train, leave."""
    import torch
    import torch.distributed as dist

    from repro_torch.core.distributed import make_mesh
    from repro_torch.launch.mesh import device_mesh, init_group

    world = shape[0] * shape[1]
    if kind == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    init_group(rank, world, meet, kind)
    try:
        devs = [torch.device(kind, i) if kind == "cuda"
                else torch.device("cpu") for i in range(world)]
        _train(args, device_mesh(make_mesh(shape, ("data", "model"),
                                           devs)))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    raise SystemExit(main())
