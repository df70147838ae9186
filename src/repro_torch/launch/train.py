"""Training launcher, the port's copy of ``repro/launch/train.py``.

    python -m repro_torch.launch.train --arch qwen2-1.5b --steps 100 \\
        --batch 8 --seq-len 512

``--reduced`` swaps in the same family's smoke-scale config (``--device
cpu`` runs it here). One card: ``--data-axis`` / ``--model-axis`` other
than 1 are refused. The trainer gives checkpoint / restart, preemption
handling and straggler logging (``runtime/``).
"""
from __future__ import annotations

import argparse


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
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
    ap.add_argument("--data-axis", type=int, default=1)
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="cuda unless given (cpu runs the plain path)")
    args = ap.parse_args(argv)
    if args.data_axis != 1 or args.model_axis != 1:
        ap.error("the port trains on one device: --data-axis and "
                 "--model-axis must be 1")

    import repro_torch.configs as cfgs
    from repro_torch.optim import OptimizerConfig
    from repro_torch.runtime import Trainer, TrainerConfig

    cfg = cfgs.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    tcfg = TrainerConfig(
        steps=args.steps, ckpt_every=args.ckpt_every,
        log_every=args.log_every, seed=args.seed, batch=args.batch,
        seq_len=args.seq_len, microbatches=args.microbatches,
        **({} if args.ckpt_dir is None else {"ckpt_dir": args.ckpt_dir}))
    ocfg = OptimizerConfig(peak_lr=args.lr, end_lr=args.lr / 10,
                           warmup_steps=max(1, args.steps // 20),
                           total_steps=args.steps)
    out = Trainer(cfg, tcfg, ocfg, device=args.device).run()
    print(f"[train] done: steps={out['stop_step']} "
          f"loss {out['losses'][0]:.4f} -> {out['losses'][-1]:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
