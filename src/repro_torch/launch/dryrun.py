"""Multi-pod dry run, the port's ``repro/launch/dryrun.py``.

For every (architecture x input shape) cell, on the 16x16 single-pod and
2x16x16 two-pod meshes (``launch.mesh.make_production_mesh``), the
reference lowers the sharded step over 512 placeholder XLA devices,
compiles it and reads ``memory_analysis()``, the HLO's bytes and
collectives, and its jaxpr FLOP count. Eager PyTorch has no compiler, so
the port builds each cell on the ``meta`` device (shapes and dtypes, no
memory, no card) and counts:

* ``memory.argument_bytes`` / ``output_bytes``: one device's bytes of the
  step's arguments and outputs, from the sharding rules' placements by
  arithmetic (``sharding.rules.Placement``). The outputs are the train
  step's parameters, optimizer state and four scalar statistics; the
  prefill's logits; the decode step's logits and cache. The logits are
  placed as the reference's ``lm_logits`` pins them, ``(BATCH_AXES,
  None, "model")`` resolved under the cell's strategy, and the updated
  state like the state it replaces.
* ``flops_global`` (and ``transcendental``): ``analysis.flops.
  FlopCounter`` over one run of the step on ``meta``, the train step's
  microbatch body run once and multiplied. FLOPs do not depend on the
  mesh, except through a train cell's microbatch count, so a cell's count
  is made once an (arch, shape, microbatches) and reused; ``--jobs N``
  makes the counts in N worker processes.
* ``tokens_per_step``, ``n_params``, ``active_params``: as the
  reference's.

The keys a compiler fills are ``null``: ``device_hbm_bytes``,
``device_hbm_bytes_flash_adjusted``, ``collective_bytes``, ``hlo_ops``,
``xla_cost_flops_per_device_loopbody_once``, ``memory.temp_bytes``,
``lower_s`` and ``compile_s``. Nothing here estimates them.

Usage (no card needed):
    python -m repro_torch.launch.dryrun --arch gemma3-1b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes]
        [--jobs N] [--out results.json]
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
import sys
import time
import traceback
from concurrent.futures import ProcessPoolExecutor

from repro_torch import configs as cfgs
from repro_torch.analysis.flops import FlopCounter
from repro_torch.configs.base import LM_SHAPES, shape_by_name
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import (cell_fn_and_args, default_microbatches,
                                      resolve_strategy)
from repro_torch.models import lm
from repro_torch.sharding.activation import (BATCH_AXES, activation_mesh,
                                             resolve_spec)
from repro_torch.sharding.rules import (device_bytes, named,
                                        reference_cache_leaves)

# the reference's keys that only a compiler fills
COMPILER_KEYS = ("device_hbm_bytes", "device_hbm_bytes_flash_adjusted",
                 "collective_bytes", "hlo_ops",
                 "xla_cost_flops_per_device_loopbody_once", "lower_s",
                 "compile_s")
_LOGITS_SPEC = (BATCH_AXES, None, "model")  # the reference's lm_logits pin


def mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def count_flops(kind: str, fn, args) -> dict:
    """``{"flops", "transcendental"}`` of one run of a cell's step on its
    (``meta``) arguments; a train step's microbatch body runs once, under
    ``FlopCounter.repeat``."""
    with FlopCounter() as c:
        if kind == "train":
            fn(*args, repeat=c.repeat)
        else:
            fn(*args)
    return c.result()


def logits_bytes(cfg, B: int, S: int, mesh, strategy: str) -> int:
    """One device's bytes of the ``(B, S, V_pad)`` logits, placed as the
    reference's ``lm_logits`` pins them."""
    shape = (B, S, cfg.padded_vocab_size)
    with activation_mesh(mesh, strategy):
        spec = resolve_spec(shape, _LOGITS_SPEC) or (None,) * 3
    return named({"logits": spec}, mesh)["logits"].nbytes(
        shape, lm.dtype_of(cfg.dtype))


def arg_trees(kind: str, args) -> tuple:
    """A cell's step arguments as leaf trees keyed like their specs
    (``input_specs``): a decode step's tokens and position as one-leaf
    dicts, its cache in the reference's stacked form."""
    if kind != "decode":
        return args
    params, tokens, cache, index = args
    return (params, {"tokens": tokens}, reference_cache_leaves(cache),
            {"index": index})


def cell_bytes(cfg, shape, kind: str, args, specs, mesh) -> dict:
    """``{"argument_bytes", "output_bytes"}``, one device's."""
    trees = arg_trees(kind, args)
    arg = sum(device_bytes(t, s, mesh) for t, s in zip(trees, specs))
    strategy = resolve_strategy(cfg, shape.name, mesh)
    if kind == "train":
        # the parameters and optimizer state, and loss, lr, grad_norm (f32)
        # and step (int32): replicated scalars
        out = (device_bytes(trees[0], specs[0], mesh)
               + device_bytes(trees[1], specs[1], mesh) + 4 * 4)
    elif kind == "prefill":
        out = logits_bytes(cfg, shape.global_batch, shape.seq_len, mesh,
                           strategy)
    else:
        out = (logits_bytes(cfg, shape.global_batch, 1, mesh, strategy)
               + device_bytes(trees[2], specs[2], mesh))
    return {"argument_bytes": int(arg), "output_bytes": int(out)}


def flops_key(arch: str, shape_name: str, multi_pod: bool) -> tuple:
    """``(arch, shape, microbatches)``: what a cell's FLOP count depends
    on (a train cell's microbatch count follows the mesh; 1 otherwise)."""
    cfg, shape = cfgs.get(arch), shape_by_name(shape_name)
    k = 1
    if shape.kind == "train":
        k = default_microbatches(
            cfg, shape, make_production_mesh(multi_pod=multi_pod),
            target_tokens_per_device=cfg.microbatch_target_tokens)
    return (cfg.name, shape_name, k)


def _count_cell(arch: str, shape_name: str, multi_pod: bool) -> tuple:
    """A worker's count: ``(flops_key, {"flops", "transcendental"})``."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    kind, fn, args, _ = cell_fn_and_args(cfgs.get(arch), shape_name, mesh)
    return (flops_key(arch, shape_name, multi_pod),
            count_flops(kind, fn, args))


def _work(arch: str, shape_name: str) -> int:
    """A count's rough cost, to start the longest first: the sLSTM runs
    one step a token, the rest a few ops a layer."""
    cfg = cfgs.get(arch)
    steps = shape_by_name(shape_name).seq_len if "slstm" in cfg.pattern \
        else 1
    return cfg.n_layers * steps


def count_all(cells, jobs: int) -> dict:
    """The FLOP counts of ``cells`` (``(arch, shape, multi_pod)``), each
    ``flops_key`` once, over ``jobs`` worker processes. A count that
    raises is left out (its cell recounts in ``run_cell`` and reports the
    failure there)."""
    todo = {}
    for arch, shape, mp in cells:
        if shape in cfgs.get(arch).shapes:
            todo.setdefault(flops_key(arch, shape, mp), (arch, shape, mp))
    order = sorted(todo.values(), key=lambda c: -_work(c[0], c[1]))
    out = {}
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=jobs, mp_context=ctx) as ex:
        for fut in [ex.submit(_count_cell, *c) for c in order]:
            try:
                key, counts = fut.result()
            except Exception:  # noqa: BLE001 — run_cell reports it
                traceback.print_exc()
                continue
            out[key] = counts
    return out


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             flops_cache: dict | None = None, verbose: bool = True) -> dict:
    """One cell's record. ``flops_cache`` (a dict shared across calls)
    keeps a FLOP count an (arch, shape, microbatches)."""
    cfg = cfgs.get(arch)
    if shape_name not in cfg.shapes:
        return {"arch": arch, "shape": shape_name,
                "mesh": mesh_name(multi_pod), "status": "skipped",
                "reason": "shape not applicable (DESIGN.md "
                          "§Arch-applicability)"}
    mesh = make_production_mesh(multi_pod=multi_pod)
    shape = shape_by_name(shape_name)
    t0 = time.time()
    kind, fn, args, specs = cell_fn_and_args(cfg, shape_name, mesh)
    memory = cell_bytes(cfg, shape, kind, args, specs, mesh)
    key = flops_key(arch, shape_name, multi_pod)
    cache = {} if flops_cache is None else flops_cache
    if key not in cache:
        cache[key] = count_flops(kind, fn, args)
    flops = cache[key]
    tokens = shape.global_batch * (shape.seq_len if kind != "decode" else 1)
    res = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name(multi_pod),
        "kind": kind,
        "status": "ok",
        "flops_global": float(flops["flops"]),
        "transcendental_global": float(flops["transcendental"]),
        **{k: None for k in COMPILER_KEYS},
        "memory": {**memory, "temp_bytes": None},
        "tokens_per_step": tokens,
        "n_params": cfg.n_params(),
        "active_params": cfg.active_params(),
        "count_s": round(time.time() - t0, 2),
    }
    if verbose:
        print(f"[dryrun] {arch} x {shape_name} x {res['mesh']}: OK "
              f"flops={res['flops_global']:.3e} "
              f"args/dev={memory['argument_bytes'] / 2**30:.2f}GiB "
              f"out/dev={memory['output_bytes'] / 2**30:.2f}GiB "
              f"({res['count_s']:.1f}s)")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--jobs", type=int, default=1,
                    help="worker processes for the FLOP counts")
    args = ap.parse_args(argv)

    if args.all:
        archs = list(cfgs.names())
        shapes = [s.name for s in LM_SHAPES]
    else:
        archs = [args.arch]
        shapes = [args.shape] if args.shape else [s.name for s in LM_SHAPES]

    meshes = [args.multi_pod]
    if args.both_meshes:
        meshes = [False, True]

    cells = [(a, s, mp) for a in archs for s in shapes for mp in meshes]
    flops_cache = count_all(cells, args.jobs) if args.jobs > 1 else {}
    results, failed = [], 0
    for arch, shape, mp in cells:
        try:
            results.append(run_cell(arch, shape, multi_pod=mp,
                                    flops_cache=flops_cache))
        except Exception as e:  # noqa: BLE001 — report, keep going
            failed += 1
            traceback.print_exc()
            results.append({
                "arch": arch, "shape": shape, "mesh": mesh_name(mp),
                "status": "failed", "error": f"{type(e).__name__}: {e}",
            })

    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"[dryrun] wrote {len(results)} cells to {args.out}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
