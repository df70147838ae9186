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

* ``device_hbm_bytes``, ``device_hbm_bytes_flash_adjusted``,
  ``collective_bytes``, ``hlo_ops`` and ``memory.temp_bytes`` (with
  ``memory.peak_bytes`` beside it): ``analysis.census.Census`` over rank
  0's run of the sharded step, a DTensor program over a fake process
  group of 256 or 512 ranks on the production mesh
  (``launch.mesh.make_production_device_mesh``, DTensor's collective
  forms of the cards) with ``meta`` blocks, the train step's microbatch
  body run once and multiplied (``census_s`` its host seconds). Its
  argument and output bytes, read from the local blocks, must equal the
  placements' arithmetic above, or the cell fails. Every family runs it.
  ``--census 16x16`` counts the 16 x 16 mesh's only (a 2 x 16 x 16 cell
  takes minutes: DTensor plans its three-dim redistributions by a graph
  search); the other mesh's cells then keep these keys ``null`` and say
  so under ``census``.

``xla_cost_flops_per_device_loopbody_once``, ``lower_s`` and
``compile_s`` stay ``null``: they are a compiler's (its cost analysis of
one loop body, its lowering and compile times), and eager PyTorch
compiles nothing.

Usage (no card needed):
    python -m repro_torch.launch.dryrun --arch gemma3-1b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes]
        [--jobs N] [--census {all,16x16}] [--out results.json]
    python -m repro_torch.launch.dryrun --all --census 16x16 --jobs 6 \\
        --record src/repro_torch/launch/census_16x16.json

The record (``RECORD``, ``record_diff``) holds every ``ok`` 16 x 16
cell's census keys and byte counts as this port's pinned layouts give
them; a dry run on another PyTorch build must give the same.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
import os
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

# the reference's keys that a compiler fills; the census fills the first four
CENSUS_KEYS = ("device_hbm_bytes", "device_hbm_bytes_flash_adjusted",
               "collective_bytes", "hlo_ops")
# the committed census of every ``ok`` 16 x 16 cell (``--record``), which
# another PyTorch build's dry run must reproduce (``record_diff``)
RECORD = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "census_16x16.json")
# a record cell's keys: the census's, and ``memory``'s byte counts
RECORD_MEMORY = ("temp_bytes", "argument_bytes", "output_bytes")
# ATen ops that two PyTorch builds dispatch differently for one program at
# the same placements (a decomposition, not a layout): the comparison with
# the record leaves out their counts and their traffic (the record keeps
# their bytes, ``decomposed_bytes``). Counts in PERF.md (PR 31).
BUILD_DECOMPOSED = {
    # torch.utils.checkpoint's non-reentrant wrapper: 2.11 makes two
    # zero-element tensors a checkpointed call, 2.13 none
    "empty": "checkpoint's zero-element placeholders",
    # the backward of a sort's values: 2.11 starts from ``zeros``, 2.13
    # from ``grad.new_zeros`` (the census reads its argument's bytes)
    "zeros": "SortBackward's zeros",
    "new_zeros": "SortBackward's new_zeros",
}
COMPILER_KEYS = CENSUS_KEYS + ("xla_cost_flops_per_device_loopbody_once",
                               "lower_s", "compile_s")
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


def place_args(kind: str, args, specs, mesh) -> tuple:
    """A cell's ``meta`` arguments as DTensors on ``mesh`` placed by their
    specs (``input_specs``); the parameters in place."""
    from repro_torch.sharding.rules import (distribute, distribute_params,
                                            distribute_state)

    if kind == "train":
        params, opt, batch = args
        params, opt = distribute_state(params, opt, mesh)
        return params, opt, distribute(batch, specs[2], mesh)
    if kind == "prefill":
        params, batch = args
        distribute_params(params, mesh)
        return params, distribute(batch, specs[1], mesh)
    params, tokens, cache, index = args
    distribute_params(params, mesh)
    tokens = distribute({"tokens": tokens}, specs[1], mesh)["tokens"]
    placed = distribute(reference_cache_leaves(cache), specs[2], mesh)
    for i, run in enumerate(cache["self"]):
        for j, layer in enumerate(run):
            for name in layer:
                layer[name] = placed[f"self.{i}.{name}"][j]
    for name in cache.get("cross", {}):
        cache["cross"][name] = placed[f"cross.{name}"]
    return params, tokens, cache, index


def census_cell(arch: str, shape_name: str, multi_pod: bool) -> dict:
    """The census keys of one cell's sharded step (rank 0 of a fake group
    on the production mesh), its local argument and output bytes and
    ``census_s``."""
    from repro_torch.analysis.census import Census
    from repro_torch.launch.mesh import make_production_device_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import OptimizerConfig
    from repro_torch.sharding.rules import local_bytes

    t0 = time.time()
    cfg, shape = cfgs.get(arch), shape_by_name(shape_name)
    mesh = make_production_mesh(multi_pod=multi_pod)
    dmesh = make_production_device_mesh(multi_pod=multi_pod)
    kind, fn, args, specs = cell_fn_and_args(cfg, shape_name, mesh)
    args = place_args(kind, args, specs, dmesh)
    arg_bytes = sum(local_bytes(t) for t in arg_trees(kind, args))
    strategy = resolve_strategy(cfg, shape.name, mesh)
    with activation_mesh(dmesh, strategy), Census() as c:
        if kind == "train":
            k = default_microbatches(
                cfg, shape, mesh,
                target_tokens_per_device=cfg.microbatch_target_tokens)
            step = make_train_step(cfg, OptimizerConfig(), k, mesh=dmesh)
            out = step(*args, repeat=c.repeat)
        else:
            out = fn(*args)
    if kind == "train":
        out_bytes = (local_bytes(out[0]) + local_bytes(out[1])
                     + 4 * len(out[2]))
    elif kind == "prefill":
        out_bytes = local_bytes({"logits": out})
    else:
        out_bytes = local_bytes({"logits": out[0]}) + local_bytes(
            reference_cache_leaves(out[1]))
    res = c.result()
    del out
    return {**res, "argument_bytes": int(arg_bytes),
            "output_bytes": int(out_bytes),
            "census_s": round(time.time() - t0, 2)}


def _work(arch: str, shape_name: str) -> int:
    """A count's rough cost, to start the longest first: the sLSTM runs
    one step a token, the rest a few ops a layer."""
    cfg = cfgs.get(arch)
    steps = shape_by_name(shape_name).seq_len if "slstm" in cfg.pattern \
        else 1
    return cfg.n_layers * steps


def _census_job(arch: str, shape_name: str, multi_pod: bool) -> tuple:
    return (arch, shape_name, multi_pod), census_cell(arch, shape_name,
                                                      multi_pod)


def count_all(cells, jobs: int, census: tuple = (False, True)) -> tuple:
    """The FLOP counts of ``cells`` (``(arch, shape, multi_pod)``), each
    ``flops_key`` once, and the census of each cell on a mesh in
    ``census`` (its ``multi_pod`` values), over ``jobs`` worker
    processes: ``(flops by key, census by cell)``. A job that raises is
    left out (its cell redoes it in ``run_cell`` and reports the failure
    there)."""
    todo, sharded_cells = {}, []
    for arch, shape, mp in cells:
        if shape in cfgs.get(arch).shapes:
            todo.setdefault(flops_key(arch, shape, mp), (arch, shape, mp))
            if mp in census:
                sharded_cells.append((arch, shape, mp))
    jobs_list = [(-_work(c[0], c[1]), _count_cell, c) for c in todo.values()]
    jobs_list += [(-_work(c[0], c[1]) * 4, _census_job, c)
                  for c in sharded_cells]
    jobs_list.sort(key=lambda j: j[0])
    flops, counted = {}, {}
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=jobs, mp_context=ctx) as ex:
        futs = [(fn, ex.submit(fn, *c)) for _, fn, c in jobs_list]
        for fn, fut in futs:
            try:
                key, res = fut.result()
            except Exception:  # noqa: BLE001 — run_cell reports it
                traceback.print_exc()
                continue
            (flops if fn is _count_cell else counted)[key] = res
    return flops, counted


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             flops_cache: dict | None = None, verbose: bool = True,
             census: bool = True, census_cache: dict | None = None) -> dict:
    """One cell's record. ``flops_cache`` (a dict shared across calls)
    keeps a FLOP count an (arch, shape, microbatches), ``census_cache``
    the censuses ``count_all`` made; ``census=False`` leaves the census
    keys ``null``."""
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
    counted, why = {}, None
    if census:
        counted = (census_cache or {}).get((arch, shape_name, multi_pod)) \
            or census_cell(arch, shape_name, multi_pod)
        for k in ("argument_bytes", "output_bytes"):
            if counted[k] != memory[k]:
                raise ValueError(
                    f"{k}: the local blocks hold {counted[k]}, the "
                    f"placements {memory[k]}")
    else:
        why = "not counted on this mesh (--census)"
    res = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name(multi_pod),
        "kind": kind,
        "status": "ok",
        "flops_global": float(flops["flops"]),
        "transcendental_global": float(flops["transcendental"]),
        **{k: counted.get(k) for k in COMPILER_KEYS},
        "bytes_by_op": counted.get("bytes_by_op"),
        "memory": {**memory, "temp_bytes": counted.get("temp_bytes"),
                   "peak_bytes": counted.get("peak_bytes")},
        "census": why or "ok",
        "census_s": counted.get("census_s"),
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
        if counted:
            flash = counted["device_hbm_bytes_flash_adjusted"] / 2**30
            print(f"[census] {arch} x {shape_name} x {res['mesh']}: "
                  f"hbm/dev={counted['device_hbm_bytes'] / 2**30:.2f}GiB "
                  f"(flash {flash:.2f}) "
                  f"coll/dev={counted['collective_bytes']} "
                  f"temp={counted['temp_bytes'] / 2**30:.2f}GiB "
                  f"({counted['census_s']:.1f}s)")
        else:
            print(f"[census] {arch} x {shape_name} x {res['mesh']}: {why}")
    return res


def record_of(cells: list) -> dict:
    """The record of a dry run's ``ok`` 16 x 16 cells: ``{"arch x shape":
    {census keys, memory byte counts}}``, with the PyTorch build that
    made it."""
    import torch

    out = {}
    for c in cells:
        if c["status"] != "ok" or c["mesh"] != "16x16" or \
                c["census"] != "ok":
            continue
        by_op = c.get("bytes_by_op") or {}
        out[f"{c['arch']} x {c['shape']}"] = {
            **{k: c[k] for k in CENSUS_KEYS},
            **{k: c["memory"][k] for k in RECORD_MEMORY},
            "decomposed_bytes": {op: by_op.get(op, 0.0)
                                 for op in sorted(BUILD_DECOMPOSED)}}
    return {"mesh": "16x16", "torch": torch.__version__, "cells": out}


def _comparable(cell: dict) -> dict:
    """A record cell with ``BUILD_DECOMPOSED``'s ops out of the op census
    and their traffic out of the traffic totals."""
    named = sum(cell["decomposed_bytes"].values())
    out = {k: v for k, v in cell.items() if k != "decomposed_bytes"}
    out["hlo_ops"] = {k: v for k, v in cell["hlo_ops"].items()
                      if k not in BUILD_DECOMPOSED}
    for k in ("device_hbm_bytes", "device_hbm_bytes_flash_adjusted"):
        out[k] = cell[k] - named
    return out


def record_diff(cells: list, record: dict | None = None) -> list:
    """Each difference between a dry run's ``ok`` 16 x 16 cells and the
    record (``RECORD`` when None), as ``(cell, key, got, recorded)``: a
    cell missing on either side, or any key that differs, the op census
    and the traffic but for ``BUILD_DECOMPOSED``'s ops."""
    if record is None:
        with open(RECORD) as f:
            record = json.load(f)
    got, want = record_of(cells)["cells"], record["cells"]
    diffs = [(c, "cell", c in got, c in want)
             for c in sorted(set(got) ^ set(want))]
    for c in sorted(set(got) & set(want)):
        g, w = _comparable(got[c]), _comparable(want[c])
        for k, v in w.items():
            if g.get(k) != v:
                diffs.append((c, k, g.get(k), v))
    return diffs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--jobs", type=int, default=1,
                    help="worker processes for the FLOP counts and the "
                    "censuses")
    ap.add_argument("--census", choices=("all", "16x16"),
                    default="all",
                    help="the meshes whose cells the census counts "
                    "(the 2x16x16 mesh's take minutes each: DTensor plans "
                    "its three-dim redistributions by a graph search)")
    ap.add_argument("--record", metavar="PATH", default=None,
                    help="write the ok 16x16 cells' census keys there (the "
                    "committed record is launch/census_16x16.json)")
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
    counted = (False, True) if args.census == "all" else (False,)
    flops_cache, census_cache = (count_all(cells, args.jobs, counted)
                                 if args.jobs > 1 else ({}, {}))
    results, failed = [], 0
    for arch, shape, mp in cells:
        try:
            results.append(run_cell(arch, shape, multi_pod=mp,
                                    flops_cache=flops_cache,
                                    census=mp in counted,
                                    census_cache=census_cache))
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
    if args.record:
        rec = record_of(results)
        with open(args.record, "w") as f:
            json.dump(rec, f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"[dryrun] wrote the census of {len(rec['cells'])} cells to "
              f"{args.record}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
