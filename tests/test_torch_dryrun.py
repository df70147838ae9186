"""The dry-run group in the port against the JAX package, on the CPU.

* Specs: for all ten architectures at full width, on the 16x16 and
  2x16x16 production meshes (the reference's ``FakeMesh``: its rules read
  only axis names and sizes), every parameter and optimizer leaf's spec
  (the default, unfactored moments), and the batch and cache specs of every
  applicable shape, == the reference's; the strategy and microbatch count
  of each cell too; ``constrain``'s resolved spec == what the reference
  pins under ``activation_mesh`` (``tp_sp`` and ``fsdp``).
* Bytes: in a subprocess with 8 XLA host devices (the pattern of
  ``tests/test_sharding_rules.py``) on a 2 x 4 mesh, every argument
  leaf's per-device shape == ``NamedSharding.shard_shape`` from the
  reference's ``input_specs``, for every reduced architecture and shape;
  for qwen2 ``train_4k`` and deepseek-v2 ``decode_32k`` (reduced),
  ``argument_bytes`` == the compiled ``memory_analysis()`` exactly and
  ``output_bytes`` == it less one named term: XLA's output size counts
  the result tuple's table of buffer pointers, 8 bytes a leaf.
* FLOPs: against the reference's ``flops_of`` over the reduced configs of
  all ten architectures (train, prefill, decode at B 2, S 32) and at full
  width for qwen2-1.5b ``train_4k`` and ``prefill_32k`` on a one-device
  host mesh. Products (matmul FLOPs) are equal but for differences the
  test computes and names (``_named_gap``); totals are within 2 % at full
  width (printed).
* The dry run's records: the reference's keys, ``null`` where only a
  compiler can fill them; skipped and failed cells; the grid.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import pytest
import torch

import repro.configs as jcfgs
from repro.analysis import flops as jflops
from repro.configs.base import LM_SHAPES as J_SHAPES
from repro.configs.base import ShapeSpec as JShape
from repro.configs.base import shape_by_name as j_shape
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro.optim import OptimizerConfig as JOpt
from repro.optim import init_opt_state as j_init_opt
from repro.sharding import activation as jact
from repro.sharding.rules import _path_str
from repro.sharding.rules import batch_pspecs as j_batch_pspecs
from repro.sharding.rules import cache_pspecs as j_cache_pspecs
from repro.sharding.rules import param_pspecs as j_param_pspecs
import repro_torch.configs as cfgs
from repro_torch.analysis.flops import FlopCounter
from repro_torch.configs.base import LM_SHAPES, ShapeSpec, shape_by_name
from repro_torch.launch import dryrun
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models import lm
from repro_torch.optim import OptimizerConfig, init_opt_state
from repro_torch.sharding import activation
from repro_torch.sharding.rules import (Placement, _shape, batch_pspecs,
                                        cache_pspecs, leaves, param_pspecs,
                                        reference_cache_leaves)

ROOT = Path(__file__).resolve().parents[1]
MESHES = [False, True]  # multi_pod


def _fake_mesh(multi_pod: bool):
    """The reference tests' ``FakeMesh`` of a production mesh."""
    names = (("pod",) if multi_pod else ()) + ("data", "model")
    shape = ({"pod": 2} if multi_pod else {}) | {"data": 16, "model": 16}
    return SimpleNamespace(axis_names=names, shape=shape)


def _entry(e):
    """A spec entry as jax's ``PartitionSpec`` keeps it: a one-axis tuple
    is that axis."""
    if e is None or isinstance(e, str):
        return e
    return e[0] if len(e) == 1 else tuple(e)


def _jax_specs(tree_specs) -> dict:
    """``{dotted path: spec tuple}`` of a reference spec tree."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree_specs, is_leaf=lambda x: isinstance(x, jax.sharding.
                                                  PartitionSpec))[0]
    return {_path_str(p).replace("/", "."): tuple(_entry(e) for e in s)
            for p, s in flat}


def _port_specs(specs: dict) -> dict:
    return {k: tuple(_entry(e) for e in s) for k, s in specs.items()}


_J_PARAMS, _T_PARAMS = {}, {}


def _params(arch):
    """The reference's abstract full-width params and the port's ``meta``
    ones, made once an architecture."""
    if arch not in _J_PARAMS:
        cfg = jcfgs.get(arch)
        _J_PARAMS[arch] = jax.eval_shape(
            lambda: jlm.init_lm(jax.random.PRNGKey(0), cfg))
        _T_PARAMS[arch] = lm.init_lm(0, cfgs.get(arch), device="meta")
    return _J_PARAMS[arch], _T_PARAMS[arch]


# ---------------------------------------------------------------------------
# specs at full width, both production meshes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("multi_pod", MESHES)
@pytest.mark.parametrize("arch", cfgs.names())
def test_param_and_opt_specs_equal_reference(arch, multi_pod):
    jp, tp = _params(arch)
    fake, mesh = _fake_mesh(multi_pod), make_production_mesh(
        multi_pod=multi_pod)
    got = _port_specs(param_pspecs(tp, mesh))
    want = _jax_specs(j_param_pspecs(jp, fake))
    assert got == want
    # the default (unfactored) moments, as the dry run's cells hold them:
    # a factored state's 1-D ``nu.embed.row`` meets the 2-D ``embed`` rule,
    # which raises in the reference's rules as in their copy
    jo = jax.eval_shape(lambda: j_init_opt(jp, JOpt()))
    to = init_opt_state(tp, OptimizerConfig())
    assert _port_specs(param_pspecs(to, mesh)) == _jax_specs(
        j_param_pspecs(jo, fake))


@pytest.mark.parametrize("multi_pod", MESHES)
@pytest.mark.parametrize("arch", cfgs.names())
def test_batch_and_cache_specs_equal_reference(arch, multi_pod):
    """Every applicable shape: the strategy, the microbatch count, the
    batch's specs, and for decode the cache's (the port's cache in the
    reference's stacked form)."""
    jc, tc = jcfgs.get(arch), cfgs.get(arch)
    fake, mesh = _fake_mesh(multi_pod), make_production_mesh(
        multi_pod=multi_pod)
    for name in tc.shapes:
        strat = jsteps.resolve_strategy(jc, name, fake)
        assert steps.resolve_strategy(tc, name, mesh) == strat
        assert steps.default_microbatches(
            tc, shape_by_name(name), mesh, tc.microbatch_target_tokens) == \
            jsteps.default_microbatches(jc, j_shape(name), fake,
                                        jc.microbatch_target_tokens)
        jb = jsteps.batch_struct(jc, j_shape(name))
        tb = steps.batch_struct(tc, shape_by_name(name))
        assert {k: (tuple(v.shape), str(v.dtype)) for k, v in jb.items()} \
            == {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                for k, v in tb.items()}
        assert _port_specs(batch_pspecs(tb, mesh, strat)) == _jax_specs(
            j_batch_pspecs(jb, fake, strat))
        if shape_by_name(name).kind != "decode":
            continue
        B, S = shape_by_name(name).global_batch, shape_by_name(name).seq_len
        jcache = jax.eval_shape(lambda: jlm.init_cache(jc, B, S))
        tcache = reference_cache_leaves(lm.init_cache(tc, B, S, "meta"))
        assert _port_specs(cache_pspecs(tcache, mesh, strat)) == _jax_specs(
            j_cache_pspecs(jcache, fake, strat))


CONSTRAIN_CASES = [  # shape, spec
    ((256, 4096, 1536), (jact.BATCH_AXES, None, None)),
    ((256, 4096, 152064), (jact.BATCH_AXES, None, "model")),
    ((1, 524288, 4096), (jact.BATCH_AXES, "data", None)),
    ((32, 4096, 12, 128), (jact.BATCH_AXES, None, "model", None)),
    ((8, 12, 128), (("data", "model"), None, "model")),
    ((3, 5), ("model", "data")),
    ((512, 7), (("pod", "data"), None)),
]


@pytest.mark.parametrize("strategy", ["tp_sp", "fsdp"])
def test_constrain_resolves_like_reference(strategy, monkeypatch):
    """Under ``activation_mesh``, ``resolve_spec`` == the spec the
    reference's ``constrain`` pins (captured from its
    ``with_sharding_constraint``; None where it pins nothing), and
    ``constrain`` returns its input itself; outside, nothing resolves."""
    pinned = []
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, spec: pinned.append(tuple(spec)) or x)
    for multi_pod in MESHES:
        fake, mesh = _fake_mesh(multi_pod), make_production_mesh(
            multi_pod=multi_pod)
        for shape, spec in CONSTRAIN_CASES:
            pinned.clear()
            with jact.activation_mesh(fake, strategy):
                jact.constrain(jax.ShapeDtypeStruct(shape, jnp.int8), spec)
            want = tuple(_entry(e) for e in pinned[0]) if pinned else None
            x = torch.empty(shape, device="meta")
            with activation.activation_mesh(mesh, strategy):
                got = activation.resolve_spec(shape, spec)
                assert activation.constrain(x, spec) is x
            assert (None if got is None else
                    tuple(_entry(e) for e in got)) == want, (shape, spec)
    assert activation.resolve_spec((8, 8), ("data", None)) is None


# ---------------------------------------------------------------------------
# per-device shapes and bytes against XLA (8 host devices, a subprocess)
# ---------------------------------------------------------------------------

XLA_BYTES = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import json
    import jax
    import repro.configs as cfgs
    from repro.launch.mesh import make_mesh
    from repro.launch.steps import input_specs, lower_cell
    from repro.sharding.rules import _path_str

    # jax.make_mesh's axes are Explicit since jax 0.6; the reference's
    # make_mesh asks for Auto, which its with_sharding_constraint needs
    mesh = make_mesh((2, 4), ("data", "model"))
    out = {"shards": {}, "memory": {}}
    for arch in cfgs.names():
        cfg = cfgs.get(arch).reduced()
        for shape in cfg.shapes:
            kind, args = input_specs(cfg, shape, mesh)
            got = {}
            for i, a in enumerate(args):
                for path, leaf in jax.tree_util.tree_flatten_with_path(a)[0]:
                    sh = leaf.sharding
                    got[f"{i}:{_path_str(path)}"] = list(
                        leaf.shape if sh is None else
                        sh.shard_shape(leaf.shape))
            out["shards"][f"{arch}/{shape}"] = got
    for arch, shape in (("qwen2_1_5b", "train_4k"),
                        ("deepseek_v2_236b", "decode_32k")):
        comp = lower_cell(cfgs.get(arch).reduced(), shape, mesh).compile()
        m = comp.memory_analysis()
        out["memory"][f"{arch}/{shape}"] = {
            "argument_bytes": int(m.argument_size_in_bytes),
            "output_bytes": int(m.output_size_in_bytes)}
    print("XLA_BYTES " + json.dumps(out))
""")


@pytest.fixture(scope="module")
def xla_bytes():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", XLA_BYTES], capture_output=True,
                       text=True, timeout=600, env=env)
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("XLA_BYTES ")]
    assert line, r.stdout[-2000:] + r.stderr[-4000:]
    return json.loads(line[0][len("XLA_BYTES "):])


def _port_cell(arch, shape):
    """A reduced cell on a 2 x 4 ``meta`` mesh: ``(cfg, kind, args, specs,
    mesh)``."""
    mesh = make_mesh((2, 4), ("data", "model"), [torch.device("meta")] * 8)
    cfg = cfgs.get(arch).reduced()
    kind, fn, args, specs = steps.cell_fn_and_args(cfg, shape, mesh)
    return cfg, kind, args, specs, mesh


def test_device_shapes_equal_xla(xla_bytes):
    """Every argument leaf of every reduced cell: the port's per-device
    shape == ``NamedSharding.shard_shape`` (the decode position, an int32
    scalar, replicated)."""
    n = 0
    for arch in cfgs.names():
        for shape in cfgs.get(arch).shapes:
            cfg, kind, args, specs, mesh = _port_cell(arch, shape)
            got = {}
            for i, (tree, spec) in enumerate(zip(
                    dryrun.arg_trees(kind, args), specs)):
                # the reference passes the decode tokens and position bare
                bare = kind == "decode" and i in (1, 3)
                for path, leaf in leaves(tree).items():
                    key = f"{i}:" + ("" if bare else path.replace(".", "/"))
                    got[key] = list(Placement(mesh, spec[path]).shard_shape(
                        _shape(leaf)))
            assert got == xla_bytes["shards"][f"{arch}/{shape}"], \
                (arch, shape)
            n += len(got)
    assert n > 1000


@pytest.mark.parametrize("arch,shape", [("qwen2_1_5b", "train_4k"),
                                        ("deepseek_v2_236b", "decode_32k")])
def test_bytes_equal_memory_analysis(xla_bytes, arch, shape):
    cfg, kind, args, specs, mesh = _port_cell(arch, shape)
    got = dryrun.cell_bytes(cfg, shape_by_name(shape), kind, args, specs,
                            mesh)
    want = xla_bytes["memory"][f"{arch}/{shape}"]
    assert got["argument_bytes"] == want["argument_bytes"]
    # the named gap: XLA's output size holds the result tuple's table of
    # buffer pointers, 8 bytes a leaf (train: parameters, optimizer state,
    # 4 statistics; decode: the logits and the cache's leaves)
    if kind == "train":
        n_out = (len(leaves(args[0])) + len(leaves(args[1])) + 4)
    else:
        n_out = 1 + len(leaves(reference_cache_leaves(args[2])))
    assert got["output_bytes"] + 8 * n_out == want["output_bytes"]


# ---------------------------------------------------------------------------
# FLOPs against the reference's flops_of
# ---------------------------------------------------------------------------


def _jax_matmul(closed, outer_only: bool = False) -> float:
    """The products of a jaxpr, scan bodies times their length (the
    reference counter's walk, dot_general only); with ``outer_only``, only
    those that contract nothing (an einsum's outer product)."""
    total = 0.0

    def walk(jaxpr, mult):
        nonlocal total
        for eqn in jaxpr.eqns:
            name = eqn.primitive.name
            if name == "dot_general":
                if not outer_only or not eqn.params[
                        "dimension_numbers"][0][0]:
                    total += mult * jflops._dot_flops(eqn)
            elif name == "scan":
                walk(eqn.params["jaxpr"].jaxpr, mult * eqn.params["length"])
            elif name == "while":
                walk(eqn.params["body_jaxpr"].jaxpr, mult)
            else:
                for inner in jflops._subjaxprs(eqn):
                    walk(inner, mult)

    walk(closed.jaxpr, 1.0)
    return total


def _attention_calls(cfg, B, S) -> list:
    """``(B, Sq, Skv, H, D)`` of each ``flash_attention`` call of a
    forward pass."""
    hd = (cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim
          if cfg.mla is not None else cfg.resolved_head_dim)
    calls = [(B, S, S, cfg.n_heads, hd)
             for k in cfg.pattern if k in ("attn", "attn_local",
                                           "dense_ffn_attn")]
    if cfg.is_encoder_decoder:
        T = cfg.n_frontend_tokens
        calls += [(B, T, T, cfg.n_heads, hd)] * cfg.n_encoder_layers
        calls += [(B, S, T, cfg.n_heads, hd)] * cfg.n_layers
    return calls


def _named_gap(cfg, kind, B, S, closed) -> float:
    """The port's products less the reference's, named:

    1. ``flash_attention_bwd`` recomputes the scores: one more ``Q K^T``
       an attention call in a train step (the reference's autodiff of its
       dense plain version keeps them; at the chunked route its
       ``jax.checkpoint`` a key block recomputes them too, so no gap);
    2. an einsum that contracts nothing (the mLSTM's ``bhd,bhe->bhde``,
       and the first pair of its three-operand ``bhs,bhsd,bhse->bhde``) is
       a dot_general in the reference, 2 a product, and an elementwise
       multiply in the port;
    3. in a train step, the recurrences' scans: the reference transposes
       every product of their bodies, the port's autograd skips those
       whose cotangent is of a constant initial state or of an unused
       final state. With one chunk (S <= 256): an mLSTM layer's ``C_p``
       product, its final carry's ``C`` and ``n`` products (two each), and
       its outer product's forward and two transposes; an sLSTM layer's
       first step's recurrent product ``dh_prev``.
    """
    gap = -_jax_matmul(closed, outer_only=True) if kind != "train" else 0.0
    if kind == "train":
        for b, sq, skv, h, d in _attention_calls(cfg, B, S):
            if sq * skv <= 2048 * 2048:
                gap += 2.0 * b * h * sq * skv * d
        di = int(cfg.d_model * cfg.mlstm_proj_factor)
        nh = cfg.n_heads
        dh, L = di // max(nh, 1), min(256, S)
        for k in cfg.pattern:
            if k == "mlstm":
                assert S <= 256, "one chunk"
                gap -= 3 * 2.0 * B * nh * L * dh * dh
                gap -= 5 * 2.0 * B * nh * L * dh
            elif k == "slstm":
                dhs = cfg.d_model // nh
                gap -= 2.0 * B * nh * dhs * 4 * dhs
    return gap


def _jax_cell(jc, kind, B, S):
    params = jax.eval_shape(lambda: jlm.init_lm(jax.random.PRNGKey(0), jc))
    batch = jsteps.batch_struct(jc, JShape("x", S, B, kind))
    if kind == "train":
        opt = jax.eval_shape(lambda: j_init_opt(params, JOpt()))
        return jsteps.make_train_step(jc, JOpt(), 1), (params, opt, batch)
    if kind == "prefill":
        return jsteps.make_prefill_step(jc), (params, batch)
    cache = jax.eval_shape(lambda: jlm.init_cache(jc, B, S))
    return jsteps.make_serve_step(jc), (
        params, batch["tokens"], cache, jax.ShapeDtypeStruct((), jnp.int32))


def _port_count(tc, kind, B, S):
    p = lm.init_lm(0, tc, device="meta")
    batch = steps.batch_struct(tc, ShapeSpec("x", S, B, kind))
    with FlopCounter() as c:
        if kind == "train":
            p.requires_grad_(True)
            steps.make_train_step(tc, OptimizerConfig())(
                p, init_opt_state(p, OptimizerConfig()), batch)
        elif kind == "prefill":
            steps.make_prefill_step(tc)(p, batch)
        else:
            steps.make_serve_step(tc)(p, batch["tokens"], lm.init_cache(
                tc, B, S, "meta"), S - 1)
    return c


@pytest.mark.parametrize("arch", cfgs.names())
def test_flops_equal_reference_reduced(arch):
    """Reduced configs at B 2, S 32: products equal the reference's but
    for ``_named_gap``; every count positive."""
    jc, tc = jcfgs.get(arch).reduced(), cfgs.get(arch).reduced()
    B, S = 2, 32
    for kind in ("train", "prefill", "decode"):
        fn, args = _jax_cell(jc, kind, B, S)
        closed = jax.make_jaxpr(fn)(*args)
        want = _jax_matmul(closed)
        c = _port_count(tc, kind, B, S)
        assert c.matmul == want + _named_gap(tc, kind, B, S, closed), \
            (kind, c.matmul, want)
        assert c.flops > c.matmul > 0 and c.transcendental > 0


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k"])
def test_flops_equal_reference_full_width(shape):
    """qwen2-1.5b at full width on a one-device host mesh (train_4k: 64
    microbatches of 4 rows, the reference's scan and the port's body once
    under ``repeat``): products equal (both routes are chunked at 4,096
    and 32,768 keys, so ``_named_gap`` is 0), totals within 2 %."""
    from repro.launch.mesh import make_host_mesh
    jc, tc = jcfgs.get("qwen2_1_5b"), cfgs.get("qwen2_1_5b")
    jmesh = make_host_mesh(1, 1)
    kind, fn, args, _ = jsteps.cell_fn_and_args(jc, shape, jmesh)
    with jmesh, jact.activation_mesh(
            jmesh, jsteps.resolve_strategy(jc, shape, jmesh)):
        closed = jax.make_jaxpr(fn)(*args)
    want = jflops.count_jaxpr(closed.jaxpr)
    mesh = make_mesh((1, 1), ("data", "model"), [torch.device("meta")])
    tkind, tfn, targs, _ = steps.cell_fn_and_args(tc, shape, mesh)
    assert tkind == kind
    with FlopCounter() as c:
        if kind == "train":
            assert steps.default_microbatches(
                tc, shape_by_name(shape), mesh,
                tc.microbatch_target_tokens) == 64
            tfn(*targs, repeat=c.repeat)
        else:
            tfn(*targs)
    assert c.matmul == _jax_matmul(closed)
    gap = c.flops / want["flops"] - 1.0
    print(f"qwen2-1.5b {shape}: port {c.flops:.6e} reference "
          f"{want['flops']:.6e} FLOPs, gap {gap:+.4%}; transcendental "
          f"{c.transcendental:.6e} / {want['transcendental']:.6e}")
    assert abs(gap) < 0.02
    assert c.result() == dryrun.count_flops(kind, tfn, targs)


# ---------------------------------------------------------------------------
# the dry run's records
# ---------------------------------------------------------------------------

# the reference's record keys (src/repro/launch/dryrun.py::run_cell)
REF_KEYS = {"arch", "shape", "mesh", "kind", "status", "flops_global",
            "device_hbm_bytes", "device_hbm_bytes_flash_adjusted",
            "collective_bytes", "hlo_ops",
            "xla_cost_flops_per_device_loopbody_once", "memory",
            "tokens_per_step", "n_params", "active_params", "lower_s",
            "compile_s"}


def test_grid_and_shapes_are_the_reference_s():
    assert [(s.name, s.seq_len, s.global_batch, s.kind) for s in LM_SHAPES] \
        == [(s.name, s.seq_len, s.global_batch, s.kind) for s in J_SHAPES]
    assert list(cfgs.names()) == list(jcfgs.names())
    for a in cfgs.names():
        tc, jc = cfgs.get(a), jcfgs.get(a)
        assert tc.shapes == jc.shapes
        assert (tc.n_params(), tc.active_params()) == (jc.n_params(),
                                                       jc.active_params())
        for s in LM_SHAPES:
            assert tc.strategy_for(s.name) == jc.strategy_for(s.name)


def test_run_cell_record():
    r = dryrun.run_cell("qwen2-1.5b", "decode_32k", multi_pod=True,
                        verbose=False)
    assert REF_KEYS <= set(r) and r["status"] == "ok"
    assert r["mesh"] == "2x16x16" and r["kind"] == "decode"
    # the census fills the keys it counts (a dense decoder runs sharded);
    # a compiler's own keys stay null
    assert r["census"] == "ok"
    for k in dryrun.COMPILER_KEYS:
        assert (r[k] is not None) == (k in dryrun.CENSUS_KEYS), k
    assert r["memory"]["temp_bytes"] >= 0
    assert r["memory"]["argument_bytes"] > r["memory"]["output_bytes"] > 0
    assert r["tokens_per_step"] == 128 and r["flops_global"] > 0
    skipped = dryrun.run_cell("qwen2-1.5b", "long_500k", multi_pod=False)
    assert skipped["status"] == "skipped"
    assert skipped["reason"] == ("shape not applicable (DESIGN.md "
                                 "§Arch-applicability)")


def test_main_reports_a_failed_cell(monkeypatch, tmp_path):
    """A cell that raises is ``failed`` and ``main`` returns 1; the others
    still run. Two worker processes count the FLOPs."""
    out = tmp_path / "d.json"
    assert dryrun.main(["--arch", "whisper-base", "--shape", "decode_32k",
                        "--both-meshes", "--jobs", "2", "--out",
                        str(out)]) == 0
    cells = json.loads(out.read_text())
    assert [c["mesh"] for c in cells] == ["16x16", "2x16x16"]
    assert cells[0]["flops_global"] == cells[1]["flops_global"]

    def boom(*a, **k):
        raise RuntimeError("boom")

    monkeypatch.setattr(dryrun, "count_flops", boom)
    assert dryrun.main(["--arch", "xlstm-125m", "--shape", "long_500k",
                        "--out", str(out)]) == 1
    (cell,) = json.loads(out.read_text())
    assert cell["status"] == "failed" and "boom" in cell["error"]
