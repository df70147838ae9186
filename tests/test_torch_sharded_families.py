"""Sharded training of the MoE, MLA, encoder-decoder and recurrent families
in the port against the JAX package, on the CPU.

As ``test_torch_sharded_train.py`` does for the dense decoders: each
sharded run is a real 4-process gloo group spawned from a worker script
(``WORKER``), and the weights are the JAX ``init_lm`` tree carried into
the port (``serving.convert``). Reduced mixtral-8x22b (MoE, ``"tp"``),
deepseek-v2-236b (MoE, ``"ep"``, MLA; cut to its first 4 layers: the
reduced config keeps all 60 of a pattern without a period),
whisper-base, xlstm-125m and recurrentgemma-9b, at ``B, S = 4, 16``:

* One train step on ``(2, 2)``, ``(4, 1)`` and ``(1, 4)`` against the JAX
  ``make_train_step(mesh=...)`` jitted on 4 host devices (a subprocess),
  the block boundary's bf16 cotangent rounding off on both sides: loss
  and grad norm 1e-6 relative, first and second moments 1e-6, parameters
  by ``_params_close``'s rule (the dense test's).
* The same steps against the port's unsharded step; an MoE's dispatch
  groups are the mesh's data shards, so its unsharded step runs under
  ``activation_mesh`` over one device in as many groups.
* The group-local MoE dispatch: the port's ``moe`` on ``(2, 2)`` (G = 2)
  and ``(4, 1)`` (G = 4) against the JAX ``moe`` under a 4-device mesh of
  the same shape, at capacity factor 0.5, where pairs drop and G changes
  which: output and load-balancing loss within 1e-6. Without a mesh
  ``moe`` is one group, the one-group program's bits.
* The launcher: ``launch.train --reduced --data-axis 2 --model-axis 2
  --device cpu`` trains mixtral, whisper and recurrentgemma for 2 steps,
  the losses within 1e-5 of the unsharded trainer's (mixtral's reduced
  capacity factor 2.0 drops no pair at any group count, which the test
  checks, so its grouped dispatch is the unsharded one's).
"""
import json
import os
import pickle
import subprocess
import sys
import textwrap
from contextlib import nullcontext
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.configs as jcfgs  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
import repro_torch.configs as cfgs  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.core.distributed import make_mesh  # noqa: E402
from repro_torch.data.lm_pipeline import TokenStream  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import mlp  # noqa: E402
from repro_torch.runtime import trainer as tr  # noqa: E402
from repro_torch.serving import convert  # noqa: E402
from repro_torch.sharding.activation import activation_mesh  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("mixtral_8x22b", "deepseek_v2_236b", "whisper_base", "xlstm_125m",
         "recurrentgemma_9b")
MOE_ARCHS = ("mixtral_8x22b", "deepseek_v2_236b")
MESHES = ((2, 2), (4, 1), (1, 4))
MOE_MESHES = ((2, 2), (4, 1))
CUT = {"deepseek_v2_236b": 4}  # layers kept of the reduced config
MOE_CF = 0.5  # a capacity factor at which pairs drop
B, S = 4, 16
LR = 1e-3
OPT = dict(peak_lr=LR, warmup_steps=1, total_steps=10)


def reduced(module, arch, cf=None):
    """``arch``'s reduced config from ``module`` (the JAX or the port's
    ``configs``), cut to ``CUT``'s layers, at capacity factor ``cf``."""
    c = module.get(arch).reduced()
    if arch in CUT:
        c = c.replace(n_layers=CUT[arch], layer_pattern=c.pattern[:CUT[arch]])
    if cf is not None:
        c = c.replace(moe=replace(c.moe, capacity_factor=cf))
    return c


def moe_run(cfg) -> int:
    """The index of the first run of MoE layers (kind ``attn``; deepseek's
    first layer is a dense ``dense_ffn_attn``)."""
    kinds = [k for i, k in enumerate(cfg.pattern)
             if i == 0 or cfg.pattern[i - 1] != k]
    return kinds.index("attn") if "attn" in kinds else kinds.index(
        "attn_local")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    kept = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(kept)


def _env():
    return {**os.environ, "PYTHONPATH": str(ROOT / "src"),
            "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu"}


WORKER = textwrap.dedent("""
    import json, os, pickle, sys
    import numpy as np
    import torch
    import torch.multiprocessing as mp


    def full(t):
        return t.full_tensor().numpy() if hasattr(t, "full_tensor") \\
            else t.numpy()


    def run(rank, tmp, plan):
        torch.set_num_threads(1)
        import torch.distributed as dist
        sys.path.insert(0, os.path.join(os.environ["ROOT"], "tests"))
        from test_torch_sharded_families import reduced, moe_run
        import repro_torch.configs as cfgs
        from repro_torch import optim
        from repro_torch.core.distributed import make_mesh
        from repro_torch.launch.mesh import device_mesh, init_group
        from repro_torch.launch.steps import make_train_step
        from repro_torch.models import mlp
        from repro_torch.serving import convert
        from repro_torch.sharding import rules
        from repro_torch.sharding.activation import (activation_mesh,
                                                     dispatch_groups)

        init_group(rank, 4, os.path.join(tmp, "meet"), "cpu")
        ocfg = optim.OptimizerConfig(**plan["opt"])
        meshes = {}

        def mesh_of(shape):
            if tuple(shape) not in meshes:
                meshes[tuple(shape)] = device_mesh(make_mesh(
                    tuple(shape), ("data", "model"),
                    [torch.device("cpu")] * 4))
            return meshes[tuple(shape)]

        out = {}
        for arch in plan["archs"]:
            with open(os.path.join(tmp, f"{arch}.pkl"), "rb") as f:
                weights, batch = pickle.load(f)
            cfg = reduced(cfgs, arch)
            for shape in plan["meshes"]:
                mesh = mesh_of(shape)
                p = convert.lm_params_from_numpy(weights, cfg, device="cpu")
                o = optim.init_opt_state(p, ocfg)
                p, o = rules.distribute_state(p, o, mesh)
                p.requires_grad_(True)
                b = {k: torch.from_numpy(v) for k, v in batch.items()}
                b = rules.distribute(b, rules.batch_pspecs(b, mesh), mesh)
                with activation_mesh(mesh):
                    p, o, st = make_train_step(cfg, ocfg, mesh=mesh)(p, o, b)
                out[(arch, tuple(shape))] = {
                    "loss": float(st["loss"]),
                    "grad_norm": float(st["grad_norm"]),
                    "params": [full(t.detach()) for t in p.parameters()],
                    "mu": {k: full(v) for k, v in o["mu"].items()},
                    "nu": {k: full(v["full"]) for k, v in o["nu"].items()}}
        for arch in plan["moe_archs"]:
            with open(os.path.join(tmp, f"{arch}.pkl"), "rb") as f:
                weights, _ = pickle.load(f)
            with open(os.path.join(tmp, "moe_x.pkl"), "rb") as f:
                x = pickle.load(f)
            cfg = reduced(cfgs, arch, plan["cf"])
            for shape in plan["moe_meshes"]:
                mesh = mesh_of(shape)
                p = rules.distribute_params(convert.lm_params_from_numpy(
                    weights, cfg, device="cpu"), mesh)
                run = moe_run(cfg)
                xd = rules.distribute({"x": torch.from_numpy(x)},
                                      {"x": ("data", None, None)}, mesh)
                with activation_mesh(mesh):
                    got, aux = mlp.moe(p["layers"][run][0]["moe"], xd["x"],
                                       cfg)
                    groups = dispatch_groups()
                out[("moe", arch, tuple(shape))] = {
                    "out": full(got), "aux": float(full(aux)),
                    "groups": groups}
        if rank == 0:
            with open(os.path.join(tmp, "port.pkl"), "wb") as f:
                pickle.dump(out, f)
        dist.destroy_process_group()


    if __name__ == "__main__":
        mp.spawn(run, args=(sys.argv[1], json.loads(sys.argv[2])), nprocs=4)
""")

JAX_STEP = textwrap.dedent("""
    import os
    # 4 host devices on one thread: the suite runs beside other workers
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                               "--xla_cpu_multi_thread_eigen=false "
                               "intra_op_parallelism_threads=1")
    import json, pickle, sys
    import numpy as np
    import jax, jax.numpy as jnp
    sys.path.insert(0, os.path.join(os.environ["ROOT"], "tests"))
    from test_torch_sharded_families import reduced, moe_run
    import repro.configs as cfgs
    import repro.models.blocks as blocks
    from repro.launch.mesh import make_mesh
    from repro.launch.steps import make_train_step
    from repro.models import mlp
    from repro.optim import OptimizerConfig, init_opt_state
    from repro.sharding import batch_pspecs, named, param_pspecs
    from repro.sharding.activation import activation_mesh

    # the block boundary's bf16 cotangent rounding off; the layout
    # constraints stay
    blocks.grad_compressed_boundary = lambda x, spec: x
    tmp, plan = sys.argv[1], json.loads(sys.argv[2])
    opt = OptimizerConfig(**plan["opt"])
    host = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    out = {}
    for arch in plan["archs"]:
        with open(os.path.join(tmp, f"{arch}.pkl"), "rb") as f:
            weights, batch = pickle.load(f)
        cfg = reduced(cfgs, arch)
        for shape in plan["meshes"]:
            mesh = make_mesh(tuple(shape), ("data", "model"))
            p = jax.tree.map(jnp.asarray, weights)
            o = init_opt_state(p, opt)
            b = {k: jnp.asarray(v) for k, v in batch.items()}
            p = jax.tree.map(jax.device_put, p,
                             named(param_pspecs(p, mesh), mesh))
            o = jax.tree.map(jax.device_put, o,
                             named(param_pspecs(o, mesh), mesh))
            b = jax.tree.map(jax.device_put, b,
                             named(batch_pspecs(b, mesh), mesh))
            with mesh, activation_mesh(mesh):
                p2, o2, st = jax.jit(make_train_step(cfg, opt, 1,
                                                     mesh=mesh))(p, o, b)
            nu = jax.tree.map(lambda d: d["full"], o2["nu"],
                              is_leaf=lambda d: isinstance(d, dict)
                              and "full" in d)
            out[(arch, tuple(shape))] = {
                "loss": float(st["loss"]),
                "grad_norm": float(st["grad_norm"]),
                "params": host(p2), "mu": host(o2["mu"]), "nu": host(nu)}
    with open(os.path.join(tmp, "moe_x.pkl"), "rb") as f:
        x = pickle.load(f)
    for arch in plan["moe_archs"]:
        with open(os.path.join(tmp, f"{arch}.pkl"), "rb") as f:
            weights, _ = pickle.load(f)
        cfg = reduced(cfgs, arch, plan["cf"])
        p = jax.tree.map(lambda a: jnp.asarray(a[0]),
                         weights["layers"][moe_run(cfg)]["moe"])
        for shape in plan["moe_meshes"]:
            mesh = make_mesh(tuple(shape), ("data", "model"))
            with mesh, activation_mesh(mesh):
                got, aux = jax.jit(lambda p, x: mlp.moe(p, x, cfg))(
                    p, jnp.asarray(x))
            out[("moe", arch, tuple(shape))] = {
                "out": np.asarray(got), "aux": float(aux)}
    with open(os.path.join(tmp, "jax.pkl"), "wb") as f:
        pickle.dump(out, f)
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's sharded steps and MoE calls (4 gloo processes) and the
    JAX sharded ones (4 host devices), side by side, and the port's
    unsharded steps: ``{"port", "jax", "plain", "weights"}``."""
    tmp = tmp_path_factory.mktemp("families")
    weights = {}
    for arch in ARCHS:
        jc = reduced(jcfgs, arch)
        jp = jax.tree.map(np.asarray, jlm.init_lm(jax.random.PRNGKey(0), jc))
        weights[arch] = jp
        batch = TokenStream(reduced(cfgs, arch), B, S, seed=1).batch_at(0)
        with open(tmp / f"{arch}.pkl", "wb") as f:
            pickle.dump((jp, batch), f)
    x = np.random.default_rng(3).standard_normal((B, S, 64)).astype(
        np.float32)
    with open(tmp / "moe_x.pkl", "wb") as f:
        pickle.dump(x, f)
    plan = json.dumps({"archs": ARCHS, "meshes": MESHES, "opt": OPT,
                       "moe_archs": MOE_ARCHS, "moe_meshes": MOE_MESHES,
                       "cf": MOE_CF})
    (tmp / "worker.py").write_text(WORKER)
    env = {**_env(), "ROOT": str(ROOT)}
    procs = [subprocess.Popen([sys.executable, str(tmp / "worker.py"),
                               str(tmp), plan], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True),
             subprocess.Popen([sys.executable, "-c", JAX_STEP, str(tmp),
                               plan], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)]
    plain = {}
    ocfg = optim.OptimizerConfig(**OPT)
    for arch in ARCHS:
        c = reduced(cfgs, arch)
        # the MoE's too in each mesh's dispatch groups, on one device
        for groups in sorted({m[0] for m in MESHES}) if arch in MOE_ARCHS \
                else (1,):
            p = convert.lm_params_from_numpy(weights[arch], c, device="cpu")
            p.requires_grad_(True)
            o = optim.init_opt_state(p, ocfg)
            batch = TokenStream(c, B, S, seed=1).batch_at(0)
            with activation_mesh(make_mesh(
                    (groups, 1), ("data", "model"),
                    [torch.device("cpu")] * groups)) if groups > 1 \
                    else nullcontext():
                p, o, st = make_train_step(c, ocfg)(
                    p, o, {k: torch.from_numpy(v) for k, v in batch.items()})
            plain[(arch, groups)] = {
                "loss": float(st["loss"]),
                "grad_norm": float(st["grad_norm"]),
                "params": [t.detach().numpy() for t in p.parameters()],
                "mu": {k: v.numpy() for k, v in o["mu"].items()},
                "nu": {k: v["full"].numpy() for k, v in o["nu"].items()}}
    for p in procs:
        _, err = p.communicate(timeout=900)
        assert p.returncode == 0, err[-4000:]
    out = {"plain": plain, "weights": weights}
    for side in ("port", "jax"):
        with open(tmp / f"{side}.pkl", "rb") as f:
            out[side] = pickle.load(f)
    return out


def _by_param(tree: dict, arch: str, weights) -> list:
    """A moment tree keyed by the reference's leaf paths as one array a
    parameter, in ``params.parameters()`` order (``weights``, the JAX
    tree, gives the parameters)."""
    p = convert.lm_params_from_numpy(weights, reduced(cfgs, arch),
                                     device="cpu")
    by_id = {}
    for name, leaf in optim.param_leaves(p).items():
        t = np.asarray(tree[name])
        if isinstance(leaf, list):
            by_id.update({id(x): t[i] for i, x in enumerate(leaf)})
        else:
            by_id[id(leaf)] = t
    return [by_id[id(x)] for x in p.parameters()]


def _jax_by_param(tree, arch: str) -> list:
    """A JAX ``init_lm``-shaped tree of numpy arrays as one array a port
    parameter, in ``params.parameters()`` order."""
    p = convert.lm_params_from_numpy(tree, reduced(cfgs, arch),
                                     device="cpu")
    return [t.detach().numpy() for t in p.parameters()]


def _params_close(got, want, mu):
    """Parameters within 1e-6 where the step's gradient (``mu / (1 - b1)``)
    exceeds 1e-6 in size; within 2e-3 (twice the learning rate) where it
    does not (Adam's first step moves a weight by about the learning rate
    whatever its gradient's size, so a reordered sum that flips a
    near-zero gradient's sign moves it by up to twice that)."""
    for g, w, m in zip(got, want, mu):
        g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
        big = np.abs(np.asarray(m, np.float32)) / 0.1 > 1e-6
        np.testing.assert_allclose(g[big], w[big], atol=1e-6, rtol=0)
        np.testing.assert_allclose(g, w, atol=2 * LR, rtol=0)


def _moments_close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g, np.float32).ravel(),
                                   np.asarray(w, np.float32).ravel(),
                                   atol=1e-6, rtol=0)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_equals_jax(runs, arch, mesh):
    port, jx = runs["port"][(arch, mesh)], runs["jax"][(arch, mesh)]
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(port[k], jx[k], rtol=1e-6)
    for name in ("mu", "nu"):
        _moments_close(_by_param(port[name], arch, runs["weights"][arch]),
                       _jax_by_param(jx[name], arch))
    _params_close(port["params"], _jax_by_param(jx["params"], arch),
                  _jax_by_param(jx["mu"], arch))


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_equals_unsharded(runs, arch, mesh):
    """The sharded step against the port's unsharded step; the MoE's
    against the unsharded step dispatched in as many groups as the mesh's
    data size (``activation_mesh`` over one device), as the sharded
    program dispatches."""
    groups = mesh[0] if arch in MOE_ARCHS else 1
    port, plain = runs["port"][(arch, mesh)], runs["plain"][(arch, groups)]
    w = runs["weights"][arch]
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(port[k], plain[k], rtol=1e-6)
    for name in ("mu", "nu"):
        _moments_close(_by_param(port[name], arch, w),
                       _by_param(plain[name], arch, w))
    _params_close(port["params"], plain["params"],
                  _by_param(plain["mu"], arch, w))


def _dropped(cfg, x: np.ndarray, weights, groups: int) -> set:
    """The ``(token, k)`` pairs the dispatch drops at ``groups`` groups
    (the port's per-group dispatch on plain tensors)."""
    p = convert.lm_params_from_numpy(weights, cfg, device="cpu")
    pm = p["layers"][moe_run(cfg)][0]["moe"]
    mo = cfg.moe
    T = x.shape[0] * x.shape[1] // groups
    cap = max(1, int(T * mo.n_experts_per_token * mo.capacity_factor
                     / mo.n_experts))
    xg = torch.from_numpy(x).reshape(groups, T, x.shape[2])
    _, _, pair_slot, _, _ = mlp._dispatch_local(
        xg, pm["router"], mo.n_experts_per_token, mo.n_experts, cap)
    g, t, k = np.nonzero((pair_slot == mo.n_experts * cap).numpy())
    return set(zip((g * T + t).tolist(), k.tolist()))


@pytest.mark.parametrize("mesh", MOE_MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_grouped_moe_equals_reference(runs, arch, mesh):
    """G = the mesh's data size; at capacity factor 0.5 pairs drop, and
    which ones depends on G."""
    port = runs["port"][("moe", arch, mesh)]
    jx = runs["jax"][("moe", arch, mesh)]
    assert port["groups"] == mesh[0]
    np.testing.assert_allclose(port["out"], jx["out"], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(port["aux"], jx["aux"], rtol=1e-6)
    cfg = reduced(cfgs, arch, MOE_CF)
    x = np.random.default_rng(3).standard_normal((B, S, 64)).astype(
        np.float32)
    here = _dropped(cfg, x, runs["weights"][arch], mesh[0])
    one = _dropped(cfg, x, runs["weights"][arch], 1)
    assert here and here != one
    other = runs["jax"][("moe", arch, tuple(
        m for m in MOE_MESHES if m != mesh)[0])]
    assert np.abs(other["out"] - jx["out"]).max() > 1e-3


def _one_group(pm, x, cfg):
    """The one-group program ``moe`` ran before the grouped dispatch, the
    module's steps written out: route, buckets, the load-balancing loss of
    the one group's counts, slots, gather, experts, and the combine that
    keeps a pair whose slot is below ``E * cap``."""
    mo = cfg.moe
    Bx, Sx, D = x.shape
    T, K, E = Bx * Sx, mo.n_experts_per_token, mo.n_experts
    cap = max(1, int(T * K * mo.capacity_factor / E))
    xt = x.reshape(T, D)
    probs, top_p, top_e = mlp.route(pm, xt, K)
    buckets = mlp._buckets(top_e, E)
    aux = mlp._aux(probs, buckets[3], mo.router_aux_coef)
    slot_tok, slot_w, pair_slot = mlp._dispatch_one(top_p, top_e, cap,
                                                    x.dtype, buckets)
    y = mlp._experts(pm, mlp._gather(xt, slot_tok, E, cap), cfg.act)
    n = slot_w.shape[0]
    ordered = torch.sort(pair_slot, dim=1).values
    out = torch.zeros((T, D), dtype=y.dtype)
    for j in range(K):
        s = ordered[:, j]
        kept = (s < n)[:, None]
        s = torch.clamp(s, max=n - 1)
        out = out + torch.where(kept, y[s] * slot_w[s, None], 0)
    out = out.reshape(Bx, Sx, D)
    if mo.n_shared_experts:
        out = out + mlp.mlp(pm["shared"], x, cfg.act)
    return out, aux


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_without_mesh_is_one_group(arch):
    """No mesh: ``moe`` (the grouped program at G = 1, which the sharded
    step runs too) gives the one-group program's bits (``_one_group``):
    output, loss and gradients, with pairs dropping."""
    cfg = reduced(cfgs, arch, MOE_CF)
    jc = reduced(jcfgs, arch, MOE_CF)
    jp = jax.tree.map(np.asarray, jlm.init_lm(jax.random.PRNGKey(0), jc))
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (B, S, 64)).astype(np.float32))
    assert _dropped(cfg, x.numpy(), jp, 1)
    res = []
    for grouped in (False, True):
        p = convert.lm_params_from_numpy(jp, cfg, device="cpu")
        pm = p["layers"][moe_run(cfg)][0]["moe"]
        pm.requires_grad_(True)
        xi = x.clone().requires_grad_(True)
        out, aux = (mlp.moe if grouped else _one_group)(pm, xi, cfg)
        (out.square().sum() + aux).backward()
        res.append([out.detach(), aux.detach(), xi.grad]
                   + [t.grad for t in pm.parameters()])
    for a, b in zip(*res):
        assert torch.equal(a, b)


def _train(args, steps=2):
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--reduced",
           "--steps", str(steps), "--batch", str(B), "--seq-len", str(S),
           "--device", "cpu", "--log-every", "1", "--ckpt-every", "0",
           *args]
    out = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT,
                         timeout=600, env=_env())
    assert out.returncode == 0, out.stderr[-4000:]
    line = [ln for ln in out.stdout.splitlines()
            if ln.startswith("[train] losses ")]
    assert line, out.stdout[-2000:]
    return json.loads(line[0][len("[train] losses "):])


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "whisper-base",
                                  "recurrentgemma-9b"])
def test_launcher_trains_sharded(tmp_path, arch):
    """``--data-axis 2 --model-axis 2``: four gloo processes; the losses of
    2 steps against the unsharded trainer's, 1e-5 relative."""
    name = arch.replace("-", "_").replace(".", "_")
    c = cfgs.get(name).reduced()
    if c.moe.n_experts:  # the batches' pairs drop at neither G = 1 nor 2
        for step in range(2):
            for groups in (1, 2):
                _check_lossless(c, step, groups)
    got = _train(["--arch", arch, "--data-axis", "2", "--model-axis", "2",
                  "--ckpt-dir", str(tmp_path / "ck")])
    t = tr.TrainerConfig(steps=2, ckpt_every=0, ckpt_dir=str(tmp_path / "p"),
                         batch=B, seq_len=S, log_every=100)
    ocfg = optim.OptimizerConfig(peak_lr=3e-4, end_lr=3e-5, warmup_steps=1,
                                 total_steps=2)
    want = tr.Trainer(c, t, opt_cfg=ocfg, device="cpu").run()["losses"]
    np.testing.assert_allclose(got, want, rtol=1e-5)


def _check_lossless(cfg, step, groups):
    """Every expert bucket of every group fits its capacity: each token
    picks K distinct experts, so a bucket holds at most ``T_g`` pairs, and
    the reduced capacity factor 2.0 with K 2 of E 4 gives ``cap = T_g``."""
    mo = cfg.moe
    T = B * S // groups
    assert max(1, int(T * mo.n_experts_per_token * mo.capacity_factor
                      / mo.n_experts)) >= T, (step, groups)


# (what, q shape, kv shape, kv spec): the families' attention calls as the
# models place them, heads over "model" where they divide
ROUTE_CASES = (
    ("cross-attention", (4, 16, 4, 16), (4, 8, 4, 16), ("data", None,
                                                        "model", None)),
    ("MLA, D 192", (4, 16, 8, 192), (4, 16, 8, 192), ("data", None,
                                                      "model", None)),
    ("MQA", (4, 16, 4, 32), (4, 16, 1, 32), ("data", None, None, None)))


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("what,qs,ks,kspec", ROUTE_CASES,
                         ids=[c[0] for c in ROUTE_CASES])
def test_local_route_takes_the_families_placements(what, qs, ks, kspec,
                                                   mesh):
    """``ops._local_plan`` gives each rank's blocks a plan for
    cross-attention (``Sq != Skv``), MLA's head dim 192 and MQA's one kv
    head on every ``(N, 1)`` / ``(1, N)`` block; a sequence-sharded k
    still has none (on the card it raises)."""
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import fake_device_mesh
    from repro_torch.sharding import rules

    dm = fake_device_mesh(mesh, ("data", "model"), "cpu")
    q = rules.distribute({"q": torch.empty(qs, device="meta")},
                         {"q": ("data", None, "model", None)}, dm)["q"]
    k, v = (rules.distribute({"k": torch.empty(ks, device="meta")},
                             {"k": kspec}, dm)["k"] for _ in range(2))
    assert ops._local_plan(q, k, v) is not None
    seq = rules.distribute({"k": torch.empty(ks, device="meta")},
                           {"k": (None, "data", None, None)}, dm)["k"]
    if mesh[0] > 1:
        assert ops._local_plan(q, seq, seq) is None


@pytest.mark.parametrize("arch", ["mixtral_8x22b", "recurrentgemma_9b"])
def test_adamw_in_slices_is_bitwise_one_pass(monkeypatch, arch):
    """AdamW's full-moment step runs in slices of ``_STEP_ELEMS`` elements
    along a leaf's first dimension (the full-width embedding's and expert
    stacks' f32 temporaries would not fit one card beside the state): two
    steps with ``_STEP_ELEMS`` 7 (slices of 7 elements) == the
    one-pass step, bitwise, in the parameters and both moments."""
    from repro_torch.optim import adamw

    c = reduced(cfgs, arch)
    batch = {k: torch.from_numpy(v)
             for k, v in TokenStream(c, B, S, seed=1).batch_at(0).items()}
    ocfg = optim.OptimizerConfig(**OPT)
    res = []
    for elems in (adamw._STEP_ELEMS, 7):
        monkeypatch.setattr(adamw, "_STEP_ELEMS", elems)
        p = convert.lm_params_from_numpy(
            jax.tree.map(np.asarray, jlm.init_lm(jax.random.PRNGKey(0),
                                                 reduced(jcfgs, arch))),
            c, device="cpu").requires_grad_(True)
        o = optim.init_opt_state(p, ocfg)
        step = make_train_step(c, ocfg)
        for _ in range(2):
            p, o, _st = step(p, o, dict(batch))
        res.append([t.detach().clone() for t in p.parameters()]
                   + list(o["mu"].values())
                   + [v["full"] for v in o["nu"].values()])
    assert all(torch.equal(a, b) for a, b in zip(*res))


ONE_RANK = textwrap.dedent("""
    import json, os, sys, tempfile
    import torch
    from repro_torch.core.distributed import make_mesh
    from repro_torch.data.lm_pipeline import TokenStream
    from repro_torch.launch.mesh import device_mesh, init_group
    from repro_torch.launch.train import model_config
    from repro_torch.models import lm
    from repro_torch.sharding import rules
    from repro_torch.sharding.activation import activation_mesh

    torch.set_num_threads(1)
    init_group(0, 1, sys.argv[1], "cpu")
    mesh = device_mesh(make_mesh((1, 1), ("data", "model"),
                                 [torch.device("cpu")]))
    cfg = model_config(sys.argv[2])
    batch = {k: torch.from_numpy(v) for k, v in
             TokenStream(cfg, 2, 32, seed=0).batch_at(0).items()}


    def run(sharded):
        p = lm.init_lm(0, cfg, device="cpu")
        b = dict(batch)
        if sharded:
            rules.distribute_params(p, mesh)
            b = rules.distribute(b, rules.batch_pspecs(b, mesh), mesh)
        p.requires_grad_(True)
        with activation_mesh(mesh) if sharded else torch.enable_grad():
            loss = lm.train_step_loss(p, cfg, b)
            loss.backward()
        full = lambda t: t.full_tensor() if hasattr(t, "full_tensor") \\
            else t  # noqa: E731
        return [full(loss).detach()] + [full(t.grad)
                                        for t in p.parameters()]


    same = [bool(torch.equal(a, b)) for a, b in zip(run(False), run(True))]
    print("SAME " + json.dumps(same))
""")


@pytest.mark.parametrize("arch", ["xlstm-125m"])
def test_one_rank_mesh_is_the_one_process_step_bitwise(tmp_path, arch):
    """Full width, bf16: the loss and every gradient of one step on a
    ``(1, 1)`` mesh (one gloo process, DTensors throughout) == the
    one-process step's, bitwise. The mLSTM's conv input has five uses (four
    taps and the v projection); a conv run whole on a rank's block summed
    its four taps' gradient terms before adding the fifth, a different
    order, and the second losses of phase 18 (e) differed on the card."""
    r = subprocess.run([sys.executable, "-c", ONE_RANK, str(tmp_path), arch],
                       cwd=ROOT, capture_output=True, text=True,
                       timeout=600, env=_env())
    assert r.returncode == 0, r.stderr[-4000:]
    same = json.loads([ln for ln in r.stdout.splitlines()
                       if ln.startswith("SAME ")][0][5:])
    assert all(same), same
