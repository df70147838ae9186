"""Sharded LM training in the port against the JAX package, on the CPU.

Each sharded run is a real process group: 4 processes on gloo, the
rendezvous a ``FileStore`` in ``tmp_path``, spawned from a worker script
(``WORKER``). The weights are the JAX ``init_lm`` tree carried into the
port (``serving.convert``).

* One train step (``make_train_step(mesh=...)``) of reduced qwen2, gemma3
  and granite on the ``(2, 2)``, ``(4, 1)`` and ``(1, 4)`` meshes (on
  ``(1, 4)`` qwen2's 4 q heads shard over ``model`` while its 2 kv heads
  stay whole: the GQA map of ``ops.flash_attention``'s local route)
  against the port's unsharded step and the JAX ``make_train_step(mesh=
  ...)`` jitted on 4 host devices (``XLA_FLAGS``, a subprocess), with the
  block boundary's bf16 cotangent rounding off on both sides (its ties
  flip under any other reduction order). Loss and grad norm 1e-6
  relative; first and second moments 1e-6; parameters 1e-6 wherever the
  gradient exceeds 1e-6 in size. Where it does not, Adam's first step
  moves a weight by about the learning rate whatever its gradient's size,
  so a reordered sum that flips a near-zero gradient's sign moves it by up
  to twice that: the measured gap there is up to 1.6e-4 at a learning rate
  of 1e-3, and those elements are held to 2e-3.
* Each rank's local blocks hold ``device_bytes`` of the placements' bytes
  and XLA's ``memory_analysis()`` argument bytes of the same step.
* The launcher (``python -m repro_torch.launch.train --data-axis 2
  --model-axis 2 --device cpu``) trains the three models for 2 steps: its
  losses against the port's unsharded trainer, 1e-5 relative.
* Elastic restore: a checkpoint saved on ``(2, 2)`` restores on ``(4, 1)``
  and on ``(1, 1)``, and the next step's loss equals an uninterrupted
  run's (1e-5 relative).
* On a CPU-only machine ``--device cuda`` with more processes than cards
  is refused.
"""
import json
import os
import pickle
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.configs as jcfgs  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
import repro_torch.configs as cfgs  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.data.lm_pipeline import TokenStream  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.runtime import trainer as tr  # noqa: E402
from repro_torch.serving import convert  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("qwen2_1_5b", "gemma3_1b", "granite_34b")
MESHES = ((2, 2), (4, 1), (1, 4))
B, S = 4, 16
LR = 1e-3
OPT = dict(peak_lr=LR, warmup_steps=1, total_steps=10)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    kept = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(kept)


def _env():
    return {**os.environ, "PYTHONPATH": str(ROOT / "src"),
            "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu"}


def _batch(cfg):
    return TokenStream(cfg, B, S, seed=1).batch_at(0)


WORKER = textwrap.dedent("""
    import json, os, pickle, sys
    import numpy as np
    import torch
    import torch.multiprocessing as mp


    def full(t):
        return t.full_tensor().numpy() if hasattr(t, "full_tensor") \\
            else t.numpy()


    def run(rank, tmp, arch, meshes, opt):
        torch.set_num_threads(1)
        import torch.distributed as dist
        import repro_torch.configs as cfgs
        from repro_torch import optim
        from repro_torch.core.distributed import make_mesh
        from repro_torch.launch.mesh import device_mesh, init_group
        from repro_torch.launch.steps import make_train_step
        from repro_torch.serving import convert
        from repro_torch.sharding import rules
        from repro_torch.sharding.activation import activation_mesh

        init_group(rank, 4, os.path.join(tmp, "meet"), "cpu")
        with open(os.path.join(tmp, "weights.pkl"), "rb") as f:
            weights, batch = pickle.load(f)
        cfg = cfgs.get(arch).reduced()
        ocfg = optim.OptimizerConfig(**opt)
        out = {}
        for shape in meshes:
            mesh = device_mesh(make_mesh(shape, ("data", "model"),
                                         [torch.device("cpu")] * 4))
            p = convert.lm_params_from_numpy(weights, cfg, device="cpu")
            o = optim.init_opt_state(p, ocfg)
            want = (rules.device_bytes(p, rules.param_pspecs(p, mesh), mesh)
                    + rules.device_bytes(o, rules.param_pspecs(o, mesh),
                                         mesh))
            p, o = rules.distribute_state(p, o, mesh)
            p.requires_grad_(True)
            b = {k: torch.from_numpy(v) for k, v in batch.items()}
            bspecs = rules.batch_pspecs(b, mesh)
            want += rules.device_bytes(b, bspecs, mesh)
            b = rules.distribute(b, bspecs, mesh)
            got = rules.local_bytes(p) + rules.local_bytes(o) \\
                + rules.local_bytes(b)
            with activation_mesh(mesh):
                p, o, st = make_train_step(cfg, ocfg, mesh=mesh)(p, o, b)
            res = {"loss": float(st["loss"]),
                   "grad_norm": float(st["grad_norm"]),
                   "local_bytes": got, "device_bytes": want,
                   "params": [full(t.detach()) for t in p.parameters()],
                   "mu": [full(o["mu"][k]) for k in o["mu"]],
                   "nu": [full(o["nu"][k]["full"]) for k in o["nu"]]}
            out["x".join(map(str, shape))] = res
        if rank == 0:
            with open(os.path.join(tmp, "port.pkl"), "wb") as f:
                pickle.dump(out, f)
        dist.destroy_process_group()


    if __name__ == "__main__":
        tmp, arch = sys.argv[1], sys.argv[2]
        meshes = json.loads(sys.argv[3])
        mp.spawn(run, args=(tmp, arch, [tuple(m) for m in meshes],
                            json.loads(sys.argv[4])), nprocs=4)
""")

JAX_STEP = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import json, pickle, sys
    import numpy as np
    import jax, jax.numpy as jnp
    import repro.configs as cfgs
    import repro.models.blocks as blocks
    from repro.launch.mesh import make_mesh
    from repro.launch.steps import make_train_step
    from repro.optim import OptimizerConfig, init_opt_state
    from repro.sharding import batch_pspecs, named, param_pspecs
    from repro.sharding.activation import activation_mesh
    from repro.analysis import hlo

    # the block boundary's bf16 cotangent rounding off (see the module
    # docstring); the layout constraints stay
    blocks.grad_compressed_boundary = lambda x, spec: x
    tmp, arch = sys.argv[1], sys.argv[2]
    meshes = json.loads(sys.argv[3])
    opt = OptimizerConfig(**json.loads(sys.argv[4]))
    with open(os.path.join(tmp, "weights.pkl"), "rb") as f:
        weights, batch = pickle.load(f)
    cfg = cfgs.get(arch).reduced()
    out = {}
    for shape in meshes:
        mesh = make_mesh(tuple(shape), ("data", "model"))
        p = jax.tree.map(jnp.asarray, weights)
        o = init_opt_state(p, opt)
        b = {k: jnp.asarray(v) for k, v in batch.items()}
        p = jax.tree.map(jax.device_put, p, named(param_pspecs(p, mesh),
                                                  mesh))
        o = jax.tree.map(jax.device_put, o, named(param_pspecs(o, mesh),
                                                  mesh))
        b = jax.tree.map(jax.device_put, b, named(batch_pspecs(b, mesh),
                                                  mesh))
        step = make_train_step(cfg, opt, 1, mesh=mesh)
        with mesh, activation_mesh(mesh):
            fn = jax.jit(step)
            comp = fn.lower(p, o, b).compile()
            p2, o2, st = fn(p, o, b)
        m = comp.memory_analysis()
        res = {"loss": float(st["loss"]), "grad_norm": float(st["grad_norm"]),
               "argument_bytes": int(m.argument_size_in_bytes),
               "params": [np.asarray(x) for x in jax.tree.leaves(p2)],
               "mu": [np.asarray(x) for x in jax.tree.leaves(o2["mu"])],
               "nu": [np.asarray(x) for x in jax.tree.leaves(o2["nu"])]}
        try:
            res["collective_bytes"] = hlo.collective_bytes(comp.as_text())
        except Exception as e:  # noqa: BLE001 - reported by the test
            res["collective_bytes"] = f"{type(e).__name__}: {e}"
        out["x".join(map(str, shape))] = res
    with open(os.path.join(tmp, "jax.pkl"), "wb") as f:
        pickle.dump(out, f)
""")


def _run_both(tmp: Path, arch: str) -> dict:
    """The port's sharded steps (4 gloo processes), the JAX sharded steps
    (4 host devices) and the port's unsharded step of ``arch`` from the
    JAX weights: ``{"port", "jax", "plain"}``."""
    jc, c = jcfgs.get(arch).reduced(), cfgs.get(arch).reduced()
    jp = jax.tree.map(np.asarray, jlm.init_lm(jax.random.PRNGKey(0), jc))
    batch = _batch(c)
    tmp.mkdir(parents=True, exist_ok=True)
    with open(tmp / "weights.pkl", "wb") as f:
        pickle.dump((jp, batch), f)
    (tmp / "worker.py").write_text(WORKER)
    args = [str(tmp), arch, json.dumps(MESHES), json.dumps(OPT)]
    procs = [subprocess.Popen([sys.executable, str(tmp / "worker.py"), *args],
                              cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True),
             subprocess.Popen([sys.executable, "-c", JAX_STEP, *args],
                              cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)]
    for p in procs:
        _, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-4000:]
    ocfg = optim.OptimizerConfig(**OPT)
    p = convert.lm_params_from_numpy(jp, c, device="cpu")
    p.requires_grad_(True)
    o = optim.init_opt_state(p, ocfg)
    p, o, st = make_train_step(c, ocfg)(
        p, o, {k: torch.from_numpy(v) for k, v in batch.items()})
    plain = {"loss": float(st["loss"]), "grad_norm": float(st["grad_norm"]),
             "params": [t.detach().numpy() for t in p.parameters()],
             "mu": [o["mu"][k].numpy() for k in o["mu"]],
             "nu": [o["nu"][k]["full"].numpy() for k in o["nu"]],
             "mu_by_param": _by_param(p, o["mu"])}
    out = {"plain": plain}
    for side in ("port", "jax"):
        with open(tmp / f"{side}.pkl", "rb") as f:
            out[side] = pickle.load(f)
    return out


def _by_param(params, tree: dict) -> list:
    """A moment tree (one entry a reference leaf, stacked layers on a
    leading axis) as one array a parameter, in ``params.parameters()``
    order."""
    by_id = {}
    for name, leaf in optim.param_leaves(params).items():
        t = tree[name]
        if isinstance(leaf, list):
            by_id.update({id(x): t[i].numpy() for i, x in enumerate(leaf)})
        else:
            by_id[id(leaf)] = t.numpy()
    return [by_id[id(x)] for x in params.parameters()]


_RUNS: dict = {}


@pytest.fixture
def runs(tmp_path_factory):
    def get(arch):
        if arch not in _RUNS:
            _RUNS[arch] = _run_both(tmp_path_factory.mktemp(arch), arch)
        return _RUNS[arch]
    return get


def _params_close(got, want, mu):
    """Parameters within 1e-6 where the step's gradient (``mu / (1 - b1)``)
    exceeds 1e-6 in size; within 2e-3 (twice the learning rate) where it
    does not."""
    for g, w, m in zip(got, want, mu):
        g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
        big = np.abs(np.asarray(m, np.float32)) / 0.1 > 1e-6
        np.testing.assert_allclose(g[big], w[big], atol=1e-6, rtol=0)
        np.testing.assert_allclose(g, w, atol=2 * LR, rtol=0)


def _moments_close(a, b):
    for name in ("mu", "nu"):
        for g, w in zip(a[name], b[name]):
            np.testing.assert_allclose(np.asarray(g, np.float32).ravel(),
                                       np.asarray(w, np.float32).ravel(),
                                       atol=1e-6, rtol=0)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_equals_unsharded_and_jax(runs, arch, mesh):
    r = runs(arch)
    key = f"{mesh[0]}x{mesh[1]}"
    port, jx, plain = r["port"][key], r["jax"][key], r["plain"]
    for other in (plain, jx):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(port[k], other[k], rtol=1e-6)
    _moments_close(port, plain)
    _params_close(port["params"], plain["params"], plain["mu_by_param"])
    # the JAX leaves in its tree order: the reference's stacked layers
    c = cfgs.get(arch).reduced()
    tree = convert.lm_params_from_numpy(
        jax.tree.unflatten(jax.tree.structure(
            jlm.init_lm(jax.random.PRNGKey(0), jcfgs.get(arch).reduced())),
            jx["params"]), c, device="cpu")
    mu_tree = convert.lm_params_from_numpy(
        jax.tree.unflatten(jax.tree.structure(
            jlm.init_lm(jax.random.PRNGKey(0), jcfgs.get(arch).reduced())),
            jx["mu"]), c, device="cpu")
    _params_close(port["params"], [t.detach().numpy()
                                   for t in tree.parameters()],
                  [t.detach().numpy() for t in mu_tree.parameters()])
    # each rank's blocks: the placements' bytes and XLA's argument bytes
    assert port["local_bytes"] == port["device_bytes"] \
        == jx["argument_bytes"]


def _train(args, tmp, steps=3):
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--reduced",
           "--steps", str(steps), "--batch", str(B), "--seq-len", str(S),
           "--device", "cpu", "--log-every", "1", *args]
    out = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT,
                         timeout=600, env=_env())
    assert out.returncode == 0, out.stderr[-4000:]
    line = [ln for ln in out.stdout.splitlines()
            if ln.startswith("[train] losses ")]
    assert line, out.stdout[-2000:]
    return json.loads(line[0][len("[train] losses "):])


def _plain_losses(arch, tmp, steps=3, microbatches=1):
    c = cfgs.get(arch).reduced()
    t = tr.TrainerConfig(steps=steps, ckpt_every=0, ckpt_dir=str(tmp),
                         batch=B, seq_len=S, log_every=100,
                         microbatches=microbatches)
    ocfg = optim.OptimizerConfig(peak_lr=3e-4, end_lr=3e-5,
                                 warmup_steps=max(1, steps // 20),
                                 total_steps=steps)
    return tr.Trainer(c, t, opt_cfg=ocfg, device="cpu").run()["losses"]


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "gemma3-1b", "granite-34b"])
def test_launcher_trains_sharded(tmp_path, arch):
    """``--data-axis 2 --model-axis 2``: four gloo processes; the losses
    of 2 steps against the unsharded trainer's, 1e-5 relative; the final
    checkpoint is committed by rank 0."""
    got = _train(["--arch", arch, "--data-axis", "2", "--model-axis", "2",
                  "--ckpt-dir", str(tmp_path / "ck")], tmp_path, steps=2)
    want = _plain_losses(arch.replace("-", "_").replace(".", "_"),
                         tmp_path / "plain", steps=2)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert (tmp_path / "ck" / "step_000000002" / "COMMITTED").exists()


def test_launcher_microbatches_sharded(tmp_path):
    """``--microbatches 2`` on ``(2, 2)``: each rank's slice of its own
    rows a microbatch, the f32 accumulator placed like the parameters;
    the losses against the unsharded trainer's two microbatches (other
    rows a microbatch, the same mean), 1e-5 relative."""
    got = _train(["--arch", "qwen2-1.5b", "--data-axis", "2",
                  "--model-axis", "2", "--microbatches", "2",
                  "--ckpt-every", "0", "--ckpt-dir", str(tmp_path / "ck")],
                 tmp_path, steps=2)
    want = _plain_losses("qwen2_1_5b", tmp_path / "plain", steps=2,
                         microbatches=2)
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.fixture(scope="module")
def saved_on_2x2(tmp_path_factory):
    """3 steps of qwen2 on ``(2, 2)`` checkpointed at step 2 (the step-3
    checkpoint removed), and the uninterrupted unsharded run's losses."""
    tmp = tmp_path_factory.mktemp("elastic")
    ck = tmp / "ck"
    first = _train(["--arch", "qwen2-1.5b", "--data-axis", "2",
                    "--model-axis", "2", "--ckpt-dir", str(ck),
                    "--ckpt-every", "2"], tmp)
    shutil.rmtree(ck / "step_000000003")
    return ck, first, _plain_losses("qwen2_1_5b", tmp / "plain")


@pytest.mark.parametrize("mesh", [("4", "1"), ("1", "1")],
                         ids=["4x1", "1x1"])
def test_checkpoint_restores_on_another_mesh(tmp_path, saved_on_2x2, mesh):
    """The counterpart of ``tests/test_substrate.py:139``: 2 steps saved
    on ``(2, 2)``, resumed for a third on ``mesh``: the resumed run trains
    one step, and its loss equals an uninterrupted unsharded run's third
    (1e-5 relative)."""
    saved, first, want = saved_on_2x2
    ck = tmp_path / "ck"
    shutil.copytree(saved, ck)
    rest = _train(["--arch", "qwen2-1.5b", "--data-axis", mesh[0],
                   "--model-axis", mesh[1], "--ckpt-dir", str(ck)], tmp_path)
    assert len(rest) == 1
    np.testing.assert_allclose(first, want, rtol=1e-5)
    np.testing.assert_allclose(rest[0], want[2], rtol=1e-5)


@pytest.mark.parametrize("batch,mesh", [("12", ("2", "2")),
                                        ("8", ("4", "1"))],
                         ids=["6-rows-a-rank", "2-rows-a-rank"])
def test_launcher_refuses_an_uneven_microbatch_split(tmp_path, batch, mesh):
    """``--microbatches 4`` where a rank's rows (6, or 2) do not split into
    4 equal slices: every rank raises before the step's first collective
    (no row dropped, no empty slice)."""
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--reduced",
           "--arch", "qwen2-1.5b", "--steps", "1", "--batch", batch,
           "--seq-len", str(S), "--device", "cpu", "--microbatches", "4",
           "--data-axis", mesh[0], "--model-axis", mesh[1],
           "--ckpt-every", "0", "--ckpt-dir", str(tmp_path / "ck")]
    out = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT,
                         timeout=300, env=_env())
    assert out.returncode != 0
    assert "do not split into 4 microbatches" in out.stderr


PREEMPT = textwrap.dedent("""
    import json, os, signal, sys
    import torch
    import torch.multiprocessing as mp


    def run(rank, tmp):
        torch.set_num_threads(1)
        import torch.distributed as dist
        import repro_torch.configs as cfgs
        from repro_torch import optim
        from repro_torch.core.distributed import make_mesh
        from repro_torch.launch.mesh import device_mesh, init_group
        from repro_torch.runtime import trainer as tr

        init_group(rank, 4, os.path.join(tmp, "meet"), "cpu")
        mesh = device_mesh(make_mesh((2, 2), ("data", "model"),
                                     [torch.device("cpu")] * 4))
        t = tr.Trainer(cfgs.get("qwen2_1_5b").reduced(), tr.TrainerConfig(
            steps=20, ckpt_every=0, ckpt_dir=os.path.join(tmp, "ck"),
            log_every=100, batch=4, seq_len=16), mesh,
            optim.OptimizerConfig(total_steps=20, warmup_steps=1))
        draw = t.batch_at

        def batch_at(step):  # rank 1 alone is sent SIGTERM in step 2
            if rank == 1 and step == 2:
                os.kill(os.getpid(), signal.SIGTERM)
            return draw(step)

        t.batch_at = batch_at
        out = t.run()
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump({"preempted": out["preempted"],
                       "stop_step": out["stop_step"],
                       "losses": out["losses"],
                       "latest": t.store.latest_step()}, f)
        dist.destroy_process_group()


    if __name__ == "__main__":
        mp.spawn(run, args=(sys.argv[1],), nprocs=4)
""")


def test_preemption_on_one_rank_stops_every_rank(tmp_path):
    """SIGTERM reaches rank 1 alone, during step 2 of a sharded run on
    ``(2, 2)``: the ranks agree on the flag after that step, every rank
    stops after step 2 with ``preempted``, and rank 0 has committed the
    checkpoint of step 3 before any rank returns."""
    (tmp_path / "worker.py").write_text(PREEMPT)
    r = subprocess.run([sys.executable, str(tmp_path / "worker.py"),
                        str(tmp_path)], cwd=ROOT, capture_output=True,
                       text=True, timeout=300, env=_env())
    assert r.returncode == 0, r.stderr[-4000:]
    outs = [json.loads((tmp_path / f"rank{i}.json").read_text())
            for i in range(4)]
    for o in outs:
        assert o["preempted"] and o["stop_step"] == 3 and o["latest"] == 3
        assert o["losses"] == outs[0]["losses"] and len(o["losses"]) == 3
    assert (tmp_path / "ck" / "step_000000003" / "COMMITTED").exists()


def test_launcher_refuses_more_processes_than_cards(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen2-1.5b", "--reduced", "--steps", "1", "--device", "cuda",
         "--data-axis", "2", "--model-axis", "1", "--ckpt-dir",
         str(tmp_path)], capture_output=True, text=True, cwd=ROOT,
        timeout=300, env=_env())
    assert out.returncode != 0 and "visible card" in out.stderr


def test_trainer_takes_the_reference_argument_order(tmp_path):
    """``Trainer(cfg, tcfg, mesh, opt_cfg)`` is the reference's order (no
    mesh: one device); an object that is no ``DeviceMesh`` raises, a
    ``core.distributed.Mesh`` too (``launch.mesh.device_mesh`` makes one
    over a process group)."""
    c = cfgs.get("qwen2_1_5b").reduced()
    t = tr.TrainerConfig(steps=1, ckpt_dir=str(tmp_path))
    ocfg = optim.OptimizerConfig(peak_lr=2e-3)
    assert tr.Trainer(c, t, None, ocfg, device="cpu").opt_cfg is ocfg
    with pytest.raises(ValueError, match="DeviceMesh"):
        tr.Trainer(c, t, device="cpu", mesh=object())
    from repro_torch.launch.mesh import make_host_mesh
    with pytest.raises(ValueError, match="DeviceMesh"):
        tr.Trainer(c, t, make_host_mesh(1, 1, device="cpu"), ocfg)
