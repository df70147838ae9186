"""The census of a sharded step (``analysis/census.py``), on the CPU.

* A ``(1, 1)`` mesh moves no byte between devices.
* Rank 0's census of a real 4-process gloo run of the sharded train step
  (reduced qwen2, gemma3, granite on ``(2, 2)``, ``(1, 4)``, ``(4, 1)``)
  equals the census of the same program over a fake process group of 4
  ranks on ``meta`` exactly: collective bytes by kind, the traffic (plain
  and flash-adjusted), the op census, the peak and temp bytes.
* On a data-parallel ``(4, 1)`` mesh the collective bytes by kind equal
  what the placements alone give (``placement_collectives``): one
  all-gather of each data-sharded weight's whole bytes a use in the
  forward (a tied embedding is used twice: the lookup and the head), one
  reduce-scatter of each such use's gradient to the weight's block, one
  all-reduce of each replicated weight's whole gradient, and two scalar
  all-reduces (the loss's mean, the clip's squared norm). On a mesh with a
  model axis the activations' redistributions (the Megatron-SP layout
  ``constrain`` pins, the vocab-sharded cross entropy) add collectives
  that DTensor's propagation chooses op by op; the placements alone do
  not give them, and those meshes are held by the gloo run == the fake
  group.
* ``hbm_bytes`` and ``temp_bytes`` of small known programs are exact;
  ``flash_attention`` counts at its boundary.
* ``roofline_terms`` equals ``repro.analysis.hlo.roofline_terms`` given
  the reference's constants, read from ``repro.analysis.hlo``; the port's
  defaults are the H100's datasheet rates.
* Beside the reference: the collective bytes by kind of the JAX step
  compiled on 4 host devices (``hlo.collective_bytes``) against the
  port's, on ``(2, 2)``. DTensor's propagation and XLA's partitioner
  place collectives differently; the test names each kind's ratio and
  holds it to what was measured.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.configs as cfgs  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.analysis.census import (HBM_BW, LINK_BW,  # noqa: E402
                                         PEAK_FLOPS_BF16, Census,
                                         model_flops_per_step,
                                         roofline_terms)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.mesh import fake_device_mesh  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.sharding import rules  # noqa: E402
from repro_torch.sharding.activation import activation_mesh  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
B, S = 4, 16
CELLS = (("qwen2_1_5b", (2, 2)), ("gemma3_1b", (1, 4)),
         ("granite_34b", (4, 1)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    kept = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(kept)


def _env():
    return {**os.environ, "PYTHONPATH": str(ROOT / "src"),
            "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu"}


def census_of_step(arch, mesh, device):
    """The census of one sharded train step of reduced ``arch`` on
    ``mesh`` (a ``DeviceMesh``) with the batch of ``TokenStream`` seed 1
    (on ``meta``: empty tensors of its shapes)."""
    c = cfgs.get(arch).reduced()
    ocfg = optim.OptimizerConfig()
    p = lm.init_lm(0, c, device=device)
    o = optim.init_opt_state(p, ocfg)
    p, o = rules.distribute_state(p, o, mesh)
    p.requires_grad_(True)
    if device == "meta":
        b = {k: torch.empty((B, S), dtype=torch.int32, device="meta")
             for k in ("tokens", "labels")}
    else:
        from repro_torch.data.lm_pipeline import TokenStream
        b = {k: torch.from_numpy(v)
             for k, v in TokenStream(c, B, S, seed=1).batch_at(0).items()}
    b = rules.distribute(b, rules.batch_pspecs(b, mesh), mesh)
    with activation_mesh(mesh), Census() as cen:
        out = make_train_step(c, ocfg, mesh=mesh)(p, o, b)
    r = cen.result()
    del out
    return r


WORKER = textwrap.dedent("""
    import json, os, sys
    import torch
    import torch.multiprocessing as mp


    def run(rank, tmp, cells):
        torch.set_num_threads(1)
        import torch.distributed as dist
        sys.path.insert(0, os.path.join(os.environ["ROOT"], "tests"))
        from test_torch_census import census_of_step
        from repro_torch.core.distributed import make_mesh
        from repro_torch.launch.mesh import device_mesh, init_group

        init_group(rank, 4, os.path.join(tmp, "meet"), "cpu")
        out = {}
        for arch, shape in cells:
            mesh = device_mesh(make_mesh(tuple(shape), ("data", "model"),
                                         [torch.device("cpu")] * 4))
            out[arch] = census_of_step(arch, mesh, "cpu")
        if rank == 0:
            with open(os.path.join(tmp, "real.json"), "w") as f:
                json.dump(out, f)
        dist.destroy_process_group()


    if __name__ == "__main__":
        mp.spawn(run, args=(sys.argv[1], json.loads(sys.argv[2])),
                 nprocs=4)
""")


@pytest.fixture(scope="module")
def real_census(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("census")
    (tmp / "worker.py").write_text(WORKER)
    r = subprocess.run([sys.executable, str(tmp / "worker.py"), str(tmp),
                        json.dumps(CELLS)], cwd=ROOT, capture_output=True,
                       text=True, timeout=600,
                       env={**_env(), "ROOT": str(ROOT)})
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads((tmp / "real.json").read_text())


def test_one_device_mesh_moves_nothing():
    mesh = fake_device_mesh((1, 1), ("data", "model"), "cpu")
    r = census_of_step("qwen2_1_5b", mesh, "meta")
    assert r["collective_bytes"] == {}
    assert not any(k in r["hlo_ops"] for k in ("all-gather", "all-reduce",
                                               "reduce-scatter"))
    assert r["hlo_ops"]["flash_attention"] == 2  # two layers' forwards
    assert r["device_hbm_bytes"] > r["device_hbm_bytes_flash_adjusted"] > 0


@pytest.mark.parametrize("arch,shape", CELLS)
def test_real_gloo_census_equals_the_fake_group(real_census, arch, shape):
    fake = census_of_step(arch, fake_device_mesh(shape, ("data", "model"),
                                                 "cpu"), "meta")
    real = real_census[arch]
    assert real == json.loads(json.dumps(fake))
    assert sum(real["collective_bytes"].values()) > 0


def placement_collectives(cfg, params) -> dict:
    """The collective bytes of one data-parallel train step derived from
    the parameters' placements (DTensors on a ``(data, 1)`` mesh)."""
    want = {"all-gather": 0.0, "reduce-scatter": 0.0, "all-reduce": 8.0}
    for name, p in params.named_parameters():
        uses = 2 if name == "embed" and cfg.tie_embeddings else 1
        size = p.element_size()
        if p.placements[0].is_shard():  # over "data": gathered a use
            want["all-gather"] += uses * p.numel() * size
            want["reduce-scatter"] += uses * p.to_local().numel() * size
        else:  # replicated: its partial-sum gradient all-reduced
            want["all-reduce"] += p.numel() * size
    return want


@pytest.mark.parametrize("arch", [a for a, _ in CELLS])
def test_data_parallel_collectives_follow_the_placements(arch):
    mesh = fake_device_mesh((4, 1), ("data", "model"), "cuda")
    got = census_of_step(arch, mesh, "meta")["collective_bytes"]
    c = cfgs.get(arch).reduced()
    p = lm.init_lm(0, c, device="meta")
    p, _ = rules.distribute_state(
        p, optim.init_opt_state(p, optim.OptimizerConfig()), mesh)
    want = placement_collectives(c, p)
    assert want["all-gather"] > 0 and want["all-reduce"] > 8
    assert got == want


def test_known_program_traffic_and_temporaries():
    """``a = x @ w; y = relu(a); z = y.sum()`` on f32, ``a`` dropped
    after ``y`` is made: traffic = (x + w + a) + (a + y) + (y + z) bytes;
    the peak holds ``a`` and ``y`` together; ``z``, made after the peak,
    is not subtracted from it."""
    x, w = torch.randn(8, 16), torch.randn(16, 32)
    with Census() as c:
        a = x @ w
        y = torch.relu(a)
        del a
        z = y.sum()
        del y
    r = c.result()
    f = 4
    assert r["device_hbm_bytes"] == f * ((8 * 16 + 16 * 32 + 8 * 32)
                                         + (8 * 32 + 8 * 32) + (8 * 32 + 1))
    assert r["hlo_ops"] == {"mm": 1, "relu": 1, "sum": 1}
    assert r["peak_bytes"] == f * (2 * 8 * 32)
    assert r["temp_bytes"] == r["peak_bytes"]  # z came after the peak
    assert float(z) == float(torch.relu(x @ w).sum())
    assert r["collective_bytes"] == {}


def test_flash_attention_counts_at_its_boundary():
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 32, 4, 16, generator=g)
    k = torch.randn(2, 32, 2, 16, generator=g)
    v = torch.randn(2, 32, 2, 16, generator=g)
    with Census() as c:
        out = ops.flash_attention(q, k, v)
    r = c.result()
    f = 4
    assert r["hlo_ops"] == {"flash_attention": 1}
    assert r["device_hbm_bytes_flash_adjusted"] == f * (
        2 * q.numel() + k.numel() + v.numel())
    assert r["device_hbm_bytes"] > r["device_hbm_bytes_flash_adjusted"]
    # the kernel's output is the one storage the call leaves
    assert r["peak_bytes"] == out.numel() * f


def test_roofline_terms_equal_the_reference():
    from repro.analysis import hlo

    coll = {"all-gather": 3e9, "all-reduce": 1e9, "reduce-scatter": 2e9}
    for flops, hbm, chips in ((1e15, 1e11, 256), (4e17, 2e13, 512)):
        want = hlo.roofline_terms(flops, hbm, coll, chips)
        got = roofline_terms(flops, hbm, coll, chips,
                             peak_flops=hlo.PEAK_FLOPS_BF16,
                             hbm_bw=hlo.HBM_BW, link_bw=hlo.ICI_BW)
        assert got == want
    assert model_flops_per_step(10, 7) == hlo.model_flops_per_step(10, 7)
    assert model_flops_per_step(10, 7, "decode") == \
        hlo.model_flops_per_step(10, 7, "decode")
    # the port's own rates are the H100 SXM's datasheet figures
    assert (PEAK_FLOPS_BF16, HBM_BW, LINK_BW) == (989e12, 3.35e12, 450e9)
    assert roofline_terms(989e12, 0, {}, 1)["t_compute_s"] == 1.0


JAX_COLL = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import json, sys
    import jax, jax.numpy as jnp
    import repro.configs as cfgs
    from repro.analysis import hlo
    from repro.launch.mesh import make_mesh
    from repro.launch.steps import make_train_step
    from repro.models import lm
    from repro.optim import OptimizerConfig, init_opt_state
    from repro.sharding import batch_pspecs, named, param_pspecs
    from repro.sharding.activation import activation_mesh

    cfg = cfgs.get(sys.argv[1]).reduced()
    mesh = make_mesh((2, 2), ("data", "model"))
    opt = OptimizerConfig()
    p = lm.init_lm(jax.random.PRNGKey(0), cfg)
    o = init_opt_state(p, opt)
    b = {k: jnp.zeros((4, 16), jnp.int32) for k in ("tokens", "labels")}
    p = jax.tree.map(jax.device_put, p, named(param_pspecs(p, mesh), mesh))
    o = jax.tree.map(jax.device_put, o, named(param_pspecs(o, mesh), mesh))
    b = jax.tree.map(jax.device_put, b, named(batch_pspecs(b, mesh), mesh))
    with mesh, activation_mesh(mesh):
        text = jax.jit(make_train_step(cfg, opt, 1, mesh=mesh)).lower(
            p, o, b).compile().as_text()
    print("COLL " + json.dumps(hlo.collective_bytes(text)))
""")

# port / reference collective bytes by kind, qwen2 reduced, (2, 2), one
# train step, as measured: the port reduce-scatters each data-parallel
# weight gradient to its parameter's placement (``shard_like_params``)
# where XLA's partitioner all-reduces it (all-reduce 0.037x, the
# logsumexp's max and sum all-reduced explicitly (``lm._lse``); the port's
# reduce-scatter has no reference term); the port gathers 0.67x the
# reference's bytes; XLA moves 16,384 bytes by all-to-all and 128 by
# collective-permute where DTensor uses none. These pins detect a change;
# what the bytes should be is derived on a data-parallel mesh above
_RATIOS = {"all-gather": 0.6662810873337189,
           "all-reduce": 0.03702292016059359,
           "all-to-all": 0.0, "collective-permute": 0.0,
           "reduce-scatter": None}


def test_collective_bytes_beside_the_reference():
    r = subprocess.run([sys.executable, "-c", JAX_COLL, "qwen2_1_5b"],
                       cwd=ROOT, capture_output=True, text=True,
                       timeout=600, env=_env())
    assert r.returncode == 0, r.stderr[-4000:]
    want = json.loads([ln for ln in r.stdout.splitlines()
                       if ln.startswith("COLL ")][0][5:])
    got = census_of_step("qwen2_1_5b", fake_device_mesh(
        (2, 2), ("data", "model"), "cuda"), "meta")["collective_bytes"]
    kinds = sorted(set(want) | set(got))
    ratios = {k: (got.get(k, 0.0) / want[k] if want.get(k) else None)
              for k in kinds}
    # printed beside the reference's: the measured gaps pinned below
    print("port", got, "reference", want, "ratios", ratios)
    assert set(ratios) == set(_RATIOS)
    for k, r in _RATIOS.items():
        assert (ratios[k] is None) if r is None else \
            ratios[k] == pytest.approx(r, rel=1e-9), k
