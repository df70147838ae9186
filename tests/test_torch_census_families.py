"""The census of the MoE, MLA, encoder-decoder and recurrent families'
sharded steps (``analysis/census.py``, ``launch/dryrun.py``), on the CPU.

* Rank 0's census of a real 4-process gloo run of the sharded train step
  equals the same program's over a fake process group of 4 ranks on
  ``meta``, exactly: reduced mixtral-8x22b on ``(2, 2)``, deepseek-v2-236b
  (its first 4 layers) on ``(1, 4)``, recurrentgemma-9b on ``(4, 1)``.
* The RG-LRU, mLSTM and sLSTM blocks on a fake ``(2, 2)`` group (forward
  and backward) run the same collectives at two sequence lengths whose
  time loops differ in trip count: nothing inside a loop communicates.
* The sLSTM's token loop counted by one middle step (``analysis.flops.
  loop_steps``, the reference's while-trip convention) equals the whole
  loop's count: traffic, ops, FLOPs and collectives, with and without a
  backward pass under remat; its temporaries are three steps' storages.
* ``dryrun.run_cell`` counts every one of the five families' ``train_4k``
  cells on the 16 x 16 mesh by census: ``census`` "ok", its keys filled,
  the compiler's own ``null``.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import repro_torch.configs as cfgs  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.analysis.census import Census  # noqa: E402
from repro_torch.analysis import flops as fl  # noqa: E402
from repro_torch.analysis.flops import FlopCounter  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import fake_device_mesh  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import blocks as blk  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.sharding import rules  # noqa: E402
from repro_torch.sharding.activation import activation_mesh  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
B, S = 4, 16
CELLS = (("mixtral_8x22b", (2, 2)), ("deepseek_v2_236b", (1, 4)),
         ("recurrentgemma_9b", (4, 1)))
FAMILIES = ("mixtral-8x22b", "deepseek-v2-236b", "whisper-base",
            "xlstm-125m", "recurrentgemma-9b")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    kept = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(kept)


def _env():
    return {**os.environ, "PYTHONPATH": str(ROOT / "src"),
            "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu"}


def reduced(arch):
    """The reduced config; deepseek's cut to its first 4 layers (its
    reduced config keeps all 60 of a pattern without a period)."""
    c = cfgs.get(arch).reduced()
    if c.moe.n_experts and c.n_layers > 4:
        c = c.replace(n_layers=4, layer_pattern=c.pattern[:4])
    return c


def census_of_step(arch, mesh, device):
    """The census of one sharded train step of ``reduced(arch)`` on
    ``mesh`` with the batch of ``TokenStream`` seed 1 (on ``meta``: empty
    tensors of its shapes)."""
    from repro_torch.data.lm_pipeline import TokenStream

    c = reduced(arch)
    ocfg = optim.OptimizerConfig()
    p = lm.init_lm(0, c, device=device)
    o = optim.init_opt_state(p, ocfg)
    p, o = rules.distribute_state(p, o, mesh)
    p.requires_grad_(True)
    b = {k: torch.from_numpy(v)
         for k, v in TokenStream(c, B, S, seed=1).batch_at(0).items()}
    if device == "meta":
        b = {k: torch.empty_like(v, device="meta") for k, v in b.items()}
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
        from test_torch_census_families import census_of_step
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
                       text=True, timeout=900,
                       env={**_env(), "ROOT": str(ROOT)})
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads((tmp / "real.json").read_text())


@pytest.mark.parametrize("arch,shape", CELLS)
def test_real_gloo_census_equals_the_fake_group(real_census, arch, shape):
    fake = census_of_step(arch, fake_device_mesh(shape, ("data", "model"),
                                                 "cpu"), "meta")
    real = real_census[arch]
    assert real == json.loads(json.dumps(fake))
    assert sum(real["collective_bytes"].values()) > 0


# (arch, kind, two sequence lengths whose loops differ in trip count: two
# and three of the RG-LRU's and the mLSTM's 256-step chunks, the sLSTM's
# steps; DTensor picks redistributions by their size, so both lengths keep
# the chunk length)
LOOPS = (("recurrentgemma_9b", "rglru", (272, 528)),
         ("xlstm_125m", "mlstm", (272, 528)),
         ("xlstm_125m", "slstm", (6, 10)))


def _block_census(arch, kind, seq):
    """The census of one ``kind`` block's forward and backward over a
    ``(B, seq, d)`` input on a fake ``(2, 2)`` group, placed as a sharded
    step places the residual stream (``blocks.SP_SPEC``)."""
    cfg = cfgs.get(arch).reduced()
    mesh = fake_device_mesh((2, 2), ("data", "model"), "cpu")
    params = rules.distribute_params(lm.init_lm(0, cfg, device="meta"),
                                     mesh)
    run = [k for i, k in enumerate(cfg.pattern)
           if i == 0 or cfg.pattern[i - 1] != k].index(kind)
    p = params["layers"][run][0]
    p.requires_grad_(True)
    with activation_mesh(mesh):
        x = rules.distribute(
            {"x": torch.empty((B, seq, cfg.d_model), device="meta")},
            {"x": ("data", "model", None)}, mesh)["x"].requires_grad_(True)
        with Census() as c:
            y, _ = blk.apply_block_full(p, x, cfg, kind, None)
            y.sum().backward()
    return c.result()


@pytest.mark.parametrize("arch,kind,seqs", LOOPS,
                         ids=[k for _, k, _ in LOOPS])
def test_recurrent_loops_move_nothing(arch, kind, seqs):
    kinds = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
             "collective-permute")
    counts = []
    for seq in seqs:
        r = _block_census(arch, kind, seq)
        counts.append({k: r["hlo_ops"].get(k, 0) for k in kinds})
    assert counts[0] == counts[1]
    assert sum(counts[0].values()) > 0  # the block's projections do move


@pytest.mark.parametrize("grad", [False, True], ids=["forward", "backward"])
@pytest.mark.parametrize("seq", [3, 6])
def test_counted_slstm_loop_equals_the_whole_loop(seq, grad):
    cfg = cfgs.get("xlstm-125m")
    rcfg = cfg.replace(remat="full")
    p = lm.init_lm(0, cfg, device="meta")["layers"][1][0]
    got = []
    for whole in (True, False):
        kept = fl._loop_counters
        if whole:
            fl._loop_counters = lambda t, n: []
        try:
            res = []
            for mode in (Census, FlopCounter):
                x = torch.empty((4, seq, cfg.d_model), device="meta",
                                dtype=torch.bfloat16, requires_grad=grad)
                with torch.set_grad_enabled(grad), mode() as c:
                    y = blk.remat(blk.apply_block_full, rcfg, p, x)(
                        p, x, cfg, "slstm", None)[0]
                    if grad:
                        y.float().sum().backward()
                res.append(c)
        finally:
            fl._loop_counters = kept
        got.append(res)
    (cw, fw), (cc, fc) = got
    for k in ("device_hbm_bytes", "device_hbm_bytes_flash_adjusted",
              "collective_bytes", "hlo_ops"):
        assert cw.result()[k] == cc.result()[k], k
    assert cw.bytes_by_op == cc.bytes_by_op
    assert fw.result() == fc.result() and fw.by_op == fc.by_op


@pytest.fixture(scope="module")
def counted():
    """The five ``train_4k`` cells' FLOP counts and censuses on 16 x 16,
    made in 2 worker processes."""
    cells = [(a, "train_4k", False) for a in FAMILIES]
    return dryrun.count_all(cells, 2, census=(False,))


@pytest.mark.parametrize("arch", FAMILIES)
def test_dryrun_census_of_train_4k(counted, arch):
    flops, censuses = counted
    r = dryrun.run_cell(arch, "train_4k", multi_pod=False, verbose=False,
                        flops_cache=flops, census_cache=censuses)
    assert r["status"] == "ok" and r["census"] == "ok"
    for k in dryrun.CENSUS_KEYS:
        assert r[k] is not None, k
    assert r["memory"]["temp_bytes"] is not None
    assert sum(r["collective_bytes"].values()) > 0
    for k in set(dryrun.COMPILER_KEYS) - set(dryrun.CENSUS_KEYS):
        assert r[k] is None, k
