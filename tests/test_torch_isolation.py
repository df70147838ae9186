"""The port stands alone: it imports nothing of JAX and nothing of the
``repro`` package, and its default device is CUDA (raising without one).
"""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [m for m in _imported(tree)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def _module_name(path):
    parts = path.relative_to(PORT.parent).with_suffix("").parts
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


def test_importing_every_module_loads_no_jax_or_repro():
    mods = sorted(_module_name(p) for p in PORT.rglob("*.py"))
    assert "repro_torch.kernels.ops" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        f"             if m.split('.')[0] in {FORBIDDEN!r})\n"
        "assert not bad, bad\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=120, env=env)
    assert out.returncode == 0, out.stderr


def test_default_device_is_cuda():
    import numpy as np

    from repro_torch import configs
    from repro_torch.analysis import audit
    from repro_torch.core.lm_conformal import (ConformalLmClassifier,
                                              ConformalOodDetector)
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.serving import ServingEngine, convert
    from repro_torch.telemetry import calibrate_engine, loadgen, replay

    cfg = configs.get("qwen2-1.5b").reduced()
    tree = convert.lm_params_to_numpy(lm.init_lm(0, cfg, device="cpu"))
    emb = np.zeros((8, 4), np.float32)
    entry_points = {
        "engine": lambda: ServingEngine(n_sessions=1, capacity=8, dim=2,
                                        k=2).device,
        "init_lm": lambda: lm.init_lm(0, cfg)["embed"].device,
        "lm_params_from_numpy": lambda: convert.lm_params_from_numpy(
            tree, cfg)["embed"].device,
        "ood_detector": lambda: ConformalOodDetector(k=2).fit(emb)._emb.device,
        "lm_classifier": lambda: ConformalLmClassifier(2, k=2).fit(
            emb, np.arange(8) % 2)._state.X.device,
        "replay": lambda: replay(loadgen.generate(
            "steady", ops=4, tenants=1, capacity=8), dim=2,
            k=2).engine.device,
    }
    for name, make in entry_points.items():
        if torch.cuda.is_available():
            assert make().type == "cuda", name
        else:
            with pytest.raises(RuntimeError, match="CUDA"):
                make()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            serve.main(["--arch", "qwen2-1.5b", "--reduced"])
        with pytest.raises(RuntimeError, match="CUDA"):
            calibrate_engine(tenants=1, capacity=8, dim=2, k=2, chunks=(1,),
                             reps=1)
        with pytest.raises(RuntimeError, match="CUDA"):
            audit.main(["--out", os.devnull])
