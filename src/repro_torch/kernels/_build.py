"""Build and load the port's CUDA kernels (nvcc -> one shared library ->
ctypes).

Every ``csrc/*.cu`` file exposes a plain C entry point (``rt_*``) that
launches its kernel on the stream it is given and returns
``cudaGetLastError()``. At first use the sources are compiled in parallel
(one ``nvcc`` per file) for ``sm_90a`` and linked into one library under
``build/repro_torch_kernels/<hash of sources and flags>/`` at the root of
the checkout; a later process with the same sources loads it directly.
Nothing is compiled when this module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I64, _I, _F = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, \
    ctypes.c_float
# C signatures of the entry points, in argument order
SIGNATURES = {
    "rt_stream_update_class": [_P, _I64, _P, _I64, _P, _I64, _P, _I64, _I64,
                               _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                               _I, _I, _P],
    "rt_stream_update_reg": [_P, _I64, _P, _I64, _P, _I64, _P, _I64, _P,
                             _I64, _P, _I64, _P, _I64, _I64, _P, _P, _P, _P,
                             _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                             _P],
    "rt_interval_sweep": [_P, _I64, _P, _P, _P, _P, _P, _I64, _P, _P, _P,
                          _I, _I, _I, _I, _I, _F, _P],
    "rt_sqd_sqrt": [_P, _P, _I64, _P],
    "rt_pairwise_sq_dists": [_P, _I64, _P, _I64, _P, _P, _I, _I, _I, _I,
                             _P],
    "rt_cp_knn_counts": [_P, _I64, _P, _P, _P, _P, _I64, _P, _P, _I, _I, _I,
                         _I, _I, _P],
    "rt_kde_rowsums": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I,
                       _I, _I, _P],
    "rt_kde_scratch_bytes": [_I, _I, _I, _I, _I, _I],
    "rt_kde_expf": [_P, _P, _I64, _P],
    "rt_flash_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                           _I, _F, _F, _P],
}

RESTYPES = {"rt_kde_scratch_bytes": _I64}  # the rest return a CUDA error

_lib = None
build_seconds: float | None = None  # wall time of this process's build
build_log: str = ""  # nvcc's output (registers, spills) of that build


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the port's CUDA kernels are built at first use "
            "on a machine with the CUDA toolkit")
    return path


def _sources() -> list[Path]:
    return sorted(_CSRC.glob("*.cu"))


def _digest(sources: list[Path]) -> str:
    """Hash of the flags, the sources and the headers they include
    (``csrc/*.cuh``), so a changed header builds a new library."""
    h = hashlib.sha256(" ".join(ARCH + FLAGS).encode())
    for src in sorted(sources + list(_CSRC.glob("*.cuh"))):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _compile(sources: list[Path], out: Path) -> None:
    """Compile every source in parallel, link into ``out`` atomically."""
    global build_seconds, build_log
    nvcc = _nvcc()
    t0 = time.perf_counter()
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs = [Path(tmp) / (src.stem + ".o") for src in sources]
        procs = [subprocess.Popen(
            [nvcc, *ARCH, *FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(sources, objs)]
        logs = []
        for src, proc in zip(sources, procs):
            text, _ = proc.communicate()
            logs.append(f"== {src.name}\n{text}")
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{text}")
        lib_tmp = Path(tmp) / out.name
        link = subprocess.run([nvcc, *ARCH, "-shared", *map(str, objs), "-o",
                               str(lib_tmp)], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stderr}")
        os.replace(lib_tmp, out)
    build_seconds = time.perf_counter() - t0
    build_log = "\n".join(logs)


def load() -> ctypes.CDLL:
    """The kernels' library, built first if this checkout has none."""
    global _lib
    if _lib is not None:
        return _lib
    sources = _sources()
    out = BUILD_ROOT / _digest(sources) / "librepro_torch_kernels.so"
    if not out.exists():
        _compile(sources, out)
    lib = ctypes.CDLL(str(out))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = RESTYPES.get(name, ctypes.c_int)
    _lib = lib
    return lib


def check(rc: int, name: str) -> None:
    """Raise when a C entry point reports a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
