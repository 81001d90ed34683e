"""Build and load the native sources of ``unmore_tpu_torch/csrc``.

Each source exposes a plain C interface and is compiled into a shared
library under ``build/kernels/`` at the root of the checkout, at first use,
then loaded with ``ctypes``: a CUDA kernel ``csrc/<name>.cu`` by ``nvcc``
for ``sm_90a``, host code ``csrc/<name>.cpp`` by ``g++``. The library's
file name carries a hash of the source and the compiler flags, so an
edited source is rebuilt and a stale library is never loaded. A failed
build raises. Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off")  # no FMA: the plain versions' bits

_loaded: dict[str, ctypes.CDLL] = {}
_load_lock = threading.Lock()
# seconds and ptxas report of each build done by this process, by kernel name
build_log: dict[str, dict] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")
    return nvcc


def _gxx() -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the host library csrc/*.cpp builds only where g++ is installed")
    return gxx


def source_path(name: str) -> Path:
    """``csrc/<name>.cu`` (a CUDA kernel) or ``csrc/<name>.cpp`` (host code)."""
    for suffix in (".cu", ".cpp"):
        src = CSRC / f"{name}{suffix}"
        if src.exists():
            return src
    raise FileNotFoundError(f"no csrc/{name}.cu or csrc/{name}.cpp")


def library_path(name: str) -> Path:
    src = source_path(name)
    flags = NVCC_FLAGS if src.suffix == ".cu" else GXX_FLAGS
    digest = hashlib.sha1(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start_build(name: str):
    """Start the compiler for ``name`` unless its library exists; returns
    the process (or None), the temporary output and the final path."""
    out = library_path(name)
    if out.exists():
        return None, None, out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    src = source_path(name)
    if src.suffix == ".cu":
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    else:
        cmd = [_gxx(), *GXX_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish_build(name: str, proc, tmp: Path, out: Path, t0: float):
    if proc is None:
        return
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"{Path(proc.args[0]).name} failed for csrc/{source_path(name).name}:\n{log}")
    os.replace(tmp, out)
    build_log[name] = {"seconds": time.perf_counter() - t0, "log": log}


def build(names) -> dict[str, dict]:
    """Compile every named source that is not built yet, one compiler
    process per source, all started together. Returns :data:`build_log`."""
    t0 = time.perf_counter()
    started = [(n, *_start_build(n)) for n in names]
    for n, proc, tmp, out in started:
        _finish_build(n, proc, tmp, out, t0)
    return build_log


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu`` or ``.cpp``; cached per
    process. Thread-safe: the stage-1 data workers load from threads."""
    with _load_lock:
        if name not in _loaded:
            build([name])
            _loaded[name] = ctypes.CDLL(str(library_path(name)))
        return _loaded[name]
