"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source `csrc/<name>.cu` exposes a plain C interface and is compiled on
first use into `build/torch_kernels/lib<name>-<hash>.so` at the repository
root (listed in `.gitignore`); the hash covers the source and the flags, so an
edited source is rebuilt.  Nothing is compiled when a module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
# Every source under csrc/, by name: the forward and backward of the packed
# qkv attention (fused_qkv_attention.py) and the ring hop (ring_hop.py).
KERNELS = ("fused_qkv_attention", "fused_qkv_attention_bwd", "ring_hop")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)

# name -> (seconds, nvcc's output: ptxas register / shared-memory report)
BUILD_LOG: Dict[str, tuple] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin and on PATH): the port's "
        "CUDA kernels are built on the machine with the card"
    )


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def nvcc_command(name: str, output: Path) -> list:
    return [nvcc_path(), *NVCC_FLAGS, "-o", str(output), str(CSRC / f"{name}.cu")]


def build_all(names: Iterable[str]) -> None:
    """Compile every library that is missing, all nvcc processes at once."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in todo:
        tmp = library_path(name).with_suffix(f".{os.getpid()}.tmp")
        procs.append((name, tmp, time.perf_counter(), subprocess.Popen(
            nvcc_command(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, tmp, t0, proc in procs:
        log, _ = proc.communicate()
        BUILD_LOG[name] = (time.perf_counter() - t0, log)
        if proc.returncode:
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
        else:
            os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The compiled library `name`, building it first if needed."""
    if name not in _LIBS:
        build_all([name])
        _LIBS[name] = ctypes.CDLL(str(library_path(name)))
    return _LIBS[name]
