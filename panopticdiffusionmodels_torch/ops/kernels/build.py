"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source `csrc/<name>.cu` exposes a plain C interface and is compiled on
first use into `build/torch_kernels/lib<name>-<hash>.so` at the repository
root (listed in `.gitignore`); the hash covers the source, the shared
headers `csrc/*.cuh` and the flags, so an edited source or header is
rebuilt.  Nothing is compiled when a module is imported.

`build_host_library` does the same for host C++ that needs no card (the
native feature loader, `data/csrc/fastloader.cpp`): g++ into
`build/torch_native/lib<name>.so`.
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
# qkv attention (fused_qkv_attention.py), the ring hop (ring_hop.py), the
# (B, H, L, D) attention (fused_attention.py) and the LayerNorm-prologue qkv
# GEMM (fused_ln_qkv_attention.py).
KERNELS = ("fused_qkv_attention", "fused_qkv_attention_bwd", "ring_hop", "fused_attention",
           "fused_ln_qkv_attention")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)

HOST_BUILD_DIR = BUILD_DIR.parent / "torch_native"
HOST_CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-shared")  # native/Makefile's

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
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode())
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


def build_host_library(source: Path) -> Path:
    """Compile the host C++ file `source` with g++ into
    `build/torch_native/lib<stem>.so`, unless that library was built from
    these bytes and flags (a `.sha256` file beside it records them); returns
    its path.  Raises when g++ is missing or fails."""
    source = Path(source)
    output = HOST_BUILD_DIR / f"lib{source.stem}.so"
    digest = hashlib.sha256(source.read_bytes() + " ".join(HOST_CXX_FLAGS).encode()).hexdigest()
    stamp = output.with_suffix(".so.sha256")
    if output.exists() and stamp.exists() and stamp.read_text() == digest:
        return output
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError(f"no C++ compiler (g++ or $CXX) to build {source.name}")
    HOST_BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = output.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *HOST_CXX_FLAGS, "-o", str(tmp), str(source)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{cxx} failed for {source.name}:\n{proc.stderr}")
    os.replace(tmp, output)  # atomic: a concurrent builder or loader sees a whole file
    stamp.write_text(digest)
    return output
