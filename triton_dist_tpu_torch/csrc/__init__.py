"""Build and load the port's hand-written CUDA kernels.

Each ``<name>.cu`` beside this file is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, and loaded with
``ctypes``. Nothing is built when the package is imported: the first CUDA
launch of a kernel builds its library, under ``_build/`` (ignored by git),
named by the hash of its source and of every header it includes from this
directory (``shmem.cuh``, ``ag_relay_2d.cuh``, ``gemm_tile.cuh``,
``group_gemm_tile.cuh``, ``ring_attention_tile.cuh``), so an edited source or header is rebuilt and a
finished build is reused. ``build()`` compiles several sources in
parallel, one ``nvcc`` process each.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR / "_build"
SOURCES = ("flash_decode_paged", "flash_decode", "ring_attention", "group_gemm",
           "all_to_all", "allgather", "gemm", "flash_decode_dist", "shmem",
           "reduce_scatter", "tp_overlap", "pool_ag", "page_migrate",
           "moe_tp")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    for cand in (shutil.which("nvcc"),
                 CUDA_HOME and os.path.join(CUDA_HOME, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the card, with the CUDA toolkit on PATH "
                       "or under CUDA_HOME")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def local_headers(path: Path) -> list[Path]:
    """The headers of this directory that ``path`` includes, directly or
    through another of them, each once, in the order first met."""
    seen: list[Path] = []
    todo = [path]
    while todo:
        for name in _INCLUDE.findall(todo.pop(0).read_bytes()):
            header = _DIR / name.decode()
            if header.exists() and header not in seen:
                seen.append(header)
                todo.append(header)
    return seen


def source_digest(name: str) -> str:
    """The hash that names ``<name>.cu``'s library: the source, every local
    header it includes, and the compiler flags."""
    source = _DIR / f"{name}.cu"
    h = hashlib.sha256(source.read_bytes())
    for header in local_headers(source):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}_{source_digest(name)[:16]}.so"


def build(names=SOURCES) -> dict[str, dict]:
    """Compile every source in ``names`` whose library is missing, all
    ``nvcc`` processes started together. Returns, per name, the seconds its
    build took (0.0 when it was already built) and the compiler's log
    (registers, shared memory and spills from ``-Xptxas=-v``)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    report, procs = {}, {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            report[name] = {"seconds": 0.0, "log": ""}
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib, time.perf_counter())
    for name, (proc, tmp, lib, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}.cu "
                               f"(exit {proc.returncode}):\n{log}")
        os.replace(tmp, lib)
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
    return report


def load(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """The loaded library of ``<name>.cu``, built first if need be, with
    ``argtypes`` set from ``signatures`` (every C entry returns an int: the
    ``cudaError_t`` of its launch)."""
    lib = _libs.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.tdt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.tdt_cuda_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def current_on(device):
    """A context that makes ``device`` the current CUDA device for a launch,
    or nothing to do when it already is (the one-card case)."""
    import torch

    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error."""
    if rc != 0:
        msg = lib.tdt_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
