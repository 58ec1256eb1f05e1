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

A source may also be built with preprocessor defines: they join its hash
and its library's name. ``TRACE`` is the traced build of ``shmem.cuh``
(``-DTDT_SHMEM_TRACE``): its kernels log their signal protocol instead of
running it (``analysis/capture.py``). Inside ``tracing(log)`` ``load``
gives the traced library of every source that includes ``shmem.cuh``,
pointed at the log; there is no fallback to the untraced one.
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
           "moe_tp", "sigcheck_gallery")
TRACE = ("TDT_SHMEM_TRACE",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_libs: dict[tuple, ctypes.CDLL] = {}
# the log the traced libraries write while tracing(): (records address,
# count address, capacity, launch counter address), or None
_trace_log: tuple | None = None


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


def source_digest(name: str, defines=()) -> str:
    """The hash that names ``<name>.cu``'s library: the source, every local
    header it includes, the compiler flags and the defines."""
    source = _DIR / f"{name}.cu"
    h = hashlib.sha256(source.read_bytes())
    for header in local_headers(source):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    if defines:
        h.update(b"\0" + " ".join(defines).encode())
    return h.hexdigest()


def library_path(name: str, defines=()) -> Path:
    tag = "".join(f"_{d.lower()}" for d in defines)
    return BUILD_DIR / f"lib{name}{tag}_{source_digest(name, defines)[:16]}.so"


def traceable(name: str) -> bool:
    """Whether ``<name>.cu`` includes ``shmem.cuh`` (has a traced build)."""
    return _DIR / "shmem.cuh" in local_headers(_DIR / f"{name}.cu")


def build(names=SOURCES, traced: bool = False) -> dict[str, dict]:
    """Compile every source in ``names`` whose library is missing, and with
    ``traced`` the traced build of each that includes ``shmem.cuh``, all
    ``nvcc`` processes started together. Returns, per name
    (``<name>+trace`` for a traced build), the seconds its build took (0.0
    when it was already built) and the compiler's log (registers, shared
    memory and spills from ``-Xptxas=-v``). Any build that fails raises."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    variants = [(name, ()) for name in names]
    if traced:
        variants += [(name, TRACE) for name in names if traceable(name)]
    report, procs = {}, {}
    for name, defines in variants:
        key = name + ("+trace" if defines else "")
        lib = library_path(name, defines)
        if lib.exists():
            report[key] = {"seconds": 0.0, "log": ""}
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-o",
               str(tmp), str(_DIR / f"{name}.cu")]
        procs[key] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, lib, time.perf_counter())
    failed = []
    for key, (proc, tmp, lib, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {key} (exit {proc.returncode}):"
                          f"\n{log}")
            continue
        os.replace(tmp, lib)
        report[key] = {"seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise RuntimeError("\n".join(failed))
    return report


def load(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """The loaded library of ``<name>.cu``, built first if need be, with
    ``argtypes`` set from ``signatures`` (every C entry returns an int: the
    ``cudaError_t`` of its launch). Inside ``tracing()`` a source that
    includes ``shmem.cuh`` gives its traced build, pointed at the log."""
    defines = TRACE if _trace_log is not None and traceable(name) else ()
    lib = _libs.get((name, defines))
    if lib is None:
        build((name,), traced=bool(defines))
        lib = ctypes.CDLL(str(library_path(name, defines)))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.tdt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.tdt_cuda_error_string.restype = ctypes.c_char_p
        if defines:
            lib.tdt_trace_attach.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                             ctypes.c_longlong, ctypes.c_void_p]
            lib.tdt_trace_attach.restype = ctypes.c_int
            lib.attached = None
        _libs[(name, defines)] = lib
    if defines and lib.attached != _trace_log:
        check(lib, lib.tdt_trace_attach(*_trace_log), f"{name} trace log")
        lib.attached = _trace_log
    return lib


@contextlib.contextmanager
def tracing(records: int, count: int, capacity: int, launch: int):
    """Within it, ``load`` gives the traced builds, writing into the log at
    device address ``records`` (``capacity`` records of ten int64) with its
    count at ``count`` and its launch counter at ``launch``."""
    global _trace_log
    saved = _trace_log
    _trace_log = (records, count, capacity, launch)
    try:
        yield
    finally:
        _trace_log = saved


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
