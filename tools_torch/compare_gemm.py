#!/usr/bin/env python3
"""Hold the dense GEMM (B2) and the slot reduction built from this checkout
against the same C entry points built from another ``gemm.cu``, bit for bit:
at the four GEMMs of a Llama-3-8B layer over 4096 token rows (qkv, wo,
gate‖up, down), at both tile heights, a ragged shape, B read as [N, K],
bf16 into f32, f32 throughout, and the slot reduction of four f32 slots.
Each case also times both builds between CUDA events, in turns (other,
this, this, other; the median of 10 launches each time).

    python3 tools_torch/compare_gemm.py OTHER_CSRC_DIR

OTHER_CSRC_DIR holds the other ``gemm.cu`` and the headers it includes (an
unpacked earlier commit's ``triton_dist_tpu_torch/csrc``, say). Run it from
the root of a checkout on a machine with a CUDA card and ``nvcc``. The
other library is built into this checkout's ``csrc/_build``. Prints one
JSON line per case and exits non-zero if any case differs.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

# (M, K, N, dtype, B as [N, K], out f32, tile rows)
CASES = ((4096, 4096, 6144, "bfloat16", False, False, 128),
         (4096, 4096, 4096, "bfloat16", False, False, 128),
         (4096, 4096, 28672, "bfloat16", False, False, 128),
         (4096, 14336, 4096, "bfloat16", False, False, 128),
         (1024, 4096, 1536, "bfloat16", False, False, 64),
         (100, 72, 200, "bfloat16", False, False, 64),
         (4096, 4096, 14336, "bfloat16", True, False, 128),
         (1024, 4096, 4096, "bfloat16", False, True, 128),
         (2048, 4096, 4096, "float32", False, True, 128),
         (1000, 512, 700, "float32", True, True, 128))


def other_library(src_dir: Path, name: str = "gemm") -> ctypes.CDLL:
    """``<name>.cu`` of ``src_dir`` built (once) and loaded."""
    from triton_dist_tpu_torch import csrc

    source = src_dir / f"{name}.cu"
    digest = hashlib.sha256(source.read_bytes())
    for header in sorted(src_dir.glob("*.cuh")):
        digest.update(header.read_bytes())
    lib = csrc.BUILD_DIR / f"lib{name}_other_{digest.hexdigest()[:16]}.so"
    if not lib.exists():
        csrc.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([csrc._nvcc(), *csrc.NVCC_FLAGS, "-o", str(lib),
                        str(source)], check=True, capture_output=True)
    return ctypes.CDLL(str(lib))


def main() -> int:
    if len(sys.argv) != 2 or not os.path.isdir(sys.argv[1]):
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import torch

    from triton_dist_tpu_torch import csrc
    from triton_dist_tpu_torch.ops import gemm as tg
    from triton_dist_tpu_torch.utils.perf import perf_func

    if not torch.cuda.is_available():
        print("compare_gemm: CUDA is not available", file=sys.stderr)
        return 2
    mine = csrc.load("gemm", tg._SIGNATURES)
    other = other_library(Path(sys.argv[1]).resolve())
    for fn, argtypes in tg._SIGNATURES.items():
        if not hasattr(other, fn):    # an entry the other build lacks
            continue
        getattr(other, fn).argtypes = argtypes
        getattr(other, fn).restype = ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(21)
    same = True
    for M, K, N, dtype_name, trans, out_f32, tile_m in CASES:
        dtype = getattr(torch, dtype_name)
        a = torch.randn(M, K, generator=gen, device="cuda").to(dtype)
        b = (torch.randn((N, K) if trans else (K, N), generator=gen,
                         device="cuda") * 0.02).to(dtype)
        outs = {}
        for lib in (mine, other):
            c = torch.full((M, N), float("nan"), device="cuda",
                           dtype=torch.float32 if out_f32 else dtype)

            def call(lib=lib, c=c):
                if dtype == torch.bfloat16:
                    rc = lib.tdt_gemm_bf16(a.data_ptr(), b.data_ptr(),
                                           c.data_ptr(), M, N, K, int(trans),
                                           int(out_f32), tile_m, stream)
                else:
                    rc = lib.tdt_gemm_f32(a.data_ptr(), b.data_ptr(),
                                          c.data_ptr(), M, N, K, int(trans),
                                          stream)
                csrc.check(mine, rc, "gemm")

            call()
            outs[lib] = (c, call)
        torch.cuda.synchronize()
        equal = bool(torch.equal(outs[mine][0], outs[other][0]))
        same &= equal
        times = {mine: [], other: []}
        for lib in (other, mine, mine, other):
            times[lib].append(perf_func(outs[lib][1], iters=10)[1])
        print(json.dumps({"case": f"{dtype_name} {M}x{K}x{N} tile {tile_m}"
                          + (" B as [N, K]" if trans else "")
                          + (" into f32" if out_f32 else ""),
                          "bitwise_equal": equal, "ms_this": times[mine],
                          "ms_other": times[other]}), flush=True)
    ws = torch.randn(4, 1024, 4096, generator=gen, device="cuda")
    outs = []
    for lib in (mine, other):
        o = torch.empty(1024, 4096, dtype=torch.bfloat16, device="cuda")
        csrc.check(mine, lib.tdt_slot_reduce(ws.data_ptr(), o.data_ptr(), 4,
                                             o.numel(), 1, stream),
                   "slot_reduce")
        outs.append(o)
    torch.cuda.synchronize()
    equal = bool(torch.equal(outs[0], outs[1]))
    same &= equal
    print(json.dumps({"case": "slot_reduce 4 x [1024, 4096] f32 -> bf16",
                      "bitwise_equal": equal}), flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
