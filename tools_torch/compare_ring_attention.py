#!/usr/bin/env python3
"""Hold the one-rank ring attention kernels (B24, B25) built from this
checkout against the same C entry points built from another
``ring_attention.cu``, bit for bit: forward and backward at the training
shape (B=1, Hq=32, Hkv=8, D=128, S=4096, causal) in bf16 and f32, at a
ragged S=1000 and not causal. Each case also times both builds between
CUDA events, in turns (other, this, this, other; the median of 10 calls
each time).

    python3 tools_torch/compare_ring_attention.py OTHER_CSRC_DIR

OTHER_CSRC_DIR holds the other ``ring_attention.cu`` and the headers it
includes (an unpacked earlier commit's ``triton_dist_tpu_torch/csrc``,
say). Run it from the root of a checkout on a machine with a CUDA card and
``nvcc``. Prints one JSON line per case and exits non-zero if any case
differs.
"""

from __future__ import annotations

import ctypes
import importlib
import json
import os
import sys
from pathlib import Path

from compare_gemm import other_library

REPO = Path(__file__).resolve().parent.parent

# (dtype, S, causal)
CASES = (("bfloat16", 4096, True), ("float32", 4096, True),
         ("bfloat16", 1000, True), ("float32", 2048, False))
DIMS = dict(B=1, Hq=32, Hkv=8, D=128)


def main() -> int:
    if len(sys.argv) != 2 or not os.path.isdir(sys.argv[1]):
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import torch

    from triton_dist_tpu_torch import csrc
    from triton_dist_tpu_torch.utils.perf import perf_func

    # the ops package exports a function named like the module
    tra = importlib.import_module("triton_dist_tpu_torch.ops.ring_attention")

    if not torch.cuda.is_available():
        print("compare_ring_attention: CUDA is not available",
              file=sys.stderr)
        return 2
    mine = csrc.load("ring_attention", tra._SIGNATURES)
    other = other_library(Path(sys.argv[1]).resolve(), "ring_attention")
    for fn in (*tra._FWD.values(), *tra._BWD.values()):
        getattr(other, fn).argtypes = tra._SIGNATURES[fn]
        getattr(other, fn).restype = ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    B, Hq, Hkv, D = DIMS["B"], DIMS["Hq"], DIMS["Hkv"], DIMS["D"]
    same = True
    for name, S, causal in CASES:
        dtype = getattr(torch, name)
        gen = torch.Generator(device="cuda").manual_seed(S + causal)

        def randn(*shape):
            return (torch.randn(shape, generator=gen, device="cuda") * 0.5) \
                .to(dtype)

        q, do = randn(B, Hq, S, D), randn(B, Hq, S, D)
        k, v = randn(B, Hkv, S, D), randn(B, Hkv, S, D)
        scale = 1.0 / D ** 0.5
        qp = tra._prescale(q, scale)
        outs, calls = {}, {}
        for lib in (mine, other):
            out = torch.empty_like(q)
            lse = torch.empty(B, Hq, S, device="cuda")
            delta = torch.empty(B, Hq, S, device="cuda")
            grads = [torch.empty_like(q), torch.empty_like(k),
                     torch.empty_like(v)]

            def fwd(lib=lib, out=out, lse=lse):
                csrc.check(mine, getattr(lib, tra._FWD[dtype])(
                    qp.data_ptr(), k.data_ptr(), v.data_ptr(),
                    out.data_ptr(), lse.data_ptr(), B, Hq, Hkv, S, D,
                    int(causal), stream), "ring_attention_fwd")

            def bwd(lib=lib, out=out, lse=lse, delta=delta, grads=grads):
                csrc.check(mine, getattr(lib, tra._BWD[dtype])(
                    qp.data_ptr(), k.data_ptr(), v.data_ptr(),
                    out.data_ptr(), lse.data_ptr(), do.data_ptr(),
                    delta.data_ptr(), *(g.data_ptr() for g in grads), B, Hq,
                    Hkv, S, D, int(causal), scale, stream),
                    "ring_attention_bwd")

            fwd()
            bwd()
            outs[lib] = (out, lse, *grads)
            calls[lib] = (fwd, bwd)
        torch.cuda.synchronize()
        equal = all(torch.equal(a, b) for a, b in zip(outs[mine],
                                                     outs[other]))
        same &= equal
        times = {(lib, h): [] for lib in (mine, other) for h in (0, 1)}
        for lib in (other, mine, mine, other):
            for h in (0, 1):
                times[lib, h].append(perf_func(calls[lib][h], iters=10)[1])
        print(json.dumps({
            "case": f"{name} S={S} {'causal' if causal else 'full'}",
            "bitwise_equal": equal,
            "fwd_ms_this": times[mine, 0], "fwd_ms_other": times[other, 0],
            "bwd_ms_this": times[mine, 1], "bwd_ms_other": times[other, 1]}),
            flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
