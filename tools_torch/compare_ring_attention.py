#!/usr/bin/env python3
"""Hold the ring attention kernels (B24, B25) built from this checkout
against the same C entry points built from another ``ring_attention.cu``,
bit for bit: the one-rank kernels forward and backward at the training
shape (B=1, Hq=32, Hkv=8, D=128, S=4096, causal) in bf16 and f32, at a
ragged S=1000 and not causal; then the kernels across ranks (one
cooperative launch a call, every rank on the card) at 2 and 4 ranks on the
same global shape, contiguous and causal, in bf16 and f32. Each case also
times both builds between CUDA events, in turns (other, this, this, other;
the median of 10 calls each time). An other build whose entries across
ranks take no head dim (before head dim 256) is called without it.

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
# (dtype, ranks), global S = 4096, contiguous, causal
RANK_CASES = (("bfloat16", 2), ("float32", 2), ("bfloat16", 4),
              ("float32", 4))


class _WithoutHeadDim:
    """Another build's library whose entries across ranks take no head
    dim: the head dim the wrapper passes is dropped."""

    def __init__(self, lib, names):
        self._lib, self._names = lib, set(names)

    def __getattr__(self, name):
        fn = getattr(self._lib, name)
        if name not in self._names:
            return fn
        return lambda tables, n, shape, strides, _d, *rest: fn(
            tables, n, shape, strides, *rest)


def compare_ranks(tra, mine, other, perf_func) -> bool:
    """RANK_CASES through the wrappers, once with each build's library."""
    import torch

    from triton_dist_tpu_torch.shmem import (check_errors,
                                             initialize_distributed)

    B, Hq, Hkv, D, S = DIMS["B"], DIMS["Hq"], DIMS["Hkv"], DIMS["D"], 4096
    loader = tra._lib
    same = True
    for name, n in RANK_CASES:
        dtype = getattr(torch, name)
        gen = torch.Generator(device="cuda").manual_seed(S + n)

        def randn(*shape):
            return (torch.randn(shape, generator=gen, device="cuda") * 0.5) \
                .to(dtype)

        q, do = randn(B, Hq, S, D), randn(B, Hq, S, D)
        k, v = randn(B, Hkv, S, D), randn(B, Hkv, S, D)
        ctx = initialize_distributed(("cp",), (n,), "cuda")
        outs, calls = {}, {}
        try:
            for key, lib in (("this", mine), ("other", other)):
                tra._lib = lambda lib=lib: lib
                out, lse = tra.ring_attention_fwd(ctx, q, k, v, axis="cp")
                grads = tra.ring_attention_bwd(ctx, q, k, v, out, lse, do,
                                               axis="cp")
                check_errors(ctx)
                outs[key] = (out, lse, *grads)
                calls[key] = (
                    lambda: tra.ring_attention_fwd(ctx, q, k, v, axis="cp"),
                    lambda: tra.ring_attention_bwd(ctx, q, k, v, out, lse, do,
                                                   axis="cp"))
            equal = all(torch.equal(a, b) for a, b in zip(outs["this"],
                                                         outs["other"]))
            same &= equal
            times = {(key, h): [] for key in outs for h in (0, 1)}
            for key in ("other", "this", "this", "other"):
                lib = mine if key == "this" else other
                tra._lib = lambda lib=lib: lib
                for h in (0, 1):
                    times[key, h].append(perf_func(calls[key][h],
                                                   iters=10)[1])
            check_errors(ctx)
        finally:
            tra._lib = loader
        print(json.dumps({
            "case": f"{name} n={n} S={S} contiguous causal",
            "bitwise_equal": equal,
            "fwd_ms_this": times["this", 0], "fwd_ms_other": times["other", 0],
            "bwd_ms_this": times["this", 1],
            "bwd_ms_other": times["other", 1]}), flush=True)
    return same


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
    other_dir = Path(sys.argv[1]).resolve()
    other = other_library(other_dir, "ring_attention")
    ranks = (*tra._FWD_RANKS.values(), *tra._BWD_RANKS.values())
    with_d = b"const long long* strides, int D" in \
        (other_dir / "ring_attention.cu").read_bytes()
    for fn in (*tra._FWD.values(), *tra._BWD.values(), *ranks):
        sig = list(tra._SIGNATURES[fn])
        if fn in ranks and not with_d:
            del sig[4]                    # the head dim after the strides
        getattr(other, fn).argtypes = sig
        getattr(other, fn).restype = ctypes.c_int
    other.tdt_cuda_error_string.argtypes = [ctypes.c_int]
    other.tdt_cuda_error_string.restype = ctypes.c_char_p
    other_ranks = other if with_d else _WithoutHeadDim(other, ranks)
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
    same &= compare_ranks(tra, mine, other_ranks, perf_func)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
