#!/usr/bin/env python3
"""Hold the option-free grouped GEMMs (B17, B18, and B17 from bf16 into
f32, B20's one-rank slot) built from this checkout against the same forms
built from another ``group_gemm.cu``, bit for bit (this build through its
one entry, ``tdt_grouped_gemm_ex``; the other through it too, or through
the option-free forms' own entries where it is older): at Mixtral-8x7B's expert
widths (d_model 4096, expert FFN 14336, 8 experts) over the aligned rows of
a decode step (8 tokens x top-2, block_m 16), a prefill chunk (256 x 2,
block_m 64) and a long prefill (4096 x 2, block_m 128), in bf16 and f32.
Each case also times both builds between CUDA events, in turns (other,
this, this, other; the median of 10 launches each time).

    python3 tools_torch/compare_group_gemm.py OTHER_CSRC_DIR

OTHER_CSRC_DIR holds the other ``group_gemm.cu`` and the headers it
includes (an unpacked earlier commit's ``triton_dist_tpu_torch/csrc``, say).
Run it from the root of a checkout on a machine with a CUDA card and
``nvcc``. The other library is built into this checkout's ``csrc/_build``.
Prints one JSON line per case and exits non-zero if any case differs.
"""

from __future__ import annotations

import ctypes
import json
import os
import sys
from pathlib import Path

from compare_gemm import other_library

REPO = Path(__file__).resolve().parent.parent

D, F, E = 4096, 14336, 8
# (name, tokens x top-2 rows, block_m)
ROWS = (("decode", 16, 16), ("chunk", 512, 64), ("prefill", 8192, 128))
# (form, gated, K, N, input type, output type); f32 at the decode rows only
FORMS = (("gated bf16", True, D, F, "bfloat16", "bfloat16"),
         ("bf16", False, F, D, "bfloat16", "bfloat16"),
         ("bf16 into f32", False, F, D, "bfloat16", "float32"),
         ("gated f32", True, D, F, "float32", "float32"),
         ("f32", False, F, D, "float32", "float32"))
# the option-free forms under their own C names, in a build from before
# tdt_grouped_gemm_ex took every form: x, w (or wg, wu), be, nb, out, P, K,
# N, block_m, E, stream
LEGACY = {"gated bf16": "tdt_grouped_gemm_gated_bf16",
          "bf16": "tdt_grouped_gemm_bf16",
          "bf16 into f32": "tdt_grouped_gemm_bf16_f32",
          "gated f32": "tdt_grouped_gemm_gated_f32",
          "f32": "tdt_grouped_gemm_f32"}
_P, _I = ctypes.c_void_p, ctypes.c_int


def launcher(lib, gg):
    """A function that launches one option-free form through ``lib``: its
    ``tdt_grouped_gemm_ex`` where it has one, else the form's own entry."""
    if hasattr(lib, "tdt_grouped_gemm_ex"):
        fn = lib.tdt_grouped_gemm_ex
        fn.argtypes, fn.restype = gg._EX, ctypes.c_int

        def launch(form, x, ws, be, nb, out, P, K, N, bm, stream):
            _, gated, _, _, in_name, out_name = next(
                f for f in FORMS if f[0] == form)
            return fn(x, ws[0], ws[1] if gated else None, be, nb, None, out,
                      P, K, N, bm, E, 0, 0, gg.RING_DEPTHS[-1], int(gated),
                      3 if in_name == "float32" else 0,
                      int(out_name == "float32"), stream)
        return launch

    def launch(form, x, ws, be, nb, out, P, K, N, bm, stream):
        fn = getattr(lib, LEGACY[form])
        fn.argtypes = [_P] * (5 + len(ws) - 1) + [_I] * 5 + [_P]
        fn.restype = ctypes.c_int
        return fn(x, *ws, be, nb, out, P, K, N, bm, E, stream)
    return launch


def main() -> int:
    if len(sys.argv) != 2 or not os.path.isdir(sys.argv[1]):
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import torch

    from triton_dist_tpu_torch import csrc
    from triton_dist_tpu_torch.ops import group_gemm as gg
    from triton_dist_tpu_torch.utils.perf import perf_func

    if not torch.cuda.is_available():
        print("compare_group_gemm: CUDA is not available", file=sys.stderr)
        return 2
    mine = gg._lib()                              # this build
    other = other_library(Path(sys.argv[1]).resolve(), "group_gemm")
    launch = {mine: launcher(mine, gg), other: launcher(other, gg)}
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(23)
    same = True
    for rows_name, T, bm in ROWS:
        ids = torch.randint(0, E, (T,), generator=gen, device="cuda")
        gi, rv, be, nb, _ = gg.expert_alignment(ids, E, bm)
        P = gi.shape[0]
        for form, gated, K, N, in_name, out_name in FORMS:
            if in_name == "float32" and rows_name != "decode":
                continue
            dt, odt = getattr(torch, in_name), getattr(torch, out_name)
            x = torch.randn(T, K, generator=gen, device="cuda")[gi.long()]
            x = torch.where(rv[:, None], x, 0.0).to(dt).contiguous()
            ws = [(torch.randn(E, K, N, generator=gen, device="cuda")
                   * K ** -0.5).to(dt) for _ in range(2 if gated else 1)]
            outs = {}
            for lib in (mine, other):
                out = torch.zeros(P, N, dtype=odt, device="cuda")

                def call(lib=lib, out=out):
                    rc = launch[lib](form, x.data_ptr(),
                                     [w.data_ptr() for w in ws],
                                     be.data_ptr(), nb.data_ptr(),
                                     out.data_ptr(), P, K, N, bm, stream)
                    csrc.check(mine, rc, form)

                call()
                outs[lib] = (out, call)
            torch.cuda.synchronize()
            equal = bool(torch.equal(outs[mine][0], outs[other][0]))
            same &= equal
            times = {mine: [], other: []}
            for lib in (other, mine, mine, other):
                times[lib].append(perf_func(outs[lib][1], iters=10)[1])
            print(json.dumps({"case": f"{form} {rows_name} rows={T} "
                                      f"P={P} K={K} N={N} block_m={bm}",
                              "bitwise_equal": equal,
                              "ms_this": times[mine],
                              "ms_other": times[other]}), flush=True)
            del x, ws, outs
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
