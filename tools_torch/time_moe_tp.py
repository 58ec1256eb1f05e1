#!/usr/bin/env python3
"""Time the MoE-TP kernels across ranks (B19 ``ag_moe_group_gemm`` and B20
``moe_reduce_rs``, their 1-tier form over 4 ranks on one card) of a
checkout, at Mixtral-8x7B's expert widths (d_model 4096, expert FFN 14336,
8 experts, top-2) on 4096 tokens with uniform random expert ids (seed 5),
bf16: the median of each kernel alone over 10 calls under
``torch.profiler``, and the registers ptxas gave each kernel of
``csrc/moe_tp.cu``.

    python3 tools_torch/time_moe_tp.py [ROOT]

ROOT is the checkout whose ``triton_dist_tpu_torch`` is timed (this one by
default; an unpacked earlier commit, say). To compare two checkouts on one
card, run it in turns in one command (other, this, this, other). Needs a
CUDA card and ``nvcc``; each checkout builds into its own ``csrc/_build``.
Prints one JSON line.
"""

from __future__ import annotations

import json
import re
import statistics
import sys
from pathlib import Path


def main() -> int:
    root = Path(sys.argv[1] if len(sys.argv) > 1
                else Path(__file__).resolve().parent.parent).resolve()
    sys.path.insert(0, str(root))
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("time_moe_tp: CUDA is not available", file=sys.stderr)
        return 2
    from triton_dist_tpu_torch import csrc
    from triton_dist_tpu_torch.ops import moe as mo
    from triton_dist_tpu_torch.shmem import initialize_distributed

    log = csrc.build(("moe_tp",))["moe_tp"]["log"]
    regs, entry = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        entry = m.group(1) if m else entry
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            regs.append([entry, int(m.group(1))])

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    E, D, F, T, topk = 8, 4096, 14336, 4096, 2
    wd = (torch.randn(E, F, D, generator=g, device=dev) * 0.01).bfloat16()
    wu = (torch.randn(E, D, F, generator=g, device=dev) * 0.01).bfloat16()
    h = torch.randn(T * topk, F, generator=g, device=dev).bfloat16()
    x = torch.randn(T * topk, D, generator=g, device=dev).bfloat16()
    ids = torch.randint(0, E, (T * topk,), generator=g, device=dev,
                        dtype=torch.int32)
    tw = torch.softmax(torch.randn(T, topk, generator=g, device=dev), -1)
    ctx = initialize_distributed(("x",), (4,), device=dev)

    def alone(fn, match: str) -> float:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
        return statistics.median(
            e.time_range.elapsed_us() / 1e3 for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and match in e.name)

    rec = {"root": str(root), "card": torch.cuda.get_device_name(0),
           "moe_reduce_rs_ms": alone(
               lambda: mo.moe_reduce_rs(ctx, h, ids, tw, wd), "moe_rs_kernel"),
           "ag_moe_group_gemm_ms": alone(
               lambda: mo.ag_moe_group_gemm(ctx, x, ids, wu),
               "ag_moe_kernel"),
           "registers": regs}
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
