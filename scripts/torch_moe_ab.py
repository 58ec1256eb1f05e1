#!/usr/bin/env python3
"""A/B of the PyTorch port's MoE serving path between two checkouts, on one
CUDA card.

    python3 scripts/torch_moe_ab.py A_DIR B_DIR [--out FILE]

Runs ``chip_smoke.py``'s MoE engine phase in each checkout in the order
A, B, B, A, one child process each (so the host's drift between the runs
falls on both sides): Mixtral-8x7B's widths at 16 layers with random
weights (seed 0), the seeded 16-request trace served twice through the
one-rank ``ShardedServingEngine``, then one decode dispatch under
``torch.profiler``. Prints one JSON line per run (tok/s of both serves,
TTFT p50, step device and host means, the dispatch's wall, device time,
idle share and device ops per step), the card's name and power limit, and
the medians of each side; ``--out`` also writes the lines to a file.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

CHILD = r"""
import dataclasses, inspect, json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from triton_dist_tpu_torch import csrc
from triton_dist_tpu_torch.models.moe import (MoEConfig, init_moe_params,
                                              moe_mlp_ep_overlap)
from triton_dist_tpu_torch.serving.sharded import DECODE_BLOCK_M
from triton_dist_tpu_torch.utils.env import set_tf32

set_tf32(False)
csrc.build()
dev = torch.device("cuda")
preset = MoEConfig.mixtral_8x7b()
cfg = dataclasses.replace(preset, base=dataclasses.replace(
    preset.base, n_layers=cs.MOE_LAYERS))
params = init_moe_params(cfg, seed=0, device=dev)
eng = cs.check_moe_engine(params, cfg, dev, cs.make_trace(cfg.base,
                          cs.N_REQUESTS, 0), cs.ENGINE, "ab")

def ffn(h, p):
    return moe_mlp_ep_overlap(h, p["w_router"], p["we_gate"], p["we_up"],
                              p["we_down"], cfg.topk, block_m=DECODE_BLOCK_M)

kw = ({"distinct_tokens": True} if "distinct_tokens"
      in inspect.signature(cs.profile_dispatch).parameters else {})
prof = cs.profile_dispatch(params, cfg.base, dev, ffn=ffn, **kw)
print("AB " + json.dumps({
    "tok_per_s": eng["tok_per_s"],
    "rerun_tok_per_s": eng["tokens_generated"] / eng["rerun_wall_s"],
    "ttft_p50_s": eng["ttft_p50_s"],
    "step_device_mean_s": eng["step_device_mean_s"],
    "step_host_mean_s": eng["step_host_mean_s"],
    "dispatch_wall_s": prof["wall_s"],
    "dispatch_device_busy_s": prof["device_busy_s"],
    "dispatch_idle_share": prof["device_idle_share"],
    "device_ops_per_step": prof["device_ops_per_step"]}), flush=True)
"""


def run(tree: str) -> dict:
    out = subprocess.run([sys.executable, "-c", CHILD], cwd=tree,
                         capture_output=True, text=True, timeout=600)
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("AB ")]
    if out.returncode != 0 or not lines:
        raise RuntimeError(f"run in {tree} failed ({out.returncode}):\n"
                           f"{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
    return json.loads(lines[-1][3:])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("a")
    ap.add_argument("b")
    ap.add_argument("--out")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    results = {"A": [], "B": []}
    lines = []
    for side in "ABBA":
        rec = {"side": side, "tree": getattr(args, side.lower()),
               **run(getattr(args, side.lower()))}
        results[side].append(rec)
        lines.append(json.dumps(rec))
        print(lines[-1], flush=True)
    summary = {side: {k: statistics.median(r[k] for r in recs)
                      for k in recs[0] if k not in ("side", "tree")}
               for side, recs in results.items()}
    lines.append(json.dumps({"card": smi, "median": summary}))
    print(lines[-1], flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
