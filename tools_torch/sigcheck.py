#!/usr/bin/env python3
"""sigcheck CLI for the port: the signal-protocol verifier over the traced
kernels on the card.

Runs each op with the traced build of ``csrc/shmem.cuh`` (built first if
need be) on a machine with a CUDA card and ``nvcc``, and checks the logged
protocol. Exit status is 0 unless ``--fail-on-findings`` is set and any
finding (or any gallery miss) is reported. Output is one JSON document on
stdout (``n_findings``, ``gallery_misses``, ``ops``, ``gallery``), as the
JAX package's ``scripts/sigcheck.py`` prints; its serving lint has no
counterpart here yet.

  python3 tools_torch/sigcheck.py --all --fail-on-findings   # the gate
  python3 tools_torch/sigcheck.py --op gemm_rs               # one op
  python3 tools_torch/sigcheck.py --gallery                  # self-test
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--all", action="store_true",
                    help="check every registered op")
    ap.add_argument("--op", action="append", default=[],
                    help="check one registered op (repeatable)")
    ap.add_argument("--gallery", action="store_true",
                    help="run the broken-kernel gallery (checker self-test)")
    ap.add_argument("--fail-on-findings", action="store_true",
                    help="exit 1 if any finding is reported")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress the human summary on stderr")
    args = ap.parse_args()
    if not (args.all or args.op or args.gallery):
        ap.error("pick --all, --op NAME, or --gallery")

    import torch

    if not torch.cuda.is_available():
        print("sigcheck: the traced kernels run on the card; CUDA is not "
              "available", file=sys.stderr)
        return 2

    from triton_dist_tpu_torch.analysis import check_gallery, check_registry

    t0 = time.monotonic()
    doc = {"ops": {}, "gallery": {}}
    n_findings = 0
    gallery_misses = []

    if args.all or args.op:
        reports = check_registry(args.op or None)
        if args.op:
            unknown = [o for o in args.op if o not in reports]
            if unknown:
                print(f"unknown op(s): {unknown}", file=sys.stderr)
                return 2
        for name, rep in sorted(reports.items()):
            doc["ops"][name] = rep.to_json()
            n_findings += len(rep.findings)
            if not args.quiet:
                for f in rep.findings:
                    print(f"  {f}", file=sys.stderr)

    if args.gallery:
        for name, (expected, rep) in check_gallery().items():
            caught = expected in rep.finding_kinds
            doc["gallery"][name] = {"expected": expected, "caught": caught,
                                    "report": rep.to_json()}
            if not caught:
                gallery_misses.append(name)

    doc["elapsed_s"] = round(time.monotonic() - t0, 3)
    doc["n_findings"] = n_findings
    doc["gallery_misses"] = gallery_misses
    json.dump(doc, sys.stdout, indent=1)
    print()

    if not args.quiet:
        checked = sum(1 for r in doc["ops"].values() if not r["skipped"])
        skipped = len(doc["ops"]) - checked
        misses = gallery_misses or "none"
        print(f"sigcheck: {checked} ops checked, {skipped} skipped, "
              f"{n_findings} findings, gallery misses: {misses} "
              f"[{doc['elapsed_s']}s]", file=sys.stderr)

    if args.fail_on_findings and (n_findings or gallery_misses):
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
