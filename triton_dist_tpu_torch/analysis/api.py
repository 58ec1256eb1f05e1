"""Top-level sigcheck entry points: check one op, the whole registry, or the
broken-kernel gallery.

Counterpart of ``triton_dist_tpu/analysis/api.py``. ``sigcheck(run,
op=...)`` captures the op on the card at several concrete rank counts
(default n in {2, 3, 4}), checks every launch's per-actor streams, then
fits the peer-pattern summary across all captured n. A capture-time
exception becomes a ``capture_error`` finding rather than an escape: an op
the verifier cannot capture is a verifier coverage bug and must fail
loudly, not silently pass.
"""

from __future__ import annotations

import dataclasses
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from triton_dist_tpu_torch.analysis.capture import capture_op, merge_launches
from triton_dist_tpu_torch.analysis.checker import (CAPTURE_ERROR, Finding,
                                                    check_events,
                                                    fit_peer_patterns)

DEFAULT_MESHES: Tuple[Dict[str, int], ...] = (
    {"x": 2}, {"x": 3}, {"x": 4})


def _prod(xs) -> int:
    out = 1
    for x in xs:
        out *= int(x)
    return out


@dataclasses.dataclass
class OpReport:
    """Verification result for one registered op (or one gallery kernel)."""

    op: str
    ns: List[int] = dataclasses.field(default_factory=list)
    findings: List[Finding] = dataclasses.field(default_factory=list)
    protocol: Dict[str, str] = dataclasses.field(default_factory=dict)
    event_counts: Dict[int, int] = dataclasses.field(default_factory=dict)
    skipped: Optional[str] = None

    @property
    def ok(self) -> bool:
        return not self.findings

    @property
    def finding_kinds(self) -> List[str]:
        return [f.kind for f in self.findings]

    def to_json(self) -> dict:
        return {
            "op": self.op,
            "ns": self.ns,
            "skipped": self.skipped,
            "event_counts": {str(n): c for n, c in self.event_counts.items()},
            "protocol": self.protocol,
            "findings": [f.to_json() for f in self.findings],
        }


def sigcheck(run: Callable[..., Any], op: str = "op",
             meshes: Sequence[Dict[str, int]] = DEFAULT_MESHES,
             capture: Callable = capture_op) -> OpReport:
    """Capture ``run(ctx)`` on each mesh in ``meshes`` and verify the
    recorded signal protocol. ``run`` receives a port ``ShmemContext`` on
    the card and should invoke the op end to end the way real callers do
    (workspace creation included). ``capture(run, mesh)`` gives the
    launches' streams (``capture_op``)."""
    report = OpReport(op=op)
    streams_by_n: Dict[int, Dict] = {}
    for mesh in meshes:
        n = _prod(mesh.values())
        report.ns.append(n)
        try:
            launches = capture(run, mesh)
        except Exception as exc:  # noqa: BLE001 — must become a finding
            tb = traceback.format_exc(limit=8).strip().splitlines()
            report.findings.append(Finding(
                CAPTURE_ERROR, op, n,
                f"capture raised {type(exc).__name__}: {exc}",
                events=tb[-6:]))
            continue
        streams_by_n[n] = merge_launches(launches)
        report.event_counts[n] = sum(
            len(v) for v in streams_by_n[n].values())
        for streams in launches:    # the launches of a stream run in turn
            report.findings.extend(check_events(op, streams, n))
    if streams_by_n:
        report.protocol = fit_peer_patterns(streams_by_n)
    return report


def check_registry(names: Optional[Sequence[str]] = None
                   ) -> Dict[str, OpReport]:
    """Run sigcheck over every registered op (or just ``names``). Skipped
    entries yield an :class:`OpReport` with ``skipped`` set so reports stay
    surface-complete."""
    from triton_dist_tpu_torch.analysis.registry import REGISTRY

    reports: Dict[str, OpReport] = {}
    for name, entry in REGISTRY.items():
        if names is not None and name not in names:
            continue
        if entry.skip is not None:
            reports[name] = OpReport(op=name, skipped=entry.skip)
            continue
        reports[name] = sigcheck(entry.run, op=name, meshes=entry.meshes)
    return reports


def check_gallery(device=None) -> Dict[str, Tuple[str, OpReport]]:
    """Run sigcheck over the intentionally-broken gallery kernels, traced on
    the card (``device`` "cpu": over their plain streams instead). Returns
    name → (expected finding kind, report); callers assert the expected
    kind is present (a gallery kernel that sigcheck stops flagging means a
    checker regression)."""
    from triton_dist_tpu_torch.analysis.gallery import GALLERY, plain_capture
    from triton_dist_tpu_torch.utils.env import default_device

    on_card = default_device(device).type == "cuda"
    out: Dict[str, Tuple[str, OpReport]] = {}
    for name, entry in GALLERY.items():
        report = sigcheck(entry.run, op=name, meshes=entry.meshes,
                          capture=capture_op if on_card
                          else plain_capture(name))
        out[name] = (entry.expected, report)
    return out
