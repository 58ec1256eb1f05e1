"""sigcheck on the card: the signal-protocol verifier of the port's
collective kernels.

Counterpart of ``triton_dist_tpu/analysis/``. The reference replays each
kernel's Python body per rank; the port runs the kernels themselves, built
with ``-DTDT_SHMEM_TRACE`` (``csrc/shmem.cuh``), whose every signal, wait,
put, barrier and marked read is logged instead of run, and checks the log,
over n in {2, 3, 4}, for

- **coverage**: the signals reaching each wait sum to exactly what it
  consumes (under-signal = static deadlock, over-signal = residue that
  poisons the next call on the pad);
- **deadlock-freedom**: the cross-actor wait graph has an execution order
  (actors are lanes: the blocks of one rank run at once on the card);
- **ordering**: every marked read of a put's destination happens after the
  put by the vector clocks of signal and wait.

Entry points: :func:`sigcheck` (one op), :func:`check_registry` (the whole
``ops`` surface), :func:`check_gallery` (the broken-protocol kernels, B26)
and ``tools_torch/sigcheck.py`` (CLI, JSON findings).
"""

from triton_dist_tpu_torch.analysis.events import Event, Region, SemId
from triton_dist_tpu_torch.analysis.checker import Finding, check_events
from triton_dist_tpu_torch.analysis.capture import capture_op, decode
from triton_dist_tpu_torch.analysis.api import (OpReport, check_gallery,
                                                check_registry, sigcheck)

__all__ = ["Event", "Finding", "OpReport", "Region", "SemId", "capture_op",
           "check_events", "check_gallery", "check_registry", "decode",
           "sigcheck"]
