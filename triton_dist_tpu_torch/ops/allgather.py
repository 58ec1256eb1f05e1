"""The push/ring all-gather, in its one-rank form.

Counterpart of ``all_gather`` in ``triton_dist_tpu/ops/allgather.py`` with the
methods ``push`` and ``ring`` (and ``auto``, which picks ``push`` at up to
four ranks): TPU kernel B9, ``_ag_call``. Each rank's shard [m, ...] lands
in its slot of the gathered [n * m, ...]; the push kernel copies its own
shard into its slot and puts it to every peer, the ring forwards the slots
it receives. At one rank both are the copy of the shard into slot 0, which
``all_gather`` launches as a hand-written Hopper kernel
(``csrc/allgather.cu``) on a CUDA tensor, and runs as its plain PyTorch
version (``all_gather_plain``) on a CPU tensor. The puts across ranks wait
for the shmem layer and the collectives (ROADMAP.md Queue A, items 4
"shmem layer across ranks" and 5 "collectives"), and so do the low-latency,
2-D and broadcast forms (B10-B12).
"""

from __future__ import annotations

import ctypes

import torch

from triton_dist_tpu_torch import csrc

_P = ctypes.c_void_p
# shard, out, nbytes, slot, stream
_SIGNATURES = {"tdt_ag_copy": [_P, _P, ctypes.c_longlong, ctypes.c_int, _P]}
METHODS = ("auto", "push", "ring")


def all_gather_plain(x):
    """The plain PyTorch version of ``all_gather`` at one rank."""
    out = torch.empty_like(x)
    out.copy_(x)
    return out


def all_gather(ctx, x, axis: str | None = None, method: str = "auto"):
    """Gather the shard ``x`` [m, ...] of every rank along ``axis`` (the
    context's first axis by default) into [n * m, ...], rank r's shard in
    rows ``r * m .. (r + 1) * m``.

    A CPU tensor runs the plain version. A CUDA tensor (contiguous, 16-byte
    aligned, any type) launches the kernel, adding one to
    ``all_gather.launches``, or raises. Methods other than ``auto``, ``push``
    and ``ring``, and axes above one rank, raise ``NotImplementedError``."""
    axis = axis or ctx.axis_names[0]
    if method not in METHODS:
        raise NotImplementedError(
            f"all_gather: method {method!r} is not ported (one rank takes "
            f"{METHODS}; the low-latency and 2-D gathers wait for ROADMAP.md "
            "Queue A, item 5 \"collectives\")")
    n = ctx.axis_size(axis)
    if n != 1:
        raise NotImplementedError(
            f"all_gather over {n} ranks is not ported yet: the puts across "
            "ranks wait for the shmem layer (ROADMAP.md Queue A, items 4 "
            "\"shmem layer across ranks\" and 5 \"collectives\")")
    if x.device.type == "cpu":
        return all_gather_plain(x)
    if not x.is_contiguous() or x.data_ptr() % 16 or x.numel() == 0:
        raise ValueError(f"all_gather: the shard {tuple(x.shape)} must be "
                         f"non-empty, contiguous and 16-byte aligned")
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    lib = csrc.load("allgather", _SIGNATURES)
    stream = torch.cuda.current_stream(out.device).cuda_stream
    with csrc.current_on(out.device):
        rc = lib.tdt_ag_copy(x.data_ptr(), out.data_ptr(),
                             x.numel() * x.element_size(), 0, stream)
    csrc.check(lib, rc, "all_gather")
    all_gather.launches += 1
    return out


all_gather.launches = 0

__all__ = ["METHODS", "all_gather", "all_gather_plain"]
