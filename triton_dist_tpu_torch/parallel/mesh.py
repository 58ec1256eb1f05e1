"""Mesh construction helpers.

Counterpart of ``triton_dist_tpu/parallel/mesh.py``. The JAX package builds a
``jax.sharding.Mesh`` over named axes; the port's mesh is the shmem layer's
``ShmemContext``, every rank of it on the one device (``shmem/context.py``).
``factorize_devices`` is the reference's, in pure Python.
"""

from __future__ import annotations

from typing import Sequence

from triton_dist_tpu_torch.shmem.context import (ShmemContext,
                                                 initialize_distributed)


def make_mesh(axes: dict[str, int], device=None) -> ShmemContext:
    """The mesh of an ordered ``{axis_name: size}`` dict: a
    ``ShmemContext`` whose ranks all run on ``device`` (``cuda`` unless the
    caller names another)."""
    return initialize_distributed(tuple(axes), tuple(axes.values()), device)


def factorize_devices(n_devices: int,
                      axis_order: Sequence[str] = ("dp", "pp", "tp"),
                      prefer_inner: str | None = "tp") -> dict[str, int]:
    """Split ``n_devices`` across the named axes. The ``prefer_inner`` axis
    (innermost = fastest interconnect neighbours) takes the largest prime
    factor; the rest are dealt largest-first, round-robin inner-to-outer.
    E.g. 8 → {dp:2, pp:2, tp:2}; 4 → {dp:1, pp:2, tp:2};
    12 → {dp:2, pp:2, tp:3}; 1 → all ones."""
    axes = {a: 1 for a in axis_order}
    remaining = n_devices
    order = list(axis_order)[::-1]  # inner first
    if prefer_inner and prefer_inner in axes:
        order.remove(prefer_inner)
        order.insert(0, prefer_inner)
    factors = []
    while remaining > 1:
        f = next((p for p in range(2, remaining + 1) if remaining % p == 0))
        factors.append(f)
        remaining //= f
    # deal largest factors first so the preferred axis gets the biggest one
    for i, f in enumerate(sorted(factors, reverse=True)):
        axes[order[i % len(order)]] *= f
    return axes


__all__ = ["factorize_devices", "make_mesh"]
