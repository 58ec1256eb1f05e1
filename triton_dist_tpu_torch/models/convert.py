"""Parameters of the JAX package, as numpy arrays, into the port's dict.

The cross-framework tests build weights with the JAX ``init_params`` and run
both models on them. ``jax.tree.map(np.asarray, params)`` gives bf16 arrays
of ``ml_dtypes.bfloat16``, which ``torch.from_numpy`` refuses; they travel as
their raw 16-bit words (``view(np.uint16)`` then ``view(torch.bfloat16)``),
which is bit-exact. A round trip through f32 would be exact too, but it
would hide a wrong type; the words cannot.
"""

from __future__ import annotations

import numpy as np
import torch

from triton_dist_tpu_torch.ops.group_gemm import PackedGatedWeights
from triton_dist_tpu_torch.utils.env import default_device


def tensor_from_numpy(a: np.ndarray, device) -> torch.Tensor:
    """One array, bit for bit, on ``device``."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:      # jax hands out read-only views
        a = a.copy()
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16) \
            .to(device)
    return torch.from_numpy(a).to(device)


def params_from_jax(np_params: dict, device="cuda",
                    dtype: torch.dtype | None = None) -> dict:
    """The JAX parameter pytree (nested dicts of numpy arrays) as the port's
    parameter dict: the same keys, shapes and layouts, bit for bit. That
    covers the MoE blocks of ``init_moe_params`` too: ``w_router`` f32
    [L, D, E], ``we_gate`` / ``we_up`` [L, E, D, F], ``we_down`` [L, E, F, D].
    ``dtype``, when given, is the model's working type: every array must be
    in it or in f32 (the norm gains, the router), else this raises rather
    than re-round the reference's weights."""
    dev = default_device(device)

    def conv(tree):
        if isinstance(tree, dict):
            return {k: conv(v) for k, v in tree.items()}
        t = tensor_from_numpy(np.asarray(tree), dev)
        if dtype is not None and t.dtype not in (dtype, torch.float32):
            raise TypeError(f"array of type {t.dtype} in a {dtype} model")
        return t

    return conv(np_params)


def packed_from_jax(w: np.ndarray, block_n: int,
                    device="cuda") -> PackedGatedWeights:
    """The JAX package's packed gate‖up array (``pack_gated_weights(...).w``
    [E, H, 2F], as numpy) with the ``block_n`` it was packed with, as the
    port's ``PackedGatedWeights``, bit for bit; the width must divide F."""
    E, H, F2 = w.shape
    if F2 % 2 or (F2 // 2) % block_n:
        raise ValueError(f"a packed array [{E}, {H}, {F2}] is not packed at "
                         f"block_n={block_n}")
    return PackedGatedWeights(tensor_from_numpy(w, default_device(device)),
                              block_n)


__all__ = ["packed_from_jax", "params_from_jax", "tensor_from_numpy"]
