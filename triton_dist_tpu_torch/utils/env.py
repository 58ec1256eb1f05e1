"""Device selection and numeric flags.

The counterpart of ``triton_dist_tpu/utils/env.py::default_interpret``: where
the JAX package picks Pallas interpret mode off the CPU backend, the port
picks the device its entry points run on. There is no silent fallback: an
entry point asked for CUDA on a machine without a card raises.
"""

from __future__ import annotations

import torch


def default_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. Raises when CUDA is asked for and no card is visible."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on the card by default; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU")
    return dev


def tf32_flags() -> dict:
    """The two TF32 switches that decide how float32 products run on the
    card: matrix products (off by default) and cuDNN convolutions (on by
    default)."""
    return {"cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32}


def set_tf32(enabled: bool = False) -> dict:
    """Set both TF32 switches (off by default, so float32 stays float32 on
    the card) and return them as ``tf32_flags`` reports them."""
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled
    return tf32_flags()
