"""PyTorch/CUDA port of ``triton_dist_tpu`` for one NVIDIA H100.

The module paths mirror the JAX package's, so each function's counterpart
is found under the same name. Importing the package imports ``torch`` and
nothing else heavy: no kernel is built or loaded until its first launch on
a CUDA tensor (``triton_dist_tpu_torch.csrc``). Entry points run on
``device="cuda"`` unless the caller passes ``device="cpu"``, where every
kernel wrapper takes its plain PyTorch version.
"""

__all__ = ["csrc", "layers", "models", "ops", "parallel", "serving", "shmem",
           "utils"]
