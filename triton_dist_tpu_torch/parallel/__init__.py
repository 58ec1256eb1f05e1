from triton_dist_tpu_torch.parallel.mesh import factorize_devices, make_mesh
from triton_dist_tpu_torch.parallel.pipeline import pipeline_apply
from triton_dist_tpu_torch.parallel.train import (ParallelPlan, TrainState,
                                                  adamw, make_loss_fn,
                                                  make_train_step)

__all__ = ["ParallelPlan", "TrainState", "adamw", "factorize_devices",
           "make_loss_fn", "make_mesh", "make_train_step", "pipeline_apply"]
