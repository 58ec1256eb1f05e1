from triton_dist_tpu_torch.parallel.train import (ParallelPlan, TrainState,
                                                  adamw, make_loss_fn,
                                                  make_train_step)

__all__ = ["ParallelPlan", "TrainState", "adamw", "make_loss_fn",
           "make_train_step"]
