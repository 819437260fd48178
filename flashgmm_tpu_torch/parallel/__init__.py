from .train import (make_train_state, pointcloud_train_step,
                    set_guarded_grads, train_step, vbr_train_step,
                    video_train_step)

__all__ = ["make_train_state", "pointcloud_train_step", "set_guarded_grads",
           "train_step", "vbr_train_step", "video_train_step"]
