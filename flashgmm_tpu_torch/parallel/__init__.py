from .inference import (make_sharded_forward, make_spatial_sharded_forward,
                        make_spatial_sharded_transform)
from .mesh import Mesh, make_mesh, replicate, shard_batch
from .train import (make_train_state, pointcloud_train_step,
                    set_guarded_grads, train_step, vbr_train_step,
                    video_train_step)

__all__ = ["Mesh", "make_mesh", "make_sharded_forward",
           "make_spatial_sharded_forward", "make_spatial_sharded_transform",
           "make_train_state", "pointcloud_train_step", "replicate",
           "set_guarded_grads", "shard_batch", "train_step",
           "vbr_train_step", "video_train_step"]
