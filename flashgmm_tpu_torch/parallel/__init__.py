from .distributed import broadcast_parameters, init_from_env, launched
from .inference import (make_sharded_forward, make_spatial_sharded_forward,
                        make_spatial_sharded_transform)
from .mesh import Mesh, make_mesh, replicate, shard_batch
from .train import (data_parallel_train_step, local_rows, make_train_state,
                    pointcloud_train_step, set_guarded_grads, train_step,
                    vbr_train_step, video_train_step)

__all__ = ["Mesh", "broadcast_parameters", "data_parallel_train_step",
           "init_from_env", "launched", "local_rows", "make_mesh",
           "make_sharded_forward", "make_spatial_sharded_forward",
           "make_spatial_sharded_transform", "make_train_state",
           "pointcloud_train_step", "replicate", "set_guarded_grads",
           "shard_batch", "train_step", "vbr_train_step", "video_train_step"]
