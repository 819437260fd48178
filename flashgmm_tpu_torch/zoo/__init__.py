from .image import (cfgs, cfgs_vbr, cfgs_video, create_model, image_models,
                    model_architectures)
from .npz import load_jax_params, load_npz, save_npz_weights
from .torch_convert import (load_checkpoint_file, load_torch_state_dict,
                            rename_legacy_keys)
from .torch_export import export_torch_state_dict, load_into_torch_model

models = image_models

__all__ = [
    "models",
    "image_models",
    "model_architectures",
    "cfgs",
    "cfgs_vbr",
    "cfgs_video",
    "create_model",
    "export_torch_state_dict",
    "load_checkpoint_file",
    "load_into_torch_model",
    "load_jax_params",
    "load_npz",
    "load_torch_state_dict",
    "rename_legacy_keys",
    "save_npz_weights",
]
