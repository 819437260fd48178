from .npz import load_jax_params, load_npz
from .torch_convert import load_torch_state_dict

__all__ = ["load_jax_params", "load_npz", "load_torch_state_dict"]
