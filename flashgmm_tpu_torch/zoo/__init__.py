from .npz import load_jax_params, load_npz

__all__ = ["load_jax_params", "load_npz"]
