from .jax_params import jax_params_to_state_dict, load_jax_params

__all__ = ["jax_params_to_state_dict", "load_jax_params"]
