from .jax_params import (
    jax_d_params_to_state_dict,
    jax_d_pose_params_to_state_dict,
    jax_params_to_state_dict,
    jax_vgg_params_to_state_dict,
    load_jax_inversion,
    load_jax_params,
    load_jax_train_state,
)

__all__ = ["jax_d_params_to_state_dict", "jax_d_pose_params_to_state_dict",
           "jax_params_to_state_dict", "jax_vgg_params_to_state_dict", "load_jax_inversion",
           "load_jax_params", "load_jax_train_state"]
