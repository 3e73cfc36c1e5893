from .camera import CameraParams, camera_from_angles, sweep_cameras
from .rays import (
    get_points,
    get_rays_in_world,
    get_z_vals,
    normalize_points,
    prepare_nerf_inputs,
)
from .integration import sdf_to_sigma, volume_integration

__all__ = [
    "CameraParams", "camera_from_angles", "sweep_cameras",
    "get_points", "get_rays_in_world", "get_z_vals", "normalize_points",
    "prepare_nerf_inputs", "sdf_to_sigma", "volume_integration",
]
