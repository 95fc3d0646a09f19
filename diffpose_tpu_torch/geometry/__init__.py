"""Camera and quaternion geometry of the Human3.6M pipeline."""

from diffpose_tpu_torch.geometry.camera import (
    camera_to_world,
    image_coordinates,
    normalize_screen_coordinates,
    project_to_2d,
    project_to_2d_linear,
    world_to_camera,
)
from diffpose_tpu_torch.geometry.quaternion import qinverse, qrot

__all__ = [
    "qrot", "qinverse", "normalize_screen_coordinates", "image_coordinates",
    "world_to_camera", "camera_to_world", "project_to_2d", "project_to_2d_linear",
]
