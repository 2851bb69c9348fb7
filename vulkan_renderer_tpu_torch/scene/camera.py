"""First-person camera with the reference's exact projection conventions.

The port's own copy of what it uses of vulkan_renderer_tpu/scene/camera.py
(src/camera.c / camera.h): the camera state and the pixel -> ray matrix.
Pixel parity requires the same right-handed projection with negated x
(-1/right, camera.c:59-71) and the Rz*Rx view rotation (camera.c:24-56).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class FirstPersonCamera:
    """reference: camera.h:27-47."""
    position_world_space: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32))
    rotation_x: float = 0.0
    rotation_z: float = 0.0
    vertical_fov: float = np.radians(70.0)
    near: float = 0.05
    far: float = 1.0e4
    speed: float = 2.0


def get_world_to_view_space(camera: FirstPersonCamera) -> np.ndarray:
    cx, sx = np.cos(camera.rotation_x), np.sin(camera.rotation_x)
    cz, sz = np.cos(camera.rotation_z), np.sin(camera.rotation_z)
    rot_x = np.array([[1, 0, 0], [0, cx, sx], [0, -sx, cx]], np.float32)
    rot_z = np.array([[cz, sz, 0], [-sz, cz, 0], [0, 0, 1]], np.float32)
    rotation = rot_z @ rot_x
    # View matrix = transpose(rotation) with translated origin (camera.c:44-55).
    origin_view = -(rotation.T @ np.asarray(camera.position_world_space,
                                            np.float32))
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = rotation.T
    m[:3, 3] = origin_view
    return m


def get_pixel_to_ray_direction_world_space(camera: FirstPersonCamera,
                                           width: int, height: int) -> np.ndarray:
    """3x3 matrix mapping (pixel_x, pixel_y, 1) to an (unnormalized) world
    ray direction.

    The reference builds this by inverting the translation-stripped VP
    matrix (main.c:2136-2157), which is singular for some ordinary camera
    poses. The same map (up to a constant scale, which cancels everywhere
    the matrix is used) is built directly from the camera basis:
      ndc = viewport_transform(pixel); dir_view = (-ndc.x*right, ndc.y*top,
      -1); dir_world = R_view_to_world @ dir_view.
    The -right factor mirrors the reference's negated-x projection
    (camera.c:59-71)."""
    view = get_world_to_view_space(camera).astype(np.float64)
    rotation_view_to_world = view[:3, :3].T
    top = np.tan(0.5 * camera.vertical_fov)
    right = (width / height) * top

    vt0 = 2.0 / width
    vt1 = 2.0 / height
    vt2 = 0.5 * vt0 - 1.0
    vt3 = 0.5 * vt1 - 1.0
    # pixel (px, py, 1) -> dir_view = (-right*(vt0*px+vt2), top*(vt1*py+vt3), -1)
    pixel_to_dir_view = np.array([
        [-right * vt0, 0.0, -right * vt2],
        [0.0, top * vt1, top * vt3],
        [0.0, 0.0, -1.0],
    ], np.float64)
    return (rotation_view_to_world @ pixel_to_dir_view).astype(np.float32)
