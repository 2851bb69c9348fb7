"""Quicksave (.save) reader/writer, byte-identical with the reference
(main.c:49-130); the port's own copy of
vulkan_renderer_tpu/assets/quicksave.py. Published experiment .save files
are inputs to baseline configs, so this must parse them exactly.

Layout (little endian, written by 64-bit builds):
  first_person_camera_t: 11 f32 + 1 i32 = 48 bytes
    position[3], rotation_z, rotation_x, vertical_fov, near, far, speed,
    rotate_camera (i32), rotation_x_0, rotation_z_0
  u32 legacy_count (0)
  u32 polygonal_light_count
  per light:
    POLYGONAL_LIGHT_QUICKSAVE_SIZE = 20 f32 + 2 u32:
      rotation_angles[3], scaling_x, translation[3], scaling_y,
      radiant_flux[3], inv_scaling_x, surface_radiance[3], inv_scaling_y,
      plane[4], vertex_count (u32), texturing_technique (u32)
    u64 path_size | path bytes (incl. NUL) if path_size > 0
    2 x 8-byte legacy pointers (ignored)
    f32 x 4 x vertex_count plane-space vertices (x, y, pad, pad)
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

from ..scene.camera import FirstPersonCamera
from ..scene.lights import PolygonalLightSpec, update_polygonal_light


@dataclasses.dataclass
class Quicksave:
    camera: FirstPersonCamera
    lights: list[PolygonalLightSpec]


def load_quicksave(path: str) -> Quicksave:
    with open(path, "rb") as f:
        cam_raw = struct.unpack("<9fi2f", f.read(48))
        camera = FirstPersonCamera(
            position_world_space=np.array(cam_raw[0:3], np.float32),
            rotation_z=cam_raw[3],
            rotation_x=cam_raw[4],
            vertical_fov=cam_raw[5],
            near=cam_raw[6],
            far=cam_raw[7],
            speed=cam_raw[8],
        )
        (_legacy,) = struct.unpack("<I", f.read(4))
        (light_count,) = struct.unpack("<I", f.read(4))
        lights = []
        for _ in range(light_count):
            vals = struct.unpack("<20f", f.read(80))
            vertex_count, texturing = struct.unpack("<II", f.read(8))
            (path_size,) = struct.unpack("<Q", f.read(8))
            tex_path = ""
            if path_size:
                tex_path = f.read(path_size)[:-1].decode("utf-8", "replace")
            f.read(16)  # legacy pointers
            verts = np.frombuffer(f.read(16 * vertex_count), np.float32) \
                .reshape(vertex_count, 4)[:, :2].copy()
            scaling_y = vals[7]
            if scaling_y <= 0.0:  # legacy fix (main.c:105-106)
                scaling_y = vals[3]
            lights.append(PolygonalLightSpec(
                rotation_angles=np.array(vals[0:3], np.float32),
                scaling_x=vals[3],
                translation=np.array(vals[4:7], np.float32),
                scaling_y=scaling_y,
                radiant_flux=np.array(vals[8:11], np.float32),
                vertices_plane_space=verts,
                texturing_technique=int(texturing),
                texture_file_path=tex_path,
            ))
    return Quicksave(camera=camera, lights=lights)


def save_quicksave(path: str, save: Quicksave) -> None:
    with open(path, "wb") as f:
        cam = save.camera
        f.write(struct.pack(
            "<9fi2f",
            *np.asarray(cam.position_world_space, np.float32),
            cam.rotation_z, cam.rotation_x, cam.vertical_fov,
            cam.near, cam.far, cam.speed, 0, 0.0, 0.0))
        f.write(struct.pack("<II", 0, len(save.lights)))
        for spec in save.lights:
            light = update_polygonal_light(
                spec, max_vertex_count=max(spec.vertex_count, 3))
            f.write(struct.pack(
                "<20f",
                *light.rotation_angles, float(light.scaling_x),
                *light.translation, float(light.scaling_y),
                *light.radiant_flux, float(light.inv_scaling_x),
                *light.surface_radiance, float(light.inv_scaling_y),
                *light.plane))
            f.write(struct.pack("<II", spec.vertex_count,
                                spec.texturing_technique))
            if spec.texture_file_path:
                encoded = spec.texture_file_path.encode("utf-8") + b"\x00"
                f.write(struct.pack("<Q", len(encoded)))
                f.write(encoded)
            else:
                f.write(struct.pack("<Q", 0))
            f.write(b"\x00" * 16)
            padded = np.zeros((spec.vertex_count, 4), np.float32)
            padded[:, :2] = spec.vertices_plane_space
            f.write(padded.tobytes())
