"""Polygonal area lights: user-editable state and derived attributes.

The port's own copy of what it uses of vulkan_renderer_tpu/scene/lights.py
(src/polygonal_light.c / polygonal_light.h). The derivations (Euler
rotation, world-space vertices, plane equation, fan areas, radiance from
flux) are numerically identical, so reference quicksaves reproduce the
same constants; scene/scene.py stacks the records into tensors.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np

from .. import MAX_POLYGONAL_LIGHT_VERTEX_COUNT

M_PI = float(np.pi)


class PolygonTexturing:
    """polygon_texturing_* of polygonal_light_utility.glsl."""
    NONE = 0
    AREA = 1
    PORTAL = 2
    IES_PROFILE = 3


class PolygonalLight(NamedTuple):
    """Derived light record (polygonal_light_utility.glsl:26-83); vertex
    lanes beyond vertex_count repeat the first vertex (the reference's
    constant-buffer convention, main.c:2160-2187)."""
    rotation_angles: np.ndarray     # (3,)
    scaling_x: np.ndarray           # ()
    translation: np.ndarray         # (3,)
    scaling_y: np.ndarray           # ()
    radiant_flux: np.ndarray        # (3,)
    inv_scaling_x: np.ndarray       # ()
    surface_radiance: np.ndarray    # (3,)
    inv_scaling_y: np.ndarray       # ()
    plane: np.ndarray               # (4,)
    vertex_count: np.ndarray        # () int32
    texturing_technique: np.ndarray  # () int32
    texture_index: np.ndarray       # () int32
    rotation: np.ndarray            # (3, 3) plane->world rotation
    area: np.ndarray                # ()
    rcp_area: np.ndarray            # ()
    vertices_plane_space: np.ndarray  # (MAXL, 2)
    vertices_world_space: np.ndarray  # (MAXL, 3)
    fan_areas: np.ndarray             # (MAXL-2, 2)


@dataclasses.dataclass
class PolygonalLightSpec:
    """User-editable light state (the non-derived fields of polygonal_light_t)."""
    rotation_angles: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32))
    scaling_x: float = 1.0
    scaling_y: float = 1.0
    translation: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32))
    radiant_flux: np.ndarray = dataclasses.field(
        default_factory=lambda: np.ones(3, np.float32))
    vertices_plane_space: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array(
            [[-1, -1], [1, -1], [1, 1], [-1, 1]], np.float32))
    texturing_technique: int = 0  # polygon_texturing_none
    texture_index: int = 0
    texture_file_path: str = ""

    @property
    def vertex_count(self) -> int:
        return int(self.vertices_plane_space.shape[0])


def rotation_matrix_from_euler(angles: np.ndarray) -> np.ndarray:
    """Euler XYZ rotation exactly as polygonal_light.c:50-64."""
    cx, sx = np.cos(angles[0]), np.sin(angles[0])
    cy, sy = np.cos(angles[1]), np.sin(angles[1])
    cz, sz = np.cos(angles[2]), np.sin(angles[2])
    cxsy = cx * sy
    sxsy = sx * sy
    return np.array([
        [cy * cz, -cy * sz, -sy],
        [-sxsy * cz + cx * sz, sxsy * sz + cx * cz, -sx * cy],
        [cxsy * cz + sx * sz, -cxsy * sz + sx * cz, cx * cy],
    ], np.float32)


def update_polygonal_light(spec: PolygonalLightSpec,
                           max_vertex_count: int | None = None) -> PolygonalLight:
    """Derive all redundant light attributes (polygonal_light.c:46-107)."""
    if max_vertex_count is None:
        max_vertex_count = MAX_POLYGONAL_LIGHT_VERTEX_COUNT
    count = spec.vertex_count
    if not 3 <= count <= max_vertex_count:
        raise ValueError(f"a polygonal light has 3 to {max_vertex_count} "
                         f"vertices, got {count}")
    rotation = rotation_matrix_from_euler(np.asarray(spec.rotation_angles,
                                                     np.float32))
    verts_plane = np.asarray(spec.vertices_plane_space, np.float32)
    scalings = np.array([spec.scaling_x, spec.scaling_y], np.float32)
    translation = np.asarray(spec.translation, np.float32)

    # World-space vertices: translation + R @ diag(sx, sy) @ (x, y, 0).
    verts_world = translation[None, :] + \
        verts_plane[:, 0:1] * (scalings[0] * rotation[:, 0])[None, :] + \
        verts_plane[:, 1:2] * (scalings[1] * rotation[:, 1])[None, :]
    verts_world = verts_world.astype(np.float32)

    plane = np.empty(4, np.float32)
    plane[:3] = rotation[:, 2]
    plane[3] = -float(rotation[:, 2] @ translation)

    # Fan areas with the reference's sign conventions
    # (polygonal_light.c:81-103).
    signed_area = np.float32(0.0)
    fan_areas = np.zeros((max_vertex_count - 2, 2), np.float32)
    scale_prod = np.float32(scalings[0] * scalings[1])
    for i in range(count - 2):
        m00 = verts_plane[i + 2, 0] - verts_plane[0, 0]
        m01 = verts_plane[i + 1, 0] - verts_plane[0, 0]
        m10 = verts_plane[i + 2, 1] - verts_plane[0, 1]
        m11 = verts_plane[i + 1, 1] - verts_plane[0, 1]
        tri = np.float32(0.5) * (m00 * m11 - m01 * m10)
        signed_area += tri
        sign = np.float32(-1.0 if tri < 0.0 else 1.0)
        fan_areas[i, 0] = scale_prod * tri * sign
        fan_areas[i, 1] = scale_prod * signed_area * sign

    signed_area *= scale_prod
    abs_area = abs(float(signed_area))
    radiance = np.asarray(spec.radiant_flux, np.float32) / \
        np.float32(abs_area * M_PI)
    if signed_area <= 0.0:
        plane = -plane

    # Pad by repeating the first vertex.
    pad = max_vertex_count - count
    verts_plane_p = np.concatenate(
        [verts_plane, np.repeat(verts_plane[:1], pad, 0)], axis=0)
    verts_world_p = np.concatenate(
        [verts_world, np.repeat(verts_world[:1], pad, 0)], axis=0)
    # Fan areas: repeat the last valid entry (main.c:2181-2186).
    for i in range(count - 2, max_vertex_count - 2):
        fan_areas[i] = fan_areas[count - 3]

    return PolygonalLight(
        rotation_angles=np.asarray(spec.rotation_angles, np.float32),
        scaling_x=np.float32(spec.scaling_x),
        translation=translation,
        scaling_y=np.float32(spec.scaling_y),
        radiant_flux=np.asarray(spec.radiant_flux, np.float32),
        inv_scaling_x=np.float32(1.0 / spec.scaling_x),
        surface_radiance=radiance.astype(np.float32),
        inv_scaling_y=np.float32(1.0 / spec.scaling_y),
        plane=plane,
        vertex_count=np.int32(count),
        texturing_technique=np.int32(spec.texturing_technique),
        texture_index=np.int32(spec.texture_index),
        rotation=rotation,
        area=np.float32(abs_area),
        rcp_area=np.float32(1.0 / abs_area),
        vertices_plane_space=verts_plane_p,
        vertices_world_space=verts_world_p,
        fan_areas=fan_areas,
    )
