"""Segment / ray vs convex polygonal light.

Counterpart of vulkan_renderer_tpu/ops/intersect.py::
polygonal_light_ray_intersection (reference
polygonal_light_utility.glsl:93-112), batched over rays.
"""

from __future__ import annotations

import torch

from .math_utils import cross


def polygonal_light_ray_intersection(plane, vertices_world, vertex_count,
                                     ray_origin, ray_end_homogeneous):
    """plane: (4,); vertices_world: (MAXL, 3), first vertex repeated past
    vertex_count; vertex_count: int; ray_origin: (3,), or (P, 3) for one
    origin per ray; ray_end_homogeneous: (P, 4) with w=1 for a point, w=0
    for a direction. Returns (P,) bool."""
    maxl = vertices_world.shape[0]
    o = ray_origin
    o_dot = plane[0] * o[..., 0] + plane[1] * o[..., 1] \
        + plane[2] * o[..., 2] + plane[3]
    end = ray_end_homogeneous
    e_dot = plane[0] * end[:, 0] + plane[1] * end[:, 1] \
        + plane[2] * end[:, 2] + plane[3] * end[:, 3]
    opposite = o_dot * e_dot <= 0.0

    ray_dir = end[:, :3] - end[:, 3:4] * o                 # (P, 3)
    rel = vertices_world - o[..., None, :]                  # ([P,] MAXL, 3)
    edge_normals = cross(rel, torch.roll(rel, -1, -2))      # ([P,] MAXL, 3)
    signs = ray_dir[:, None, 0] * edge_normals[..., 0] \
        + ray_dir[:, None, 1] * edge_normals[..., 1] \
        + ray_dir[:, None, 2] * edge_normals[..., 2]        # (P, MAXL)
    prev_signs = torch.cat([torch.zeros_like(signs[:, :1]), signs[:, :-1]],
                           dim=1)
    lanes = torch.arange(maxl, device=signs.device)
    unused = (lanes >= 3) & (lanes >= vertex_count)
    ok = (prev_signs * signs >= 0.0) | unused[None, :]
    return opposite & torch.all(ok, dim=1)
