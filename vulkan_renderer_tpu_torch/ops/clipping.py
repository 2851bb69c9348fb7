"""Convex-polygon clipping against the upper hemisphere (z >= 0) for the
per-pixel shading path.

Counterpart of vulkan_renderer_tpu/ops/clipping.py::clip_polygon
(reference polygon_clipping.glsl:19-225), batched over pixels with a
static input vertex count n: the masked Sutherland-Hodgman pass of
ops/soa.py clip_soa, which K4's plain version runs too.
"""

from __future__ import annotations

import torch

from .soa import clip_soa


def polygon_lanes(vertices):
    """(..., m, 3) tensor -> list of m vec3 tuples of (...) planes."""
    return [tuple(vertices[..., k, c] for c in range(3))
            for k in range(vertices.shape[-2])]


def stack_lanes(lanes):
    """Inverse of polygon_lanes: list of m vec3 tuples -> (..., m, 3)."""
    return torch.stack([torch.stack(v, dim=-1) for v in lanes], dim=-2)


def clip_polygon(vertices, vertex_count: int):
    """Clip a convex polygon to z >= 0.

    vertices: (P, >= n, 3), lanes below vertex_count (a static int n) are
    the polygon. Returns (clipped (P, n + 1, 3), count (P,) int32): count
    is 0 (fully clipped; all lanes zero) or in [3, n + 1], lanes at and
    past count repeat the first vertex, and winding is preserved."""
    out, count = clip_soa(polygon_lanes(vertices[..., :vertex_count, :]),
                          vertex_count)
    return stack_lanes(out), count
