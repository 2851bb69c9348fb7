"""Convex-polygon clipping against the upper hemisphere (z >= 0) for the
per-pixel shading path.

Counterpart of vulkan_renderer_tpu/ops/clipping.py::clip_polygon
(reference polygon_clipping.glsl:19-225) as the JAX package writes it: a
masked Sutherland-Hodgman pass, each input edge emitting its current
vertex when above the horizon and the horizon crossing when it crosses,
outputs placed by an exclusive prefix sum of the emit counts. Batched
over a leading pixel axis P with a static input vertex count n, so the
output has n + 1 lanes instead of the JAX package's MAX_POLYGON_VERTEX
_COUNT (lanes it never fills past the count). The emitted vertices are
scattered to their slots, plus 0, which is what the JAX package's one-hot
masked sums compute (-0.0 becomes +0.0). K4's plain version clips with
its own copy of this pass (ops/soa.py clip_soa).

Precision: the float type is the input's; the float64 evaluation takes
the same branches except where a vertex's z sits within rounding of 0.
"""

from __future__ import annotations

import torch

from .math_utils import cumsum_lanes


def _intersect_z0(lhs, rhs):
    """Intersection of the segments lhs -> rhs (..., 3) with the plane
    z == 0 (glsl iz0)."""
    t = (lhs[..., 2] / (lhs[..., 2] - rhs[..., 2]))[..., None]
    xy = t * rhs[..., :2] + (lhs[..., :2] - t * lhs[..., :2])
    return torch.cat([xy, torch.zeros_like(xy[..., :1])], dim=-1)


def clip_polygon(vertices, vertex_count: int):
    """Clip a convex polygon to z >= 0.

    vertices: (P, >= n, 3), lanes below vertex_count (a static int n) are
    the polygon. Returns (clipped (P, n + 1, 3), count (P,) int32): count
    is 0 (fully clipped; all lanes zero) or in [3, n + 1], lanes at and
    past count repeat the first vertex, and winding is preserved."""
    n = vertex_count
    m = n + 1
    v = vertices[:, :n]
    p = v.shape[0]
    above = v[:, :, 2] > 0.0
    v_next = torch.roll(v, -1, dims=1)
    above_next = torch.roll(above, -1, dims=1)
    emit_cur = above
    emit_int = above != above_next
    isect = _intersect_z0(v, v_next)

    counts = emit_cur.to(torch.int32) + emit_int.to(torch.int32)
    offsets = cumsum_lanes(counts) - counts  # exclusive prefix sum
    out_count = torch.sum(counts, dim=1, dtype=torch.int32)

    # Scatter each emitted element to its output slot; the ones not
    # emitted go to a spare lane m, dropped after.
    spare = torch.full_like(offsets, m)
    out = v.new_zeros((p, m + 1, 3))
    out.scatter_(1, torch.where(emit_cur, offsets, spare).long()[..., None]
                 .expand(-1, -1, 3), v)
    out.scatter_(1, torch.where(emit_int, offsets + emit_cur.to(torch.int32),
                                spare).long()[..., None].expand(-1, -1, 3),
                 isect)
    out = out[:, :m] + 0.0

    # Degenerate results (fewer than 3 vertices) count as fully clipped.
    out_count = torch.where(out_count >= 3, out_count, 0)
    lanes = torch.arange(m, device=v.device, dtype=torch.int32)
    pad = (lanes[None, :] >= out_count[:, None])[..., None]
    out = torch.where(pad, out[:, :1], out)
    out = torch.where((out_count == 0)[:, None, None], 0.0, out)
    return out, out_count
