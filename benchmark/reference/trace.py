"""Brute-force ray tracing for the reference: every ray against every
triangle, with the per-triangle formulas of the port's plain tracers at
commit b4b0e8b (render/trace_kernel.py: K2's reciprocal-det and K1's
division-free Moeller-Trumbore), and no acceleration structure. A
triangle the port's cluster walk reaches is a triangle tested here, so
the two agree wherever a culling decision of the walk is right.
"""

from __future__ import annotations

import torch

T_MIN = 1.0e-3
# Ray x triangle pairs per step: bounded intermediates (~25 live float
# tensors of this many elements).
PAIRS = 1 << 24


def _steps(rays: int, triangles: int):
    step = max(1, PAIRS // max(rays, 1))
    for t0 in range(0, triangles, step):
        yield t0, min(triangles, t0 + step)


def _ray_chunks(count: int, triangles: int):
    """Ray chunks that keep a step's pairs near PAIRS when the scene is
    small, and at 256 rays when it is large."""
    size = max(256, PAIRS // max(triangles, 1))
    for r0 in range(0, count, size):
        yield r0, min(count, r0 + size)


def closest_hit(v0, e1, e2, origins, dirs, t_min: float = T_MIN):
    """(prim (R,) int64 with -1 on a miss, t (R,) with inf on a miss):
    the lowest t, and of equal t the lowest triangle id, over triangles
    (v0, e1, e2) (T, 3) each."""
    prims, ts = [], []
    for r0, r1 in _ray_chunks(dirs.shape[0], v0.shape[0]):
        p, t = _closest_chunk(v0, e1, e2, origins[r0:r1], dirs[r0:r1], t_min)
        prims.append(p)
        ts.append(t)
    return torch.cat(prims), torch.cat(ts)


def _closest_chunk(v0, e1, e2, o, d, t_min):
    r = d.shape[0]
    best_t = torch.full((r,), float("inf"), device=d.device)
    best = torch.full((r,), -1, dtype=torch.int64, device=d.device)
    ox, oy, oz = (o[:, i, None] for i in range(3))
    dx, dy, dz = (d[:, i, None] for i in range(3))
    for t0, t1 in _steps(r, v0.shape[0]):
        v0x, v0y, v0z = (v0[None, t0:t1, i] for i in range(3))
        e1x, e1y, e1z = (e1[None, t0:t1, i] for i in range(3))
        e2x, e2y, e2z = (e2[None, t0:t1, i] for i in range(3))
        px = dy * e2z - dz * e2y
        py = dz * e2x - dx * e2z
        pz = dx * e2y - dy * e2x
        det = e1x * px + e1y * py + e1z * pz
        det_ok = torch.abs(det) > 1e-12
        inv_det = 1.0 / torch.where(det_ok, det, 1.0)
        tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
        u = (tx * px + ty * py + tz * pz) * inv_det
        qx = ty * e1z - tz * e1y
        qy = tz * e1x - tx * e1z
        qz = tx * e1y - ty * e1x
        v = (dx * qx + dy * qy + dz * qz) * inv_det
        tt = (e2x * qx + e2y * qy + e2z * qz) * inv_det
        hit = det_ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) \
            & (tt >= t_min)
        tt = torch.where(hit, tt, float("inf"))
        step_t, step_i = torch.min(tt, dim=1)  # first of equal minima
        better = step_t < best_t
        best_t = torch.where(better, step_t, best_t)
        best = torch.where(better, step_i + t0, best)
    return best, best_t


def occluded(v0, e1, e2, origins, dirs, t_max, t_min: float = T_MIN):
    """(R,) bool: some triangle is hit with t in [t_min, t_max]; a ray
    with t_max < 0 is dead and never occluded."""
    out = [_anyhit_chunk(v0, e1, e2, origins[r0:r1], dirs[r0:r1],
                         t_max[r0:r1], t_min)
           for r0, r1 in _ray_chunks(dirs.shape[0], v0.shape[0])]
    return torch.cat(out) if out else torch.zeros(
        0, dtype=torch.bool, device=dirs.device)


def _anyhit_chunk(v0, e1, e2, o, d, tm, t_min):
    r = d.shape[0]
    result = torch.zeros(r, dtype=torch.bool, device=d.device)
    live = tm >= 0.0
    if not bool(live.any()):
        return result
    ox, oy, oz = (o[:, i, None] for i in range(3))
    dx, dy, dz = (d[:, i, None] for i in range(3))
    tmax = tm[:, None]
    for t0, t1 in _steps(r, v0.shape[0]):
        v0x, v0y, v0z = (v0[None, t0:t1, i] for i in range(3))
        e1x, e1y, e1z = (e1[None, t0:t1, i] for i in range(3))
        e2x, e2y, e2z = (e2[None, t0:t1, i] for i in range(3))
        px = dy * e2z - dz * e2y
        py = dz * e2x - dx * e2z
        pz = dx * e2y - dy * e2x
        det = e1x * px + e1y * py + e1z * pz
        su = torch.where(det >= 0.0, 1.0, -1.0)
        adet = det * su
        tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
        u = (tx * px + ty * py + tz * pz) * su
        qx = ty * e1z - tz * e1y
        qy = tz * e1x - tx * e1z
        qz = tx * e1y - ty * e1x
        v = (dx * qx + dy * qy + dz * qz) * su
        tt = (e2x * qx + e2y * qy + e2z * qz) * su
        hit = (adet > 1e-12) & (u >= 0.0) & (v >= 0.0) & (u + v <= adet) \
            & (tt >= t_min * adet) & (tt <= tmax * adet)
        result |= hit.any(dim=1)
    return result & live
