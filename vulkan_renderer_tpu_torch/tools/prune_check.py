"""A scene built to provoke K2's prune, and the rays that probe it.

K2 (csrc/closest.cu) walks the cluster BVH and drops a box that it
enters beyond the best t found so far, and a sub-box whose slab test
fails against [0, best t]. The entry comes from the slab test and the
best t from Moeller-Trumbore: two roundings of one distance, which can
part by ulps, so a box can be entered beyond the t at which its own
triangle is hit. If a hit found earlier in the walk lies in between, a
prune by the bare best t drops the box, and K2 returns that hit instead
of the lexicographic minimum of (t, prim) that trace_closest_plain
returns. K2 therefore widens the prune by kPruneMargin (PRUNE_MARGIN
here).

layered_floor makes that likely: a square floor of tiles, each split into
two triangles, at a height float32 cannot represent (z = 0.1), in
clusters of half a row of tiles, so that every shared row edge lies
between two clusters; the floor is repeated in layers one ulp apart, and
the clusters of all layers are shuffled by a seed, so one ray meets
2 x LAYERS boxes that it enters within ulps of each other and triangles
whose t tie or part by an ulp, in an order of cluster ids unrelated to
the order of the walk. edge_rays aims rays at points on shared tile edges
(row, column and diagonal edges, some at vertices) from above, at
elevations from grazing (0.2 degrees) to 60 degrees, half of them in the
plane of the edge.

    python -m vulkan_renderer_tpu_torch.tools.prune_check

prints one JSON line: K2 against trace_closest_plain on the card over
1024 x 1024 rays, exit code 1 on a mismatch.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from ..core.device import get_device
from ..render import trace_kernel as tk
from ..render.clusters import Clusters, build_clusters_np, bvh_children, \
    clusters_from_numpy
from ..render.trace_kernel import inverse_directions

CLUSTER_SIZE = 64
TILES = 64       # a row of tiles is two clusters
LAYERS = 4
FLOOR_Z = 0.1
EXTENT = 1.1     # tile side 2.2 / TILES: no power of two
ANGLE = 0.3      # radians the tile grid is turned about z


def layer_heights() -> np.ndarray:
    """(LAYERS,) float32: float32(FLOOR_Z) and the next floats above."""
    heights = [np.float32(FLOOR_Z)]
    for _ in range(LAYERS - 1):
        heights.append(np.nextafter(heights[-1], np.float32(np.inf)))
    return np.array(heights, np.float32)


def _rotate(x, y):
    c, s = np.cos(ANGLE), np.sin(ANGLE)
    return c * x - s * y, s * x + c * y


def layered_floor() -> np.ndarray:
    """(2 TILES^2 LAYERS, 3, 3) float32 triangles in cluster order: each
    run of CLUSTER_SIZE triangles is half a row of one layer's tiles (the
    tile of corners c00 c10 c11 c01 split along its diagonal into
    (c00, c10, c11) and (c00, c11, c01)), the runs of all layers in a
    seeded order. The tile side and the turn of the grid keep the corners
    off powers of two, so Moeller-Trumbore's t rounds unlike the slab
    test's entry (on axis-aligned tiles a power of two wide both reduce
    to (o_z - z) / d_z)."""
    e = np.linspace(-EXTENT, EXTENT, TILES + 1)
    x, y = _rotate(*np.meshgrid(e, e))
    grid = np.stack([x, y], axis=-1).astype(np.float32)  # (row, column)
    c00 = grid[:-1, :-1].reshape(-1, 2)
    c10 = grid[:-1, 1:].reshape(-1, 2)
    c11 = grid[1:, 1:].reshape(-1, 2)
    c01 = grid[1:, :-1].reshape(-1, 2)
    quad = np.stack([np.stack([c00, c10, c11], 1),
                     np.stack([c00, c11, c01], 1)], 1).reshape(-1, 3, 2)
    runs = []
    for height in layer_heights():
        tri = np.concatenate([quad, np.full(quad.shape[:2] + (1,), height,
                                            np.float32)], axis=-1)
        runs.append(tri.reshape(-1, CLUSTER_SIZE, 3, 3))
    runs = np.concatenate(runs)
    order = np.random.default_rng(0).permutation(runs.shape[0])
    return np.ascontiguousarray(runs[order].reshape(-1, 3, 3), np.float32)


def floor_clusters(triangles: np.ndarray, device) -> Clusters:
    """The port's cluster tables and BVH over `triangles` (normals up,
    uvs and materials 0), in the given order."""
    count = triangles.shape[0]
    normals = np.zeros((count, 3, 3), np.float32)
    normals[..., 2] = 1.0
    return clusters_from_numpy(build_clusters_np(
        triangles, normals, np.zeros((count, 3, 2), np.float32),
        np.zeros(count, np.int32), CLUSTER_SIZE), device)


def edge_rays(count: int):
    """(origins (R, 3), dirs (R, 3), t_max (R,)) float32 CPU tensors: R
    rays aimed from above at points of shared tile edges at FLOOR_Z.
    Each ray picks a row, column or diagonal edge, a point on it (one in
    eight at a vertex), an elevation log-uniform in [0.2, 60] degrees, an
    azimuth along the edge (half the rays) or uniform, and a distance in
    [0.5, 2]; t_max is inf, as for primary rays."""
    rng = np.random.default_rng(1)
    e = np.linspace(-EXTENT, EXTENT, TILES + 1)
    kind = rng.integers(0, 3, count)       # row, column, diagonal
    line = rng.integers(1, TILES, count)   # an interior row/column edge
    cell = rng.integers(0, TILES, (count, 2))
    s = rng.uniform(0.0, 1.0, count)
    snap = rng.uniform(0.0, 1.0, count) < 0.125
    s = np.where(snap, 0.0, s)
    width = e[1] - e[0]
    along = np.where(snap, e[cell[:, 0]], -EXTENT + 2.0 * EXTENT * s)
    across = np.where(snap, e[cell[:, 1]], -EXTENT + 2.0 * EXTENT * s)
    px = np.select([kind == 0, kind == 1], [along, e[line]],
                   e[cell[:, 0]] + width * s)
    py = np.select([kind == 0, kind == 1], [e[line], across],
                   e[cell[:, 1]] + width * s)
    px, py = _rotate(px, py)
    edge_azimuth = ANGLE + np.select([kind == 0, kind == 1],
                                     [0.0, 0.5 * np.pi], 0.25 * np.pi)
    azimuth = np.where(rng.uniform(0.0, 1.0, count) < 0.5,
                       edge_azimuth + np.pi * rng.integers(0, 2, count),
                       rng.uniform(0.0, 2.0 * np.pi, count))
    elevation = np.radians(np.exp(rng.uniform(np.log(0.2), np.log(60.0),
                                              count)))
    dirs = np.stack([np.cos(elevation) * np.cos(azimuth),
                     np.cos(elevation) * np.sin(azimuth),
                     -np.sin(elevation)], axis=-1)
    target = np.stack([px, py, np.full(count, np.float32(FLOOR_Z),
                                        np.float64)], axis=-1)
    origins = target - rng.uniform(0.5, 2.0, (count, 1)) * dirs
    return (torch.from_numpy(origins.astype(np.float32)),
            torch.from_numpy(dirs.astype(np.float32)),
            torch.full((count,), float("inf")))


def at_risk(clusters: Clusters, origins, dirs, prim, t):
    """(R,) bool: the ray hits (prim >= 0) and the slab test, in the
    operations of csrc/common.cuh slab, enters the 8-triangle sub-box of
    the triangle it hits beyond its t. Every box above a sub-box contains
    it and is entered no later, so these are the rays where pruning by the
    best t so far could drop the winner."""
    hit = prim >= 0
    p = prim.clamp(min=0).long()
    k = p // clusters.cluster_size
    g = (p % clusters.cluster_size) // 8
    sub = clusters.subboxes.reshape(clusters.cluster_count, -1, 6)[k, g]
    inv = inverse_directions(dirs)
    t0 = (sub[:, 0:3] - origins) * inv
    t1 = (sub[:, 3:6] - origins) * inv
    near = torch.minimum(t0, t1)
    entry = torch.maximum(torch.maximum(near[:, 0], near[:, 1]), near[:, 2])
    return hit & (entry > t)


# csrc/closest.cu kPruneMargin: the prune keeps a box entered at
# t_near <= best_t + best_t * PRUNE_MARGIN.
PRUNE_MARGIN = 2.0 ** -16


def walk_tables(clusters: Clusters) -> dict:
    """The numpy tables walk_closest_np reads."""
    boxes, refs = bvh_children(clusters.bvh_nodes.cpu().numpy())
    k, c = clusters.cluster_count, clusters.cluster_size
    return dict(boxes=boxes, refs=refs, clusters=k, cluster_size=c,
                planes=clusters.planes.cpu().numpy().reshape(k, 9, c),
                subboxes=clusters.subboxes.cpu().numpy().reshape(k, -1, 6))


def _slab_np(lo, hi, o, inv, cap):
    """csrc/common.cuh slab on one ray in float32: (passes, t_near)."""
    t_near = t_far = None
    for a in range(3):
        t0 = np.float32(lo[a] - o[a]) * inv[a]
        t1 = np.float32(hi[a] - o[a]) * inv[a]
        near = t0 if (t0 < t1 or t0 != t0) else t1
        far = t0 if (t0 > t1 or t0 != t0) else t1
        t_near = near if t_near is None else (
            t_near if (t_near > near or t_near != t_near) else near)
        t_far = far if t_far is None else (
            t_far if (t_far < far or t_far != t_far) else far)
    return bool(t_near <= t_far and t_far >= 0 and t_near <= cap
                and cap >= 0), t_near


def walk_closest_np(tables: dict, origin, direction, t_max,
                    margin: float = PRUNE_MARGIN):
    """K2 on one ray, operation for operation in float32 numpy: the walk
    of csrc/common.cuh walk_bvh and the visit of csrc/closest.cu, with the
    prune's margin a parameter (0 is the bare best t). Returns (prim, t)
    as K2 would; a model of the kernel's order of visits, for showing on
    the CPU what the margin changes."""
    f32 = np.float32
    o = np.asarray(origin, f32)
    d = np.asarray(direction, f32)
    inv = [f32(1.0) / x if abs(x) > f32(1e-20) else f32(1e30) for x in d]
    margin, t_min, t_max = f32(margin), f32(tk.T_MIN), f32(t_max)
    best_t, best = f32(np.inf), -1
    c = tables["cluster_size"]

    def cap():  # best_t > 0; inf * 0 would be NaN
        return best_t if margin == 0 else f32(best_t + f32(best_t * margin))

    def visit(k):
        nonlocal best_t, best
        rows, subs = tables["planes"][k], tables["subboxes"][k]
        dx, dy, dz = d
        for g in range(subs.shape[0]):
            if not _slab_np(subs[g, :3], subs[g, 3:], o, inv, cap())[0]:
                continue
            v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = \
                rows[:, g * 8:min((g + 1) * 8, c)]
            with np.errstate(all="ignore"):
                px = dy * e2z - dz * e2y
                py = dz * e2x - dx * e2z
                pz = dx * e2y - dy * e2x
                det = e1x * px + e1y * py + e1z * pz
                det_ok = np.abs(det) > f32(1e-12)
                inv_det = f32(1.0) / np.where(det_ok, det, f32(1.0))
                tx, ty, tz = o[0] - v0x, o[1] - v0y, o[2] - v0z
                u = (tx * px + ty * py + tz * pz) * inv_det
                qx = ty * e1z - tz * e1y
                qy = tz * e1x - tx * e1z
                qz = tx * e1y - ty * e1x
                v = (dx * qx + dy * qy + dz * qz) * inv_det
                tt = (e2x * qx + e2y * qy + e2z * qz) * inv_det
            hit = det_ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (tt >= t_min)
            for t in np.nonzero(hit)[0]:  # ascending ids, as the kernel
                prim = k * c + g * 8 + int(t)
                if tt[t] < best_t or (tt[t] == best_t and prim < best):
                    best_t, best = tt[t], prim

    stack, ref = [], 0
    while True:
        while ref >= 0:
            (box_l, box_r), (ref_l, ref_r) = tables["boxes"][ref], \
                tables["refs"][ref]
            in_l, t_l = _slab_np(box_l[:3], box_l[3:], o, inv, t_max)
            in_r, t_r = _slab_np(box_r[:3], box_r[3:], o, inv, t_max)
            in_l, in_r = in_l and t_l <= cap(), in_r and t_r <= cap()
            if in_l and in_r:
                right_first = t_r < t_l
                stack.append((ref_l, t_l) if right_first else (ref_r, t_r))
                ref = ref_r if right_first else ref_l
            elif in_l or in_r:
                ref = ref_l if in_l else ref_r
            else:
                ref = None
                while stack and ref is None:
                    ref, t_near = stack.pop()
                    ref = ref if t_near <= cap() else None
                if ref is None:
                    return best, best_t
        if -1 - ref < tables["clusters"]:
            visit(-1 - ref)
        ref = None
        while stack and ref is None:
            ref, t_near = stack.pop()
            ref = ref if t_near <= cap() else None
        if ref is None:
            return best, best_t


def measure(device, rays: int = 1024 * 1024) -> dict:
    """The layered floor and `rays` edge rays on `device`, traced by
    trace_closest (K2 on a card) and trace_closest_plain: mismatches of
    prim and of t's bits (ties included), hits, the rays at risk
    (at_risk), the scene's and the plain version's seconds and,
    on a card, K2's ms (CUDA events, its second call)."""
    device = get_device(device)
    start = time.perf_counter()
    triangles = layered_floor()
    clusters = floor_clusters(triangles, device)
    origins, dirs, t_max = (a.to(device) for a in edge_rays(rays))
    scene_s = time.perf_counter() - start
    prim_k, t_k = tk.trace_closest(clusters, origins, dirs, t_max)
    kernel_ms = None
    if device.type == "cuda":
        events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        events[0].record()
        tk.trace_closest(clusters, origins, dirs, t_max)
        events[1].record()
        torch.cuda.synchronize(device)
        kernel_ms = round(events[0].elapsed_time(events[1]), 4)
    start = time.perf_counter()
    prim_p, t_p = tk.trace_closest_plain(clusters, origins, dirs, t_max)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    plain_s = time.perf_counter() - start
    return {
        "triangles": int(triangles.shape[0]),
        "clusters": clusters.cluster_count, "rays": rays,
        "hits": [int((prim_k >= 0).sum()), int((prim_p >= 0).sum())],
        "prim_mismatches": int((prim_k != prim_p).sum()),
        "t_bit_mismatches": int((t_k.view(torch.int32)
                                 != t_p.view(torch.int32)).sum()),
        "rays_at_risk": int(at_risk(clusters, origins, dirs, prim_p,
                                    t_p).sum()),
        "scene_s": round(scene_s, 3), "kernel_ms": kernel_ms,
        "plain_s": round(plain_s, 3)}


def main() -> int:
    row = measure("cuda")
    print(json.dumps(row), flush=True)
    return int(row["prim_mismatches"] + row["t_bit_mismatches"] > 0)


if __name__ == "__main__":
    sys.exit(main())
