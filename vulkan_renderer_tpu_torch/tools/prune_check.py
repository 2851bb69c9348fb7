"""Scenes built to provoke K2's prune, and the rays that probe them.

K2 (csrc/closest.cu) walks the cluster BVH and drops a box whose entry
lies beyond the best t found so far. The entry comes from the slab test
and the best t from Moeller-Trumbore: two roundings of one distance,
which can part, so a box can be entered beyond the t at which its own
triangle is hit. If a hit found earlier in the walk lies in between, the
prune drops the box, and K2 returns that hit instead of the
lexicographic minimum of (t, prim) that trace_closest_plain returns.
K2 therefore drops a box only past hit_t_floor, a lower bound on the
computed t of any hit inside it (the header of csrc/closest.cu derives
it; axis_bound_ratios checks its two error terms).

layered_floor makes the few-ulp case likely: a square floor of tiles,
each split into two triangles, at a height float32 cannot represent (z =
0.1), in clusters of half a row of tiles, so that every shared row edge
lies between two clusters; the floor is repeated in layers one ulp
apart, and the clusters of all layers are shuffled by a seed, so one ray
meets 2 x LAYERS boxes that it enters within ulps of each other and
triangles whose t tie or part by an ulp, in an order of cluster ids
unrelated to the order of the walk. edge_rays aims rays at points on
shared tile edges (row, column and diagonal edges, some at vertices)
from above, at elevations from grazing (0.2 degrees) to 60 degrees, half
of them in the plane of the edge. thin_edge_scene adds, under that
floor, triangles whose computed t can fall far short of their boxes:
edge-on triangles in planes through one eye, slivers and flat slivers;
thin_edge_rays leave that eye. walk_closest_np models K2's walk in
float32 numpy with the kernel's prune or the flat ones before it.

    python -m vulkan_renderer_tpu_torch.tools.prune_check [--bounds N]

prints one JSON line per scene: K2 against trace_closest_plain on the
card over 1024 x 1024 rays, exit code 1 on a mismatch.
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


# thin_edge_scene: the eye all its rays leave from, and its parts.
EYE = (0.37, -0.21, 1.3)
EDGE_ON = 2048
SLIVERS = 2048
FLAT_SLIVERS = 1024


def _per_cluster(depth: np.ndarray) -> np.ndarray:
    """The first depth of each run of CLUSTER_SIZE, for the whole run:
    a cluster's triangles lie at one depth under the floor, so its boxes
    are entered there and not at its shallowest neighbour's."""
    return np.repeat(depth[::CLUSTER_SIZE], CLUSTER_SIZE)[:depth.shape[0]]


def thin_edge_parts(seed: int = 3) -> tuple:
    """(edge_on, slivers, flat_slivers) (N, 3, 3) float32 triangles of
    thin_edge_scene."""
    rng = np.random.default_rng(seed)
    eye = np.array(EYE, np.float64)
    z_floor = float(np.float32(FLOOR_Z))
    az = rng.uniform(0.0, 2.0 * np.pi, EDGE_ON)
    along = np.stack([np.cos(az), np.sin(az), np.zeros(EDGE_ON)], axis=1)
    base = eye + rng.uniform(0.3, 1.0, (EDGE_ON, 1)) * along
    length = rng.uniform(0.02, 0.1, (EDGE_ON, 1))
    top = z_floor - _per_cluster(rng.uniform(0.0005, 0.05, EDGE_ON))
    p0, p1 = base.copy(), base + length * along
    p2 = base + 0.5 * length * along
    p0[:, 2] = p1[:, 2] = top
    p2[:, 2] = top - rng.uniform(0.02, 0.1, EDGE_ON)
    edge_on = np.stack([p0, p1, p2], axis=1)

    centre = np.stack([rng.uniform(-1.0, 1.0, SLIVERS),
                       rng.uniform(-1.0, 1.0, SLIVERS),
                       z_floor - _per_cluster(
                           10.0 ** rng.uniform(-5, -2, SLIVERS))], 1)
    axis = rng.normal(size=(SLIVERS, 3)) * [1.0, 1.0, 0.0]
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    side = np.cross(axis, rng.normal(size=(SLIVERS, 3)))
    side /= np.linalg.norm(side, axis=1, keepdims=True)
    half = 0.5 * rng.uniform(0.02, 0.2, (SLIVERS, 1)) * axis
    width = 10.0 ** rng.uniform(-9, -6, (SLIVERS, 1))
    slivers = np.stack([centre - half, centre + half,
                        centre + width * side], axis=1)

    centre = np.stack([rng.uniform(-1.0, 1.0, FLAT_SLIVERS),
                       rng.uniform(-1.0, 1.0, FLAT_SLIVERS),
                       z_floor - _per_cluster(
                           10.0 ** rng.uniform(-6, -3, FLAT_SLIVERS))], 1)
    az = rng.uniform(0.0, 2.0 * np.pi, FLAT_SLIVERS)
    axis = np.stack([np.cos(az), np.sin(az), np.zeros(FLAT_SLIVERS)], 1)
    side = np.stack([-axis[:, 1], axis[:, 0], np.zeros(FLAT_SLIVERS)], 1)
    length = rng.uniform(0.02, 0.2, (FLAT_SLIVERS, 1))
    width = length * 10.0 ** rng.uniform(-7, -2, (FLAT_SLIVERS, 1))
    flat = np.stack([centre - 0.5 * length * axis,
                     centre + 0.5 * length * axis,
                     centre + width * side], axis=1)

    return tuple(a.astype(np.float32) for a in (edge_on, slivers, flat))


def thin_edge_scene(seed: int = 3) -> np.ndarray:
    """(T, 3, 3) float32 triangles in cluster order: layered_floor, and
    below it, in clusters of their own among the floor's (runs of
    CLUSTER_SIZE in a seeded order), thin_edge_parts:
    - EDGE_ON vertical triangles in vertical planes through EYE (to the
      float32 rounding of their corners), 0.5 mm to 5 cm under the floor
      and 0.3 to 1.1 m out: a ray from EYE at one lies in its plane, so
      det and t's numerator are rounding residues and the computed t
      lands up to ~40% off its true value;
    - SLIVERS needles 2-20 cm long, level, and 1e-9 to 1e-6 m wide
      towards any side (the narrowest collinear in float32), 1e-5 to 1e-2 m under the floor: |det| between ~1e-12
      and ~1e-8 for the rays aimed along them;
    - FLAT_SLIVERS needles in the plane z = const 1e-6 to 1e-3 m under
      the floor, axis triangles of sliver factor 1e2 to 1e7 (past
      KAPPA_MAX some are never pruned).
    Every part lies where a ray meets the floor first, within 1e-6 to 1e-1
    relative of its t: the prune decides whether the walk tests them."""
    rng = np.random.default_rng(seed)
    extra = np.concatenate(thin_edge_parts(seed))
    runs = np.concatenate([layered_floor().reshape(-1, CLUSTER_SIZE, 3, 3),
                           extra.reshape(-1, CLUSTER_SIZE, 3, 3)])
    order = rng.permutation(runs.shape[0])
    return np.ascontiguousarray(runs[order].reshape(-1, 3, 3), np.float32)


def thin_edge_points(count: int, seed: int = 4) -> np.ndarray:
    """(count, 3) float64 points: a third in the edge-on triangles, a
    third on the slivers' long edges and a third on the flat slivers'
    (thin_edge_parts)."""
    groups = [a.astype(np.float64) for a in thin_edge_parts()]
    rng = np.random.default_rng(seed)
    points = []
    for i, group in enumerate(groups):
        n = count // 3 + (count % 3 > i)
        pick = group[rng.integers(0, group.shape[0], n)]
        w = rng.uniform(0.0, 1.0, (n, 2))
        if i == 0:  # anywhere in the triangle
            flip = w.sum(axis=1) > 1.0
            w[flip] = 1.0 - w[flip]
        else:       # along the long edge
            w[:, 1] = 0.0
        points.append(pick[:, 0] + w[:, :1] * (pick[:, 1] - pick[:, 0])
                      + w[:, 1:] * (pick[:, 2] - pick[:, 0]))
    return np.concatenate(points)


def thin_edge_rays(count: int, seed: int = 4):
    """(origins, dirs, t_max) float32 CPU tensors: `count` rays from EYE
    aimed at thin_edge_points; t_max is inf."""
    dirs = thin_edge_points(count, seed) - np.array(EYE, np.float64)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    origins = np.broadcast_to(np.array(EYE, np.float32), dirs.shape)
    return (torch.from_numpy(np.ascontiguousarray(origins)),
            torch.from_numpy(dirs.astype(np.float32)),
            torch.full((count,), float("inf")))


SCENES = {"layered_floor": (layered_floor, edge_rays),
          "thin_edge": (thin_edge_scene, thin_edge_rays)}


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


# The flat prune K2 had before its hit floor (a box kept while its entry
# t_near <= best_t + best_t * FLAT_MARGIN), for walk_closest_np's margin.
FLAT_MARGIN = 2.0 ** -16
# csrc/closest.cu kU and kKappaMax.
UNIT_ROUNDOFF = 2.0 ** -24
KAPPA_MAX = 2.0 ** 20


def walk_tables(clusters: Clusters) -> dict:
    """The numpy tables walk_closest_np reads."""
    nodes = clusters.bvh_nodes.cpu().numpy()
    boxes, refs = bvh_children(nodes)
    k, c = clusters.cluster_count, clusters.cluster_size
    return dict(boxes=boxes, refs=refs, kappas=nodes[:, 14:16].copy(),
                clusters=k, cluster_size=c,
                planes=clusters.planes.cpu().numpy().reshape(k, 9, c),
                subboxes=clusters.subboxes.cpu().numpy().reshape(k, -1, 6))


def _slab_np(lo, hi, o, inv, cap):
    """csrc/closest.cu slab_entry on one ray in float32: (passes, t_near,
    |1/d| of the entry axis)."""
    t_near = t_far = inv_entry = None
    for a in range(3):
        t0 = np.float32(lo[a] - o[a]) * inv[a]
        t1 = np.float32(hi[a] - o[a]) * inv[a]
        near = t0 if (t0 < t1 or t0 != t0) else t1
        far = t0 if (t0 > t1 or t0 != t0) else t1
        if t_near is None:
            t_near, t_far, inv_entry = near, far, abs(inv[a])
            continue
        inv_entry = abs(inv[a]) if near >= t_near else inv_entry
        t_near = t_near if (t_near > near or t_near != t_near) else near
        t_far = t_far if (t_far < far or t_far != t_far) else far
    return bool(t_near <= t_far and t_far >= 0 and t_near <= cap
                and cap >= 0), t_near, inv_entry


def floor_scale_np(tables: dict, o) -> tuple:
    """csrc/closest.cu floor_scale in float32: (kappa's factor, the
    constant) of eps from the scene's box (the root's children's union)."""
    f32 = np.float32
    (box_l, box_r) = tables["boxes"][0]
    lo = np.fmin(box_l[:3], box_r[:3])
    hi = np.fmax(box_l[3:], box_r[3:])
    far = size = f32(0.0)
    for a in range(3):
        far = far + max(abs(f32(lo[a] - o[a])), abs(f32(hi[a] - o[a])))
        size = size + f32(hi[a] - lo[a])
    eight_u = f32(8.0 * UNIT_ROUNDOFF)
    return eight_u * (f32(2.0) * far + size), eight_u * size


def hit_t_floor_np(t_near, inv_entry, kappa, scale):
    """csrc/closest.cu hit_t_floor in float32: a lower bound on the
    computed t of a hit on any triangle of the box, -inf where none."""
    f32 = np.float32
    if not (kappa <= KAPPA_MAX and inv_entry < f32(1e30) and t_near > 0):
        return f32(-np.inf)
    kappa = f32(kappa)
    eps = kappa * scale[0] + scale[1]
    eta = (f32(26.0) + f32(8.0) * kappa) * f32(UNIT_ROUNDOFF)
    return (t_near - eps * inv_entry) * (f32(1.0) - eta)


def walk_closest_np(tables: dict, origin, direction, t_max,
                    margin: float | None = None):
    """K2 on one ray, operation for operation in float32 numpy: the walk
    and visit of csrc/closest.cu. With margin None the prune is the
    kernel's (a box dropped when hit_t_floor_np > best t); a float gives
    the flat prune of earlier kernels instead (a box dropped when entered
    beyond best_t + best_t * margin; 0 is the bare best t). Returns
    (prim, t) as K2 would; a model of the kernel's order of visits, for
    showing on the CPU what the prune changes."""
    f32 = np.float32
    o = np.asarray(origin, f32)
    d = np.asarray(direction, f32)
    inv = [f32(1.0) / x if abs(x) > f32(1e-20) else f32(1e30) for x in d]
    t_min, t_max = f32(tk.T_MIN), f32(t_max)
    best_t, best = f32(np.inf), -1
    c = tables["cluster_size"]

    scale = floor_scale_np(tables, o)

    def floor(t_near, inv_entry, kappa):
        if margin is None:
            return hit_t_floor_np(t_near, inv_entry, kappa, scale)
        return t_near

    def keep(value):
        if margin is None:
            return not value > best_t
        if margin == 0:  # inf * 0 would be NaN
            return value <= best_t
        return value <= f32(best_t + f32(best_t * f32(margin)))

    def visit(k, kappa):
        nonlocal best_t, best
        rows, subs = tables["planes"][k], tables["subboxes"][k]
        dx, dy, dz = d
        for g in range(subs.shape[0]):
            ok, t_sub, inv_sub = _slab_np(subs[g, :3], subs[g, 3:], o, inv,
                                          t_max)
            if not ok or not keep(floor(t_sub, inv_sub, kappa)):
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

    stack, ref, ref_kappa = [], 0, np.inf

    def pop():
        while stack:
            entry = stack.pop()
            if keep(entry[1]):
                return entry[0], entry[2]
        return None, None

    while True:
        while ref >= 0:
            (box_l, box_r), (ref_l, ref_r) = tables["boxes"][ref], \
                tables["refs"][ref]
            kap_l, kap_r = tables["kappas"][ref]
            pass_l, t_l, inv_l = _slab_np(box_l[:3], box_l[3:], o, inv, t_max)
            pass_r, t_r, inv_r = _slab_np(box_r[:3], box_r[3:], o, inv, t_max)
            fl_l = floor(t_l, inv_l, kap_l) if pass_l else f32(0)
            fl_r = floor(t_r, inv_r, kap_r) if pass_r else f32(0)
            in_l, in_r = pass_l and keep(fl_l), pass_r and keep(fl_r)
            if in_l and in_r:
                right_first = t_r < t_l
                stack.append((ref_l, fl_l, kap_l) if right_first
                             else (ref_r, fl_r, kap_r))
                ref, ref_kappa = (ref_r, kap_r) if right_first \
                    else (ref_l, kap_l)
            elif in_l or in_r:
                ref, ref_kappa = (ref_l, kap_l) if in_l else (ref_r, kap_r)
            else:
                ref, ref_kappa = pop()
                if ref is None:
                    return best, best_t
        if -1 - ref < tables["clusters"]:
            visit(-1 - ref, ref_kappa)
        ref, ref_kappa = pop()
        if ref is None:
            return best, best_t


def axis_bound_ratios(count: int = 200_000, seed: int = 0) -> dict:
    """Checks the two error terms of K2's hit floor (csrc/closest.cu
    header) in float32 numpy: `count` random axis triangles (1 cm to 1 m,
    at +-50 m, half of them slivers of kappa 1 to 10^4) and a ray each,
    aimed at a point of an edge or near the triangle from 0.1 to 300 m,
    half of them 10^-6 to 1 rad off its plane. Over the computed hits (Moeller-Trumbore as in
    closest_kernel), the largest of (t* - t) / (t* (5 + 4 kappa) u) and of
    the distance from the ray's exact meeting with the plane to the
    triangle over u (kappa (|T| + t*) + |e1| + |e2|); the kernel's bound
    takes at least 2 and 4 of them."""
    f32 = np.float64(UNIT_ROUNDOFF)
    rng = np.random.default_rng(seed)
    n = count
    axis = rng.integers(0, 3, n)
    scale = 10.0 ** rng.uniform(-2, 2, n)
    centre = rng.uniform(-50.0, 50.0, (n, 3))
    a = rng.normal(size=(n, 2))
    kappa = 10.0 ** rng.uniform(0, 4, n)
    b = np.where((rng.uniform(size=n) < 0.5)[:, None],
                 a + rng.normal(size=(n, 2)) / kappa[:, None],
                 rng.normal(size=(n, 2)))
    corners = np.repeat(centre[:, None], 3, axis=1)
    for k in range(3):
        m = axis == k
        i, j = (k + 1) % 3, (k + 2) % 3
        for c, off in ((1, a), (2, b)):
            corners[m, c, i] += scale[m] * off[m, 0]
            corners[m, c, j] += scale[m] * off[m, 1]
    tri = corners.astype(np.float32)
    v0, e1, e2 = tri[:, 0], tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]
    w = rng.dirichlet([1.0, 1.0, 1.0], n)
    on_edge = rng.uniform(size=n) < 0.5  # half on an edge, half near
    w[on_edge, rng.integers(0, 3, int(on_edge.sum()))] = 0.0
    w /= w.sum(axis=1, keepdims=True)
    w[~on_edge] *= rng.uniform(0.9, 1.1, (int((~on_edge).sum()), 1))
    target = (tri.astype(np.float64) * w[:, :, None]).sum(axis=1)
    d = rng.normal(size=(n, 3))
    normal = np.eye(3)[axis]
    graze = (rng.uniform(size=n) < 0.5)[:, None]
    tilt = 1.0 - 10.0 ** rng.uniform(-6, 0, (n, 1))
    d = np.where(graze, d - (d * normal).sum(1, keepdims=True) * normal
                 * tilt, d)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = (target - 10.0 ** rng.uniform(-1, 2.5, (n, 1)) * d) \
        .astype(np.float32)
    d = d.astype(np.float32)
    with np.errstate(all="ignore"):
        px = d[:, 1] * e2[:, 2] - d[:, 2] * e2[:, 1]
        py = d[:, 2] * e2[:, 0] - d[:, 0] * e2[:, 2]
        pz = d[:, 0] * e2[:, 1] - d[:, 1] * e2[:, 0]
        det = e1[:, 0] * px + e1[:, 1] * py + e1[:, 2] * pz
        ok = np.abs(det) > np.float32(1e-12)
        inv = np.float32(1.0) / np.where(ok, det, np.float32(1.0))
        tx, ty, tz = (o - v0).T
        u = (tx * px + ty * py + tz * pz) * inv
        qx = ty * e1[:, 2] - tz * e1[:, 1]
        qy = tz * e1[:, 0] - tx * e1[:, 2]
        qz = tx * e1[:, 1] - ty * e1[:, 0]
        v = (d[:, 0] * qx + d[:, 1] * qy + d[:, 2] * qz) * inv
        t = (e2[:, 0] * qx + e2[:, 1] * qy + e2[:, 2] * qz) * inv
        hit = ok & (u >= 0) & (v >= 0) & (u + v <= 1) \
            & (t >= np.float32(tk.T_MIN))
        O, D, V0, E1, E2 = (x.astype(np.float64) for x in (o, d, v0, e1, e2))
        N = np.cross(E1, E2)
        t_star = ((V0 - O) * N).sum(1) / (D * N).sum(1)
        R = O + t_star[:, None] * D - V0
        g11, g12, g22 = (E1 * E1).sum(1), (E1 * E2).sum(1), (E2 * E2).sum(1)
        r1, r2 = (R * E1).sum(1), (R * E2).sum(1)
        den = g11 * g22 - g12 * g12
        us, vs = (g22 * r1 - g12 * r2) / den, (g11 * r2 - g12 * r1) / den
        k = np.sqrt(g11 * g22) / np.linalg.norm(N, axis=1)
        area2 = np.linalg.norm(N, axis=1)
        outside = (np.maximum(-us, 0.0) * area2 / np.sqrt(g22)
                   + np.maximum(-vs, 0.0) * area2 / np.sqrt(g11)
                   + np.maximum(us + vs - 1.0, 0.0) * area2
                   / np.linalg.norm(E2 - E1, axis=1))
        edges = np.sqrt(g11) + np.sqrt(g22)
        T = np.linalg.norm(O - V0, axis=1)
        live = hit & (t_star > 0) & np.isfinite(k)
        t_ratio = (t_star - t) / t_star / (f32 * (5.0 + 4.0 * k))
        side_ratio = outside / (f32 * (k * (T + t_star) + edges))
    return {"hits": int(live.sum()),
            "t_ratio": float(t_ratio[live].max()),
            "lateral_ratio": float(side_ratio[live].max())}


def measure(device, rays: int = 1024 * 1024,
            scene: str = "layered_floor") -> dict:
    """A SCENES scene and `rays` of its rays on `device`, traced by
    trace_closest (K2 on a card) and trace_closest_plain: mismatches of
    prim and of t's bits (ties included), hits, the rays at risk
    (at_risk), the scene's and the plain version's seconds and,
    on a card, K2's ms (CUDA events, its second call)."""
    device = get_device(device)
    start = time.perf_counter()
    build_scene, make_rays = SCENES[scene]
    triangles = build_scene()
    clusters = floor_clusters(triangles, device)
    origins, dirs, t_max = (a.to(device) for a in make_rays(rays))
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
        "scene": scene, "triangles": int(triangles.shape[0]),
        "clusters": clusters.cluster_count, "rays": rays,
        "hits": [int((prim_k >= 0).sum()), int((prim_p >= 0).sum())],
        "prim_mismatches": int((prim_k != prim_p).sum()),
        "t_bit_mismatches": int((t_k.view(torch.int32)
                                 != t_p.view(torch.int32)).sum()),
        "rays_at_risk": int(at_risk(clusters, origins, dirs, prim_p,
                                    t_p).sum()),
        "scene_s": round(scene_s, 3), "kernel_ms": kernel_ms,
        "plain_s": round(plain_s, 3)}


def main(argv=None) -> int:
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--bounds", type=int, default=0, metavar="ROUNDS",
                        help="instead, run axis_bound_ratios ROUNDS times "
                        "(200,000 triangles each) on the CPU")
    args = parser.parse_args(argv)
    if args.bounds:
        rows = [axis_bound_ratios(seed=i) for i in range(args.bounds)]
        print(json.dumps({"triangles": 200_000 * args.bounds,
                          "hits": sum(r["hits"] for r in rows),
                          "t_ratio": max(r["t_ratio"] for r in rows),
                          "lateral_ratio": max(r["lateral_ratio"]
                                               for r in rows)}))
        return 0
    bad = 0
    for scene in SCENES:
        row = measure("cuda", scene=scene)
        print(json.dumps(row), flush=True)
        bad += row["prim_mismatches"] + row["t_bit_mismatches"]
    return int(bad > 0)


if __name__ == "__main__":
    sys.exit(main())
