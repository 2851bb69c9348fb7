"""Probes of K1's sub-box gate: does it drop a hit that the Pallas K1 finds?

The Pallas K1 (vulkan_renderer_tpu/render/trace_kernel.py::_anyhit_pass_one)
tests every triangle of each cluster whose box passes the slab test.
K1 (csrc/anyhit.cu) also gates each 8-triangle group on its sub-box, grown
by the bound that its header derives so that the gate keeps every triangle
that Moeller-Trumbore accepts; trace_anyhit_plain has no sub-box gate.
A bare slab test of the sub-box (K1's gate before) drops hits on rays
through vertices and on grazing rays. This module counts, for a scene and
its rays, the rays where a gate changes the answer:

- `slab_gate`: the bare slab test against [0, t_max] (render/
  trace_kernel.py::subbox_candidates), the gate K1 had before;
- `grown_gate`: a float32 torch model of K1's gate, operation for operation;
- on a card, K1 itself against trace_anyhit_plain.

Scenes (PROBES): the small city's and a larger city's vertex rays (one
shadow ray from each of the bench frame's four street lights, jittered by
up to 0.75 m, through each vertex, t_max 1.5 times the distance), and
grazing segments in the planes of tools/prune_check.py's edge-on
triangles and along its slivers and flat slivers (no floor: the segments
from a light at prune_check.EYE to 1.5 times as far as a point of each
part).

    python -m vulkan_renderer_tpu_torch.tools.anyhit_gate_check \
        [--device cpu|cuda] [--probes NAME ...] [--bounds N]

prints one JSON line per probe, and exit code 1 where K1 (on a card) or
the model of its gate parts from the gateless function. --bounds N
instead checks the gate's bound over N x 200,000 random axis triangles
per ray kind on the CPU (bound_ratios).
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from ..core.device import get_device
from ..render import trace_kernel as tk
from ..render.clusters import (KAPPA_MAX, SUB_GROUP, Clusters,
                               cluster_kappa_np, triangle_kappa_np)
from . import prune_check
from .city import make_city

UNIT_ROUNDOFF = prune_check.UNIT_ROUNDOFF
JITTER = 0.75    # m, the vertex rays' light positions
STRETCH = 1.5    # t_max over the distance to the aimed point
# The bench frame's four street lights (tools/bench_frame.py lights).
LIGHTS = np.array([[-30.0 + 20.0 * i, 0.0, 8.0] for i in range(4)],
                  np.float32)


def city_triangles(buildings: int, detail: int) -> np.ndarray:
    tris, _, _, _, _ = make_city(buildings, detail=detail)
    return tris.astype(np.float32)


def vertex_rays(triangles: np.ndarray, seed: int = 0):
    """(origins (R, 3), dirs (R, 3), t_max (R,)) float32 CPU tensors: one
    ray from each of LIGHTS, jittered in x and y by up to JITTER, through
    each distinct vertex of `triangles`, unit directions, t_max STRETCH
    times the distance to the vertex."""
    verts = np.unique(triangles.reshape(-1, 3), axis=0).astype(np.float64)
    rng = np.random.default_rng(seed)
    origins = np.repeat(LIGHTS.astype(np.float64), len(verts), axis=0)
    origins[:, :2] += rng.uniform(-JITTER, JITTER, (len(origins), 2))
    origins = origins.astype(np.float32).astype(np.float64)
    to = np.tile(verts, (len(LIGHTS), 1)) - origins
    dist = np.linalg.norm(to, axis=1)
    return (torch.from_numpy(origins.astype(np.float32)),
            torch.from_numpy((to / dist[:, None]).astype(np.float32)),
            torch.from_numpy((STRETCH * dist).astype(np.float32)))


def thin_edge_triangles() -> np.ndarray:
    """prune_check.thin_edge_parts without the floor above them."""
    return np.ascontiguousarray(np.concatenate(prune_check.thin_edge_parts()),
                                np.float32)


def thin_edge_segments(count: int, seed: int = 5):
    """(origins, dirs, t_max) float32 CPU tensors: `count` segments from
    a light at prune_check.EYE through prune_check.thin_edge_points (in
    the edge-on triangles' planes, along the slivers and the flat
    slivers), to STRETCH times the distance to the point."""
    eye = np.array(prune_check.EYE, np.float32).astype(np.float64)
    to = prune_check.thin_edge_points(count, seed) - eye
    dist = np.linalg.norm(to, axis=1)
    return (torch.from_numpy(np.tile(eye.astype(np.float32),
                                     (to.shape[0], 1))),
            torch.from_numpy((to / dist[:, None]).astype(np.float32)),
            torch.from_numpy((STRETCH * dist).astype(np.float32)))


# name: (triangles, rays)
PROBES = {
    "city_20x3_vertices": (lambda: city_triangles(20, 3),
                           lambda tris: vertex_rays(tris)),
    "city_60x5_vertices": (lambda: city_triangles(60, 5),
                           lambda tris: vertex_rays(tris)),
    "thin_edge_segments": (thin_edge_triangles,
                           lambda tris: thin_edge_segments(96 * 1024)),
}


def slab_gate(clusters, k0, k1, origins, inv, t_max):
    """The bare slab test of each triangle's sub-box: K1's gate before
    its repair."""
    return tk.subbox_candidates(clusters, k0, k1, origins, inv, t_max)


def _scene_scale(clusters: Clusters, origins):
    """csrc/common.cuh floor_scale per ray in float32: (R,) x and y."""
    node = clusters.bvh_nodes[0]
    lo = torch.fmin(node[0:3], node[6:9])
    hi = torch.fmax(node[3:6], node[9:12])
    far = size = None
    for a in range(3):
        f = torch.maximum((lo[a] - origins[:, a]).abs(),
                          (hi[a] - origins[:, a]).abs())
        far = f if far is None else far + f
        s = hi[a] - lo[a]
        size = s if size is None else size + s
    eight_u = 8.0 * UNIT_ROUNDOFF  # a power of two: the kernel's 8.0f * kU
    return eight_u * (2.0 * far + size), eight_u * size.expand_as(far)


def grown_gate(clusters: Clusters):
    """K1's sub-box gate (csrc/anyhit.cu visit and grown_slab) in float32
    torch, operation for operation, as a trace_anyhit_plain subbox_gate."""
    kappa = torch.from_numpy(cluster_kappa_np(
        clusters.planes.cpu().numpy(), clusters.cluster_size)).to(
            clusters.planes.device)
    return lambda c, k0, k1, o, inv, t_max: _grown_mask(
        c, kappa[None, k0:k1], k0, k1, o, inv, t_max)


def _grown_mask(clusters, kap, k0, k1, origins, inv, t_max):
    """(R, k1 - k0, C) bool: grown_gate for clusters k0..k1-1 of kappa
    kap (1, k1 - k0)."""
    sx, sy = _scene_scale(clusters, origins)
    eps = kap * sx[:, None] + sy[:, None]                      # (R, kc)
    gated = (t_max * 1e-18 <= sy)[:, None] & (kap <= KAPPA_MAX) \
        & (eps < 1e8)
    cap = t_max[:, None] * (1.0 + (26.0 + 8.0 * kap) * UNIT_ROUNDOFF)
    g = clusters.subbox_count
    boxes = clusters.subboxes[k0:k1].reshape(k1 - k0, g, 6)
    t_near = t_far = None
    for a in range(3):
        t0 = (boxes[None, :, :, a] - origins[:, None, None, a]) \
            * inv[:, None, None, a]
        t1 = (boxes[None, :, :, 3 + a] - origins[:, None, None, a]) \
            * inv[:, None, None, a]
        w = (eps * inv[:, None, a].abs())[:, :, None]
        near = torch.minimum(t0, t1) - w
        far = torch.maximum(t0, t1) + w
        t_near = near if t_near is None else torch.maximum(t_near, near)
        t_far = far if t_far is None else torch.minimum(t_far, far)
    cap = cap[:, :, None]
    grown = (t_near <= t_far) & (t_far >= 0.0) & (t_near <= cap) \
        & (cap >= 0.0)
    filled = ~torch.isnan(boxes[None, :, :, 0])
    mask = torch.where(gated[:, :, None], grown, filled)
    group_of = torch.arange(clusters.cluster_size,
                            device=origins.device) // SUB_GROUP
    return mask[:, :, group_of]


def count_gates(clusters: Clusters, origins, dirs, t_max) -> dict:
    """The gateless function (trace_anyhit_plain) and the rays where each
    gate model parts from it (gated rays can only lose hits)."""
    plain = tk.trace_anyhit_plain(clusters, origins, dirs, t_max)
    row = {"rays": int(dirs.shape[0]), "occluded": int(plain.sum())}
    for name, gate in (("slab_gate", slab_gate),
                       ("grown_gate", grown_gate(clusters))):
        got = tk.trace_anyhit_plain(clusters, origins, dirs, t_max,
                                    subbox_gate=gate)
        row[f"{name}_parts"] = int((got != plain).sum())
    return row, plain


def measure(device, probe: str) -> dict:
    """A PROBES probe: the gate models' counts (on `device`) and, on a
    card, K1 against trace_anyhit_plain (mismatches, K1's ms by CUDA
    events on its second call)."""
    device = get_device(device)
    start = time.perf_counter()
    make_triangles, make_rays = PROBES[probe]
    triangles = make_triangles()
    clusters = prune_check.floor_clusters(triangles, device)
    origins, dirs, t_max = (a.to(device) for a in make_rays(triangles))
    scene_s = time.perf_counter() - start
    start = time.perf_counter()
    row, plain = count_gates(clusters, origins, dirs, t_max)
    row = {"probe": probe, "triangles": int(triangles.shape[0]),
           "clusters": clusters.cluster_count, **row,
           "scene_s": round(scene_s, 3),
           "models_s": round(time.perf_counter() - start, 3)}
    if device.type == "cuda":
        occ = tk.trace_anyhit(clusters, origins, dirs, t_max)
        events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        events[0].record()
        tk.trace_anyhit(clusters, origins, dirs, t_max)
        events[1].record()
        torch.cuda.synchronize(device)
        row.update(k1_occluded=int(occ.sum()),
                   k1_mismatches=int((occ != plain).sum()),
                   k1_ms=round(events[0].elapsed_time(events[1]), 4))
    return row


# ---------------------------------------------------------------------------
# The bound, on random triangles
# ---------------------------------------------------------------------------

RAY_KINDS = ("vertex", "edge", "graze", "near")


def random_triangles(rng, n: int, axis_aligned: bool):
    """(n, 3, 3) float32 triangles. Axis triangles: 1 cm to 1 m, at
    +-50 m, in a plane normal to a random axis, half of them slivers of
    kappa 1 to 10^4 (prune_check.axis_bound_ratios's). Otherwise vertices
    in [-10, 10]^3 with edges ~N(0, 1)."""
    if not axis_aligned:
        v0 = rng.uniform(-10.0, 10.0, (n, 1, 3))
        tri = np.concatenate([v0, v0 + rng.normal(size=(n, 2, 3))], axis=1)
        return tri.astype(np.float32)
    axis = rng.integers(0, 3, n)
    scale = 10.0 ** rng.uniform(-2, 0, n)
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
    return corners.astype(np.float32)


def random_rays(rng, tri: np.ndarray, kind: str):
    """(origins (n, 3) float32, dirs (n, 3) float32 unit, target (n, 3)
    float64) at each triangle: aimed at a vertex, at a point of an edge,
    from an eye 1e-7 to 1e-2 off the triangle's plane at a vertex, a
    point of an edge or of the inside (graze, a third each), or at a
    point within 10% of it (near); from 0.1 to 300 m."""
    n = tri.shape[0]
    t64 = tri.astype(np.float64)
    w = rng.dirichlet([1.0, 1.0, 1.0], n)
    vertex = np.eye(3)[rng.integers(0, 3, n)]
    edge = w.copy()
    edge[np.arange(n), rng.integers(0, 3, n)] = 0.0
    edge /= edge.sum(axis=1, keepdims=True)
    if kind == "vertex":
        w = vertex
    elif kind == "edge":
        w = edge
    elif kind == "graze":
        third = rng.integers(0, 3, (n, 1))
        w = np.where(third == 0, vertex, np.where(third == 1, edge, w))
    elif kind == "near":
        w *= rng.uniform(0.9, 1.1, (n, 1))
    target = (t64 * w[:, :, None]).sum(axis=1)
    normal = np.cross(t64[:, 1] - t64[:, 0], t64[:, 2] - t64[:, 0])
    with np.errstate(invalid="ignore"):
        normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    if kind == "graze":
        along = rng.normal(size=(n, 3))
        along -= (along * normal).sum(1, keepdims=True) * normal
        along /= np.linalg.norm(along, axis=1, keepdims=True)
        reach = 10.0 ** rng.uniform(-1, 2.5, (n, 1))
        height = 10.0 ** rng.uniform(-7, -2, (n, 1))
        offset = reach * along + height * normal \
            * rng.choice([-1.0, 1.0], (n, 1))
    else:
        d = rng.normal(size=(n, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        offset = 10.0 ** rng.uniform(-1, 2.5, (n, 1)) * d
    origins = (target - offset).astype(np.float32)
    d = target - origins.astype(np.float64)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return origins, d.astype(np.float32), target


def anyhit_np(tri, o, d, t_max, t_min=tk.T_MIN):
    """The division-free Moeller-Trumbore of csrc/anyhit.cu (and the
    Pallas K1, trace_kernel.py:676-692) in float32 numpy, one triangle per
    ray: (accepted (n,) bool, tt / adet in float64)."""
    f32 = np.float32
    v0, e1, e2 = tri[:, 0], tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]
    dx, dy, dz = d.T
    with np.errstate(all="ignore"):
        px = dy * e2[:, 2] - dz * e2[:, 1]
        py = dz * e2[:, 0] - dx * e2[:, 2]
        pz = dx * e2[:, 1] - dy * e2[:, 0]
        det = e1[:, 0] * px + e1[:, 1] * py + e1[:, 2] * pz
        su = np.where(det >= 0, f32(1.0), f32(-1.0))
        adet = det * su
        tx, ty, tz = (o - v0).T
        u = (tx * px + ty * py + tz * pz) * su
        qx = ty * e1[:, 2] - tz * e1[:, 1]
        qy = tz * e1[:, 0] - tx * e1[:, 2]
        qz = tx * e1[:, 1] - ty * e1[:, 0]
        v = (dx * qx + dy * qy + dz * qz) * su
        tt = (e2[:, 0] * qx + e2[:, 1] * qy + e2[:, 2] * qz) * su
        ok = (adet > f32(1e-12)) & (u >= 0) & (v >= 0) & (u + v <= adet) \
            & (tt >= f32(t_min) * adet) & (tt <= t_max * adet)
        return ok, tt.astype(np.float64) / adet.astype(np.float64)


def _inverse_np(d):
    f32 = np.float32
    with np.errstate(divide="ignore"):
        return np.where(np.abs(d) > f32(1e-20),
                        f32(1.0) / np.where(np.abs(d) > f32(1e-20), d,
                                            f32(1.0)), f32(1e30))


def _slab_np(lo, hi, o, inv, t_cap, w=None):
    """common.cuh slab (w None) or csrc/anyhit.cu grown_slab in float32
    numpy, one box per ray."""
    t_near = t_far = None
    for a in range(3):
        t0 = (lo[:, a] - o[:, a]) * inv[:, a]
        t1 = (hi[:, a] - o[:, a]) * inv[:, a]
        near, far = np.minimum(t0, t1), np.maximum(t0, t1)
        if w is not None:
            near, far = near - w[:, a], far + w[:, a]
        t_near = near if t_near is None else np.maximum(t_near, near)
        t_far = far if t_far is None else np.minimum(t_far, far)
    return (t_near <= t_far) & (t_far >= 0) & (t_near <= t_cap) \
        & (t_cap >= 0)


def gate_np(lo, hi, scene_lo, scene_hi, kappa, o, d, t_max):
    """K1's gate on one box per ray in float32 numpy (csrc/anyhit.cu
    visit): the grown slab where the bound holds, else the box is kept.
    Returns (gate, eps, eta) with eps and eta the margins taken."""
    f32 = np.float32
    inv = _inverse_np(d)
    far = size = f32(0.0)
    for a in range(3):
        far = far + np.maximum(np.abs(scene_lo[:, a] - o[:, a]),
                               np.abs(scene_hi[:, a] - o[:, a]))
        size = size + (scene_hi[:, a] - scene_lo[:, a])
    eight_u = f32(8.0 * UNIT_ROUNDOFF)
    sx, sy = eight_u * (f32(2.0) * far + size), eight_u * size
    with np.errstate(invalid="ignore", over="ignore"):
        eps = kappa * sx + sy
        gated = (t_max * f32(1e-18) <= sy) & (kappa <= f32(KAPPA_MAX)) \
            & (eps < f32(1e8))
        eta = (f32(26.0) + f32(8.0) * kappa) * f32(UNIT_ROUNDOFF)
        cap = t_max * (f32(1.0) + eta)
        w = eps[:, None] * np.abs(inv)
        grown = _slab_np(lo, hi, o, inv, cap, w)
    return np.where(gated, grown, True), eps, eta


def bound_ratios(count: int = 200_000, seed: int = 0,
                 axis_aligned: bool = True, kind: str = "vertex") -> dict:
    """`count` random triangles (random_triangles) and a ray each
    (random_rays of `kind`); t_max is 1.5 t* for half of them and within
    1e-8 to 1e-5 relative of t* (either side) for the rest. Over the hits
    that Moeller-Trumbore accepts (anyhit_np): how many the bare slab test
    of the triangle's box drops (the gate before the repair) and how many
    K1's gate drops (gate_np, with the triangle's own box as the scene's,
    which gives the least eps); the largest L-infinity distance of the
    ray's exact point on the plane from that box over eps, and over the
    bound's term u (kappa (|T| + t*) + |e1| + |e2|) (header of
    csrc/anyhit.cu, (2)); and the largest t* / t_max - 1 over eta, and
    over (6 + 4 kappa) u ((1)). Axis triangles only: the gate is off for
    any other."""
    rng = np.random.default_rng(seed)
    tri = random_triangles(rng, count, axis_aligned)
    o, d, target = random_rays(rng, tri, kind)
    T64, O64, D64 = (x.astype(np.float64) for x in (tri, o, d))
    V0, E1, E2 = T64[:, 0], T64[:, 1] - T64[:, 0], T64[:, 2] - T64[:, 0]
    e1 = (tri[:, 1] - tri[:, 0]).astype(np.float64)
    e2 = (tri[:, 2] - tri[:, 0]).astype(np.float64)
    N = np.cross(e1, e2)
    with np.errstate(all="ignore"):
        t_star = ((V0 - O64) * N).sum(1) / (D64 * N).sum(1)
    rel = 10.0 ** rng.uniform(-8, -5, count) * rng.choice([-1.0, 1.0],
                                                          count)
    tight = rng.uniform(size=count) < 0.5
    t_max = np.where(tight, t_star * (1.0 + rel), STRETCH * t_star)
    t_max = np.where(np.isfinite(t_max), t_max, 1.0).astype(np.float32)
    ok, _ = anyhit_np(tri, o, d, t_max)
    lo, hi = tri.min(axis=1), tri.max(axis=1)
    slab = _slab_np(lo, hi, o, _inverse_np(d), t_max)
    kappa = triangle_kappa_np(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    gate, eps, eta = gate_np(lo, hi, lo, hi, kappa, o, d, t_max)
    k64 = kappa.astype(np.float64)
    with np.errstate(all="ignore"):
        point = O64 + t_star[:, None] * D64
        out = np.maximum(np.maximum(lo - point, point - hi), 0.0).max(1)
        term = UNIT_ROUNDOFF * (k64 * (np.linalg.norm(O64 - V0, axis=1)
                                       + np.abs(t_star))
                                + np.linalg.norm(e1, axis=1)
                                + np.linalg.norm(e2, axis=1))
        over = t_star / t_max.astype(np.float64) - 1.0
    bounded = ok & np.isfinite(k64) & (t_star > 0)
    row = {"kind": kind, "axis": axis_aligned, "triangles": count,
           "hits": int(ok.sum()), "slab_drops": int((ok & ~slab).sum()),
           "gate_drops": int((ok & ~gate).sum())}
    if axis_aligned and bounded.any():
        row.update(
            eps_ratio=float((out / eps)[bounded].max()),
            lateral_ratio=float((out / term)[bounded].max()),
            eta_ratio=float((over / eta)[bounded].max()),
            t_ratio=float((over / ((6.0 + 4.0 * k64) * UNIT_ROUNDOFF))
                          [bounded].max()))
    return row


def bounds(rounds: int) -> list:
    """bound_ratios over `rounds` seeds for each ray kind, axis and
    general triangles, merged per (kind, axis)."""
    rows = []
    for axis_aligned in (True, False):
        for kind in RAY_KINDS:
            parts = [bound_ratios(seed=s, axis_aligned=axis_aligned,
                                  kind=kind) for s in range(rounds)]
            row = {"kind": kind, "axis": axis_aligned}
            for key in ("triangles", "hits", "slab_drops", "gate_drops"):
                row[key] = sum(p[key] for p in parts)
            for key in ("eps_ratio", "lateral_ratio", "eta_ratio",
                        "t_ratio"):
                vals = [p[key] for p in parts if key in p]
                if vals:
                    row[key] = max(vals)
            rows.append(row)
    return rows


def main(argv=None) -> int:
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--probes", nargs="*", default=list(PROBES))
    parser.add_argument("--bounds", type=int, default=0, metavar="ROUNDS",
                        help="instead, run bound_ratios ROUNDS times "
                        "(200,000 triangles each) per ray kind on the CPU")
    args = parser.parse_args(argv)
    if args.bounds:
        rows = bounds(args.bounds)
        for row in rows:
            print(json.dumps(row), flush=True)
        return int(any(r["gate_drops"] for r in rows))
    bad = 0
    for probe in args.probes:
        row = measure(args.device, probe)
        print(json.dumps(row), flush=True)
        bad += row["grown_gate_parts"] + row.get("k1_mismatches", 0)
    return int(bad > 0)


if __name__ == "__main__":
    sys.exit(main())
