"""Ray tracers over the cluster tables: kernels K1, K2, K3 and their plain
PyTorch versions.

Replaces the Pallas kernels of vulkan_renderer_tpu/render/trace_kernel.py:

- K1 trace_anyhit (csrc/anyhit.cu) <- _anyhit_pass_one (:637): shadow
  any-hit, division-free Moeller-Trumbore (:676-692) over every triangle
  of each cluster whose box passes, t in [t_min, t_max], no backface
  culling, t_max < 0 marks a dead ray. trace_anyhit_slots, K1's entry on
  the frame's path, reads the rays in place from K4's slot planes, traces
  a pixel's slots in packets of rays from one origin and returns the
  combined colors; its plain version is the ray list (shadow_megabatch),
  trace_anyhit_plain and shadow_combine.
- K2 trace_closest (csrc/closest.cu) <- _closest_pass_one (:949): primary
  closest hit, reciprocal-det Moeller-Trumbore (:1013-1028), the
  lexicographic minimum of (t, primitive id), so ties keep the lower id.
- K3 closest_attrs (csrc/closest.cu) <- _attr_pass_one (:1224) plus the
  XLA finalize _attrs_finalize (:1311): the winner's 25 scalars, then
  barycentrics, UV derivatives, normal and tangent frame.

The CUDA tracers walk one BVH over the clusters (render/clusters.py
build_cluster_bvh_np), then each reached cluster's 8-triangle sub-boxes,
then their triangles, exact by construction: the TPU build's work-item
cull, budgets, re-trace, seeds and stale-attribute fixup have no
counterpart. The plain versions test, with the kernels' per-triangle
formulas, every triangle of every cluster box that passes its slab test
against [0, t_max] (brute force inside the cull) -- K2's also needs the
triangle's sub-box to pass, as the Pallas K2 does; K1's, like the Pallas
K1, does not. The candidates are the same: a cluster box that passes
implies that every box above it in the tree passes, since a parent's box
contains its children's and the slab arithmetic rounds monotonically.
K1's own sub-box gate is conservative, so it drops no hit that the plain
version finds (csrc/anyhit.cu header; tools/anyhit_gate_check.py).
"""

from __future__ import annotations

import ctypes

import torch

from ..core import trace
from ..kernels import build
from .clusters import SUB_GROUP, Clusters

T_MIN = 1.0e-3

# Attribute planes of K3 (trace_kernel.py:1184-1193).
ATTR_NORMAL = 0      # 3: interpolated shading normal (normalized)
ATTR_UV = 3          # 2
ATTR_DUVDX = 5       # 2: d(uv)/d(pixel x)
ATTR_DUVDY = 7       # 2
ATTR_TANGENT = 9     # 3: unnormalized tangent from UV edges
ATTR_BITANGENT = 12  # 3
ATTR_MTL = 15        # 1: mean tangent length
ATTR_MATERIAL = 16   # 1: material index (exact float)
ATTR_FOUND = 17      # 1: 1.0 for a hit
ATTR_PLANES = 18
ACC_PLANES = 26      # v0 e1 e2 n0 n1 n2 (3 each) uv0 uv1 uv2 (2 each) mat found

_RAY_CHUNK = 4096  # rays per step of the plain tracers


def _pair_budget(device: torch.device) -> int:
    """Ray x triangle pairs per plain-tracer step (bounded intermediates:
    ~30 live float tensors of this many elements)."""
    return 1 << (24 if device.type == "cuda" else 22)


# ---------------------------------------------------------------------------
# Slab test and cluster culls (plain)
# ---------------------------------------------------------------------------


def inverse_directions(dirs: torch.Tensor) -> torch.Tensor:
    """Per-axis 1/d, 1e30 where |d| <= 1e-20 (trace_kernel.py:529)."""
    ok = torch.abs(dirs) > 1e-20
    return torch.where(ok, 1.0 / torch.where(ok, dirs, 1.0), 1e30)


def ray_box_slab(lo, hi, origins, inv, t_cap):
    """(R,) rays x (B,) boxes slab test -> (mask (R, B), t_near (R, B)).

    torch.minimum/maximum propagate NaN, so a NaN (padding) box fails every
    comparison and never hits (trace_kernel.py:521-538)."""
    t_near = t_far = None
    for a in range(3):
        t0 = (lo[None, :, a] - origins[:, None, a]) * inv[:, None, a]
        t1 = (hi[None, :, a] - origins[:, None, a]) * inv[:, None, a]
        near = torch.minimum(t0, t1)
        far = torch.maximum(t0, t1)
        t_near = near if t_near is None else torch.maximum(t_near, near)
        t_far = far if t_far is None else torch.minimum(t_far, far)
    tc = t_cap[:, None]
    return (t_near <= t_far) & (t_far >= 0.0) & (t_near <= tc) \
        & (tc >= 0.0), t_near


def cluster_candidates(clusters: Clusters, origins, inv, t_cap):
    """(R, K) mask of the clusters whose box passes the slab test."""
    mask, _ = ray_box_slab(clusters.aabb_lo, clusters.aabb_hi, origins, inv,
                           t_cap)
    return mask


def subbox_candidates(clusters: Clusters, k0: int, k1: int, origins, inv,
                      t_cap):
    """(R, k1 - k0, C) mask: the 8-triangle sub-box of each triangle of
    clusters k0..k1-1 passes the slab test (empty groups are NaN)."""
    g = clusters.subbox_count
    boxes = clusters.subboxes[k0:k1].reshape(-1, 6)
    mask, _ = ray_box_slab(boxes[:, 0:3], boxes[:, 3:6], origins, inv, t_cap)
    group_of = torch.arange(clusters.cluster_size,
                            device=origins.device) // SUB_GROUP
    return mask.reshape(-1, k1 - k0, g)[:, :, group_of]


def _triangle_planes(clusters: Clusters, k0: int, k1: int):
    """9 (kc, C) component planes [v0 e1 e2] of clusters k0..k1-1."""
    c = clusters.cluster_size
    tab = clusters.planes[k0:k1].reshape(k1 - k0, 9, c)
    return [tab[:, j] for j in range(9)]


def _cluster_steps(k: int, rays: int, c: int, device: torch.device):
    step = max(1, _pair_budget(device) // max(rays * c, 1))
    for k0 in range(0, k, step):
        yield k0, min(k, k0 + step)


# ---------------------------------------------------------------------------
# K1: any-hit
# ---------------------------------------------------------------------------


def _anyhit_chunk(clusters: Clusters, o, d, tm, t_min: float,
                  subbox_gate=None):
    k = clusters.cluster_count
    r = d.shape[0]
    inv = inverse_directions(d)
    cand = cluster_candidates(clusters, o, inv, tm)
    occluded = torch.zeros(r, dtype=torch.bool, device=d.device)
    ox, oy, oz = (o[:, i, None, None] for i in range(3))
    dx, dy, dz = (d[:, i, None, None] for i in range(3))
    tmax = tm[:, None, None]
    for k0, k1 in _cluster_steps(k, r, clusters.cluster_size, d.device):
        live = cand[:, k0:k1]
        if not bool(live.any()):
            continue
        v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = (
            p[None] for p in _triangle_planes(clusters, k0, k1))
        # Division-free Moeller-Trumbore (trace_kernel.py:676-692).
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
            & (tt >= t_min * adet) & (tt <= tmax * adet) & live[:, :, None]
        if subbox_gate is not None:
            hit &= subbox_gate(clusters, k0, k1, o, inv, tm)
        occluded |= hit.flatten(1).any(dim=1)
    return occluded


def trace_anyhit_plain(clusters: Clusters, origins, dirs, t_max,
                       t_min: float = T_MIN, subbox_gate=None):
    """Plain version of K1: occluded (R,) bool, the Pallas K1's function.
    subbox_gate, for probes only (tools/anyhit_gate_check.py): a function
    (clusters, k0, k1, origins, inv, t_max) -> (R, k1 - k0, C) bool mask
    that a triangle must also pass, such as subbox_candidates."""
    out = [_anyhit_chunk(clusters, origins[i:i + _RAY_CHUNK],
                         dirs[i:i + _RAY_CHUNK], t_max[i:i + _RAY_CHUNK],
                         t_min, subbox_gate)
           for i in range(0, dirs.shape[0], _RAY_CHUNK)]
    return torch.cat(out) if out else torch.zeros(0, dtype=torch.bool,
                                                  device=dirs.device)


_RAY_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_int]                                 # o, d, tmax, R
_CLUSTER_ARGTYPES = [ctypes.c_void_p,                          # bvh nodes
                     ctypes.c_void_p, ctypes.c_int, ctypes.c_int,  # planes K C
                     ctypes.c_void_p, ctypes.c_int,            # subboxes, G
                     ctypes.c_float]                           # t_min
_K1_FUNCTIONS = {
    "k1_anyhit": _RAY_ARGTYPES + _CLUSTER_ARGTYPES + [
        ctypes.c_void_p, ctypes.c_void_p,                 # occluded, counts
        ctypes.c_void_p],                                 # stream
    "k1_anyhit_slots": [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,      # out, S, P
        ctypes.c_int, ctypes.c_int,                       # groups, per group
        ctypes.c_int,                                     # packet width
        ctypes.c_void_p, ctypes.c_void_p,                 # hit, positions
        ctypes.c_void_p, ctypes.c_void_p]                 # cam, base0
    + _CLUSTER_ARGTYPES + [
        ctypes.c_void_p, ctypes.c_void_p,                 # colors, live
        ctypes.c_void_p, ctypes.c_void_p]}                # packets, stream
_K2_ARGTYPES = _RAY_ARGTYPES + _CLUSTER_ARGTYPES + [
    ctypes.c_void_p, ctypes.c_void_p,                   # t, prim
    ctypes.c_void_p, ctypes.c_void_p]                   # counts, stream
_K3_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int,                          # prim, o, d, R
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,  # planes attrs C
                ctypes.c_void_p,                       # dcam (2, 3)
                ctypes.c_void_p, ctypes.c_void_p]      # out (18, R), stream


def _check_rays(origins, dirs, t_max):
    r = dirs.shape[0]
    build.check_tensor(origins, "origins", torch.float32, (r, 3))
    build.check_tensor(dirs, "dirs", torch.float32, (r, 3))
    build.check_tensor(t_max, "t_max", torch.float32, (r,))
    return r


def _cluster_args(clusters: Clusters, t_min: float):
    return [build.ptr(clusters.bvh_nodes), build.ptr(clusters.planes),
            clusters.cluster_count, clusters.cluster_size,
            build.ptr(clusters.subboxes), clusters.subbox_count, t_min]


def _counting_library(name: str, functions: dict, test_counts, dirs):
    """The kernel library, or with test_counts (an int64 tensor of 3 on
    the rays' device: BVH child boxes, sub-boxes, triangles) the build
    that adds each thread's box and triangle tests into it
    (-DVR_COUNT_TESTS=1)."""
    if test_counts is None:
        return build.load_library(name, functions), None
    build.require_cuda(dirs, test_counts)
    build.check_tensor(test_counts, "test_counts", torch.int64, (3,))
    return (build.load_library(name, functions, {"VR_COUNT_TESTS": 1}),
            build.ptr(test_counts))


def trace_anyhit(clusters: Clusters, origins, dirs, t_max,
                 t_min: float = T_MIN, test_counts=None):
    """Shadow any-hit: origins/dirs (R, 3), t_max (R,) -> occluded (R,)
    bool. CPU tensors take trace_anyhit_plain; CUDA tensors launch K1.
    test_counts: see _counting_library (a measurement build)."""
    if dirs.device.type == "cpu":
        return trace_anyhit_plain(clusters, origins, dirs, t_max, t_min)
    build.require_cuda(origins, dirs, t_max, clusters.planes)
    r = _check_rays(origins, dirs, t_max)
    occluded = torch.empty(r, dtype=torch.bool, device=dirs.device)
    if r == 0:
        return occluded
    lib, counts = _counting_library("anyhit", _K1_FUNCTIONS, test_counts,
                                    dirs)
    with torch.cuda.device(dirs.device):
        err = lib.k1_anyhit(build.ptr(origins), build.ptr(dirs),
                            build.ptr(t_max), r,
                            *_cluster_args(clusters, t_min),
                            build.ptr(occluded), counts,
                            build.stream(dirs.device))
    build.check_launch(err, "k1_anyhit")
    trace.count("K1.launches")
    return occluded


# ---------------------------------------------------------------------------
# K1 on the frame's slot planes, with the combine
# ---------------------------------------------------------------------------

# Slot groups a pixel's slots are split into: K1's slot entry gives each
# group a warp of 32 pixels, and adds the groups' sums in group order. On
# the arcade frame (128 slots, an H100) this layout, with the groups' sums
# in shared memory and floor_scale taken per ray, ran 4 and 8 groups
# within 1% of each other; 1, 2 and 16 groups were timed only in an
# earlier layout, sums in registers and ~9% slower (PERF.md section 6).
SLOT_GROUPS = 8


# The slots a lane of K1's slot entry traces as one packet: rays of one
# pixel from one origin, which walk the tree once, load each triangle once
# and share its origin terms (csrc/anyhit.cu). The kernel is built for
# each width of PACKET_WIDTHS; on the arcade frame (16 slots a group, one
# cluster) 8 ran fastest, then 4 and 2 (PERF.md section 6).
PACKET_WIDTHS = (1, 2, 4, 8)
PACKET = 8


def packet_width(slots: int) -> int:
    """The packet width K1's slot entry takes: PACKET, or the widest of
    PACKET_WIDTHS that a slot group of slot_groups(slots) fills, where a
    group holds fewer slots. A packet wider than its group carries only
    dead lanes: the 960x540 bench frame (one slot a group) ran its slot
    entry in 3.65 ms at width 1 and 6.4-19.6 ms at 2-8, and at 4 spp (4
    slots a group) in 13.0 ms at 4, 14.4 at 1 and 22.3 at 8 (PERF.md
    section 6)."""
    widest = min(PACKET, max(slot_groups(slots)[1], 1))
    return max(w for w in PACKET_WIDTHS if w <= widest)


def slot_groups(slots: int):
    """(groups, slots a group): at most SLOT_GROUPS groups of consecutive
    slots, all as large as the first, the last holding the rest; (1, 0)
    without slots."""
    if slots == 0:
        return 1, 0
    per_group = -(-slots // min(SLOT_GROUPS, slots))
    return -(-slots // per_group), per_group


def shadow_megabatch(out, slots: int, hit, position, cam):
    """The sample-major shadow megabatch of out (3 + 7 slots, P) (base RGB,
    then per ray slot b RGB, direction, t_max): (origins, directions,
    t_max), every pixel's ray of slot 0, then of slot 1, ...; a ray starts
    at position (P, 3) on a hit pixel and at cam on a miss; a ray whose b
    is zero gets t_max = -1 and is dead (JAX pipeline.py:537-552)."""
    p = out.shape[1]
    rest = out[3:].reshape(slots, 7, p)     # slot-major: (S, 7, P)
    shade_origins = torch.where(hit[:, None], position, cam)
    flat_origins = shade_origins.repeat(slots, 1)
    flat_dirs = rest[:, 3:6].permute(0, 2, 1).reshape(-1, 3).contiguous()
    live = torch.any(rest[:, 0:3] != 0.0, dim=1).reshape(-1)
    flat_tmax = torch.where(live, rest[:, 6].reshape(-1), -1.0)
    return flat_origins, flat_dirs, flat_tmax.contiguous()


def shadow_combine(out, slots: int, occluded, base0):
    """(base0 + base) + sum_slot b V as (P, 3), V = 0 where the slot's ray
    (occluded, in megabatch order) is occluded and 1 elsewhere; b V is a
    product, so a non-finite b stays non-finite. Summed as K1's slot entry
    sums: each group of slot_groups(slots) in slot order onto 0, then the
    groups' sums in group order onto 0 (the padding past the last slot
    adds +0, which changes no sum that starts at +0)."""
    p = out.shape[1]
    count, per_group = slot_groups(slots)
    b = out[3:].reshape(slots, 7, p)[:, 0:3]              # (S, 3, P)
    visibility = torch.where(occluded, 0.0, 1.0).reshape(slots, 1, p)
    terms = b * visibility
    pad = count * per_group - slots
    if pad:
        terms = torch.cat([terms, terms.new_zeros((pad, 3, p))])
    terms = terms.reshape(count, per_group, 3, p)
    partial = out.new_zeros((count, 3, p))
    for j in range(per_group):
        partial = partial + terms[:, j]
    total = out.new_zeros((3, p))
    for g in range(count):
        total = total + partial[g]
    return (base0 + out[0:3].T) + total.T


def slot_packets(live, slots: int, packet: int):
    """The packets of K1's slot entry that hold a live ray, as a 0-dim
    int32 tensor: live (S P,) bool in megabatch order (every pixel's slot
    0, then slot 1, ...); a lane takes each group of slot_groups(slots)
    `packet` consecutive slots at a time, the last packet of a group
    holding the rest."""
    if slots == 0:
        return live.new_zeros((), dtype=torch.int32)
    p = live.numel() // slots
    count, per_group = slot_groups(slots)
    per = -(-per_group // packet)                       # packets a group
    s = torch.arange(slots, device=live.device)
    ids = (s // per_group) * per + (s % per_group) // packet
    held = live.reshape(slots, p).to(torch.int32)
    rays = held.new_zeros((count * per, p)).index_add_(0, ids, held)
    return (rays > 0).sum(dtype=torch.int32)


def trace_anyhit_slots_plain(clusters: Clusters, out, slots: int, hit,
                             position, cam, base0, live_rays=None,
                             packets=None, t_min: float = T_MIN,
                             packet: int | None = None):
    """Plain version of K1's slot entry: shadow_megabatch, then
    trace_anyhit_plain, then shadow_combine. live_rays and packets, where
    given (0-dim int32 tensors), gain the rays with t_max >= 0 and the
    packets of `packet` slots (default packet_width(slots)) that hold one
    (slot_packets)."""
    rays = shadow_megabatch(out, slots, hit, position, cam)
    if live_rays is not None:
        live_rays += (rays[2] >= 0.0).sum(dtype=torch.int32)
    if packets is not None:
        packets += slot_packets(rays[2] >= 0.0, slots,
                                packet or packet_width(slots))
    occluded = trace_anyhit_plain(clusters, *rays, t_min)
    return shadow_combine(out, slots, occluded, base0)


def trace_anyhit_slots(clusters: Clusters, out, slots: int, hit, position,
                       cam, base0, live_rays=None, packets=None,
                       t_min: float = T_MIN, packet: int | None = None):
    """K1 on the frame's shadow rays, read in place from K4's output, with
    the combine: out (3 + 7 slots, P) as K4 exports it, hit (P,) bool,
    position (P, 3) the shading points (a view of K6's position rows:
    position.T is contiguous), cam (3,), base0 (P, 3) -> colors (P, 3),
    (base0 + base) + sum_slot b V. live_rays and packets: None, or 0-dim
    int32 tensors that gain the live rays (t_max >= 0) and the packets
    that hold one. packet: the slots a lane traces together (one of
    PACKET_WIDTHS; default packet_width(slots)); the colors do not depend
    on it. CPU tensors take trace_anyhit_slots_plain; CUDA tensors launch
    K1's slot entry."""
    packet = packet or packet_width(slots)
    if packet not in PACKET_WIDTHS:
        raise ValueError(f"packet width {packet} not in {PACKET_WIDTHS}")
    if out.device.type == "cpu":
        return trace_anyhit_slots_plain(clusters, out, slots, hit, position,
                                        cam, base0, live_rays, packets,
                                        t_min, packet)
    build.require_cuda(out, hit, position, cam, base0, clusters.planes)
    p = out.shape[1]
    build.check_tensor(out, "out", torch.float32, (3 + 7 * slots, p))
    build.check_tensor(hit, "hit", torch.bool, (p,))
    build.check_tensor(position.T, "position.T", torch.float32, (3, p))
    build.check_tensor(cam, "cam", torch.float32, (3,))
    build.check_tensor(base0, "base0", torch.float32, (p, 3))
    colors = torch.empty((p, 3), dtype=torch.float32, device=out.device)
    counters = []
    for name, counter in (("live_rays", live_rays), ("packets", packets)):
        if counter is not None:
            build.require_cuda(out, counter)
            build.check_tensor(counter, name, torch.int32, ())
        counters.append(None if counter is None else build.ptr(counter))
    if p == 0:
        return colors
    count, per_group = slot_groups(slots)
    lib = build.load_library("anyhit", _K1_FUNCTIONS)
    with torch.cuda.device(out.device):
        err = lib.k1_anyhit_slots(
            build.ptr(out), slots, p, count, per_group, packet,
            build.ptr(hit), build.ptr(position.T), build.ptr(cam),
            build.ptr(base0), *_cluster_args(clusters, t_min),
            build.ptr(colors), *counters, build.stream(out.device))
    build.check_launch(err, "k1_anyhit_slots")
    trace.count("K1.launches")
    return colors


# ---------------------------------------------------------------------------
# K2: closest hit
# ---------------------------------------------------------------------------


def _closest_chunk(clusters: Clusters, o, d, tm, t_min: float):
    k = clusters.cluster_count
    c = clusters.cluster_size
    r = d.shape[0]
    inv = inverse_directions(d)
    cand = cluster_candidates(clusters, o, inv, tm)
    best_t = torch.full((r,), float("inf"), device=d.device)
    best = torch.full((r,), -1, dtype=torch.int64, device=d.device)
    ox, oy, oz = (o[:, i, None, None] for i in range(3))
    dx, dy, dz = (d[:, i, None, None] for i in range(3))
    for k0, k1 in _cluster_steps(k, r, c, d.device):
        live = cand[:, k0:k1]
        if not bool(live.any()):
            continue
        sub_mask = subbox_candidates(clusters, k0, k1, o, inv, tm)
        v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = (
            p[None] for p in _triangle_planes(clusters, k0, k1))
        # Reciprocal-det Moeller-Trumbore (trace_kernel.py:1013-1028).
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
            & (tt >= t_min) & live[:, :, None] & sub_mask
        tt = torch.where(hit, tt, float("inf")).flatten(1)
        # argmin keeps the first (lowest id) of equal minima; the strict <
        # across steps keeps earlier clusters: the kernel's tie order.
        chunk_t, chunk_i = torch.min(tt, dim=1)
        better = chunk_t < best_t
        best_t = torch.where(better, chunk_t, best_t)
        best = torch.where(better, chunk_i + k0 * c, best)
    return best.to(torch.int32), best_t


def trace_closest_plain(clusters: Clusters, origins, dirs, t_max,
                        t_min: float = T_MIN):
    """Plain version of K2: (prim (R,) int32, -1 on a miss; t (R,), inf on
    a miss)."""
    prims, ts = [], []
    for i in range(0, dirs.shape[0], _RAY_CHUNK):
        p, t = _closest_chunk(clusters, origins[i:i + _RAY_CHUNK],
                              dirs[i:i + _RAY_CHUNK],
                              t_max[i:i + _RAY_CHUNK], t_min)
        prims.append(p)
        ts.append(t)
    return torch.cat(prims), torch.cat(ts)


def trace_closest(clusters: Clusters, origins, dirs, t_max,
                  t_min: float = T_MIN, test_counts=None):
    """Closest hit: origins/dirs (R, 3), t_max (R,) -> (prim (R,) int32
    with -1 on a miss, t (R,) with inf on a miss). CPU tensors take
    trace_closest_plain; CUDA tensors launch K2. test_counts: see
    _counting_library (a measurement build)."""
    if dirs.device.type == "cpu":
        return trace_closest_plain(clusters, origins, dirs, t_max, t_min)
    build.require_cuda(origins, dirs, t_max, clusters.planes)
    r = _check_rays(origins, dirs, t_max)
    prim = torch.empty(r, dtype=torch.int32, device=dirs.device)
    t = torch.empty(r, dtype=torch.float32, device=dirs.device)
    if r == 0:
        return prim, t
    lib, counts = _counting_library(
        "closest", {"k2_closest": _K2_ARGTYPES, "k3_attrs": _K3_ARGTYPES},
        test_counts, dirs)
    with torch.cuda.device(dirs.device):
        err = lib.k2_closest(build.ptr(origins), build.ptr(dirs),
                             build.ptr(t_max), r,
                             *_cluster_args(clusters, t_min), build.ptr(t),
                             build.ptr(prim), counts,
                             build.stream(dirs.device))
    build.check_launch(err, "k2_closest")
    trace.count("K2.launches")
    return prim, t


# ---------------------------------------------------------------------------
# K3: attribute fetch + finalize
# ---------------------------------------------------------------------------


def gather_accumulator(clusters: Clusters, prim):
    """(ACC_PLANES, R) accumulator of trace_kernel.py _attr_pass_one: the
    winner's v0 e1 e2 n0 n1 n2 uv0 uv1 uv2 material and a found flag;
    zeros for misses."""
    c = clusters.cluster_size
    found = prim >= 0
    safe = torch.where(found, prim, 0).long()
    k, t = safe // c, safe % c
    geom = clusters.planes.reshape(-1, 9, c)[k, :, t]    # (R, 9)
    attrs = clusters.attrs.reshape(-1, 16, c)[k, :, t]   # (R, 16)
    acc = torch.cat([geom, attrs, torch.ones_like(geom[:, :1])], dim=1)
    return torch.where(found[:, None], acc, 0.0).T


def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def attrs_finalize(acc, origins, dirs, dcam):
    """Re-intersection, barycentric interpolation, UV derivatives and
    tangent frame (trace_kernel.py _attrs_finalize; shading_pass.frag.glsl
    :738-812). acc: (ACC_PLANES, R); origins/dirs: (R, 3); dcam: (2, 3)
    d(ray dir)/d(pixel). Returns (ATTR_PLANES, R)."""
    a = acc
    v0, e1, e2 = (a[0], a[1], a[2]), (a[3], a[4], a[5]), (a[6], a[7], a[8])
    n0, n1, n2 = (a[9], a[10], a[11]), (a[12], a[13], a[14]), \
        (a[15], a[16], a[17])
    uv0, uv1, uv2 = (a[18], a[19]), (a[20], a[21]), (a[22], a[23])
    o = (origins[:, 0], origins[:, 1], origins[:, 2])
    d = (dirs[:, 0], dirs[:, 1], dirs[:, 2])

    rce1 = _cross(d, e2)
    det = _dot(e1, rce1)
    det_ok = torch.abs(det) > 1e-30
    rcp = 1.0 / torch.where(det_ok, det, 1.0)
    r0 = tuple(o[j] - v0[j] for j in range(3))
    det0 = _dot(r0, rce1)
    b1 = rcp * det0
    e0c0 = _cross(e1, r0)
    det1 = _dot(d, e0c0)
    b2 = -rcp * det1
    b0 = 1.0 - (b1 + b2)
    duv = []
    for di in range(2):
        dd = (dcam[di, 0], dcam[di, 1], dcam[di, 2])
        rce1d = _cross(dd, e2)
        rcpd = -_dot(e1, rce1d) * rcp * rcp
        det0d = _dot(r0, rce1d)
        db1 = rcpd * det0 + rcp * det0d
        det1d = _dot(dd, e0c0)
        db2 = -rcpd * det1 - rcp * det1d
        db0 = -(db1 + db2)
        duv += [db0 * uv0[0] + db1 * uv1[0] + db2 * uv2[0],
                db0 * uv0[1] + db1 * uv1[1] + db2 * uv2[1]]

    ni = tuple(b0 * n0[j] + b1 * n1[j] + b2 * n2[j] for j in range(3))
    inv_len = torch.rsqrt(torch.clamp(_dot(ni, ni), min=1e-30))
    ni = tuple(x * inv_len for x in ni)
    uv = (b0 * uv0[0] + b1 * uv1[0] + b2 * uv2[0],
          b0 * uv0[1] + b1 * uv1[1] + b2 * uv2[1])
    te0 = (uv1[0] - uv0[0], uv1[1] - uv0[1])
    te1 = (uv2[0] - uv0[0], uv2[1] - uv0[1])
    nxe0 = _cross(ni, e1)
    e1xn = _cross(e2, ni)
    tangent = tuple(e1xn[j] * te0[0] + nxe0[j] * te1[0] for j in range(3))
    bitangent = tuple(e1xn[j] * te0[1] + nxe0[j] * te1[1] for j in range(3))
    mtl = torch.sqrt(0.5 * (_dot(tangent, tangent)
                            + _dot(bitangent, bitangent)))
    planes = list(ni) + list(uv) + duv + list(tangent) + list(bitangent) \
        + [mtl, a[24]]
    ok = (a[25] > 0.5) & det_ok
    return torch.stack([torch.where(ok, p, 0.0) for p in planes]
                       + [torch.where(ok, 1.0, 0.0)])


def closest_attrs_plain(clusters: Clusters, prim, origins, dirs, dcam):
    """Plain version of K3: (ATTR_PLANES, R)."""
    return attrs_finalize(gather_accumulator(clusters, prim), origins, dirs,
                          dcam)


def closest_attrs(clusters: Clusters, prim, origins, dirs, dcam):
    """Attribute planes of each ray's closest hit: prim (R,) int32 from
    trace_closest, origins/dirs (R, 3), dcam (2, 3) -> (ATTR_PLANES, R).
    CPU tensors take closest_attrs_plain; CUDA tensors launch K3."""
    if dirs.device.type == "cpu":
        return closest_attrs_plain(clusters, prim, origins, dirs, dcam)
    build.require_cuda(prim, origins, dirs, dcam, clusters.planes)
    r = dirs.shape[0]
    build.check_tensor(prim, "prim", torch.int32, (r,))
    build.check_tensor(origins, "origins", torch.float32, (r, 3))
    build.check_tensor(dirs, "dirs", torch.float32, (r, 3))
    build.check_tensor(dcam, "dcam", torch.float32, (2, 3))
    out = torch.empty((ATTR_PLANES, r), dtype=torch.float32,
                      device=dirs.device)
    if r == 0:
        return out
    lib = build.load_library("closest", {"k2_closest": _K2_ARGTYPES,
                                         "k3_attrs": _K3_ARGTYPES})
    with torch.cuda.device(dirs.device):
        err = lib.k3_attrs(build.ptr(prim), build.ptr(origins),
                           build.ptr(dirs), r, build.ptr(clusters.planes),
                           build.ptr(clusters.attrs), clusters.cluster_size,
                           build.ptr(dcam), build.ptr(out),
                           build.stream(dirs.device))
    build.check_launch(err, "k3_attrs")
    trace.count("K3.launches")
    return out
