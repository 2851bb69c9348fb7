"""Cluster tables and the cluster BVH for the tracers (kernels K1-K3).

Counterpart of vulkan_renderer_tpu/render/wavefront.py::build_clusters.
Triangles are fixed-size runs of C consecutive (Morton-ordered)
triangles; every table is component-major so one cluster is a few
contiguous rows:

- planes (K, 9C): [v0.x v0.y v0.z e1.x .. e2.z] planes, column k*C + t;
- attrs (K, 16C): [n0.xyz n1.xyz n2.xyz uv0.xy uv1.xy uv2.xy material];
- aabb_lo/hi (K, 3) over the valid triangles;
- subboxes (K, 6G): per 8-triangle group [lo.xyz hi.xyz], NaN for groups
  without a valid triangle;
- bvh_nodes (M, 16): one binary tree over the cluster sequence
  (build_cluster_bvh_np), which both CUDA tracers walk, with each child's
  sliver bound for K2's prune (triangle_kappa_np).

NaN boxes fail every comparison of the slab test (trace_kernel.py
ray_box_slab and csrc/common.cuh), so padding can never produce a hit;
+/-inf "empty" boxes would not work (t_near=-inf <= t_far=+inf passes).
The wavefront tracer of the JAX module is not ported.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

SUB_GROUP = 8  # triangles per sub-box
BVH_RECORD = 16  # floats per inner node: 64 bytes (csrc/common.cuh)
KAPPA_MAX = 2.0 ** 20  # csrc/closest.cu kKappaMax


def triangle_kappa_np(e1: np.ndarray, e2: np.ndarray) -> np.ndarray:
    """(..., 3) float32 edges -> (...,) float32: the bound K2's prune
    takes for each triangle (csrc/closest.cu header). An axis triangle
    (e1 and e2 both exactly 0 on one axis) gets its sliver factor
    |e1||e2| / |e1 x e2|, computed in float64 and rounded up; a triangle
    with a zero edge is never hit (det is an exact 0) and gets 0; any
    other triangle, and an axis triangle past KAPPA_MAX or collinear,
    gets +inf (its box is never pruned by t)."""
    a = np.asarray(e1, np.float32).astype(np.float64)
    b = np.asarray(e2, np.float32).astype(np.float64)
    zero_edge = ~(a != 0).any(axis=-1) | ~(b != 0).any(axis=-1)
    axis = ((a == 0) & (b == 0)).any(axis=-1)
    with np.errstate(divide="ignore", invalid="ignore"):
        kappa = np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1) \
            / np.linalg.norm(np.cross(a, b), axis=-1)
    kappa = np.where(axis & (kappa <= KAPPA_MAX), kappa, np.inf)
    kappa = np.where(zero_edge, 0.0, kappa)
    up = kappa.astype(np.float32)
    return np.where(up < kappa, np.nextafter(up, np.float32(np.inf)), up)


def cluster_kappa_np(planes: np.ndarray, cluster_size: int) -> np.ndarray:
    """(K, 9C) planes -> (K,) float32 largest triangle_kappa_np of each
    cluster (padding lanes have zero edges and count 0)."""
    tab = np.asarray(planes, np.float32).reshape(-1, 9, cluster_size)
    kappa = triangle_kappa_np(np.moveaxis(tab[:, 3:6], 1, -1),
                              np.moveaxis(tab[:, 6:9], 1, -1))
    return kappa.max(axis=1)


@dataclasses.dataclass
class Clusters:
    aabb_lo: torch.Tensor    # (K, 3)
    aabb_hi: torch.Tensor    # (K, 3)
    planes: torch.Tensor     # (K, 9C)
    attrs: torch.Tensor      # (K, 16C)
    subboxes: torch.Tensor   # (K, 6G)
    bvh_nodes: torch.Tensor  # (M, 16) inner nodes, root first

    @property
    def cluster_count(self) -> int:
        return self.aabb_lo.shape[0]

    @property
    def cluster_size(self) -> int:
        return self.planes.shape[1] // 9

    @property
    def subbox_count(self) -> int:
        return self.subboxes.shape[1] // 6


def build_clusters_np(triangle_positions: np.ndarray,
                      triangle_normals: np.ndarray,
                      triangle_tex_coords: np.ndarray,
                      material_indices: np.ndarray,
                      cluster_size: int = 64) -> dict:
    """(T, 3, 3) positions, (T, 3, 3) normals, (T, 3, 2) uvs, (T,) material
    indices -> dict of numpy tables with the JAX build_clusters layout
    (aabb_lo, aabb_hi, planes, attrs, subboxes). Padding triangles are
    degenerate (never hit)."""
    tris = np.asarray(triangle_positions, np.float32)
    t_count = tris.shape[0]
    k = max(1, -(-t_count // cluster_size))
    pad = k * cluster_size - t_count
    nrm = np.asarray(triangle_normals, np.float32)
    uvs = np.asarray(triangle_tex_coords, np.float32)
    mat = np.asarray(material_indices, np.float32)
    if pad:
        tris = np.concatenate([tris, np.zeros((pad, 3, 3), np.float32)])
        nrm = np.concatenate([nrm, np.zeros((pad, 3, 3), np.float32)])
        uvs = np.concatenate([uvs, np.zeros((pad, 3, 2), np.float32)])
        mat = np.concatenate([mat, np.zeros((pad,), np.float32)])
    lo = tris.min(axis=1).reshape(k, cluster_size, 3)
    hi = tris.max(axis=1).reshape(k, cluster_size, 3)
    lane_valid = (np.arange(k * cluster_size) < t_count) \
        .reshape(k, cluster_size, 1)
    aabb_lo = np.where(lane_valid, lo, np.inf).min(axis=1)
    aabb_hi = np.where(lane_valid, hi, -np.inf).max(axis=1)
    v0 = tris[:, 0].reshape(k, cluster_size, 3)
    e1 = (tris[:, 1] - tris[:, 0]).reshape(k, cluster_size, 3)
    e2 = (tris[:, 2] - tris[:, 0]).reshape(k, cluster_size, 3)
    planes = np.concatenate([a[:, :, c] for a in (v0, e1, e2)
                             for c in range(3)], axis=1)
    sub = max(1, min(SUB_GROUP, cluster_size))
    g = -(-cluster_size // sub)
    s_lo = np.where(lane_valid, lo, np.inf).reshape(k, g, sub, 3).min(axis=2)
    s_hi = np.where(lane_valid, hi, -np.inf).reshape(k, g, sub, 3).max(axis=2)
    s_any = lane_valid.reshape(k, g, sub, 1).any(axis=2)
    subboxes = np.concatenate([np.where(s_any, s_lo, np.nan),
                               np.where(s_any, s_hi, np.nan)], axis=-1) \
        .reshape(k, g * 6).astype(np.float32)
    cols = [nrm[:, vtx, c].reshape(k, cluster_size)
            for vtx in range(3) for c in range(3)]
    cols += [uvs[:, vtx, c].reshape(k, cluster_size)
             for vtx in range(3) for c in range(2)]
    cols.append(mat.reshape(k, cluster_size))
    return dict(aabb_lo=aabb_lo.astype(np.float32),
                aabb_hi=aabb_hi.astype(np.float32),
                planes=np.ascontiguousarray(planes, np.float32),
                attrs=np.ascontiguousarray(np.concatenate(cols, axis=1),
                                           np.float32),
                subboxes=subboxes)


def build_cluster_bvh_np(aabb_lo: np.ndarray, aabb_hi: np.ndarray,
                         kappa: np.ndarray | None = None) -> np.ndarray:
    """Binary tree over the cluster sequence, built bottom-up by pair
    reductions (as vulkan_renderer_tpu/render/bvh.py does over triangles):
    the K cluster boxes, padded with NaN boxes to a power of two >= 2, are
    the leaves; a parent's box is the NaN-aware union (np.fmin/np.fmax) of
    its children's, so a parent with one real child gets that child's box
    and a parent of padding alone stays NaN and is dropped.

    Returns (M, 16) float32 inner-node records, root first, then level by
    level: [left lo.xyz, left hi.xyz, right lo.xyz, right hi.xyz, left ref,
    right ref, left kappa, right kappa], one 64-byte record feeding two
    slab tests; a child's kappa is the largest of its clusters' `kappa`
    (K,) (cluster_kappa_np; +inf, no prune by t, when None). A ref is
    stored as int32 bits: >= 0 is an inner node's row, < 0 is the leaf
    cluster -1 - ref (padding leaves and dropped nodes point past the last
    cluster, behind a NaN box that no ray passes). The tree is
    ceil(log2(K)) levels deep, at most 31 for an int32 cluster id, within
    the kernels' 32-entry stack."""
    k = aabb_lo.shape[0]
    n = 2
    while n < k:
        n *= 2
    lo = np.full((n, 3), np.nan, np.float32)
    hi = np.full((n, 3), np.nan, np.float32)
    lo[:k] = aabb_lo
    hi[:k] = aabb_hi
    kap = np.zeros(n, np.float32)
    kap[:k] = np.inf if kappa is None else kappa
    levels = [(lo, hi)]  # leaves first, root last
    kappas = [kap]
    while lo.shape[0] > 1:
        lo = np.fmin(lo[0::2], lo[1::2])
        hi = np.fmax(hi[0::2], hi[1::2])
        kap = np.maximum(kap[0::2], kap[1::2])
        levels.append((lo, hi))
        kappas.append(kap)
    kappas.reverse()
    levels.reverse()  # levels[0] is the root, levels[-1] the leaves
    # Rows of the kept inner nodes, level by level.
    kept = [~np.isnan(lo[:, 0]) for lo, _ in levels[:-1]]
    kept[0][:] = True
    rows_of, first = [], 0
    for keep in kept:
        rows_of.append(np.where(keep, first + np.cumsum(keep) - 1, -1 - k))
        first += int(keep.sum())
    records = []
    for level, keep in enumerate(kept):
        child_lo, child_hi = levels[level + 1]
        if level + 1 == len(kept):  # children are leaf clusters
            child_refs = -1 - np.arange(child_lo.shape[0])
        else:
            child_refs = rows_of[level + 1]
        rows = np.zeros((int(keep.sum()), BVH_RECORD), np.float32)
        pairs_lo = child_lo.reshape(-1, 2, 3)[keep]
        pairs_hi = child_hi.reshape(-1, 2, 3)[keep]
        rows[:, 0:3], rows[:, 3:6] = pairs_lo[:, 0], pairs_hi[:, 0]
        rows[:, 6:9], rows[:, 9:12] = pairs_lo[:, 1], pairs_hi[:, 1]
        rows.view(np.int32)[:, 12:14] = child_refs.reshape(-1, 2)[keep]
        rows[:, 14:16] = kappas[level + 1].reshape(-1, 2)[keep]
        records.append(rows)
    return np.concatenate(records)


def bvh_children(nodes: np.ndarray):
    """Split (M, 16) records into (boxes (M, 2, 6) [lo.xyz hi.xyz] of the
    left and right child, refs (M, 2) int32)."""
    nodes = np.ascontiguousarray(nodes, np.float32)
    return nodes[:, :12].reshape(-1, 2, 6), nodes.view(np.int32)[:, 12:14]


def clusters_from_numpy(arrays: dict, device) -> Clusters:
    """Device Clusters from the five build_clusters tables (the port's own
    or the JAX package's Clusters leaves as numpy), with the cluster BVH
    built over their boxes."""
    tables = {k: np.array(arrays[k], np.float32)
              for k in ("aabb_lo", "aabb_hi", "planes", "attrs", "subboxes")}
    tables["bvh_nodes"] = build_cluster_bvh_np(
        tables["aabb_lo"], tables["aabb_hi"],
        cluster_kappa_np(tables["planes"],
                         tables["planes"].shape[1] // 9))
    return Clusters(**{k: torch.from_numpy(v).to(device)
                       for k, v in tables.items()})
