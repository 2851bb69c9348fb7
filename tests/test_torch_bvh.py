"""The cluster BVH of the port's tracers (render/clusters.py
build_cluster_bvh_np) and a numpy mirror of the CUDA kernels' walk over it
(csrc/common.cuh walk_bvh, csrc/anyhit.cu, csrc/closest.cu).

The invariants are checked on the tiny city of test_torch_trace.py, on an
odd cluster count (33) and on the one-cluster cornell box. The mirror runs
the kernels' traversal ray by ray in float32 numpy -- stack, nearer child
first, pruning by the best t so far, the (t, primitive id) tie rule, the
sub-box gate and the any-hit early exit -- and must equal the plain
versions bit for bit, while testing fewer triangles than the flat scan of
every cluster box that passes."""

import numpy as np
import pytest
import torch

from vulkan_renderer_tpu_torch.render import clusters as t_clusters
from vulkan_renderer_tpu_torch.render import trace_kernel as tk
from vulkan_renderer_tpu_torch.scene.scene import mesh_triangles
from vulkan_renderer_tpu_torch.assets.vks import load_vks
from vulkan_renderer_tpu_torch.tools.city import make_city
from vulkan_renderer_tpu_torch.tools.export_scene import write_test_scene

CAMERA = np.array([0.0, 0.0, 2.0], np.float32)
F = np.float32


def _tables(tris):
    tris = np.asarray(tris, np.float32)
    zeros = np.zeros_like(tris)
    return t_clusters.build_clusters_np(
        tris, zeros, zeros[:, :, :2], np.zeros(len(tris), np.uint8))


@pytest.fixture(scope="module")
def city():
    tris, norms, uvs, mats, _ = make_city(20, detail=3)
    tables = t_clusters.build_clusters_np(tris.astype(np.float32),
                                          norms.astype(np.float32),
                                          uvs.astype(np.float32), mats)
    return tables, t_clusters.clusters_from_numpy(tables, "cpu")


def _odd_tables():
    """33 clusters of random small triangles (the last one partial)."""
    rng = np.random.default_rng(4)
    count = 32 * 64 + 17
    centers = rng.uniform(-20.0, 20.0, (count, 1, 3))
    return _tables(centers + rng.normal(0.0, 0.5, (count, 3, 3)))


def _cornell_tables(tmp_path):
    vks = write_test_scene(str(tmp_path), "cornell_box",
                           texture_resolution=8)
    positions, _, _ = mesh_triangles(load_vks(vks))
    return _tables(positions)


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.int32)


def _check_tree(tables):
    lo, hi = tables["aabb_lo"], tables["aabb_hi"]
    k = lo.shape[0]
    nodes = t_clusters.build_cluster_bvh_np(lo, hi)
    assert nodes.shape[1] == 16 and nodes.dtype == np.float32
    boxes, refs = t_clusters.bvh_children(nodes)
    reached = []
    stack = [(0, 0)]  # (row, depth)
    depth_max = 0
    while stack:
        row, depth = stack.pop()
        depth_max = max(depth_max, depth + 1)
        for side in (0, 1):
            box, ref = boxes[row, side], int(refs[row, side])
            if ref >= 0:
                # An inner child: its stored box is the NaN-aware union of
                # its own children's, bit for bit, and contains them.
                kids = boxes[ref]
                np.testing.assert_array_equal(
                    _bits(box[:3]), _bits(np.fmin(kids[0, :3], kids[1, :3])))
                np.testing.assert_array_equal(
                    _bits(box[3:]), _bits(np.fmax(kids[0, 3:], kids[1, 3:])))
                for kid in kids:
                    if not np.isnan(kid).any():
                        assert (box[:3] <= kid[:3]).all()
                        assert (box[3:] >= kid[3:]).all()
                stack.append((ref, depth + 1))
            elif -1 - ref < k:
                cluster = -1 - ref
                reached.append(cluster)
                np.testing.assert_array_equal(_bits(box[:3]),
                                              _bits(lo[cluster]))
                np.testing.assert_array_equal(_bits(box[3:]),
                                              _bits(hi[cluster]))
            else:
                assert np.isnan(box).all()  # padding: no ray passes
    assert sorted(reached) == list(range(k))  # each cluster exactly once
    root = boxes[0]
    np.testing.assert_array_equal(_bits(np.fmin(root[0, :3], root[1, :3])),
                                  _bits(lo.min(axis=0)))
    np.testing.assert_array_equal(_bits(np.fmax(root[0, 3:], root[1, 3:])),
                                  _bits(hi.max(axis=0)))
    assert depth_max == max(1, int(np.ceil(np.log2(max(k, 2)))))
    assert depth_max <= 31
    return nodes


def test_tree_invariants_tiny_city(city):
    tables, _ = city
    assert tables["aabb_lo"].shape[0] == 31
    _check_tree(tables)


def test_tree_invariants_odd_cluster_count():
    tables = _odd_tables()
    assert tables["aabb_lo"].shape[0] == 33
    nodes = _check_tree(tables)
    # 33 leaves padded to 64: the levels keep 17, 9, 5, 3, 2, 1 nodes.
    assert nodes.shape[0] == 17 + 9 + 5 + 3 + 2 + 1


def test_tree_invariants_one_cluster(tmp_path):
    tables = _cornell_tables(tmp_path)
    assert tables["aabb_lo"].shape[0] == 1
    nodes = _check_tree(tables)
    assert nodes.shape[0] == 1


# --- numpy mirror of the kernels' walk -------------------------------------


def _slab(lo, hi, o, inv, cap):
    """common.cuh slab: (passes, t_near) in float32, NaN boxes fail."""
    t0 = (lo - o) * inv
    t1 = (hi - o) * inv
    t_near = np.max(np.minimum(t0, t1))
    t_far = np.min(np.maximum(t0, t1))
    ok = (t_near <= t_far) and (t_far >= 0) and (t_near <= cap) \
        and (cap >= 0)
    return bool(ok), t_near


class _Mirror:
    def __init__(self, tables):
        self.k = tables["aabb_lo"].shape[0]
        self.c = tables["planes"].shape[1] // 9
        self.planes = tables["planes"].reshape(self.k, 9, self.c)
        self.sub = tables["subboxes"].reshape(self.k, -1, 6)
        self.boxes, self.refs = t_clusters.bvh_children(
            t_clusters.build_cluster_bvh_np(tables["aabb_lo"],
                                            tables["aabb_hi"]))
        self.triangles = 0

    def walk(self, o, inv, t_max, keep, visit):
        stack = []
        ref = 0
        while True:
            if ref >= 0:
                box, refs = self.boxes[ref], self.refs[ref]
                in_l, t_l = _slab(box[0, :3], box[0, 3:], o, inv, t_max)
                in_r, t_r = _slab(box[1, :3], box[1, 3:], o, inv, t_max)
                in_l = in_l and keep(t_l)
                in_r = in_r and keep(t_r)
                if in_l and in_r:
                    near, far = (1, 0) if t_r < t_l else (0, 1)
                    stack.append((int(refs[far]), (t_l, t_r)[far]))
                    ref = int(refs[near])
                    continue
                if in_l or in_r:
                    ref = int(refs[0 if in_l else 1])
                    continue
            elif -1 - ref < self.k and visit(-1 - ref):
                return
            while True:
                if not stack:
                    return
                ref, t = stack.pop()
                if keep(t):
                    break

    def _group(self, k, g):
        lanes = slice(8 * g, min(8 * g + 8, self.c))
        self.triangles += lanes.stop - lanes.start
        return [p[lanes] for p in self.planes[k]], lanes.start

    def closest(self, o, d, t_max):
        inv = np.where(np.abs(d) > F(1e-20),
                       F(1) / np.where(np.abs(d) > F(1e-20), d, F(1)),
                       F(1e30)).astype(np.float32)
        best = [F(np.inf), -1]

        def visit(k):
            for g in range(self.sub.shape[1]):
                box = self.sub[k, g]
                if not _slab(box[:3], box[3:], o, inv, best[0])[0]:
                    continue
                (v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z), t0 = \
                    self._group(k, g)
                px = d[1] * e2z - d[2] * e2y
                py = d[2] * e2x - d[0] * e2z
                pz = d[0] * e2y - d[1] * e2x
                det = e1x * px + e1y * py + e1z * pz
                det_ok = np.abs(det) > F(1e-12)
                inv_det = F(1) / np.where(det_ok, det, F(1))
                tx, ty, tz = o[0] - v0x, o[1] - v0y, o[2] - v0z
                u = (tx * px + ty * py + tz * pz) * inv_det
                qx = ty * e1z - tz * e1y
                qy = tz * e1x - tx * e1z
                qz = tx * e1y - ty * e1x
                v = (d[0] * qx + d[1] * qy + d[2] * qz) * inv_det
                tt = (e2x * qx + e2y * qy + e2z * qz) * inv_det
                ok = det_ok & (u >= 0) & (v >= 0) & (u + v <= 1) \
                    & (tt >= F(tk.T_MIN))
                for lane in np.nonzero(ok)[0]:  # in lane order, as a thread
                    prim = k * self.c + t0 + int(lane)
                    if tt[lane] < best[0] or (tt[lane] == best[0]
                                              and prim < best[1]):
                        best[0], best[1] = tt[lane], prim
            return False

        self.walk(o, inv, t_max, lambda t: t <= best[0], visit)
        return best[1], best[0]

    def anyhit(self, o, d, t_max):
        if t_max < 0:
            return False
        inv = np.where(np.abs(d) > F(1e-20),
                       F(1) / np.where(np.abs(d) > F(1e-20), d, F(1)),
                       F(1e30)).astype(np.float32)
        found = [False]

        def visit(k):
            for g in range(self.sub.shape[1]):
                box = self.sub[k, g]
                if not _slab(box[:3], box[3:], o, inv, t_max)[0]:
                    continue
                (v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z), _ = \
                    self._group(k, g)
                px = d[1] * e2z - d[2] * e2y
                py = d[2] * e2x - d[0] * e2z
                pz = d[0] * e2y - d[1] * e2x
                det = e1x * px + e1y * py + e1z * pz
                su = np.where(det >= 0, F(1), F(-1))
                adet = det * su
                tx, ty, tz = o[0] - v0x, o[1] - v0y, o[2] - v0z
                u = (tx * px + ty * py + tz * pz) * su
                qx = ty * e1z - tz * e1y
                qy = tz * e1x - tx * e1z
                qz = tx * e1y - ty * e1x
                v = (d[0] * qx + d[1] * qy + d[2] * qz) * su
                tt = (e2x * qx + e2y * qy + e2z * qz) * su
                hit = (adet > F(1e-12)) & (u >= 0) & (v >= 0) \
                    & (u + v <= adet) & (tt >= F(tk.T_MIN) * adet) \
                    & (tt <= t_max * adet)
                if hit.any():
                    found[0] = True
                    return True
            return False

        self.walk(o, inv, t_max, lambda t: True, visit)
        return found[0]


def _flat_triangles(clusters, origins, dirs, t_max):
    """Triangle tests of the flat scan: every triangle of every cluster
    whose box passes."""
    cand = tk.cluster_candidates(clusters, origins,
                                 tk.inverse_directions(dirs), t_max)
    return int(cand.sum()) * clusters.cluster_size


def test_mirror_closest_equals_plain(city, rng):
    tables, clusters = city
    n = 500
    dirs = np.stack([rng.uniform(-0.3, 0.3, n), rng.uniform(0.2, 1.0, n)
                     * rng.choice([-1.0, 1.0], n), rng.uniform(-0.6, 0.3, n)],
                    axis=1).astype(np.float32)
    origins = np.broadcast_to(CAMERA, dirs.shape).copy()
    t_max = np.full(n, np.inf, np.float32)
    prim, t = tk.trace_closest_plain(clusters, torch.from_numpy(origins),
                                     torch.from_numpy(dirs),
                                     torch.from_numpy(t_max))
    mirror = _Mirror(tables)
    got = [mirror.closest(origins[i], dirs[i], t_max[i]) for i in range(n)]
    assert (prim.numpy() >= 0).mean() > 0.5
    np.testing.assert_array_equal(np.array([g[0] for g in got]),
                                  prim.numpy())
    np.testing.assert_array_equal(_bits(np.array([g[1] for g in got])),
                                  _bits(t.numpy()))
    flat = _flat_triangles(clusters, torch.from_numpy(origins),
                           torch.from_numpy(dirs), torch.from_numpy(t_max))
    assert mirror.triangles < flat, (mirror.triangles, flat)


def test_mirror_anyhit_equals_plain(city, rng):
    tables, clusters = city
    n = 500
    origins = np.concatenate([
        np.broadcast_to(CAMERA, (n // 2, 3)),
        rng.uniform([-60, -30, 0.01], [60, 30, 10], size=(n // 2, 3))]) \
        .astype(np.float32)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    t_max = rng.uniform(0.5, 80.0, n).astype(np.float32)
    t_max[::7] = -1.0
    want = tk.trace_anyhit_plain(clusters, torch.from_numpy(origins),
                                 torch.from_numpy(dirs),
                                 torch.from_numpy(t_max)).numpy()
    mirror = _Mirror(tables)
    got = np.array([mirror.anyhit(origins[i], dirs[i], t_max[i])
                    for i in range(n)])
    assert 0.05 < want.mean() < 0.95
    np.testing.assert_array_equal(got, want)
    flat = _flat_triangles(clusters, torch.from_numpy(origins),
                           torch.from_numpy(dirs), torch.from_numpy(t_max))
    assert mirror.triangles < flat, (mirror.triangles, flat)
