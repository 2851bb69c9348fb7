"""Shared inputs of the port's tracer parity tests against the JAX Pallas
tracers: cluster tables built by both packages from the same float32
triangles (asserted equal), the tiny city's 64x32 bench-camera frame with
its kernels' arguments captured, and the Pallas K1's and the K2
formulas written out in float32 numpy.

anyhit_formula_np is render/trace_kernel.py:668-692 of the JAX package
over every triangle of every cluster whose box passes _ray_slab_scalars
(:521-538), one numpy operation per jnp one: numpy's float32 ufuncs round
every product and sum on its own (no fused multiply-add)."""

import os

import numpy as np
import torch

from vulkan_renderer_tpu.render import wavefront as j_wavefront
from vulkan_renderer_tpu_torch.render import clusters as t_clusters
from vulkan_renderer_tpu_torch.render.shading import SceneStatic
from vulkan_renderer_tpu_torch.scene import scene as t_scene
from vulkan_renderer_tpu_torch.assets.vks import load_vks
from vulkan_renderer_tpu_torch.tools import bench_frame as bench
from vulkan_renderer_tpu_torch.tools.city import write_city_scene

FRAME_WIDTH, FRAME_HEIGHT = 64, 32
TABLES = ("aabb_lo", "aabb_hi", "planes", "attrs", "subboxes")


def both_clusters(positions, normals=None, uvs=None, mats=None,
                  cluster_size=64):
    """(JAX Clusters, port Clusters on the CPU) from the same float32
    triangles; asserts that every table is equal, NaN pads included."""
    positions = np.asarray(positions, np.float32)
    count = positions.shape[0]
    if normals is None:
        normals = np.zeros((count, 3, 3), np.float32)
        uvs = np.zeros((count, 3, 2), np.float32)
        mats = np.zeros(count, np.int32)
    jax_cl = j_wavefront.build_clusters(positions, cluster_size, normals,
                                        uvs, mats)
    port = t_clusters.build_clusters_np(positions, normals, uvs, mats,
                                        cluster_size)
    for name in TABLES:
        np.testing.assert_array_equal(np.asarray(getattr(jax_cl, name)),
                                      port[name], err_msg=name)
    return jax_cl, t_clusters.clusters_from_numpy(port, "cpu")


def city_frame(directory, width=FRAME_WIDTH, height=FRAME_HEIGHT):
    """The tiny city (make_city(20, detail=3), 1,928 triangles in 31
    clusters) under the bench frame's four lights, camera and settings,
    rendered at width x height on the CPU: (JAX Clusters of its
    triangles, the port's scene, {FrameKernels field: arguments})."""
    vks = write_city_scene(directory, "city", n_buildings=20, detail=3,
                           texture_resolution=16)
    mesh = load_vks(vks)
    positions, normals, uvs = t_scene.mesh_triangles(mesh)
    jax_cl, _ = both_clusters(positions, normals, uvs,
                              mesh.material_indices)
    scene = t_scene.load_scene(vks, os.path.join(directory, "city_textures"),
                               bench.lights(), "cpu",
                               data_directory=directory)
    for name in TABLES:
        np.testing.assert_array_equal(
            np.asarray(getattr(jax_cl, name)),
            getattr(scene.clusters, name).numpy(), err_msg=name)
    with torch.no_grad():
        captured = bench.capture_inputs(scene, SceneStatic.for_scene(scene),
                                        bench.settings(), width, height)
    return jax_cl, scene, captured


def jax_prim(prim):
    """The JAX tracers' uint32 primitive ids (0xFFFFFFFF on a miss) as
    int64, -1 on a miss, as the port returns them."""
    prim = np.asarray(prim).astype(np.int64)
    prim[prim == 0xFFFFFFFF] = -1
    return prim


def _slab_np(lo, hi, o, inv, t_cap):
    """_ray_slab_scalars: (R,) rays x (K,) boxes -> (R, K) bool."""
    t_near = t_far = None
    for a in range(3):
        t0 = (lo[None, :, a] - o[:, None, a]) * inv[:, None, a]
        t1 = (hi[None, :, a] - o[:, None, a]) * inv[:, None, a]
        near, far = np.minimum(t0, t1), np.maximum(t0, t1)
        t_near = near if t_near is None else np.maximum(t_near, near)
        t_far = far if t_far is None else np.minimum(t_far, far)
    cap = t_cap[:, None]
    return (t_near <= t_far) & (t_far >= 0) & (t_near <= cap) & (cap >= 0)


def anyhit_formula_np(clusters, origins, dirs, t_max, t_min=1.0e-3,
                      chunk=256):
    """The Pallas K1's function in float32 numpy: occluded (R,) bool.
    clusters: the JAX or the port's Clusters (aabb_lo/hi, planes)."""
    f32 = np.float32
    lo = np.asarray(clusters.aabb_lo, f32)
    hi = np.asarray(clusters.aabb_hi, f32)
    planes = np.asarray(clusters.planes, f32)
    k = planes.shape[0]
    c = planes.shape[1] // 9
    tab = planes.reshape(k, 9, c)
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = (
        tab[:, j].reshape(1, -1) for j in range(9))
    o_all, d_all, tm_all = (np.asarray(a, f32) for a in (origins, dirs,
                                                         t_max))
    out = np.zeros(d_all.shape[0], bool)
    for i in range(0, d_all.shape[0], chunk):
        o, d, tm = o_all[i:i + chunk], d_all[i:i + chunk], tm_all[i:i + chunk]
        with np.errstate(all="ignore"):
            ok = np.abs(d) > f32(1e-20)
            inv = np.where(ok, f32(1.0) / np.where(ok, d, f32(1.0)),
                           f32(1e30))
            mask = np.repeat(_slab_np(lo, hi, o, inv, tm), c, axis=1)
            ox, oy, oz = (o[:, j, None] for j in range(3))
            dx, dy, dz = (d[:, j, None] for j in range(3))
            tmax = tm[:, None]
            px = dy * e2z - dz * e2y
            py = dz * e2x - dx * e2z
            pz = dx * e2y - dy * e2x
            det = e1x * px + e1y * py + e1z * pz
            su = np.where(det >= 0.0, f32(1.0), f32(-1.0))
            adet = det * su
            tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
            u = (tx * px + ty * py + tz * pz) * su
            qx = ty * e1z - tz * e1y
            qy = tz * e1x - tx * e1z
            qz = tx * e1y - ty * e1x
            v = (dx * qx + dy * qy + dz * qz) * su
            tt = (e2x * qx + e2y * qy + e2z * qz) * su
            hit = (adet > f32(1e-12)) & (u >= 0) & (v >= 0) \
                & (u + v <= adet) & (tt >= f32(t_min) * adet) \
                & (tt <= tmax * adet) & mask
        out[i:i + chunk] = hit.any(axis=1)
    return out


def closest_formula_np(clusters, origins, dirs, t_max, t_min=1.0e-3,
                       chunk=128):
    """The port's K2 function (and the Pallas K2's without its prune by
    the best t so far) in float32 numpy: every triangle whose cluster box
    and 8-triangle sub-box pass the slab test against [0, t_max], the
    reciprocal-det Moeller-Trumbore of trace_kernel.py:1013-1028, and the
    lexicographic minimum of (t, primitive id). Returns (prim (R,) int64,
    -1 on a miss; t (R,), inf on a miss)."""
    f32 = np.float32
    lo = np.asarray(clusters.aabb_lo, f32)
    hi = np.asarray(clusters.aabb_hi, f32)
    planes = np.asarray(clusters.planes, f32)
    sub = np.asarray(clusters.subboxes, f32)
    k = planes.shape[0]
    c = planes.shape[1] // 9
    g = sub.shape[1] // 6
    boxes = sub.reshape(k * g, 6)
    tab = planes.reshape(k, 9, c)
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = (
        tab[:, j].reshape(1, -1) for j in range(9))
    o_all, d_all, tm_all = (np.asarray(a, f32) for a in (origins, dirs,
                                                         t_max))
    prim = np.full(d_all.shape[0], -1, np.int64)
    best = np.full(d_all.shape[0], np.inf, f32)
    for i in range(0, d_all.shape[0], chunk):
        o, d, tm = o_all[i:i + chunk], d_all[i:i + chunk], tm_all[i:i + chunk]
        with np.errstate(all="ignore"):
            ok = np.abs(d) > f32(1e-20)
            inv = np.where(ok, f32(1.0) / np.where(ok, d, f32(1.0)),
                           f32(1e30))
            mask = np.repeat(_slab_np(lo, hi, o, inv, tm), c, axis=1) \
                & np.repeat(_slab_np(boxes[:, :3], boxes[:, 3:], o, inv, tm),
                            c // g, axis=1)
            ox, oy, oz = (o[:, j, None] for j in range(3))
            dx, dy, dz = (d[:, j, None] for j in range(3))
            px = dy * e2z - dz * e2y
            py = dz * e2x - dx * e2z
            pz = dx * e2y - dy * e2x
            det = e1x * px + e1y * py + e1z * pz
            det_ok = np.abs(det) > f32(1e-12)
            inv_det = f32(1.0) / np.where(det_ok, det, f32(1.0))
            tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
            u = (tx * px + ty * py + tz * pz) * inv_det
            qx = ty * e1z - tz * e1y
            qy = tz * e1x - tx * e1z
            qz = tx * e1y - ty * e1x
            v = (dx * qx + dy * qy + dz * qz) * inv_det
            tt = (e2x * qx + e2y * qy + e2z * qz) * inv_det
            hit = det_ok & (u >= 0) & (v >= 0) & (u + v <= f32(1.0)) \
                & (tt >= f32(t_min)) & mask
        tt = np.where(hit, tt, f32(np.inf))
        first = np.argmin(tt, axis=1)  # the lowest id of equal minima
        t_row = tt[np.arange(tt.shape[0]), first]
        found = np.isfinite(t_row)
        prim[i:i + chunk] = np.where(found, first, -1)
        best[i:i + chunk] = t_row
    return prim, best
