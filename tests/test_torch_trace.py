"""Parity of the port's tracer module (render/trace_kernel.py: K1, K2, K3)
with the JAX package. On the CPU the wrappers run their plain versions;
they are held against the JAX brute-force tracers
(render/visibility.py), the JAX attribute finalize and the JAX per-pixel
geometry reconstruction."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vulkan_renderer_tpu.render import pipeline as j_pipeline
from vulkan_renderer_tpu.render import shading as j_shading
from vulkan_renderer_tpu.render import trace_kernel as j_trace
from vulkan_renderer_tpu.render.visibility import (trace_anyhit_bruteforce,
                                                   trace_primary_bruteforce)
from vulkan_renderer_tpu_torch.core.device import get_device
from vulkan_renderer_tpu_torch.kernels import build
from vulkan_renderer_tpu_torch.render import clusters as t_clusters
from vulkan_renderer_tpu_torch.render import trace_kernel as tk
from vulkan_renderer_tpu_torch.tools.city import make_city

CAMERA = np.array([0.0, 0.0, 2.0], np.float32)


@pytest.fixture(scope="module")
def city():
    tris, norms, uvs, mats, _ = make_city(20, detail=3)
    tris = tris.astype(np.float32)
    norms = norms.astype(np.float32)
    uvs = uvs.astype(np.float32)
    clusters = t_clusters.clusters_from_numpy(
        t_clusters.build_clusters_np(tris, norms, uvs, mats), "cpu")
    return tris, norms, uvs, mats, clusters


def _camera_dirs(rng, n):
    """Directions fanning out from the camera along the street."""
    d = np.stack([rng.uniform(-0.3, 0.3, n), rng.uniform(0.2, 1.0, n)
                  * rng.choice([-1.0, 1.0], n), rng.uniform(-0.6, 0.3, n)],
                 axis=1).astype(np.float32)
    return d


def test_closest_matches_bruteforce(city, rng):
    """K2's plain version against trace_primary_bruteforce. prim ids are
    compared where the hit is not a tie (another triangle within 1e-6 of
    the same t); t everywhere (rtol 1e-6: same formula, float32)."""
    tris, _, _, _, clusters = city
    dirs = _camera_dirs(rng, 3000)
    want_prim, want_t = trace_primary_bruteforce(
        jnp.asarray(tris), jnp.asarray(CAMERA), jnp.asarray(dirs))
    want_prim = np.asarray(want_prim).astype(np.int64)
    want_prim[want_prim == 0xFFFFFFFF] = -1
    want_t = np.asarray(want_t)
    origins = torch.from_numpy(np.broadcast_to(CAMERA, dirs.shape).copy())
    prim, t = tk.trace_closest(clusters, origins, torch.from_numpy(dirs),
                               torch.full((len(dirs),), float("inf")))
    prim, t = prim.numpy(), t.numpy()
    assert (want_prim >= 0).mean() > 0.5 and (want_prim < 0).any()
    np.testing.assert_array_equal(prim >= 0, want_prim >= 0)
    hit = prim >= 0
    np.testing.assert_allclose(t[hit], want_t[hit], rtol=1e-6)
    tie = np.abs(t[hit] - want_t[hit]) <= 1e-6 * np.abs(want_t[hit])
    assert not ((prim[hit] != want_prim[hit]) & ~tie).any()


def test_anyhit_matches_bruteforce(city, rng):
    """K1's plain version (division-free test) against
    trace_anyhit_bruteforce (divided test): the formulas differ only at
    edges, so at most 0.1% of rays may disagree; dead rays (t_max < 0)
    never hit. The Pallas K1's own formula is held exactly, and the JAX
    Pallas K1 in interpret mode, in test_torch_pallas_parity_anyhit.py;
    K1's sub-box gate on rays aimed at vertices, where a bare slab test
    drops hits, in test_torch_anyhit_gate.py."""
    tris, _, _, _, clusters = city
    r = 4000
    origins = np.concatenate([
        np.broadcast_to(CAMERA, (r // 2, 3)),
        rng.uniform([-60, -30, 0.01], [60, 30, 10], size=(r // 2, 3))]) \
        .astype(np.float32)
    dirs = rng.normal(size=(r, 3)).astype(np.float32)
    t_max = rng.uniform(0.5, 80.0, r).astype(np.float32)
    t_max[::7] = -1.0
    want = np.asarray(trace_anyhit_bruteforce(
        jnp.asarray(tris), jnp.asarray(origins), jnp.asarray(dirs),
        jnp.asarray(t_max)))
    got = tk.trace_anyhit(clusters, torch.from_numpy(origins),
                          torch.from_numpy(dirs),
                          torch.from_numpy(t_max)).numpy()
    assert 0.05 < want.mean() < 0.95
    assert not got[::7].any()
    assert (got != want).mean() <= 1e-3


def test_attrs_finalize_matches_reference(rng):
    """K3's finalize math against trace_kernel._attrs_finalize on the same
    accumulator and rays (same operations; float32 rounding only)."""
    n = 2000
    acc = rng.normal(size=(26, n)).astype(np.float32)
    acc[25] = (rng.uniform(size=n) > 0.2).astype(np.float32)
    acc[24] = rng.integers(0, 6, n).astype(np.float32)
    origins = rng.normal(size=(n, 3)).astype(np.float32)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dcam = rng.normal(size=(2, 3)).astype(np.float32) * 1e-3
    rays8 = np.concatenate([origins.T, dirs.T, np.zeros((2, n), np.float32)])
    want = np.asarray(j_trace._attrs_finalize(
        jnp.asarray(acc), jnp.asarray(rays8), jnp.asarray(dcam),
        jnp.ones(n, bool)))
    got = tk.attrs_finalize(torch.from_numpy(acc), torch.from_numpy(origins),
                            torch.from_numpy(dirs),
                            torch.from_numpy(dcam)).numpy().T
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_closest_attrs_match_geometry_attributes(city, rng):
    """Whole attribute rows (prim from K2, attributes from K3) against the
    JAX per-pixel reconstruction shading.geometry_attributes, packed with
    pipeline._pack_geom_planes. The two re-intersect with different
    formulas, so the tolerance is relative 1e-4."""
    tris, norms, uvs, mats, clusters = city
    dirs = _camera_dirs(rng, 1500)
    origins = np.broadcast_to(CAMERA, dirs.shape).copy()
    pixel_to_ray = rng.normal(size=(3, 3)).astype(np.float32)
    dcam = np.ascontiguousarray(pixel_to_ray[:, :2].T)
    prim, _ = tk.trace_closest(clusters, torch.from_numpy(origins),
                               torch.from_numpy(dirs),
                               torch.full((len(dirs),), float("inf")))
    got = tk.closest_attrs(clusters, prim, torch.from_numpy(origins),
                           torch.from_numpy(dirs),
                           torch.from_numpy(dcam)).numpy().T
    hit = prim.numpy() >= 0
    assert hit.mean() > 0.5
    np.testing.assert_array_equal(got[:, tk.ATTR_FOUND], hit)
    assert not got[~hit].any()

    rows = np.concatenate([tris.reshape(-1, 9), norms.reshape(-1, 9),
                           uvs.reshape(-1, 6),
                           mats.astype(np.float32)[:, None]], axis=1)
    scene_like = type("S", (), {"shading_rows": jnp.asarray(rows)})
    constants = j_shading.FrameConstants(
        camera_position=jnp.asarray(CAMERA),
        pixel_to_ray=jnp.asarray(pixel_to_ray),
        exposure_factor=jnp.float32(1), roughness_factor=jnp.float32(1),
        mis_visibility_estimate=jnp.float32(0.5),
        error_factor=jnp.float32(1),
        noise_random_numbers=jnp.zeros(4, jnp.uint32))
    geom, _ = jax.vmap(functools.partial(
        j_shading.geometry_attributes, scene_like, constants))(
        jnp.asarray(prim.numpy()[hit]), jnp.asarray(dirs[hit]))
    want = np.asarray(jax.vmap(j_pipeline._pack_geom_planes)(geom))
    np.testing.assert_allclose(got[hit], want, rtol=1e-4, atol=1e-4)


def test_wrappers_do_not_fall_back(city):
    """CPU tensors take the plain versions; asking for CUDA without a card,
    or handing a kernel wrapper a tensor that is neither on the CPU nor
    on a CUDA device, raises instead of silently running elsewhere."""
    _, _, _, _, clusters = city
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        get_device("cuda")
    meta = torch.empty((4, 3), device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        tk.trace_anyhit(clusters, meta, meta, torch.empty(4, device="meta"))
    with pytest.raises(ValueError, match="CUDA tensors"):
        tk.trace_closest(clusters, meta, meta, torch.empty(4, device="meta"))
    with pytest.raises(RuntimeError, match="nvcc"):
        build.load_library("anyhit", {})
