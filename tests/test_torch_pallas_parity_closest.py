"""K2's plain version (render/trace_kernel.py::trace_closest_plain)
against the JAX Pallas K2 itself, trace_closest_fused run in interpret
mode (as tests/test_trace_kernel.py runs it), on primary rays from one
eye: tests/test_trace_kernel.py's 600 random triangles, and the tiny
city's 64x32 bench-camera frame. Both packages build the cluster tables from the
same triangles (asserted equal). K3: test_torch_pallas_parity_attrs.py.

K2. Both kernels gate triangles on their 8-triangle sub-box, so here the
gates agree. Everywhere the port equals the K2 formula in float32 numpy
(_torch_trace_inputs.closest_formula_np: every triangle behind the
passing boxes, the lexicographic minimum of (t, prim)), bit for bit.
Where the JAX kernel is certain (its `uncertain` count is 0), prim is
held equal on every ray: the Pallas K2's prune by the bare best t so far
(`t_near <= best_t`, trace_kernel.py:999 and :1010), which the port's hit
floor replaces (csrc/closest.cu header), drops no winner on these
inputs. t is held bit for bit on the tiny city's frame (axis triangles,
whose off-axis terms are exact zeros). On the random triangles the
interpreted kernel rounds t unlike its written formula on 86 of the 161
hits (the same prim, t 1 to 14 ulps apart), as the interpreted K1 does on
rays through vertices (test_torch_pallas_parity_anyhit.py); the port
sides with the formula on all of them. There t is held within 1e-5
relative, the JAX package's own tolerance for its Pallas K2 against
brute force (tests/test_trace_kernel.py:61)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_trace_inputs import (both_clusters, city_frame,
                                 closest_formula_np, jax_prim)
from vulkan_renderer_tpu.render import trace_kernel as j_trace
from vulkan_renderer_tpu_torch.render import trace_kernel as tk

def _check_closest(jax_cl, clusters, o, d):
    """K2 on rays o, d (t_max inf): the port against the formula (bit for
    bit) and the interpreted Pallas K2 (prim equal where it is certain).
    Returns the port's prim and the rays where the two t part."""
    tm = np.full(d.shape[0], np.inf, np.float32)
    prim, t = (a.numpy() for a in tk.trace_closest_plain(
        clusters, torch.from_numpy(o), torch.from_numpy(d),
        torch.from_numpy(tm)))
    f_prim, f_t = closest_formula_np(jax_cl, o, d, tm)
    np.testing.assert_array_equal(prim, f_prim)
    np.testing.assert_array_equal(t.view(np.int32), f_t.view(np.int32))
    j_prim, j_t, uncertain = j_trace.trace_closest_fused(
        jax_cl, jnp.asarray(o), jnp.asarray(d), chunk_rows=2, m_budget=64,
        interpret=True)
    assert int(uncertain) == 0
    np.testing.assert_array_equal(jax_prim(j_prim), prim)
    j_t = np.asarray(j_t)
    t_parts = t.view(np.int32) != j_t.view(np.int32)
    hit = prim >= 0
    assert not (t_parts & ~hit).any()
    np.testing.assert_allclose(j_t[hit], t[hit], rtol=1e-5)
    return prim, t_parts


def _random_rays():
    """tests/test_trace_kernel.py's closest-hit scene (_scene of
    RandomState(1)) and 640 rays from its eye (10, 10, 25), aimed at
    uniform points of the scene's box (its own rays point anywhere, and
    95% of them miss)."""
    rng = np.random.RandomState(1)
    tris = rng.rand(600, 3, 3).astype(np.float32) * 20
    tris[:, 1] = tris[:, 0] + rng.rand(600, 3) * 1.5
    tris[:, 2] = tris[:, 0] + rng.rand(600, 3) * 1.5
    tris = tris[np.argsort(tris[:, 0, 0])]
    eye = np.array([10.0, 10.0, 25.0], np.float32)
    d = rng.rand(640, 3) * 21.5 - eye
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return tris, np.broadcast_to(eye, d.shape).copy(), d


def test_closest_matches_pallas_on_random_rays():
    tris, o, d = _random_rays()
    jax_cl, clusters = both_clusters(tris, cluster_size=16)
    prim, _ = _check_closest(jax_cl, clusters, o, d)
    assert (prim >= 0).sum() > 100


@pytest.fixture(scope="module")
def frame(tmp_path_factory):
    return city_frame(str(tmp_path_factory.mktemp("city")))


def test_closest_matches_pallas_on_frame_primary_rays(frame):
    jax_cl, _, captured = frame
    clusters, o, d, _ = captured["trace_closest"]
    assert d.shape[0] == 2048
    prim, t_parts = _check_closest(jax_cl, clusters, o.numpy(), d.numpy())
    assert not t_parts.any() and (prim >= 0).mean() > 0.5
