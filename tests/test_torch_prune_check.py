"""The scenes built to provoke K2's prune (tools/prune_check.py), on the
CPU: their triangles, their rays, and a float32 model of K2's walk that
shows what the prune changes. With the bare best t as the cap, the walk
returns another hit than trace_closest_plain on some of the layered
floor's rays whose own box the slab test enters beyond their t; a flat
widening by 2^-16 still does on thin_edge_scene's edge-on triangles
and slivers; with the hit floor of csrc/closest.cu it returns the plain
version's (prim, t) on every ray of both. On the card,
tests/test_torch_gpu.py::test_closest_kernel_exact_where_pruning_decides
holds K2 itself on 1024 x 1024 rays of each."""

import os
import re

import numpy as np
import pytest
import torch

from vulkan_renderer_tpu_torch.render import trace_kernel as tk
from vulkan_renderer_tpu_torch.tools import prune_check as pc


@pytest.fixture(scope="module")
def floor():
    triangles = pc.layered_floor()
    return triangles, pc.floor_clusters(triangles, "cpu")


def test_layered_floor_layout(floor):
    triangles, clusters = floor
    assert triangles.shape == (2 * 64 * 64 * 4, 3, 3)
    assert clusters.cluster_count == 512
    heights = pc.layer_heights()
    assert heights[0] == np.float32(0.1) and float(heights[0]) != 0.1
    np.testing.assert_array_equal(np.diff(heights.view(np.int32)), 1)
    # Each cluster is flat, in one layer; the layers' clusters are mixed.
    z = triangles[..., 2].reshape(512, -1)
    assert (z.min(axis=1) == z.max(axis=1)).all()
    layer_of = np.searchsorted(heights, z[:, 0])
    assert sorted(np.bincount(layer_of)) == [128] * 4
    assert (np.diff(layer_of[:32]) != 0).any()
    lo, hi = clusters.aabb_lo.numpy(), clusters.aabb_hi.numpy()
    np.testing.assert_array_equal(lo[:, 2], hi[:, 2])


def test_edge_rays_hit_the_floor_at_tile_edges(floor):
    _, clusters = floor
    origins, dirs, t_max = pc.edge_rays(2000)
    assert origins.dtype == dirs.dtype == torch.float32
    assert torch.isinf(t_max).all() and (dirs[:, 2] < 0).all()
    elevation = torch.rad2deg(torch.asin(-dirs[:, 2]))
    assert elevation.min() >= 0.2 - 1e-4 and elevation.max() <= 60 + 1e-4
    assert (elevation < 2.0).float().mean() > 0.3  # grazing
    prim, t = tk.trace_closest(clusters, origins, dirs, t_max)
    hit = prim >= 0
    assert hit.float().mean() > 0.85
    # Where they land: on the floor, within float32 error of the target.
    point = origins[hit] + t[hit, None] * dirs[hit]
    assert (point[:, 2] - 0.1).abs().max() < 1e-6
    risk = pc.at_risk(clusters, origins, dirs, prim, t)
    assert not (risk & ~hit).any()
    assert int(risk.sum()) > 0.2 * int(hit.sum())


def _model_mismatches(clusters, rays, margins):
    """{margin: rays where walk_closest_np differs from the plain version}
    over the rays at risk (the only ones a prune can change)."""
    origins, dirs, t_max = rays
    prim, t = tk.trace_closest_plain(clusters, origins, dirs, t_max)
    at_risk = torch.nonzero(pc.at_risk(clusters, origins, dirs, prim,
                                       t))[:, 0].tolist()
    tables = pc.walk_tables(clusters)
    counts = {}
    for margin in margins:
        counts[margin] = sum(
            pc.walk_closest_np(tables, origins[i].numpy(), dirs[i].numpy(),
                               float(t_max[i]), margin=margin)
            != (int(prim[i]), float(t[i])) for i in at_risk)
    return len(at_risk), counts


def test_margin_keeps_the_winners_the_bare_prune_drops(floor):
    _, clusters = floor
    risky, counts = _model_mismatches(clusters, pc.edge_rays(1500),
                                      [0.0, None])
    assert risky > 300
    assert counts[0.0] > 0 and counts[None] == 0, counts


@pytest.fixture(scope="module")
def thin_edge():
    triangles = pc.thin_edge_scene()
    return triangles, pc.floor_clusters(triangles, "cpu")


def test_thin_edge_scene_layout(thin_edge):
    triangles, clusters = thin_edge
    edge_on, slivers, flat = pc.thin_edge_parts()
    assert triangles.shape[0] == 2 * 64 * 64 * 4 + pc.EDGE_ON \
        + pc.SLIVERS + pc.FLAT_SLIVERS
    eye = np.array(pc.EYE, np.float64)
    # Edge-on: vertical, in a plane within float32 rounding of the eye.
    e = edge_on.astype(np.float64)
    n = np.cross(e[:, 1] - e[:, 0], e[:, 2] - e[:, 0])
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    assert np.abs(n[:, 2]).max() < 1e-5
    assert np.abs(((eye - e[:, 0]) * n).sum(axis=1)).max() < 1e-5
    # Slivers: up to 1e-6 m wide, some collinear after rounding; all parts
    # under the floor.
    s = slivers.astype(np.float64)
    width = np.linalg.norm(np.cross(s[:, 1] - s[:, 0], s[:, 2] - s[:, 0]),
                           axis=1) / np.linalg.norm(s[:, 1] - s[:, 0], axis=1)
    assert 1e-9 < np.median(width) < 1e-6 and width.max() < 2e-6
    assert 0 < (width == 0).sum() < 0.2 * width.size
    for part in (edge_on, slivers, flat):
        assert part[..., 2].max() < np.float32(pc.FLOOR_Z)
    # Edge-on triangles are no axis triangles; flat slivers are, and the
    # tree marks the children that hold a triangle it cannot bound.
    kappa = [tri_kappa(p) for p in (edge_on, slivers, flat)]
    assert np.isinf(kappa[0]).all()
    # A sliver whose third corner rounds onto the first's level is an axis
    # triangle; past 2^20, or collinear in float32, it is never pruned.
    assert np.isinf(kappa[1]).mean() > 0.9
    assert np.isfinite(kappa[2]).any() and np.isinf(kappa[2]).any()
    assert np.nanmax(np.where(np.isinf(kappa[2]), 0, kappa[2])) > 1e5
    child = clusters.bvh_nodes.numpy()[:, 14:16]
    assert np.isinf(child).any() and np.isfinite(child).any()


def tri_kappa(tris):
    from vulkan_renderer_tpu_torch.render.clusters import triangle_kappa_np
    return triangle_kappa_np(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])


def test_thin_edge_rays_meet_the_dangerous_triangles(thin_edge):
    _, clusters = thin_edge
    origins, dirs, t_max = pc.thin_edge_rays(900)
    prim, t = tk.trace_closest_plain(clusters, origins, dirs, t_max)
    assert (origins == torch.tensor(pc.EYE)).all()
    # Some winners are parts under the floor, hit short of their box.
    z = pc.thin_edge_scene()[prim.clamp(min=0).numpy()][:, :, 2]
    under = (prim >= 0).numpy() & (z.max(axis=1) < np.float32(pc.FLOOR_Z))
    assert under.sum() > 20
    risk = pc.at_risk(clusters, origins, dirs, prim, t).numpy()
    assert (risk & under).sum() > 10


def test_flat_margin_drops_what_the_hit_floor_keeps(thin_edge):
    _, clusters = thin_edge
    risky, counts = _model_mismatches(clusters, pc.thin_edge_rays(600),
                                      [pc.FLAT_MARGIN, None])
    assert risky > 50
    assert counts[pc.FLAT_MARGIN] > 0 and counts[None] == 0, counts


def test_axis_triangle_error_terms_within_the_bound():
    row = pc.axis_bound_ratios(100_000, seed=7)
    assert row["hits"] > 20_000
    # closest.cu takes twice the t term and four times the lateral one.
    assert 0.1 < row["t_ratio"] < 1.0
    assert 0.1 < row["lateral_ratio"] < 2.0


def test_model_margin_is_the_kernels():
    """The constants and lines of closest.cu's hit floor that the model
    copies; kU, kKappaMax and floor_scale live in common.cuh, which K1's
    sub-box gate shares."""
    source = ""
    for name in ("closest.cu", "common.cuh"):
        path = os.path.join(os.path.dirname(tk.__file__), "..", "csrc",
                            name)
        with open(path) as f:
            source += f.read()
    m = re.search(r"kU = 1\.0f / (\d+)\.0f;", source)
    assert m and 1.0 / int(m.group(1)) == pc.UNIT_ROUNDOFF
    m = re.search(r"kKappaMax = (\d+)\.0f;", source)
    assert m and float(m.group(1)) == pc.KAPPA_MAX
    for line in ("return {8.0f * kU * (2.0f * far + size), 8.0f * kU * size};",
                 "const float eps = kappa * scale.x + scale.y;",
                 "const float eta = (26.0f + 8.0f * kappa) * kU;",
                 "const float at = (t_near - eps * inv_entry) * (1.0f - eta);",
                 "keep(hit_t_floor(t_sub, inv_sub, kappa, scale))"):
        assert line in source, line
