"""The scene built to provoke K2's prune (tools/prune_check.py), on the
CPU: its floor, its rays, and a float32 model of K2's walk that shows
what the prune's margin changes. With the bare best t as the cap, the
walk returns another hit than trace_closest_plain on some of the rays
whose own box the slab test enters beyond their t; with the margin of
csrc/closest.cu it returns the plain version's (prim, t) on every ray.
On the card, chip_smoke.py holds K2 itself on 1024 x 1024 of these
rays."""

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


def test_margin_keeps_the_winners_the_bare_prune_drops(floor):
    _, clusters = floor
    origins, dirs, t_max = pc.edge_rays(1500)
    prim, t = tk.trace_closest_plain(clusters, origins, dirs, t_max)
    at_risk = torch.nonzero(pc.at_risk(clusters, origins, dirs, prim,
                                       t))[:, 0].tolist()
    assert len(at_risk) > 300
    tables = pc.walk_tables(clusters)
    bare = wide = 0
    for i in at_risk:
        args = (tables, origins[i].numpy(), dirs[i].numpy(), float(t_max[i]))
        want = (int(prim[i]), float(t[i]))
        bare += pc.walk_closest_np(*args, margin=0.0) != want
        wide += pc.walk_closest_np(*args) != want
    assert bare > 0 and wide == 0, (bare, wide)


def test_model_margin_is_the_kernels():
    path = os.path.join(os.path.dirname(tk.__file__), "..", "csrc",
                        "closest.cu")
    with open(path) as f:
        source = f.read()
    m = re.search(r"kPruneMargin = 1\.0f / (\d+)\.0f;", source)
    assert m and 1.0 / int(m.group(1)) == pc.PRUNE_MARGIN
    assert "t_near <= cap()" in source and "cap(), &t_sub" in source
