"""K1's sub-box gate drops no hit of the Pallas K1's function
(csrc/anyhit.cu header; tools/anyhit_gate_check.py).

On the CPU: the tiny city's 4,484 rays aimed at its vertices (one from
each of the bench frame's four street lights, jittered, through each of
its 1,121 vertices), where Moeller-Trumbore accepts hits that a bare slab
test of the triangle's 8-triangle sub-box rejects by an ulp. There
trace_anyhit_plain (no sub-box gate) equals the Pallas K1's formula in
float32 numpy on every ray, and so does the float32 model of K1's grown
gate (anyhit_gate_check.grown_gate); the bare slab gate that K1 had before
parts on some rays (54 with these seeds), which shows that the rays still
probe the gate. And the gate's bound on random axis triangles
(anyhit_gate_check.bound_ratios, a cut of `--bounds`): no accepted hit
dropped, and the worst measured errors under half of the margins taken.
On the card, K1 itself is held on these rays by
tests/test_torch_gpu_tools.py::test_anyhit_gate_on_card."""

import os

import numpy as np
import pytest

from _torch_trace_inputs import anyhit_formula_np, both_clusters
from vulkan_renderer_tpu_torch.render import trace_kernel as tk
from vulkan_renderer_tpu_torch.tools import anyhit_gate_check as gate


@pytest.fixture(scope="module")
def vertex_probe():
    tris = gate.city_triangles(20, 3)
    jax_clusters, clusters = both_clusters(tris)
    rays = gate.vertex_rays(tris)
    return jax_clusters, clusters, rays


def test_plain_anyhit_is_the_gateless_function_on_vertex_rays(vertex_probe):
    jax_clusters, clusters, rays = vertex_probe
    assert rays[1].shape[0] == 4484
    got = tk.trace_anyhit_plain(clusters, *rays).numpy()
    want = anyhit_formula_np(jax_clusters, *(a.numpy() for a in rays))
    assert (got != want).sum() == 0
    assert 0.5 < want.mean() < 1.0


def test_grown_gate_drops_no_vertex_hit_and_bare_slab_does(vertex_probe):
    _, clusters, rays = vertex_probe
    row, _ = gate.count_gates(clusters, *rays)
    assert row["grown_gate_parts"] == 0
    assert row["slab_gate_parts"] > 0


@pytest.mark.parametrize("kind", gate.RAY_KINDS)
def test_gate_bound_holds_on_random_axis_triangles(kind):
    row = gate.bound_ratios(count=50_000, seed=7, kind=kind)
    assert row["hits"] > 100
    assert row["gate_drops"] == 0
    for key in ("eps_ratio", "eta_ratio"):
        assert row[key] < 0.5, (key, row[key])
    if kind != "near":
        assert row["slab_drops"] > 0


def test_gate_is_off_for_other_triangles():
    """The grown gate stays off where the bound is not proven (kappa +inf
    for triangles that are not axis triangles): every such cluster is
    tested whole, so no hit is dropped even where the bare slab test of the
    triangle's box drops many (rays at vertices)."""
    row = gate.bound_ratios(count=50_000, seed=7, axis_aligned=False,
                            kind="vertex")
    assert row["slab_drops"] > 0 and row["gate_drops"] == 0
    assert "eps_ratio" not in row
    tris = gate.random_triangles(np.random.default_rng(1), 64,
                                 axis_aligned=False)
    _, clusters = both_clusters(tris)
    assert np.isinf(gate.cluster_kappa_np(clusters.planes.numpy(),
                                          64)).all()


def test_gate_model_is_the_kernels():
    """The lines of csrc/anyhit.cu's gate that anyhit_gate_check's float32
    models (grown_gate, gate_np) copy."""
    path = os.path.join(os.path.dirname(tk.__file__), "..", "csrc",
                        "anyhit.cu")
    with open(path) as f:
        source = f.read()
    for line in ("const float eps = kappa * scale.x + scale.y;",
                 "const bool ray_bounded = ray.t_max * 1e-18f <= scale.y;",
                 "(eps < 1e8f);",
                 "ray.t_max * (1.0f + (26.0f + 8.0f * kappa) * vrt::kU);",
                 "const float near = vrt::jmin(t0, t1) - w[a];",
                 "const float far = vrt::jmax(t0, t1) + w[a];",
                 "gated ? !grown_slab(lo, lo + 3, ray, w, t_cap)"):
        assert line in source, line
