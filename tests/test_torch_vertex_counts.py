"""K4's and K5's plain versions (render/fused.py) against the JAX package
at the light vertex counts the timing sweep and the arcade figures render
beyond the quad and the pentagon: triangles (experiments 50-101),
hexagons (206-257) and heptagons (258-316). csrc/techniques.cuh compiles
one body per vertex count (template <int NV>), so each count is code of
its own on the card; tests/test_torch_gpu_frames.py holds those bodies
against these plain versions on the harness's sweep frames, and this file (with test_torch_vertex_counts_pallas.py, the
interpreted JAX K5) holds the plain versions against the JAX package.

- K4 under DIFFUSE_ONLY at NV = 6 for all 13 techniques, against the
  JAX package's plain-XLA fused_light_shading_xla. Tolerance of
  test_torch_techniques.py: the finite pattern equal and >= 99.5% of each
  output's values within 1e-4 of its largest |value| + 1e-3 relative
  (>= 99% for Arvo SA and Arvo PSA, whose azimuth sectors flip a
  boundary sample more often); directions and t_max of miss pixels held
  to the dead slot. For Arvo PSA a value finite in one package only
  counts against that share instead of failing outright: its float32
  algorithm gives a NaN direction (and b 0) where an edge's sin^2 beta
  rounds to 0 (ROADMAP Queue 3), and at a sliver edge one ulp of rsqrt
  decides it. XLA's CPU rsqrt differs from the correctly rounded
  1 / sqrt (torch.rsqrt's) on about a third of float32 inputs; at pixel
  142 of these inputs, light 0, the port's clipped 4-gon gets
  sin^2 beta = 0 on its 3e-4 rad inner edge and the JAX package does not
  (2 of 320 ray slots; 6 of 1,920 direction values).
- K4 under DIFFUSE_SPECULAR_MIS with clamped-optimal MIS at NV = 7 (the
  arcade's experiments 314 and 316), PSA and PSA-biased, against
  fused_light_shading_xla: base and b at the tolerance above; directions
  and t_max at >= 99%, with every value outside the tolerance at a
  pixel of roughness under 0.02. There the LTC transform is so
  ill-conditioned that an ulp moves the specular sample by ~1e-2: pixels
  29 (roughness 0.0101) and 116 (0.0131) of these inputs part by that
  much at every vertex count from 3 to 7 alike (dirs 99.39% at NV 7, 5
  and 3, 99.29% at NV 4), so it is not the heptagon's body.
- Urena on 3-, 5-, 6- and 7-gon lights, as the harness renders it (the
  technique samples the light's rectangle, scaling_x by scaling_y, whatever
  its vertices; both packages do): K4 against fused_light_shading_xla at
  the first tolerance, and K5 against the reference's base + sum of b at
  test_torch_resolved.py's: >= 97% of the color values within 1e-4 of
  the largest |value| + 1e-3 relative, the mean |difference| under 2e-3
  of that value, the finite pattern equal."""

import numpy as np
import pytest

from _torch_shading_inputs import (agreement, jax_reference, light_specs,
                                   noise_inputs, port_inputs, shading_inputs,
                                   to_port)
from test_torch_resolved import _check as resolved_check
from vulkan_renderer_tpu.core.settings import (MisHeuristic,
                                               PolygonSamplingTechnique,
                                               RenderSettings,
                                               SamplingStrategy)
from vulkan_renderer_tpu_torch.render import fused

Tech = PolygonSamplingTechnique
ARVO = (Tech.SOLID_ANGLE_ARVO, Tech.PROJECTED_SOLID_ANGLE_ARVO)
# Below this roughness the LTC transform amplifies an ulp into ~1e-2 of a
# specular sample's direction (module docstring).
ILL_CONDITIONED_ROUGHNESS = 0.02
NAMES = ("base", "b", "dirs", "t_max")


@pytest.fixture(scope="module")
def inputs():
    return shading_inputs(seed=23)


def _k4(inputs, counts, settings):
    """(port, reference) outputs (base, b, dirs, t_max) of K4's plain
    version and fused_light_shading_xla on `counts` lights."""
    data, ltc, hit = inputs
    specs = light_specs(counts)
    jax_noise, noise = noise_inputs(settings, len(specs), seed=8)
    want = jax_reference(data, ltc, hit, jax_noise, specs, settings)
    want[2][~hit], want[3][~hit] = 0.0, -1.0
    planes, light_scalars, static = port_inputs(data, ltc, hit, specs)
    port_settings = to_port(settings)
    out = fused.fused_light_shading(planes, noise, light_scalars, static,
                                    port_settings)
    slots = static.light_count * fused.rays_per_light(port_settings)
    got = [g.numpy() for g in fused.unpack_outputs(out, slots)]
    assert np.abs(got[1]).max() > 0  # the lights did contribute
    return got, want


@pytest.mark.parametrize("tech", list(Tech), ids=lambda t: t.value)
def test_k4_plain_hexagons_match_reference(inputs, tech):
    settings = RenderSettings(sampling_strategy=SamplingStrategy.DIFFUSE_ONLY,
                              polygon_sampling_technique=tech,
                              sample_count=2)
    got, want = _k4(inputs, (6, 6), settings)
    need = 0.99 if tech in ARVO else 0.995
    for name, g, w in zip(NAMES, got, want):
        ok = agreement(g, w, name,
                       tech != Tech.PROJECTED_SOLID_ANGLE_ARVO)
        assert ok >= need, (name, ok)
    assert not got[0].any()  # DIFFUSE_ONLY has no base term


@pytest.mark.parametrize("tech", [Tech.PROJECTED_SOLID_ANGLE,
                                  Tech.PROJECTED_SOLID_ANGLE_BIASED],
                         ids=lambda t: t.value)
def test_k4_plain_heptagon_mis_matches_reference(inputs, tech):
    settings = RenderSettings(
        sampling_strategy=SamplingStrategy.DIFFUSE_SPECULAR_MIS,
        polygon_sampling_technique=tech,
        mis_heuristic=MisHeuristic.OPTIMAL_CLAMPED,
        mis_visibility_estimate=0.5, sample_count=1)
    got, want = _k4(inputs, (7, 7), settings)
    rough = inputs[0]["roughness"]
    for name, g, w in zip(NAMES, got, want):
        ok = agreement(g, w, name)
        assert ok >= (0.995 if name in ("base", "b") else 0.99), (name, ok)
        fin = np.isfinite(w)  # the same pattern as g's (agreement)
        scale = np.abs(w[fin]).max()
        apart = fin & ~(np.abs(g - w) <= 1e-4 * scale + 1e-3 * np.abs(w))
        pixels = np.nonzero(apart.reshape(apart.shape[0], -1).any(1))[0]
        assert (rough[pixels] < ILL_CONDITIONED_ROUGHNESS).all(), \
            (name, pixels, rough[pixels])


@pytest.mark.parametrize("nv", (3, 5, 6, 7))
def test_urena_on_polygons_matches_reference(inputs, nv):
    tech = Tech.RECTANGLE_SOLID_ANGLE_URENA
    settings = RenderSettings(sampling_strategy=SamplingStrategy.DIFFUSE_ONLY,
                              polygon_sampling_technique=tech,
                              sample_count=2, trace_shadow_rays=False)
    counts = (nv, nv)
    got, want = _k4(inputs, counts, settings)
    for name, g, w in zip(NAMES, got, want):
        assert agreement(g, w, name) >= 0.995, (name, agreement(g, w, name))
    data, ltc, hit = inputs
    specs = light_specs(counts)
    jax_noise, noise = noise_inputs(settings, len(specs), seed=8)
    base, b, _, _ = jax_reference(data, ltc, hit, jax_noise, specs, settings)
    planes, light_scalars, static = port_inputs(data, ltc, hit, specs)
    resolved = fused.fused_light_shading_resolved(
        planes, noise, light_scalars, static, to_port(settings)).numpy()
    resolved_check(resolved, base + b.sum(axis=1), tech)


def test_sweep_jobs_follow_the_experiments():
    """tools/bench_frame.py::sweep_jobs builds K5 once per distinct
    technique and light vertex count of the experiments it is given: PSA
    of the 3-gon central and decentral 128-light cells (61, 87) is one
    library, and the hexagon and heptagon cells get theirs (Arvo PSA 216,
    PSA-biased 257 and 270)."""
    from vulkan_renderer_tpu_torch.experiments import harness
    from vulkan_renderer_tpu_torch.tools import bench_frame
    experiments = harness.create_experiment_list()
    picked = [experiments[i] for i in (61, 87, 50, 216, 257, 270)]
    jobs = bench_frame.sweep_jobs(picked)
    got = {(d["VR_TECHNIQUE"], d["VR_NV_MASK"]) for name, d in jobs
           if name == "fused_resolved"}
    ids = fused.TECHNIQUE_IDS
    want = {(ids[e.settings.polygon_sampling_technique],
             1 << bench_frame.vertex_count(e)) for e in picked}
    assert len(jobs) == len(got) == len(want) == 5
    assert got == want
    assert {bench_frame.vertex_count(e) for e in picked} == {3, 6, 7}
