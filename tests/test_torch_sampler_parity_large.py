"""The port's samplers (ops/sampling*.py, thin adapters over the SoA
library that K4's plain version runs) against the JAX package's
per-pixel samplers at scale, for all 13 techniques under DIFFUSE_ONLY:
render/shading.py::evaluate_polygonal_light_shading of both packages
(the JAX one vmapped) on 16,384 hit pixels x the bench frame's four quad
street lights = 65,536 pixel-light pairs per technique, 2 samples each.
The shading data and LTC coefficients are the hit pixels of a 256x128
frame of the tiny city under the bench camera (K4's input planes,
captured on the CPU), the noise UNORM16-quantized pairs from a seed.

Slow-marked: a measurement, not a tier-1 check (about 80 s on the CPU).
It prints one JSON line per technique with, for each output (base, b,
ray_dirs, t_max), the share of values beyond the per-pixel tests'
tolerance (test_torch_per_pixel.py: 1e-4 of the output's largest |value|
+ 1e-3 relative; a value finite in one array only counts as beyond) and
the worst |difference| over that largest |value|, for three pairs: the
port's per-pixel shading against the JAX package's ("port"); the JAX
package's own SoA twin of K4 (render/fused.py::fused_light_shading_xla,
the formulation the port's samplers run) against its per-pixel shading
("jax_twin"); and the port against that twin ("port_vs_twin"). At city
scale all three formulations part pairwise on many values for some
techniques (Urena's rectangles and Arvo's PSA on about half of b: small,
distant lights, float32 cancellation; PERF.md section 7, item 5), so
the port is held to the JAX per-pixel shading within the JAX package's
own gap (jax_twin) plus the per-pixel tests' allowance (0.5%; 2% for
Arvo's PSA)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_shading_inputs import (agreement, jax_frame_constants,
                                   per_pixel_scenes, port_frame_constants,
                                   quantized_noise, to_jax, to_port)
from _torch_trace_inputs import city_frame
from test_torch_per_pixel import tolerance
from vulkan_renderer_tpu.core.settings import (PolygonSamplingTechnique,
                                               RenderSettings,
                                               SamplingStrategy)
from vulkan_renderer_tpu.ops.brdf import ShadingData as JShadingData
from vulkan_renderer_tpu.ops.ltc import LtcCoefficients as JLtc
from vulkan_renderer_tpu.render import fused as j_fused
from vulkan_renderer_tpu.render import shading as j_shading
from vulkan_renderer_tpu_torch.ops.ltc import LtcCoefficients
from vulkan_renderer_tpu_torch.render import fused, shading
from vulkan_renderer_tpu_torch.render.shading import ShadingData
from vulkan_renderer_tpu_torch.tools import bench_frame as bench

PIXELS = 16384
OUTPUTS = ("base", "b", "ray_dirs", "t_max")


def _rows(planes, prefix, shape):
    idx = [fused.BASE_PLANES.index(f"{prefix}{i}{j}")
           for i in range(shape[0]) for j in range(shape[1])]
    return planes[idx].T.reshape(-1, *shape)


@pytest.fixture(scope="module")
def city_pixels(tmp_path_factory):
    """(data, ltc) numpy dictionaries of PIXELS hit pixels."""
    _, _, captured = city_frame(str(tmp_path_factory.mktemp("city")),
                                width=256, height=128)
    planes = captured["fused_shading"][0]
    planes = planes[:, bench.hit_mask(planes) > 0.5][:, :PIXELS].numpy()
    assert planes.shape[1] == PIXELS

    def rows(*names):
        return planes[[fused.BASE_PLANES.index(n) for n in names]].T.copy()
    data = dict(position=rows("pos0", "pos1", "pos2"),
                normal=rows("nrm0", "nrm1", "nrm2"),
                outgoing=rows("out0", "out1", "out2"),
                lambert_outgoing=rows("lambert_out")[:, 0],
                diffuse_albedo=rows("alb0", "alb1", "alb2"),
                fresnel_0=rows("f00", "f01", "f02"),
                roughness=rows("rough")[:, 0])
    ltc = dict(world_to_shading_space=_rows(planes, "w2s", (3, 4)),
               shading_to_cosine_space=_rows(planes, "s2c", (3, 3)),
               world_to_cosine_space=_rows(planes, "w2c", (3, 4)),
               cosine_to_shading_space=_rows(planes, "c2s", (3, 3)),
               albedo=rows("ltc_albedo")[:, 0],
               shading_to_cosine_space_determinant=rows("ltc_det")[:, 0])
    return ({k: np.ascontiguousarray(v, np.float32) for k, v in data.items()},
            {k: np.ascontiguousarray(v, np.float32) for k, v in ltc.items()})


@pytest.mark.slow
@pytest.mark.parametrize("tech", list(PolygonSamplingTechnique),
                         ids=lambda t: t.value)
def test_samplers_match_jax_at_scale(city_pixels, tech):
    data, ltc = city_pixels
    specs = to_jax(bench.lights())
    settings = RenderSettings(sampling_strategy=SamplingStrategy.DIFFUSE_ONLY,
                              polygon_sampling_technique=tech,
                              sample_count=2)
    jscene, scene = per_pixel_scenes(specs)
    jstatic = j_shading.SceneStatic(light_count=4, light_texturing=(0,) * 4,
                                    light_vertex_counts=(4,) * 4)
    static = shading.SceneStatic(light_count=4, light_texturing=(0,) * 4,
                                 light_vertex_counts=(4,) * 4)
    jdata = JShadingData(**{k: jnp.asarray(v) for k, v in data.items()})
    jltc = JLtc(**{k: jnp.asarray(v) for k, v in ltc.items()})
    tdata = ShadingData(**{k: torch.from_numpy(v) for k, v in data.items()})
    tltc = LtcCoefficients(**{k: torch.from_numpy(v)
                              for k, v in ltc.items()})
    port_settings = to_port(settings)
    ppl = j_shading.pairs_per_light(settings)
    rpl = j_shading.rays_per_light(settings)
    noises = [quantized_noise((PIXELS, ppl, 2), 100 + i) for i in range(4)]
    twin = j_fused.fused_light_shading_xla(
        jdata, jltc, jnp.ones(PIXELS, bool),
        jnp.asarray(np.concatenate(noises, axis=1)),
        j_fused._pack_light_scalars(jscene.lights, 4),
        jnp.float32(settings.mis_visibility_estimate), jstatic, settings)
    twin = dict(zip(OUTPUTS[1:], (np.asarray(a) for a in twin[1:])))
    row = {"technique": tech.value, "pairs": PIXELS * 4,
           "port": {n: dict(beyond=0.0, worst=0.0) for n in OUTPUTS},
           "jax_twin": {n: dict(beyond=0.0, worst=0.0) for n in OUTPUTS[1:]},
           "port_vs_twin": {n: dict(beyond=0.0, worst=0.0)
                            for n in OUTPUTS[1:]}}
    for i in range(4):
        want = jax.vmap(lambda d, l, nz: j_shading
                        .evaluate_polygonal_light_shading(
                            jscene, jstatic, settings,
                            jax_frame_constants(settings), i, d, l, nz))(
            jdata, jltc, noises[i])
        got = shading.evaluate_polygonal_light_shading(
            scene, static, port_settings, port_frame_constants(settings), i,
            tdata, tltc, torch.from_numpy(noises[i]))
        for name in OUTPUTS:
            w = np.asarray(getattr(want, name))
            _measure(row["port"][name], getattr(got, name).numpy(), w)
            if name != "base":
                slots = twin[name][:, i * rpl:(i + 1) * rpl]
                _measure(row["jax_twin"][name], slots, w)
                _measure(row["port_vs_twin"][name],
                         getattr(got, name).numpy(), slots)
    print(json.dumps(row))
    allowance = 1.0 - tolerance(settings)["threshold"]
    for name in OUTPUTS[1:]:
        assert row["port"][name]["beyond"] <= \
            row["jax_twin"][name]["beyond"] + allowance, (name, row)
    assert row["port"]["base"]["beyond"] <= allowance, row


def _measure(entry, got, want):
    """Fold one light's share of values beyond the per-pixel tolerance
    (a value finite in one array only counts as beyond) and worst
    |difference| over the largest |value| into entry."""
    fin = np.isfinite(want)
    ok = agreement(got, want, "", exact_finite_pattern=False)
    both = fin & np.isfinite(got)
    scale = np.abs(want[fin]).max() if fin.any() else 0.0
    worst = float(np.abs(got[both] - want[both]).max() / scale) \
        if both.any() and scale > 0 else 0.0
    entry["beyond"] = max(entry["beyond"], 1.0 - ok)
    entry["worst"] = max(entry["worst"], worst)
