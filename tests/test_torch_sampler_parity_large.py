"""The samplers at city scale, for all 13 techniques under DIFFUSE_ONLY:
four float32 evaluations of one light's shading against a float64 one.
render/shading.py::evaluate_polygonal_light_shading of both packages
(the JAX one vmapped) runs on 16,384 hit pixels x the bench frame's four
quad street lights = 65,536 pixel-light pairs per technique, 2 samples
each. The shading data and LTC coefficients are the hit pixels of a
256x128 frame of the tiny city under the bench camera (K4's input
planes, captured on the CPU), the noise UNORM16-quantized pairs from a
seed.

The four float32 evaluations: the port's per-pixel path ("port", the
JAX per-pixel formulation: ops/sampling*.py), K4's plain
version ("plain", render/fused.py::fused_light_shading_plain: the
structure-of-arrays formulation, ops/soa*.py), the JAX per-pixel path
("jax") and the JAX package's SoA twin of K4 ("jax_twin",
render/fused.py::fused_light_shading_xla). The float64 evaluation (the
oracle) is the port's per-pixel path on float64 CPU tensors of the same
float32 inputs (its modules take their float type from their inputs and
keep their thresholds' float32 values). As a sanity check, K4's plain
version on float64 planes ("plain64") is held against the oracle: its
errors as below, and the share of values more than 1e-9 of the output's
largest |value| apart (where the two formulations take different
branches, or where float64 itself leaves more than that, as Urena's
2 pi cancellation does for a distant light).

Slow-marked: a measurement, not a tier-1 check (a few minutes on the
CPU). It prints one JSON line per technique: for each evaluation and
output (base, b, ray_dirs, t_max), the median, 99th-percentile and worst
|x - x64| / max|x64| over the values finite in the oracle (a value
non-finite in x only counts as infinite, and the share of such values is
printed too); and, as before, for pairs of
float32 evaluations the share of values beyond the per-pixel tests'
tolerance (test_torch_per_pixel.py: 1e-4 of the output's largest |value|
+ 1e-3 relative; a value finite in one array only counts as beyond) and
the worst |difference| over that largest |value|: "port" (port against
JAX per-pixel), "jax_twin" (JAX SoA against JAX per-pixel),
"port_vs_twin" (port against JAX SoA) and "plain_vs_twin" (K4's plain
version against JAX SoA).

Held: the port's per-pixel path parts from the JAX per-pixel path within
the JAX package's own gap (jax_twin) plus the per-pixel tests' allowance
(0.5%; 2% for Arvo's PSA), and its 99th-percentile error of b against
the oracle is no more than 1.25x the JAX per-pixel path's (PERF.md
section 7, item 5)."""

import dataclasses
import json
import types

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
LIGHTS = 4
OUTPUTS = ("base", "b", "ray_dirs", "t_max")
EVALUATIONS = ("port", "plain", "jax", "jax_twin")
PAIRS = {"port": ("port", "jax"), "jax_twin": ("jax_twin", "jax"),
         "port_vs_twin": ("port", "jax_twin"),
         "plain_vs_twin": ("plain", "jax_twin")}
P99_FACTOR = 1.25
SANITY = 1e-9


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


class _Noise:
    """The noise of K4's plain version as its image: (2 pairs, P)."""

    def __init__(self, noises, dtype):
        self.planes = torch.from_numpy(np.concatenate(
            [n.transpose(1, 2, 0).reshape(-1, n.shape[0]) for n in noises],
            axis=0)).to(dtype)

    def image(self):
        return self.planes


def _as(lights, dtype):
    return dataclasses.replace(lights, **{
        f.name: getattr(lights, f.name).to(dtype)
        for f in dataclasses.fields(lights)
        if getattr(lights, f.name).is_floating_point()})


def _port_per_pixel(scene, static, settings, data, ltc, noises, dtype):
    """{output: (P, lights x S, ...) or base summed} of the port's
    per-pixel path at `dtype`."""
    scene = types.SimpleNamespace(**vars(scene))
    scene.lights = _as(scene.lights, dtype)
    tdata = ShadingData(**{k: torch.from_numpy(v).to(dtype)
                           for k, v in data.items()})
    tltc = LtcCoefficients(**{k: torch.from_numpy(v).to(dtype)
                              for k, v in ltc.items()})
    port_settings = to_port(settings)
    outs = [shading.evaluate_polygonal_light_shading(
        scene, static, port_settings, port_frame_constants(settings), i,
        tdata, tltc, torch.from_numpy(noises[i]).to(dtype))
        for i in range(LIGHTS)]
    return {"base": sum(o.base for o in outs).numpy(),
            **{name: torch.cat([getattr(o, name) for o in outs], 1).numpy()
               for name in OUTPUTS[1:]}}


def _plain(scene, static, settings, data, ltc, noises, dtype):
    """The same of K4's plain version at `dtype` (its planes are the
    float32 inputs, converted)."""
    planes = fused.pack_planes(
        ShadingData(**{k: torch.from_numpy(v) for k, v in data.items()}),
        LtcCoefficients(**{k: torch.from_numpy(v) for k, v in ltc.items()}),
        torch.ones(PIXELS, dtype=torch.bool)).to(dtype)
    out = fused.fused_light_shading_plain(
        planes, _Noise(noises, dtype),
        fused.pack_light_scalars(scene.lights, LIGHTS).to(dtype), static,
        to_port(settings))
    slots = LIGHTS * shading.rays_per_light(to_port(settings))
    return dict(zip(OUTPUTS, (o.numpy() for o in
                              fused.unpack_outputs(out, slots))))


def _jax(jscene, jstatic, settings, data, ltc, noises):
    """The JAX per-pixel path and its SoA twin: ({output: values},
    {output: values})."""
    jdata = JShadingData(**{k: jnp.asarray(v) for k, v in data.items()})
    jltc = JLtc(**{k: jnp.asarray(v) for k, v in ltc.items()})
    twin = j_fused.fused_light_shading_xla(
        jdata, jltc, jnp.ones(PIXELS, bool),
        jnp.asarray(np.concatenate(noises, axis=1)),
        j_fused._pack_light_scalars(jscene.lights, LIGHTS),
        jnp.float32(settings.mis_visibility_estimate), jstatic, settings)
    outs = [jax.vmap(lambda d, l, nz: j_shading
                     .evaluate_polygonal_light_shading(
                         jscene, jstatic, settings,
                         jax_frame_constants(settings), i, d, l, nz))(
        jdata, jltc, noises[i]) for i in range(LIGHTS)]
    per_pixel = {"base": np.sum([np.asarray(o.base) for o in outs], axis=0),
                 **{name: np.concatenate([np.asarray(getattr(o, name))
                                          for o in outs], axis=1)
                    for name in OUTPUTS[1:]}}
    return per_pixel, dict(zip(OUTPUTS, (np.asarray(a) for a in twin)))


def _errors(x, oracle):
    """(median, p99, worst) of |x - x64| / max|x64| over the values
    finite in the oracle, a non-finite x counting as infinite, and the
    share of those values that x has non-finite."""
    fin = np.isfinite(oracle)
    if not fin.any():
        return dict(median=0.0, p99=0.0, worst=0.0, nonfinite=0.0)
    scale = np.abs(oracle[fin]).max()
    if scale == 0.0:
        scale = 1.0
    err = np.abs(x[fin].astype(np.float64) - oracle[fin]) / scale
    err = np.where(np.isfinite(err), err, np.inf)
    return dict(median=float(np.median(err)),
                p99=float(np.quantile(err, 0.99, method="higher")),
                worst=float(err.max()),
                nonfinite=float(np.mean(~np.isfinite(x[fin]))))


def _beyond(got, want, name):
    """(share beyond the per-pixel tolerance, worst |difference| over the
    largest |value|), light by light for the ray slots as the per-pixel
    tests count, folded by max."""
    beyond = worst = 0.0
    width = got.shape[1] // LIGHTS
    parts = [(got, want)] if name == "base" else [
        (got[:, i * width:(i + 1) * width], want[:, i * width:(i + 1) * width])
        for i in range(LIGHTS)]
    for g, w in parts:
        fin = np.isfinite(w)
        both = fin & np.isfinite(g)
        scale = np.abs(w[fin]).max() if fin.any() else 0.0
        if both.any() and scale > 0:
            worst = max(worst, float(np.abs(g[both] - w[both]).max() / scale))
        beyond = max(beyond, 1.0 - agreement(g, w, name,
                                             exact_finite_pattern=False))
    return dict(beyond=beyond, worst=worst)


@pytest.mark.slow
@pytest.mark.parametrize("tech", list(PolygonSamplingTechnique),
                         ids=lambda t: t.value)
def test_samplers_match_jax_at_scale(city_pixels, tech):
    data, ltc = city_pixels
    settings = RenderSettings(sampling_strategy=SamplingStrategy.DIFFUSE_ONLY,
                              polygon_sampling_technique=tech,
                              sample_count=2)
    jscene, scene = per_pixel_scenes(to_jax(bench.lights()))
    jstatic = j_shading.SceneStatic(light_count=LIGHTS,
                                    light_texturing=(0,) * LIGHTS,
                                    light_vertex_counts=(4,) * LIGHTS)
    static = shading.SceneStatic(light_count=LIGHTS,
                                 light_texturing=(0,) * LIGHTS,
                                 light_vertex_counts=(4,) * LIGHTS)
    ppl = j_shading.pairs_per_light(settings)
    noises = [quantized_noise((PIXELS, ppl, 2), 100 + i)
              for i in range(LIGHTS)]
    args = (scene, static, settings, data, ltc, noises)
    values = {"port": _port_per_pixel(*args, torch.float32),
              "plain": _plain(*args, torch.float32)}
    values["jax"], values["jax_twin"] = _jax(jscene, jstatic, settings,
                                             data, ltc, noises)
    oracle = _port_per_pixel(*args, torch.float64)
    plain64 = _plain(*args, torch.float64)

    row = {"technique": tech.value, "pairs": PIXELS * LIGHTS,
           "vs_float64": {e: {n: _errors(values[e][n], oracle[n])
                              for n in OUTPUTS} for e in EVALUATIONS},
           "plain64": {n: _errors(plain64[n], oracle[n]) for n in OUTPUTS},
           "plain64_apart": {}}
    for n in OUTPUTS:
        fin = np.isfinite(oracle[n])
        scale = np.abs(oracle[n][fin]).max() if fin.any() else 1.0
        apart = ~np.isclose(plain64[n], oracle[n], rtol=0.0,
                            atol=SANITY * max(scale, 1e-30), equal_nan=True)
        row["plain64_apart"][n] = float(apart.mean())
    for pair, (a, b) in PAIRS.items():
        row[pair] = {n: _beyond(values[a][n], values[b][n], n)
                     for n in OUTPUTS}
    print(json.dumps(row))

    allowance = 1.0 - tolerance(settings)["threshold"]
    for name in OUTPUTS[1:]:
        assert row["port"][name]["beyond"] <= \
            row["jax_twin"][name]["beyond"] + allowance, (name, row)
    assert row["port"]["base"]["beyond"] <= allowance, row
    port_p99 = row["vs_float64"]["port"]["b"]["p99"]
    jax_p99 = row["vs_float64"]["jax"]["b"]["p99"]
    assert port_p99 <= P99_FACTOR * jax_p99 or port_p99 == 0.0, row
