"""stop_after, the port's stage cut-off, against the JAX package's: the
stages that end before the shading, the stub itself, and which kernels
each cut runs.

render_frame_constants(stop_after=stage) ends the frame after one of the
JAX package's seven stages and returns its _stage_stub: 0 + acc 1e-30 in
every pixel, acc the sum of the exit's outputs. Each test reads both
packages' exits, not only their stubs (whose values lie below 1e-20):

- the port's exit tensors are caught as they reach _stage_stub, and its
  image must be their stub: image / 1e-30 equals their float64 sum, a
  non-finite value read as 0, within 1e-5 relative (the float32 sum);
- the JAX exit tensors are caught in the same way from
  _render_frame_body (jitted, with _stage_stub patched for the call);
- the port's tensors are mapped to what the JAX exit sums (ExitMeaning:
  -1 for the JAX invalid primitive 0xFFFFFFFF, the noise pairs of the
  port's fetches, K6's shading planes as the fields of the preamble's
  ShadingData and LtcCoefficients (render/fused.py plane_views), K4's
  planes split into base, b, directions and t_max,
  occluded as visibility), and each pair must have as many values and
  agree: primitives, noise pairs and visibility exactly (EXACT); every
  other tensor's sum within SUM_RTOL of its sum of |x|. The sums run over the
  values a frame uses: hit pixels (a miss pixel's preamble is NaN in the
  port and finite in JAX) and, for directions and t_max, the slots live
  in both (a dead slot's direction is 0 in K4 and a sampled direction in
  JAX). Measured here: 1e-9 for the preamble, <= 3.3e-5 for the shading.

The scene is make_city(20, detail=3) with one of bench.py's street
lights, bench.py's camera and settings, 64x32; the JAX frames take
traversal="bruteforce". The stages from the shading on:
test_torch_stop_after_shading.py (the per-pixel paths) and
test_torch_stop_after_fused.py (K4 and K5 against the interpreted JAX
kernels).
"""

import collections
import dataclasses
import unittest.mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vulkan_renderer_tpu.core.settings import (PolygonSamplingTechnique,
                                               RenderSettings,
                                               SamplingStrategy)
from vulkan_renderer_tpu.render import pipeline as jpipeline
from vulkan_renderer_tpu.render.shading import SceneStatic as JSceneStatic
from vulkan_renderer_tpu.scene.camera import FirstPersonCamera as JCamera
from vulkan_renderer_tpu.scene.lights import PolygonalLightSpec as JLight
from vulkan_renderer_tpu.scene.scene import load_scene as j_load_scene
from vulkan_renderer_tpu_torch.ops.noise import noise_pairs
from vulkan_renderer_tpu_torch.render import fused, pipeline
from vulkan_renderer_tpu_torch.render.shading import SceneStatic
from vulkan_renderer_tpu_torch.scene.scene import load_scene
from vulkan_renderer_tpu_torch.tools import bench_frame

WIDTH, HEIGHT = 64, 32
STUB_RTOL = 1e-5
SUM_RTOL = 1e-4
JAX_INVALID = 0xFFFFFFFF
# One street light in view keeps the JAX per-pixel compiles short.
LIGHT = 2


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """(JAX scene, port scene, port SceneStatic) of the tiny city with one
    bench light, both loaded from the .vks the port's bench frame
    writes."""
    d = str(tmp_path_factory.mktemp("bench_city"))
    vks, textures = bench_frame.city_files(d, buildings=20, detail=3)
    light = bench_frame.lights()[LIGHT]
    jscene = j_load_scene(vks, textures, [JLight(
        translation=light.translation, rotation_angles=light.rotation_angles,
        scaling_x=light.scaling_x, scaling_y=light.scaling_y,
        radiant_flux=light.radiant_flux)], data_directory=d)
    scene = load_scene(vks, textures, [light], "cpu", data_directory=d)
    return jscene, scene, SceneStatic.for_scene(scene)


def jax_exit(jscene, stop_after, shadows=True, fused="on"):
    """The tensors the JAX package's frame of the bench camera and
    settings passes to _stage_stub at stop_after, as numpy arrays."""
    settings = RenderSettings(
        sampling_strategy=SamplingStrategy.DIFFUSE_SPECULAR_MIS,
        polygon_sampling_technique=(
            PolygonSamplingTechnique.PROJECTED_SOLID_ANGLE),
        sample_count=1, trace_shadow_rays=shadows)
    static = JSceneStatic(light_count=1, light_texturing=(0,),
                          light_vertex_counts=(4,), traversal="bruteforce",
                          fused=fused)
    camera = JCamera(
        position_world_space=np.array([0.0, 0.0, 2.0], np.float32),
        rotation_x=0.55 * np.pi, rotation_z=0.5 * np.pi)
    constants = jpipeline.make_frame_constants(
        camera, WIDTH, HEIGHT, settings, bench_frame.noise_numbers())

    def exit_tensors(scene, constants):
        caught = []

        def catch(width, height, with_stats, *tensors):
            caught.extend(tensors)
            return jnp.zeros((height, width, 3))

        with unittest.mock.patch.object(jpipeline, "_stage_stub", catch), \
                jax.default_matmul_precision("highest"):
            jpipeline._render_frame_body(scene, static, settings, constants,
                                         WIDTH, HEIGHT, False, stop_after)
        assert caught, f"the JAX frame did not stop after {stop_after}"
        return caught

    return [np.asarray(t) for t in jax.jit(exit_tensors)(jscene, constants)]


def counting_kernels():
    """pipeline.KERNELS with a count of calls per FrameKernels field."""
    calls = collections.Counter()

    def counted(name, fn):
        def call(*args):
            calls[name] += 1
            return fn(*args)
        return call

    return pipeline.FrameKernels(*(
        counted(f.name, getattr(pipeline.KERNELS, f.name))
        for f in dataclasses.fields(pipeline.FrameKernels))), calls


@dataclasses.dataclass
class PortExit:
    image: np.ndarray
    tensors: list          # what reached _stage_stub; [] for no cut
    noise: object          # the frame's FrameNoise
    calls: collections.Counter


def port_exit(scene, static, stop_after, shadows=True):
    """The port's bench frame cut after stop_after, with the tensors that
    reached _stage_stub, the frame's FrameNoise and its kernel calls."""
    caught, noises = [], []
    stub, make_noise = pipeline._stage_stub, pipeline.frame_noise

    def catch(width, height, *tensors):
        caught.extend(tensors)
        return stub(width, height, *tensors)

    def noise(*args):
        noises.append(make_noise(*args))
        return noises[-1]

    kernels, calls = counting_kernels()
    with unittest.mock.patch.object(pipeline, "_stage_stub", catch), \
            unittest.mock.patch.object(pipeline, "frame_noise", noise):
        image = bench_frame.render(scene, static,
                                   bench_frame.settings(shadows=shadows),
                                   kernels, WIDTH, HEIGHT,
                                   stop_after=stop_after).numpy()
    return PortExit(image, caught, noises[0] if noises else None, calls)


def port_frame(scene, static, stop_after, shadows=True):
    return port_exit(scene, static, stop_after, shadows).image


def assert_stub(cut: PortExit):
    """The image is the stub of the exit's tensors: finite, of the
    frame's shape, acc 1e-30 in every value."""
    image = cut.image
    assert image.shape == (HEIGHT, WIDTH, 3) and image.dtype == np.float32
    assert np.isfinite(image).all()
    assert cut.tensors
    acc = sum(np.nan_to_num(t.numpy().astype(np.float64), nan=0.0,
                            posinf=0.0, neginf=0.0).sum()
              for t in cut.tensors)
    assert acc != 0.0
    np.testing.assert_allclose(image.astype(np.float64) / 1e-30,
                               np.full(image.shape, acc), rtol=STUB_RTOL,
                               atol=1e-6)


def exit_meaning(stage, cut: PortExit, shadows=True):
    """The port's exit tensors as the JAX exit's, in its order (see
    render_frame_constants and the JAX _render_frame_body)."""
    t = [x.numpy() for x in cut.tensors]
    if stage in ("rays", "trace"):
        return t
    if stage == "preamble":
        data, ltc = fused.plane_views(cut.tensors[1])
        return [t[0]] + [getattr(record, f.name).numpy()
                         for record in (data, ltc)
                         for f in dataclasses.fields(record)]
    if stage == "noise":
        return [t[0], noise_pairs(cut.noise, 0, WIDTH * HEIGHT).numpy()]
    if not shadows:
        return t                              # the colors
    base0, out = t[0], t[1]
    slots = (out.shape[0] - 3) // 7
    rest = out[3:].reshape(slots, 7, -1)
    base = base0 + out[0:3].T
    b = rest[:, 0:3].transpose(2, 0, 1)       # (P, S, 3), as JAX's
    if stage == "shade":
        return [base, b, rest[:, 3:6].transpose(2, 0, 1), rest[:, 6].T]
    if stage == "shadowrays":
        return [base, b] + t[2:]
    return [base, b, np.where(t[2], 0.0, 1.0).reshape(slots, -1).T]


def jax_meaning(stage, tensors, shadows=True):
    """The JAX exit's tensors, the invalid primitive as -1; without
    shadows the colors base + sum b V (the per-pixel path keeps its slots
    there, the fused one none)."""
    t = list(tensors)
    if stage in ("trace", "noise"):
        t[0] = np.where(t[0] == JAX_INVALID, -1, t[0].astype(np.int64))
    if not shadows and stage in ("shade", "shadow"):
        b = t[1]
        visibility = t[2] if stage == "shadow" else np.ones(b.shape[:2])
        return [t[0] + np.sum(b * visibility[..., None], axis=1)]
    if stage == "shade":
        return t[:4]                          # origins: at "shadowrays"
    return t


def used(stage, index, port, jax_, hit, shadows):
    """The values of exit tensor `index` that a frame uses."""
    mask = np.ones(port[index].shape, bool)
    per_pixel = stage == "preamble" or index == 0 and stage in (
        "shade", "shadowrays", "shadow")
    if per_pixel:
        mask &= hit.reshape((-1,) + (1,) * (mask.ndim - 1))
    if shadows and stage == "shade" and index in (2, 3):
        live = np.any(port[1] != 0, axis=-1) & np.any(jax_[1] != 0, axis=-1)
        mask &= live.reshape(live.shape + (1,) * (mask.ndim - 2))
    if stage == "shadowrays" and index in (2, 3, 4):
        live = (port[4] >= 0) & (jax_[4] >= 0)
        mask &= live.reshape(live.shape + (1,) * (mask.ndim - 1))
    return mask


# The exit tensors held exactly: primitives, noise pairs, visibility.
EXACT = {("trace", 0), ("noise", 0), ("noise", 1), ("shadow", 2)}


def assert_exit_matches_jax(stage, cut, jax_tensors, hit, shadows=True):
    port = exit_meaning(stage, cut, shadows)
    jax_ = jax_meaning(stage, jax_tensors, shadows)
    assert len(port) == len(jax_)
    for index, (p, j) in enumerate(zip(port, jax_)):
        assert p.size == j.size, (stage, index, p.shape, j.shape)
        p = p.reshape(j.shape)
        if (stage, index) in EXACT and (shadows or stage != "shadow"):
            np.testing.assert_array_equal(p, j, err_msg=f"{stage} {index}")
            continue
        mask = used(stage, index, port, jax_, hit, shadows)
        p64 = np.where(mask, p, 0.0).astype(np.float64)
        j64 = np.where(mask, j, 0.0).astype(np.float64)
        assert np.isfinite(p64).all() and np.isfinite(j64).all(), \
            (stage, index)
        scale = np.abs(j64).sum()
        assert abs(p64.sum() - j64.sum()) <= SUM_RTOL * scale, \
            (stage, index, p64.sum(), j64.sum(), scale)


@pytest.fixture(scope="module")
def hit(scenes):
    """The tiny frame's hit pixels, where both packages' primary
    visibility agrees (test_stage_matches_jax_stub[trace])."""
    _, scene, static = scenes
    return port_exit(scene, static, "trace").tensors[0].numpy() != -1


@pytest.mark.parametrize("stage", ["rays", "trace", "noise", "preamble"])
def test_stage_matches_jax_stub(scenes, hit, stage):
    jscene, scene, static = scenes
    cut = port_exit(scene, static, stage)
    assert_stub(cut)
    assert_exit_matches_jax(stage, cut, jax_exit(jscene, stage), hit)


@pytest.mark.parametrize("shadows", [True, False])
@pytest.mark.parametrize("stage", pipeline.STAGES)
def test_every_stage_gives_a_finite_stub(scenes, stage, shadows):
    _, scene, static = scenes
    cut = port_exit(scene, static, stage, shadows)
    if stage == "shadowrays" and not shadows:
        assert not cut.tensors and cut.image.mean() > 0.01
    else:
        assert_stub(cut)


# The kernels a cut of the bench frame has run, by path and shadows.
_TRACE = {"trace_closest": 1, "closest_attrs": 1}
_PREAMBLE = {**_TRACE, "shading_planes": 1}
KERNELS_RUN = {
    "rays": {},
    "trace": _TRACE, "noise": _TRACE, "preamble": _PREAMBLE,
    "shade": {**_PREAMBLE, "fused_shading": 1},
    "shadowrays": {**_PREAMBLE, "fused_shading": 1},
    "shadow": {**_PREAMBLE, "fused_shading": 1, "trace_anyhit": 1},
    # The whole frame: K1's slot entry in place of the cuts' ray list.
    None: {**_PREAMBLE, "fused_shading": 1, "trace_anyhit_slots": 1},
}


@pytest.mark.parametrize("fused, shadows", [
    ("auto", True), ("auto", False), ("off", True)])
def test_kernels_run_to_the_cut(scenes, fused, shadows):
    """Each cut has run the kernels up to its stage and no other: K2 and
    K3 from "trace" on, K6 from "preamble" on (the per-pixel path reads
    its planes too), K4 (with shadows) or K5 (without) from "shade"
    on on the fused path, the ray-list K1 only at "shadow" with shadows;
    the per-pixel path runs neither K4 nor K5; a stage the frame does not
    pass runs the whole frame's; the whole frame with shadows runs K1's
    slot entry once, on either path, and never the ray-list K1."""
    _, scene, static = scenes
    static = dataclasses.replace(static, fused=fused)
    for stage in pipeline.STAGES + (None,):
        want = dict(KERNELS_RUN[stage])
        if not shadows:
            want.pop("trace_anyhit", None)
            want.pop("trace_anyhit_slots", None)
            if want.pop("fused_shading", None):
                want["fused_resolved"] = 1
        if fused == "off":
            want.pop("fused_shading", None)
            want.pop("fused_resolved", None)
        passes = not (stage == "preamble" and fused == "off"
                      or stage == "shadowrays" and not shadows)
        if not passes:
            want = port_exit(scene, static, None, shadows).calls
        got = port_exit(scene, static, stage, shadows).calls
        assert dict(got) == dict(want), stage


def test_whole_frame(scenes):
    """stop_after=None renders the frame, bit for bit as a frame rendered
    without the argument; its mean is far from any stub."""
    _, scene, static = scenes
    got = port_frame(scene, static, None)
    plain = bench_frame.render(scene, static, bench_frame.settings(),
                               width=WIDTH, height=HEIGHT).numpy()
    assert np.array_equal(got.view(np.int32), plain.view(np.int32))
    assert got.mean() > 0.01


@pytest.mark.parametrize("stage, shadows, fused", [
    ("preamble", True, "off"), ("shadowrays", False, "auto"),
    ("shadowrays", False, "off")])
def test_stage_the_frame_does_not_pass(scenes, stage, shadows, fused):
    """The preamble on the per-pixel path and the shadow rays without
    shadows cut nothing: the frame runs to the end, as in the JAX
    package."""
    _, scene, static = scenes
    static = dataclasses.replace(static, fused=fused)
    got = port_frame(scene, static, stage, shadows)
    whole = port_frame(scene, static, None, shadows)
    assert np.array_equal(got.view(np.int32), whole.view(np.int32))


def test_unknown_stage_raises(scenes):
    _, scene, static = scenes
    with pytest.raises(ValueError, match="stop_after"):
        port_frame(scene, static, "resolve")


def test_stub_reads_every_exit_tensor():
    """_stage_stub sums each tensor it is given, of any type, once, and
    reads a non-finite value as 0."""
    tensors = [torch.tensor([1.5, float("nan"), float("inf")]),
               torch.tensor([[2, -1]], dtype=torch.int32),
               torch.tensor([True, False, True])]
    image = pipeline._stage_stub(4, 2, *tensors)
    assert image.shape == (2, 4, 3) and image.dtype == torch.float32
    np.testing.assert_allclose(image.numpy() / 1e-30, 4.5, rtol=STUB_RTOL)
