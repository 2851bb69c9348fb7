"""K6's plain version (render/preamble.py) and the views of its planes
(render/fused.py plane_views) on the CPU, on a 64x32 frame of the small
city (several materials, mip chains, uv outside [0, 1] and negative):
the plain version is the composition the frame ran before K6, texture
fetch and material decode (render/shading.py finish_shading_data), LTC
coefficients (ops/ltc.py) and pack_planes, value for value; the views
rebuild its ShadingData and LtcCoefficients field for field without a
copy, and the per-pixel path shades them as it shaded the records; a
frame hands K6's planes to K4 as they are; and K6's wrapper takes the
plain version only for CPU tensors. K6 itself runs on the card
(tests/test_torch_gpu.py)."""

import dataclasses

import numpy as np
import pytest
import torch

from vulkan_renderer_tpu_torch.assets.noise import white_noise_table
from vulkan_renderer_tpu_torch.core.settings import RenderSettings
from vulkan_renderer_tpu_torch.ops.ltc import get_ltc_coefficients
from vulkan_renderer_tpu_torch.render import fused, pipeline, preamble
from vulkan_renderer_tpu_torch.render.shading import (SceneStatic,
                                                      finish_shading_data)
from vulkan_renderer_tpu_torch.render.trace_kernel import (ATTR_MATERIAL,
                                                           ATTR_UV)
from vulkan_renderer_tpu_torch.scene.camera import FirstPersonCamera
from vulkan_renderer_tpu_torch.scene.lights import PolygonalLightSpec
from vulkan_renderer_tpu_torch.scene.scene import load_scene
from vulkan_renderer_tpu_torch.tools.city import write_city_scene

WIDTH, HEIGHT = 64, 32


@pytest.fixture(scope="module")
def frame(tmp_path_factory):
    """K6's arguments and the planes K4 took, from one frame with shadows
    (calls: each kernel's arguments and result, by FrameKernels field)."""
    d = str(tmp_path_factory.mktemp("preamble"))
    vks = write_city_scene(d, "city", n_buildings=20, detail=3,
                           texture_resolution=16)
    lights = [PolygonalLightSpec(
        translation=np.array([-10.0 + 20.0 * i, 0.0, 8.0], np.float32),
        rotation_angles=np.array([np.pi, 0.0, 0.0], np.float32),
        scaling_x=1.5, scaling_y=1.5,
        radiant_flux=np.array([400.0, 380.0, 340.0], np.float32))
        for i in range(2)]
    scene = load_scene(vks, d + "/city_textures", lights, "cpu",
                       noise=white_noise_table(64, 64, 8))
    camera = FirstPersonCamera(
        position_world_space=np.array([0.0, 0.0, 2.0], np.float32),
        rotation_x=0.55 * np.pi, rotation_z=0.5 * np.pi)
    calls = {}

    def recorder(name, fn):
        def call(*args):
            calls[name] = (args, fn(*args))
            return calls[name][1]
        return call

    kernels = pipeline.FrameKernels(*(
        recorder(f.name, getattr(pipeline.KERNELS, f.name))
        for f in dataclasses.fields(pipeline.FrameKernels)))
    pipeline.render_frame(scene, SceneStatic.for_scene(scene), camera,
                          RenderSettings(trace_shadow_rays=True), WIDTH,
                          HEIGHT, kernels=kernels)
    return calls


def _composition(scene, constants, attrs, prim, t_hit, ray_dirs):
    """The preamble as the frame ran it before K6: (data, ltc, hit)."""
    hit = prim != -1
    t_safe = torch.where(hit & torch.isfinite(t_hit), t_hit, 0.0)
    position = constants.camera_position + t_safe[:, None] * ray_dirs
    data = finish_shading_data(scene, constants, attrs, position)
    f0 = data.fresnel_0
    fresnel_luminance = f0[:, 0] * 0.2126 + f0[:, 1] * 0.7152 \
        + f0[:, 2] * 0.0722
    ltc = get_ltc_coefficients(scene.ltc, fresnel_luminance, data.roughness,
                               data.position, data.normal, data.outgoing)
    return data, ltc, hit


def _bits(t):
    return t.contiguous().view(torch.int32)


def test_the_frame_covers_what_the_preamble_handles(frame):
    """The inputs reach several materials, uv outside [0, 1] and below 0,
    and textures with mip chains; misses too."""
    scene, _, attrs, prim, _, _ = frame["shading_planes"][0]
    hit = prim != -1
    assert 0.2 < float(hit.float().mean()) < 1.0
    assert len(torch.unique(attrs[ATTR_MATERIAL][hit])) > 1
    uv = attrs[ATTR_UV:ATTR_UV + 2][:, hit]
    assert float(uv.min()) < 0.0 and float(uv.max()) > 1.0
    assert int(scene.material_atlas.mip_count.max()) > 1


def test_plain_version_is_the_composition_it_replaced(frame):
    args, planes = frame["shading_planes"]
    data, ltc, hit = _composition(*args)
    want = fused.pack_planes(data, ltc, hit)
    assert torch.equal(_bits(preamble.shading_planes_plain(*args)),
                       _bits(want))
    # CPU tensors take the plain version.
    assert torch.equal(_bits(planes), _bits(want))
    # Misses are NaN in the frame and direction planes, as before.
    assert bool(torch.isnan(planes[:, ~hit]).any())


def test_plane_views_rebuild_the_records_without_a_copy(frame):
    args, _ = frame["shading_planes"]
    data, ltc, hit = _composition(*args)
    planes = fused.pack_planes(data, ltc, hit)
    views = fused.plane_views(planes)
    for record, view in zip((data, ltc), views):
        assert type(view) is type(record)
        for f in dataclasses.fields(record):
            got, want = getattr(view, f.name), getattr(record, f.name)
            assert got.shape == want.shape, f.name
            assert torch.equal(_bits(got), _bits(want)), f.name
            assert got.untyped_storage().data_ptr() == \
                planes.untyped_storage().data_ptr(), f.name


def test_the_shading_kernel_takes_the_preamble_planes(frame):
    """K4 gets the tensor K6 returned, not a copy; hit is its plane 17."""
    (_, _, _, prim, _, _), planes = frame["shading_planes"]
    (k4_planes, *_), _ = frame["fused_shading"]
    assert k4_planes is planes
    assert torch.equal(planes[fused.BASE_PLANES.index("hit")],
                       (prim != -1).to(torch.float32))


def test_kernel_wrapper_refuses_tensors_off_the_cpu_and_the_card(frame):
    """A tensor on neither the CPU nor a card never takes the plain
    version: the wrapper raises."""
    scene, constants, attrs, prim, t_hit, ray_dirs = \
        frame["shading_planes"][0]
    meta = [t.to("meta") for t in (attrs, prim, t_hit, ray_dirs)]
    with pytest.raises(ValueError, match="CUDA"):
        preamble.shading_planes(scene, constants, *meta)


def test_per_pixel_shading_of_the_views_is_that_of_the_records(frame):
    """The per-pixel path shades K6's views as it shaded the records of the
    composition, bit for bit (render/pipeline.py _rows copies each field
    contiguous)."""
    args, planes = frame["shading_planes"]
    scene, constants = args[0], args[1]
    data, ltc, hit = _composition(*args)
    static = SceneStatic.for_scene(scene)
    settings = RenderSettings(trace_shadow_rays=True)
    p = planes.shape[1]
    pairs = torch.rand((p, pipeline.pairs_per_light(settings)
                        * static.light_count, 2),
                       generator=torch.Generator().manual_seed(7))
    got = pipeline.shade_pixels(scene, static, settings, constants, hit,
                                *(pipeline._rows(r, 0, p)
                                  for r in fused.plane_views(planes)),
                                pairs)
    want = pipeline.shade_pixels(scene, static, settings, constants, hit,
                                 data, ltc, pairs)
    for g, w in zip(got, want):
        assert torch.equal(_bits(g), _bits(w))
