"""The noise as kernels K4 and K5 read it: the table at each pixel through
the frame's fetch scalars (ops/noise.py FrameNoise, csrc/techniques.cuh
Noise::pair), instead of a noise image.

The kernels cannot run here, so table_noise() below repeats their index
math in PyTorch: pair j is channels 2 (j & 1) and 2 (j & 1) + 1 of fetch
j >> 1, at table[layer, (y + off_y) & (H - 1), (x + off_x) & (W - 1)]
scaled by (float)(1 / 65535). It must equal get_noise_image (the plain
versions' noise, itself bit-exact with the JAX package's,
test_torch_assets.py) bit for bit, for frame widths that are and are not
multiples of the table's side, odd pair counts and pixel subsets. The
frame tests check that render_frame builds no noise image on either
path."""

import dataclasses

import numpy as np
import pytest
import torch

from vulkan_renderer_tpu_torch.assets.noise import white_noise_table
from vulkan_renderer_tpu_torch.core.settings import RenderSettings
from vulkan_renderer_tpu_torch.ops import noise as noise_ops
from vulkan_renderer_tpu_torch.ops.noise import frame_noise, get_noise_image
from vulkan_renderer_tpu_torch.render import fused, pipeline
from vulkan_renderer_tpu_torch.render.shading import SceneStatic
from vulkan_renderer_tpu_torch.scene.camera import FirstPersonCamera
from vulkan_renderer_tpu_torch.scene.lights import PolygonalLightSpec
from vulkan_renderer_tpu_torch.scene.scene import load_scene
from vulkan_renderer_tpu_torch.tools.export_scene import write_test_scene


def table_noise(noise) -> torch.Tensor:
    """(2 pairs, P) float32 read from the table as the kernels read it."""
    table = noise.table
    th, tw = table.shape[1], table.shape[2]
    pixels = torch.arange(noise.width * noise.height) \
        if noise.pixels is None else noise.pixels.long()
    x, y = pixels % noise.width, pixels // noise.width
    planes = []
    for j in range(noise.pair_count):
        off_x, off_y, layer = noise.fetches[j >> 1].tolist()
        texels = table[layer, (y + off_y) & (th - 1), (x + off_x) & (tw - 1)]
        for c in range(2):
            planes.append(texels[:, 2 * (j & 1) + c].to(torch.float32)
                          * np.float32(1.0 / 65535.0))
    return torch.stack(planes)


@pytest.mark.parametrize("width,height,pairs", [
    (20, 8, 7), (16, 4, 8), (37, 5, 3), (70, 3, 1)])
def test_table_reads_equal_noise_image(width, height, pairs):
    rng = np.random.default_rng(width)
    table = torch.from_numpy(rng.integers(
        0, 65536, size=(8, 32, 16, 4)).astype(np.int32))
    for _ in range(3):
        randoms = rng.integers(0, 2**32, size=4, dtype=np.uint64) \
            .astype(np.uint32)
        noise = frame_noise(table, width, height, pairs, 7, randoms)
        assert tuple(noise.fetches.shape) == ((pairs + 1) // 2, 3)
        assert noise.fetches.dtype == torch.int32
        want = get_noise_image(table, width, height, pairs, 7, randoms)
        got = table_noise(noise)
        assert got.shape == want.shape == (2 * pairs, width * height)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        assert torch.equal(noise.image(), want)


def test_pixel_subsets_read_their_own_pixels():
    rng = np.random.default_rng(4)
    table = torch.from_numpy(rng.integers(
        0, 65536, size=(4, 16, 32, 4)).astype(np.int32))
    noise = frame_noise(table, 45, 7, 5, 3, np.array(
        [0xDEADBEEF, 17, 0x80000001, 99], np.uint32))
    full = get_noise_image(table, 45, 7, 5, 3, noise.random_numbers)
    columns = torch.tensor([0, 44, 45, 200, 314])
    sub = noise.subset(columns)
    assert sub.column_count == 5 and sub.pixels.dtype == torch.int32
    assert torch.equal(table_noise(sub), full[:, columns])
    assert torch.equal(sub.image(), full[:, columns])
    # A subset of a subset names frame pixels, not columns.
    nested = sub.subset(torch.tensor([1, 3]))
    assert nested.pixels.tolist() == [44, 200]
    assert torch.equal(table_noise(nested), full[:, [44, 200]])


@pytest.fixture(scope="module")
def cornell(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("noise_cornell"))
    vks = write_test_scene(d, "cornell_box", texture_resolution=16)
    light = PolygonalLightSpec(
        translation=np.array([1.0, 1.0, 1.99], np.float32),
        rotation_angles=np.array([np.pi, 0, 0], np.float32),
        scaling_x=0.4, scaling_y=0.4,
        radiant_flux=np.array([40.0, 35.0, 30.0], np.float32))
    scene = load_scene(vks, d + "/cornell_box_textures", [light], "cpu",
                       noise=white_noise_table(32, 32, 4))
    camera = FirstPersonCamera(
        position_world_space=np.array([1.0, 0.15, 1.0], np.float32),
        rotation_x=np.pi / 2, rotation_z=np.pi)
    return scene, camera


@pytest.mark.parametrize("shadows", [False, True])
def test_frame_builds_no_noise_image(cornell, monkeypatch, shadows):
    """The frame hands the shading kernel the table and the fetch scalars;
    only the plain versions build the image (here stubbed out, as the
    kernels would run on a card)."""
    scene, camera = cornell
    calls = []

    def counted(*args):
        calls.append(args)
        return get_noise_image(*args)
    monkeypatch.setattr(noise_ops, "get_noise_image", counted)
    seen = {}

    def k4_stub(planes, noise, light_scalars, static, settings):
        seen["noise"] = noise
        nout = 3 + 7 * fused.rays_per_light(settings) * static.light_count
        return torch.zeros((nout, planes.shape[1]))

    def k5_stub(planes, noise, light_scalars, static, settings):
        seen["noise"] = noise
        return torch.zeros((planes.shape[1], 3))

    kernels = dataclasses.replace(pipeline.KERNELS, fused_shading=k4_stub,
                                  fused_resolved=k5_stub)
    settings = RenderSettings(trace_shadow_rays=shadows)
    image = pipeline.render_frame(scene, SceneStatic.for_scene(scene),
                                  camera, settings, 24, 12, kernels=kernels)
    assert image.shape == (12, 24, 3)
    assert calls == []
    noise = seen["noise"]
    assert noise.table is scene.noise_table and noise.pixels is None
    assert (noise.width, noise.height) == (24, 12)
    assert noise.pair_count == 2 * settings.sample_count
    # The plain versions' image of that noise is the reference's.
    assert torch.equal(noise.image(), table_noise(noise))
    assert len(calls) == 1


def test_ptxas_report_parses_into_registers_and_occupancy():
    """kernels/build.py reads nvcc -Xptxas -v into the table that
    tools/tune_shading.py prints for every K4 and K5 instantiation it
    builds."""
    from vulkan_renderer_tpu_torch.kernels import build
    report = "\n".join([
        "ptxas info    : 0 bytes gmem",
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_121fused_resolved_kernelILi4EEEvPKfi' for "
        "'sm_90a'",
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_1",
        "    24 bytes stack frame, 8 bytes spill stores, 12 bytes spill "
        "loads",
        "ptxas info    : Used 168 registers, used 1 barriers, 15104 bytes "
        "smem, 440 bytes cmem[0]",
        "ptxas info    : Compiling entry function '_Z5otherv' for 'sm_90a'",
        "ptxas info    : Used 32 registers, 380 bytes cmem[0]"])
    rows = build.ptxas_table(report)
    assert rows == [
        {"function": "_ZN12_GLOBAL__N_121fused_resolved_kernelILi4EEEvPKfi",
         "registers": 168, "stack": 24, "spill_stores": 8,
         "spill_loads": 12, "smem": 15104},
        {"function": "_Z5otherv", "registers": 32, "stack": 0,
         "spill_stores": 0, "spill_loads": 0, "smem": 0}]
    # 168 registers: 5,376 a warp, 3 blocks of 4 warps in 65,536.
    assert build.resident_warps(168, 128, 15104) == 12
    assert build.resident_warps(255, 128, 0) == 8
    assert build.resident_warps(128, 256, 0) == 16
    assert build.resident_warps(32, 128, 0) == 64
    # Shared memory binds: 100 KB blocks, two on an SM.
    assert build.resident_warps(32, 128, 100 * 1024) == 8
