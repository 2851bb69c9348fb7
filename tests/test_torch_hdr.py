"""The HDR capture on the port: the screenshot readers
(render/screenshot.py read_png, read_hdr, combine_ldr_screenshots_into_hdr)
against the JAX package's on the same bytes, the frame_bits branch of
render/pipeline.py _resolve against numpy's float16 bits and against the
JAX package's two-frame capture at 64x32, and tools/hdr_capture.py on the
CPU.

Tolerances: readers and byte packing exact; the recombined port frame
equals the port's direct frame rounded to float16 bit for bit (the same
package with frozen noise); against the JAX package's recombined frame
rtol 2e-3, atol 1e-4, the tolerance of tests/test_render.py
test_hdr_bit_capture_roundtrip."""

import dataclasses
import struct
import zlib

import numpy as np
import pytest
import torch

from _torch_shading_inputs import to_port
from vulkan_renderer_tpu.assets.noise import NoiseType
from vulkan_renderer_tpu.core.settings import (PolygonSamplingTechnique,
                                               RenderSettings,
                                               SamplingStrategy)
from vulkan_renderer_tpu.render import screenshot as j_screenshot
from vulkan_renderer_tpu.render.pipeline import render_frame as j_render
from vulkan_renderer_tpu.render.shading import SceneStatic as JSceneStatic
from vulkan_renderer_tpu.scene.camera import FirstPersonCamera
from vulkan_renderer_tpu.scene.lights import PolygonalLightSpec
from vulkan_renderer_tpu.scene.scene import load_scene
from vulkan_renderer_tpu.tools.export_scene import write_test_scene
from vulkan_renderer_tpu_torch.render import pipeline
from vulkan_renderer_tpu_torch.render import screenshot
from vulkan_renderer_tpu_torch.render.shading import SceneStatic
from vulkan_renderer_tpu_torch.scene.scene import (scene_from_numpy,
                                                   tree_leaves)
from vulkan_renderer_tpu_torch.tools import hdr_capture

WIDTH, HEIGHT = 64, 32


def _png_bytes(rows, width, channels, filters):
    """A PNG whose scanlines carry the given filter bytes."""
    raw = b"".join(bytes([f]) + r.tobytes() for f, r in zip(filters, rows))

    def chunk(tag, data):
        return struct.pack(">I", len(data)) + tag + data \
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    color = {1: 0, 3: 2, 4: 6}[channels]
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", width, len(rows), 8,
                                         color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def _rle_hdr_bytes(rgbe):
    """A Radiance file with RLE scanlines: each channel as one run of its
    first half and the rest literally."""
    h, w, _ = rgbe.shape
    out = [b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n",
           f"-Y {h} +X {w}\n".encode()]
    half = w // 2
    for y in range(h):
        out.append(bytes([2, 2, w >> 8, w & 0xFF]))
        for c in range(4):
            out.append(bytes([128 + half, rgbe[y, 0, c]]))
            out.append(bytes([w - half]) + rgbe[y, half:, c].tobytes())
    return b"".join(out)


def test_readers_match_reference(tmp_path):
    rng = np.random.default_rng(3)
    image = rng.integers(0, 256, (5, 7, 4), dtype=np.uint8)
    # Our own writer's PNG, and one with Sub and Up filtered rows.
    j_screenshot.write_png(str(tmp_path / "a.png"), image)
    rows = [image[y].reshape(-1) for y in range(5)]
    (tmp_path / "b.png").write_bytes(_png_bytes(rows, 7, 4,
                                                [0, 1, 2, 0, 1]))
    for name in ("a.png", "b.png"):
        got = screenshot.read_png(str(tmp_path / name))
        want = j_screenshot.read_png(str(tmp_path / name))
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(screenshot.read_png(str(tmp_path
                                                          / "a.png")), image)
    # Flat HDR from the writer, and RLE scanlines.
    hdr = rng.uniform(0.0, 40.0, (6, 9, 3)).astype(np.float32)
    hdr[0, 0] = 0.0
    screenshot.write_hdr(str(tmp_path / "flat.hdr"), hdr)
    rgbe = rng.integers(0, 256, (3, 10, 4), dtype=np.uint8)
    (tmp_path / "rle.hdr").write_bytes(_rle_hdr_bytes(rgbe))
    for name in ("flat.hdr", "rle.hdr"):
        got = screenshot.read_hdr(str(tmp_path / name))
        want = j_screenshot.read_hdr(str(tmp_path / name))
        np.testing.assert_array_equal(got, want)
    low = rng.integers(0, 256, (4, 4, 3)) / 255.0
    high = rng.integers(0, 120, (4, 4, 3)) / 255.0
    np.testing.assert_array_equal(
        screenshot.combine_ldr_screenshots_into_hdr(low, high),
        j_screenshot.combine_ldr_screenshots_into_hdr(low, high))


def test_half_float_bytes_match_numpy():
    """The packing takes numpy's float16 bits: rounding, subnormals,
    negative values and overflow to inf (65520 and above)."""
    values = np.array([0.0, -0.0, 1.0, -3.25, 65504.0, 65519.0, 65520.0,
                       1e6, -1e6, 6e-8, 1e-3, 0.1234567], np.float32)
    bits = values.astype(np.float16).view(np.uint16).astype(np.int64)
    for frame_bits, want in ((1, bits & 0xFF), (2, bits >> 8)):
        got = pipeline.half_float_byte(torch.from_numpy(values), frame_bits)
        np.testing.assert_array_equal(got.numpy(),
                                      want.astype(np.float32) / 255.0)


@pytest.fixture(scope="module")
def cornell(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("cornell"))
    vks = write_test_scene(d, "cornell_box", texture_resolution=16)
    light = PolygonalLightSpec(
        translation=np.array([1.0, 1.0, 1.99], np.float32),
        rotation_angles=np.array([np.pi, 0, 0], np.float32),
        scaling_x=0.4, scaling_y=0.4,
        radiant_flux=np.array([40.0, 35.0, 30.0], np.float32))
    scene = load_scene(vks, d + "/cornell_box_textures", [light],
                       noise_type=NoiseType.WHITE, data_directory=d)
    camera = FirstPersonCamera(
        position_world_space=np.array([1.0, 0.15, 1.0], np.float32),
        rotation_x=np.pi / 2, rotation_z=np.pi)
    return scene, camera


def test_frame_bits_recombine_to_the_direct_frame(cornell):
    """frame_bits 1 and 2 recombine to the direct linear frame in float16,
    bit for bit, on the K5 path (plain version here), and to within the
    JAX package's own roundtrip tolerance of its recombined frame."""
    jscene, camera = cornell
    settings = RenderSettings(
        sampling_strategy=SamplingStrategy.DIFFUSE_ONLY,
        polygon_sampling_technique=(
            PolygonSamplingTechnique.PROJECTED_SOLID_ANGLE),
        sample_count=4, output_linear_rgb=True)
    scene = scene_from_numpy(tree_leaves(jscene), "cpu")
    static = SceneStatic.for_scene(scene)
    port_settings = to_port(settings)

    def port_frame(bits):
        return pipeline.render_frame(
            scene, static, to_port(camera),
            dataclasses.replace(port_settings, frame_bits=bits), WIDTH,
            HEIGHT)

    low, high, direct = hdr_capture.bit_frames(port_frame)
    combined = screenshot.combine_ldr_screenshots_into_hdr(low, high)
    assert hdr_capture.half_mismatches(combined, direct) == 0
    assert float(direct.max()) > 0.0

    jstatic = JSceneStatic(light_count=1, light_texturing=(0,),
                           traversal="bruteforce")
    j_low, j_high = (np.asarray(j_render(
        jscene, jstatic, camera, dataclasses.replace(
            settings, frame_bits=bits), WIDTH, HEIGHT))
        for bits in (1, 2))
    want = j_screenshot.combine_ldr_screenshots_into_hdr(j_low, j_high)
    np.testing.assert_allclose(combined, want, rtol=2e-3, atol=1e-4)


def test_hdr_capture_tool_on_cpu(tmp_path):
    path, max_rel, mismatches = hdr_capture.capture(
        "cornell_box", 32, 16, out_dir=str(tmp_path / "out"), device="cpu",
        data_directory=str(tmp_path / "data"))
    assert mismatches == 0 and max_rel <= hdr_capture.FP16_RELATIVE
    assert path.endswith("_standin_cpu.hdr")
    image = screenshot.read_hdr(path)
    assert image.shape == (16, 32, 3) and float(image.mean()) > 0.0
    assert hdr_capture.main([
        "--width", "16", "--height", "16", "--device", "cpu",
        "--out-dir", str(tmp_path / "out2"),
        "--data-directory", str(tmp_path / "data")]) == 0
