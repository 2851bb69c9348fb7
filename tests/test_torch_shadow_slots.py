"""K1's slot entry (render/trace_kernel.py trace_anyhit_slots) on the
CPU, where it takes its plain version: the ray list a frame hands K1 is
read from K4's (3 + 7 S, P) slot planes, and the colors are combined in
slot groups in a fixed order (shadow_combine), the order the CUDA entry
sums in (csrc/anyhit.cu). The entry is held against the ray-list route
built apart from it (tests/_torch_slot_inputs.py: the rays slot by slot,
trace_anyhit_plain, and one torch.sum over the slots, the combine before
slot groups), within the bound float32 rounding sets on two orders of
one sum, and against the float64 sum; shadow_megabatch must build the
route's rays bit for bit. Cases: slot planes drawn from a seed over the
tiny city (S = 1, S not a multiple of the groups, S = 128; P not a
multiple of 32; miss pixels, dead slots), and the bench frame and the
arcade frame as the pipeline hands them over. A miss pixel's rays start
at the camera, a dead slot adds its zero weight whatever its direction,
and a NaN weight in an occluded slot gives a NaN color (the product, not
a skip). The kernel itself runs on the card, bit for bit against this
plain version (tests/test_torch_gpu.py)."""

import dataclasses
import os

import pytest
import torch

from _torch_slot_inputs import (assert_sums_agree, occluded_slot,
                                slot_inputs, slot_rays, summed_route)
from vulkan_renderer_tpu_torch.core.app import (Application,
                                                SceneSpecification)
from vulkan_renderer_tpu_torch.experiments import harness as experiments
from vulkan_renderer_tpu_torch.experiments import setups
from vulkan_renderer_tpu_torch.render import pipeline
from vulkan_renderer_tpu_torch.render import trace_kernel as tk
from vulkan_renderer_tpu_torch.render.shading import SceneStatic
from vulkan_renderer_tpu_torch.scene.scene import load_scene
from vulkan_renderer_tpu_torch.tools import bench_frame
from vulkan_renderer_tpu_torch.tools.export_scene import write_test_scene
from vulkan_renderer_tpu_torch.tools.kernel_check import bit_mismatches

PIXELS = 1000          # not a multiple of 32
SEED = 2**31 + 21


@pytest.fixture(scope="module")
def city(tmp_path_factory):
    """The tiny city (make_city(20, detail=3)) under the bench frame's
    lights, on the CPU."""
    d = str(tmp_path_factory.mktemp("slots_city"))
    vks, textures = bench_frame.city_files(d, buildings=20, detail=3)
    return load_scene(vks, textures, bench_frame.lights(), "cpu",
                      data_directory=d)


@pytest.mark.parametrize("slots", [0, 1, 5, 8, 13, 16, 128, 130])
def test_slot_groups_cover_the_slots_in_order(slots):
    count, per_group = tk.slot_groups(slots)
    assert 1 <= count <= tk.SLOT_GROUPS
    covered = [s for g in range(count)
               for s in range(g * per_group, min(slots, (g + 1) * per_group))]
    assert covered == list(range(slots))
    # Every group holds a slot, all as many as the first but the last.
    assert slots == 0 or (count - 1) * per_group < slots


@pytest.mark.parametrize("slots", [1, 13, 128])
def test_the_entry_is_the_ray_list_route(city, slots):
    clusters = city.clusters
    pixels = PIXELS if slots < 128 else 250
    args = slot_inputs(clusters, slots, pixels, SEED + slots)
    out, _, hit, position, cam, base0 = args
    assert pixels % 32 and (~hit).any()
    live = torch.zeros((), dtype=torch.int32)
    got = tk.trace_anyhit_slots(clusters, *args, live)
    want, magnitude, occluded = summed_route(clusters, *args)
    assert_sums_agree(got, want, magnitude, slots)
    rays = slot_rays(out, slots, hit, position, cam)
    for built, made in zip(tk.shadow_megabatch(out, slots, hit, position,
                                               cam), rays):
        assert bit_mismatches(built, made) == 0
    t_max = rays[2]
    assert int(live) == int((t_max >= 0.0).sum())
    assert 0 < int(live) < t_max.numel()
    # Some rays occluded, some not: the sum is not all of b or none.
    assert 0 < int((occluded & (t_max >= 0.0)).sum()) < int(live)
    # The grouped float32 sum is the sum, up to its rounding.
    visibility = (~occluded).double().reshape(slots, 1, pixels)
    b = out[3:].reshape(slots, 7, pixels)[:, 0:3].double()
    exact = base0.double() + out[0:3].T.double() \
        + (b * visibility).sum(dim=0).T
    torch.testing.assert_close(got.double(), exact, rtol=1e-6, atol=0.0)


def test_miss_pixels_start_at_the_camera(city):
    clusters = city.clusters
    out, _, hit, position, cam, base0 = slot_inputs(clusters, 13, PIXELS,
                                                    SEED)
    at_cam = torch.where(hit[:, None], position, cam).T.contiguous().T
    got = tk.trace_anyhit_slots(clusters, out, 13, hit, position, cam,
                                base0)
    moved = tk.trace_anyhit_slots(clusters, out, 13,
                                  torch.ones_like(hit), at_cam, cam, base0)
    assert bit_mismatches(got, moved) == 0


def test_dead_slots_trace_nothing(city):
    """A slot whose weight is zero in all three channels adds nothing,
    whatever its direction and t_max, and is not counted live."""
    clusters = city.clusters
    slots = 13
    out, _, hit, position, cam, base0 = slot_inputs(clusters, slots,
                                                    PIXELS, SEED)
    rest = out[3:].view(slots, 7, PIXELS)
    dead = (rest[:, 0:3] == 0.0).all(dim=1)
    assert dead.any()
    other = out.clone()
    rest_other = other[3:].view(slots, 7, PIXELS)
    rest_other[:, 3:7] = torch.where(dead[:, None], -rest[:, 3:7] * 3.0,
                                     rest[:, 3:7])
    counts = [torch.zeros((), dtype=torch.int32) for _ in range(2)]
    got = [tk.trace_anyhit_slots(clusters, o, slots, hit, position, cam,
                                 base0, n)
           for o, n in ((out, counts[0]), (other, counts[1]))]
    assert bit_mismatches(got[0], got[1]) == 0
    assert int(counts[0]) == int(counts[1]) \
        == int((~dead & (rest[:, 6] >= 0.0)).sum())


def test_a_nan_weight_in_an_occluded_slot_gives_a_nan_color(city):
    clusters = city.clusters
    slots = 13
    out, _, hit, position, cam, base0 = slot_inputs(clusters, slots,
                                                    PIXELS, SEED)
    s, p = occluded_slot(clusters, out, slots, hit, position, cam)
    out[3 + 7 * s, p] = float("nan")
    got = tk.trace_anyhit_slots(clusters, out, slots, hit, position, cam,
                                base0)
    assert torch.isnan(got[p, 0]) and torch.isfinite(got[p, 1:]).all()
    assert int(torch.isnan(got).sum()) == 1


@pytest.fixture(scope="module")
def arcade(tmp_path_factory):
    """The arcade frame (experiment 316 on the cornell stand-in) at 32x32
    and 4 spp, as the benchmark's Application builds it."""
    d = str(tmp_path_factory.mktemp("slots_arcade"))
    experiment = experiments.create_experiment_list()[316]
    settings = dataclasses.replace(experiment.settings, sample_count=4)
    vks = write_test_scene(d, "cornell_box", texture_resolution=16)
    spec = SceneSpecification(
        "arcade", vks, os.path.join(d, "cornell_box_textures"),
        camera=setups._scene_default_camera("arcade"),
        lights=setups.experiment_lights(experiment, d))
    return Application(spec, settings, 32, 32, frames_in_flight=1,
                       data_directory=d, device="cpu")


@pytest.mark.parametrize("which", ["bench", "arcade"])
def test_frames_hand_over_what_the_route_traces(city, arcade, which):
    """The slot planes of a whole frame (K4's plain version) through the
    entry give the ray-list route's colors, within the rounding of the
    slot sum's order, and the frame is their resolve."""
    if which == "bench":
        scene, static, settings = city, SceneStatic.for_scene(city), \
            bench_frame.settings()
        camera, width, height = bench_frame.camera(), 64, 32
    else:
        scene, static, settings = arcade.scene, arcade.static, \
            arcade.settings
        camera, width, height = arcade.scene_spec.camera, 32, 32
    captured = {}
    with torch.no_grad():
        image = pipeline.render_frame(
            scene, static, camera, settings, width, height,
            bench_frame.noise_numbers(),
            bench_frame.recording_kernels(captured))
        args = captured["trace_anyhit_slots"][:7]
        clusters, out, slots = args[:3]
        assert out.shape == (3 + 7 * slots, width * height)
        got = tk.trace_anyhit_slots(*args)
        want, magnitude, _ = summed_route(*args)
        assert_sums_agree(got, want, magnitude, slots)
        rays = slot_rays(out, slots, *args[3:6])
        assert (rays[2] >= 0.0).any() and (rays[2] < 0.0).any()
        constants = pipeline.make_frame_constants(
            camera, width, height, settings, bench_frame.noise_numbers(),
            "cpu")
        resolved = pipeline._resolve(got, constants, settings, width,
                                     height)
    assert bit_mismatches(resolved, image) == 0
