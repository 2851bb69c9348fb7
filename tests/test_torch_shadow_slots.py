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
a skip). The packets that hold a live ray, which the plain version
counts from the megabatch for each packet width, are held against a
count built group by group apart from it; the packet width fits a slot
group; and the cases the kernel's packets are held on at every width
provoke what they are named for. The kernel itself runs on the card,
bit for bit against this plain version (tests/test_torch_gpu.py)."""

import dataclasses
import os

import pytest
import torch

from _torch_slot_inputs import (CASE_SLOTS, PACKET_CASES,
                                assert_sums_agree, occluded_slot,
                                packet_case, slot_inputs, slot_rays,
                                summed_route)
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


def packets_apart(out, slots: int, packet: int) -> int:
    """The packets of `packet` slots that hold a live ray (b not zero in
    every channel, t_max >= 0), counted slot group by slot group, packet
    by packet."""
    pixels = out.shape[1]
    rest = out[3:].view(slots, 7, pixels)
    live = (rest[:, 0:3] != 0.0).any(dim=1) & (rest[:, 6] >= 0.0)
    count, per_group = tk.slot_groups(slots)
    total = 0
    for g in range(count):
        end = min(slots, (g + 1) * per_group)
        for start in range(g * per_group, end, packet):
            total += int(live[start:min(start + packet, end)].any(dim=0)
                         .sum())
    return total


@pytest.mark.parametrize("packet", tk.PACKET_WIDTHS)
@pytest.mark.parametrize("slots", [1, 13, 128])
def test_packets_are_counted_as_built_apart(city, slots, packet):
    clusters = city.clusters
    pixels = PIXELS if slots < 128 else 250
    args = slot_inputs(clusters, slots, pixels, SEED + slots)
    live, packets = (torch.zeros((), dtype=torch.int32) for _ in range(2))
    tk.trace_anyhit_slots(clusters, *args, live, packets, packet=packet)
    want = packets_apart(args[0], slots, packet)
    assert int(packets) == want
    assert int(live) / packet <= want <= int(live)
    # Packets of more than one slot hold more than one live ray.
    per_group = tk.slot_groups(slots)[1]
    assert (want < int(live)) == (packet > 1 and per_group > 1)


@pytest.mark.parametrize("slots", [1, 7, 8, 13, 16, 64, 128, 130])
def test_the_packet_width_fits_a_slot_group(slots):
    width = tk.packet_width(slots)
    per_group = tk.slot_groups(slots)[1]
    assert width in tk.PACKET_WIDTHS
    assert width == min(tk.PACKET, max(
        w for w in tk.PACKET_WIDTHS if w <= per_group))


@pytest.mark.parametrize("case", ["dead_packets", "first_triangle",
                                  "opposite_lights"])
def test_packet_cases_part_as_named(city, case):
    """The built cases of the packet tests: whole packets of dead slots;
    packets whose even slots are occluded by the triangle under the pixel
    and whose odd slots never are; packets toward both sides of the scene,
    some rays occluded and some not in one packet."""
    clusters = city.clusters
    out, slots, hit, position, cam, base0 = packet_case(clusters, case,
                                                        SEED)
    assert slots == CASE_SLOTS
    rays = slot_rays(out, slots, hit, position, cam)
    live = (rays[2] >= 0.0).reshape(slots, -1)
    occluded = tk.trace_anyhit_plain(clusters, *rays).reshape(slots, -1)
    if case == "dead_packets":
        assert not live[:, 0::3].any() and not live[:8, 1::3].any()
        assert live[8:, 1::3].any(dim=0).all()
        return
    assert live.all()
    if case == "first_triangle":
        assert occluded[0::2].all() and not occluded[1::2].any()
        return
    assert bool((rays[1].reshape(slots, -1, 3)[0::2, :, 0] < 0).all())
    mixed = occluded.reshape(8, 8, -1).any(dim=1) \
        & ~occluded.reshape(8, 8, -1).all(dim=1)
    assert int(mixed.sum()) > 10


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
