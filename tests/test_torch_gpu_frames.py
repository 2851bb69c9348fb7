"""The port's kernels and shading paths on the card, on the frames the
harness renders at their own sizes and on the bench frame: K4, K5 and K2
on five timing-sweep cells at 1920x1080, one for each light vertex count
(the two sweep cells and three holding cells); K4, K2 and K1 on the
arcade's heptagon frames at 1024x1024, the one scene of the harness whose
triangles are not axis-aligned; K1's slot entry on the benchmark's arcade
frame (experiment 316, 128 shadow slots a pixel); the timing-sweep
experiments through the harness (K5 runs, K4 does not); the bench frame
on the kernel path against the per-pixel path; the experiments that only
the per-pixel path renders, at their own sizes; and the harness's median
at the reference protocol against the window of the same Application.
Marked gpu: they skip where torch.cuda.is_available() is False; run them
on the card with the rest of the suite (tests/test_torch_gpu.py says
how). This file imports only the port (no JAX)."""

import dataclasses
import os

import pytest
import torch

from _torch_gpu_fixtures import built, data_dir, jax_free  # noqa: F401
from vulkan_renderer_tpu_torch.core import trace
from vulkan_renderer_tpu_torch.core.settings import \
    PolygonSamplingTechnique as Tech
from vulkan_renderer_tpu_torch.experiments import harness, setups
from vulkan_renderer_tpu_torch.render import fused, pipeline
from vulkan_renderer_tpu_torch.render import trace_kernel as tk
from vulkan_renderer_tpu_torch.tools import (bench_frame, kernel_check,
                                             per_pixel_check, profile_frame,
                                             sweep_check)

pytestmark = pytest.mark.gpu

# The sweep cells besides bench_frame.SWEEP_CELLS that hold K4 and K5 at
# the other vertex counts: (name, index of the cell's first technique).
HOLD_CELLS = (("central_3_128", 50), ("decentral_6_1x128spp", 245),
              ("central_7_128", 258))
CELLS = dict(bench_frame.SWEEP_CELLS + HOLD_CELLS)
# The techniques run through the harness in the holding cells.
HELD_TECHNIQUES = (Tech.PROJECTED_SOLID_ANGLE,
                   Tech.PROJECTED_SOLID_ANGLE_ARVO)
SWEEP_RUNS = [first + t for _, first in bench_frame.SWEEP_CELLS
              for t in range(len(Tech))] + [
    first + list(Tech).index(tech) for _, first in HOLD_CELLS
    for tech in HELD_TECHNIQUES]
# The arcade's heptagon frames through K4: PSA under DIFFUSE_ONLY (312)
# and under DIFFUSE_SPECULAR_MIS with clamped-optimal MIS (314).
ARCADE_EXPERIMENTS = (312, 314)
PER_PIXEL_EXPERIMENTS = (6, 7, 8, 46, 315, 324, 325, 326, 327)
# The harness's median at the reference protocol against the window: PSA
# in each sweep cell, and the tolerance.
PROTOCOL_EXPERIMENTS, PROTOCOL_RTOL = (113, 204), 0.05


@pytest.fixture(scope="module")
def experiments(data_dir):
    """The harness's experiments, their screenshots under data_dir."""
    return harness.create_experiment_list(
        output_dir=os.path.join(data_dir, "experiments"))


def _pink():
    """The NaN/Inf sentinel of a resolved frame."""
    return pipeline.linear_to_srgb(torch.tensor([1.0, 0.0, 0.8],
                                                device="cuda"))


def _sentinels(frame):
    return int((frame == _pink()).all(dim=-1).sum())


def _run(experiment, data_dir, warmup, measured):
    """Run one experiment through the harness: (its last frame, each
    kernel's launches in the run)."""
    last = {}
    trace.reset_counters()
    harness.run_experiments(
        [experiment], bench_frame.recording_application(data_dir, last),
        min_warmup_seconds=0.0, min_warmup_frames=warmup,
        measure_frames=measured, data_directory=data_dir, device="cuda")
    torch.cuda.synchronize()
    return last["image"], trace.launch_counts()


def _capture(data_dir, exp):
    """(experiment exp's Application, each kernel's arguments in its first
    frame)."""
    app, frame = bench_frame.experiment_frame(torch, data_dir, exp)
    return app, frame()


# --- the timing sweep at 1920x1080 ------------------------------------------


@pytest.fixture(scope="module", params=list(CELLS))
def sweep_cell(request, experiments, data_dir):
    """A sweep cell captured from the harness's own first frame of each
    technique at 1920x1080: {technique: K5's arguments at 4,096 evenly
    spaced pixels}, and K2's arguments in the first technique's frame."""
    first = CELLS[request.param]
    vertex_count = int(request.param.split("_")[1])
    held, closest = {}, None
    for t, tech in enumerate(Tech):
        exp = experiments[first + t]
        assert exp.settings.polygon_sampling_technique == tech
        assert (exp.width, exp.height) == (bench_frame.SWEEP_WIDTH,
                                           bench_frame.SWEEP_HEIGHT)
        app, captured = _capture(data_dir, exp)
        assert set(app.static.light_vertex_counts) == {vertex_count}
        if closest is None:
            closest = captured["trace_closest"]
        held[tech] = kernel_check.pixel_subset(captured["fused_resolved"])
        del app, captured
        torch.cuda.empty_cache()
    return held, closest


@pytest.mark.parametrize("tech", list(Tech), ids=lambda t: t.value)
def test_sweep_kernels_match_plain(sweep_cell, tech):
    """K5 and K4 under DIFFUSE_ONLY against their plain versions on 4,096
    pixels of the harness's frame of this cell and technique, and K4's
    slots resolved with visibility 1 against K5 (kernel_check.
    diffuse_only_faults: bit for bit, the Arvo techniques on all but 0.5%
    of their values)."""
    faults = kernel_check.diffuse_only_faults(sweep_cell[0][tech])
    assert not faults, faults


def test_sweep_closest_matches_plain(sweep_cell):
    """K2 on every primary ray of the cell's first frame: primitive and t
    exact, ties included."""
    r = kernel_check.compare_closest(sweep_cell[1])
    assert r["prim_mismatches"] == r["t_bit_mismatches"] == 0, r


@pytest.mark.parametrize("index", SWEEP_RUNS)
def test_sweep_experiment_launches_k5_alone(experiments, data_dir, index):
    """A timing-sweep experiment through the harness (both sweep cells'
    13 techniques, PSA and Arvo PSA of each holding cell; SWEEP_WARMUP
    warm-up and SWEEP_MEASURED measured frames): K5 runs and K4 does not;
    the frame is finite, has no NaN/Inf sentinel and a plausible mean
    (the 128-light cells divide both the flux and the exposure by 128,
    experiment_list.c:364-409, so their frames are dark)."""
    exp = experiments[index]
    frame, launches = _run(exp, data_dir, bench_frame.SWEEP_WARMUP,
                           bench_frame.SWEEP_MEASURED)
    assert launches["K5"] > 0 and launches["K4"] == 0, launches
    assert tuple(frame.shape) == (exp.height, exp.width, 3)
    assert bool(torch.isfinite(frame).all())
    assert _sentinels(frame) == 0
    assert 1e-4 < float(frame.mean()) < 0.95


# --- the arcade's heptagon frames at 1024x1024 ------------------------------


@pytest.fixture(scope="module")
def arcade_frames(experiments, data_dir):
    """Each kernel's arguments in the harness's first frame of experiments
    312 and 314: PSA on one heptagon, shadows on, the cornell stand-in's
    rotated blocks (30 triangles in one cluster, off the axes)."""
    frames = {}
    for index in ARCADE_EXPERIMENTS:
        app, frames[index] = _capture(data_dir, experiments[index])
        s = app.settings
        assert app.static.light_vertex_counts == (7,)
        assert s.trace_shadow_rays
        assert s.polygon_sampling_technique == Tech.PROJECTED_SOLID_ANGLE
    return frames


@pytest.mark.parametrize("index", ARCADE_EXPERIMENTS)
def test_arcade_shading_kernel_matches_plain(arcade_frames, index):
    """K4 against its plain version on 4,096 pixels: bit for bit."""
    args = kernel_check.pixel_subset(arcade_frames[index]["fused_shading"])
    r = kernel_check.compare(fused.fused_light_shading(*args),
                             fused.fused_light_shading_plain(*args))
    assert r["exact"] == 1.0 and r["nonfinite_mismatch"] == 0, r


def test_arcade_tracers_match_plain(arcade_frames):
    """On experiment 314's frame, K2 on every primary ray (primitive and t
    exact) and K1's ray list on 131,072 evenly spaced live rays of the
    frame's megabatch (exact)."""
    captured = arcade_frames[ARCADE_EXPERIMENTS[-1]]
    r = kernel_check.compare_closest(captured["trace_closest"])
    assert r["prim_mismatches"] == r["t_bit_mismatches"] == 0, r
    clusters, *rays = bench_frame.anyhit_args(captured)
    assert bool((rays[2] >= 0.0).any()), "no live shadow ray"
    rays = kernel_check.ray_subset(*rays)
    assert torch.equal(tk.trace_anyhit(clusters, *rays),
                       tk.trace_anyhit_plain(clusters, *rays))


def test_arcade_slot_entry_matches_the_route(experiments, data_dir):
    """K1's slot entry on the benchmark's arcade frame (experiment 316:
    1024x1024, 64 spp, 128 shadow slots a pixel): bit for bit as the ray
    list route (the plain megabatch, the ray-list K1 and the plain
    combine) on every pixel and as its plain version on 4,096 pixels; the
    live rays it counts are the megabatch's (t_max >= 0)."""
    _, captured = _capture(data_dir, experiments[316])
    args = captured["trace_anyhit_slots"][:7]
    clusters, out, slots, hit, position, cam, base0 = args
    live = torch.zeros((), dtype=torch.int32, device="cuda")
    got = tk.trace_anyhit_slots(*args, live)
    rays = tk.shadow_megabatch(out, slots, hit, position, cam)
    live_want = int((rays[2] >= 0.0).sum())
    want = tk.shadow_combine(out, slots, tk.trace_anyhit(clusters, *rays),
                             base0)
    del rays
    assert kernel_check.bit_mismatches(got, want) == 0
    assert int(live) == live_want
    row, _ = kernel_check.hold_slot_entry(captured)
    assert row["bit_mismatches"] == 0, row


# --- the bench frame on both shading paths ----------------------------------


@pytest.fixture(scope="module")
def bench(data_dir):
    return bench_frame.load_city(data_dir, "cuda")


@pytest.mark.parametrize("shadows", [True, False])
def test_bench_frame_paths_agree(bench, shadows):
    """The bench frame through the kernels (shadows on: K1-K4; off: K5)
    and through the per-pixel shading path (fused="off": K1 with shadows,
    K2, K3, K6 and plain PyTorch shading, neither K4 nor K5) agree at the
    CPU parity tests' frame tolerance (per_pixel_check.frames_agree): two
    formulations of the estimator, ops/soa*.py and ops/sampling*.py. The
    kernel frame is finite, has no NaN/Inf sentinel and a plausible mean,
    and the profiler sees the per-pixel frame's device launches."""
    scene, static = bench
    settings = dataclasses.replace(bench_frame.settings(),
                                   trace_shadow_rays=shadows)
    per_pixel = dataclasses.replace(static, fused="off")
    frames, launches = {}, {}
    for name, st in (("kernels", static), ("per_pixel", per_pixel)):
        trace.reset_counters()
        with torch.no_grad():
            frames[name] = bench_frame.render(scene, st, settings)
        torch.cuda.synchronize()
        launches[name] = trace.launch_counts()
    image = frames["kernels"]
    fused_kernels = ("K1", "K2", "K3", "K4") if shadows else ("K2", "K3",
                                                              "K5")
    assert all(launches["kernels"][k] > 0 for k in fused_kernels), launches
    n = launches["per_pixel"]
    assert all(n[k] > 0 for k in ("K2", "K3", "K6")), n
    assert (n["K1"] > 0) == shadows and n["K4"] == n["K5"] == 0, n
    assert tuple(image.shape) == (bench_frame.HEIGHT, bench_frame.WIDTH, 3)
    assert bool(torch.isfinite(image).all())
    assert _sentinels(image) == 0
    assert 0.01 < float(image.mean()) < 0.99
    ok, stats = per_pixel_check.frames_agree(image.cpu().numpy(),
                                             frames["per_pixel"].cpu().numpy())
    assert ok, stats
    profiled, _ = profile_frame.profile_frames(
        torch, lambda: bench_frame.render(scene, per_pixel, settings), 1, 1)
    assert profiled is not None


@pytest.mark.parametrize("index", PER_PIXEL_EXPERIMENTS)
def test_per_pixel_experiment_at_full_size(experiments, data_dir, index):
    """An experiment only the per-pixel path renders (error displays 6-8,
    the IES light 46, GGX MIS 315, the linear lights 324-327) through the
    harness at its own size (1 warm-up, 2 measured frames): the frame has
    the experiment's shape, is finite and not black, in under 40 GiB of
    device memory; K2, K3 and K6 run, K1 where shadows are on, K4 and K5
    not; the profiler sees one more frame's device launches."""
    exp = experiments[index]
    torch.cuda.reset_peak_memory_stats()
    frame, n = _run(exp, data_dir, 1, 2)
    peak = torch.cuda.max_memory_allocated() / 2**30
    assert tuple(frame.shape) == (exp.height, exp.width, 3)
    assert bool(torch.isfinite(frame).all())
    assert float(frame.mean()) > 0.0
    assert peak < 40.0, peak
    assert all(n[k] > 0 for k in ("K2", "K3", "K6")), n
    assert (n["K1"] > 0) == exp.settings.trace_shadow_rays, n
    assert n["K4"] == n["K5"] == 0, n
    app = setups.build_default_application(exp, data_dir, device="cuda")
    profiled, _ = profile_frame.profile_frames(torch, app.render_frame_sync,
                                               1, 1)
    assert profiled is not None


# --- the reference protocol ------------------------------------------------


@pytest.mark.parametrize("index", PROTOCOL_EXPERIMENTS)
def test_reference_protocol_median_within_the_window(experiments, data_dir,
                                                     index):
    """PSA in each sweep cell at the reference protocol (110 warm-up frames
    and >= 1 s, 100 measured; tools/sweep_check.py): K5 runs and K4 does
    not, and the harness's median lies within PROTOCOL_RTOL of the window
    ms/frame of the same Application (tools/bench_frame.py window_ms)."""
    csv_path = os.path.join(data_dir, f"protocol_{index}.csv")
    trace.reset_counters()
    row = sweep_check.measure(index, experiments[index], csv_path,
                              bench_frame.card_name(), data_dir)
    launches = trace.launch_counts()
    assert launches["K5"] > 0 and launches["K4"] == 0, launches
    row.pop("deltas_ms")
    assert abs(row["ratio"] - 1.0) <= PROTOCOL_RTOL, row
