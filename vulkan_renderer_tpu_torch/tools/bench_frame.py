#!/usr/bin/env python3
"""The bench frame: its one definition, and a timer for it on one GPU.

The bench frame is 960x540 at 1 spp on the procedural city (300
buildings, detail 10), lit by four quad street lights, with PSA +
DIFFUSE_SPECULAR_MIS, clamped-optimal MIS and shadows on: the frame of the
JAX package's bench.py at its defaults. The gpu-marked tests
(tests/test_torch_gpu*.py) hold the kernels on the frames the functions
below build, and the port's bench entry (vulkan_renderer_tpu_torch/
bench.py) renders its frame at bench.py's options (scene scale, spp,
shadows, materials, cluster size). The two timing-sweep cells that
--sweep times (SWEEP_CELLS) are defined here too.

Run as a script, it times the port found under --root (default: the
checkout this file is in), so that two trees can be compared in one run
on one card:

    python3 vulkan_renderer_tpu_torch/tools/bench_frame.py \
        [--root DIR] [--data DIR] [--sweep] [--count-tests] [--kernels]

It builds the bench frame's kernel libraries (K1-K4), writes or reuses
the bench city under --data, and prints one JSON line: the root, the
card (nvidia-smi name and power limit), the median and all ms/frame of
FRAMES frames after WARMUP warm-up frames (host clock around each frame
and a synchronize), each kernel's ms at the frame's shapes (CUDA events,
warm L2), the share of hit pixels K4 shades, and the register report of
every library built, and the window ms/frame: WINDOW_FRAMES frames
dispatched through core/app.py's Application with its frames in flight,
the host clock from the first dispatch until the last frame retires,
divided by WINDOW_FRAMES (after WARMUP frames rendered one at a time).
With --count-tests it adds K1's and K2's BVH child-box, sub-box and
triangle tests over the bench frame's rays (their -DVR_COUNT_TESTS=1
builds). With --sweep it adds, for PSA and Arvo PSA in both sweep cells
(--sweep-techniques all: for all 13 techniques; their K5 libraries are
built first, in parallel): the window
ms/frame as above, the harness's median ms/frame (SWEEP_WARMUP warm-up
and SWEEP_MEASURED measured frames, pipelined; the median of a few
timer-stamp deltas, which bunch when frames overlap), K5's ms on the
frame's inputs, the device memory allocated before a frame and at its
peak (torch.cuda.max_memory_allocated), and the hit share. With
--kernels it prints a second JSON line, the kernels line (kernels_line:
each kernel's launches, ms, plain version's ms and bound; PERF.md's
kernel table), which needs a tree with K1's slot entry. Without
--kernels it uses only the entry points that every tree of the port has
had since the timing sweep was first ported. It imports no JAX.
"""

import argparse
import dataclasses
import gc
import json
import os
import subprocess
import sys
import time

WIDTH, HEIGHT = 960, 540
WARMUP, FRAMES = 3, 15
# Timing-sweep cells (experiment_list.c:364-409): (name, index of the
# cell's first technique in the harness's list), at 1920x1080.
SWEEP_CELLS = (("central_4_128", 102), ("decentral_5_1x128spp", 193))
SWEEP_WIDTH, SWEEP_HEIGHT = 1920, 1080
SWEEP_WARMUP, SWEEP_MEASURED = 3, 7
WINDOW_FRAMES = 40
# The light vertex counts the timing sweep renders (experiments 50-309):
# K4 and K5 compile one body per count (csrc/techniques.cuh template <int
# NV>).
VERTEX_COUNTS = (3, 4, 5, 6, 7)
# The arcade's heptagon frames (experiments 312-316) light one 7-gon.
ARCADE_VERTEX_COUNT = 7
# The kernels line's sweep frames: the central 4-gon 128-light PSA cell
# (K5's row) and the 1-light 1920x1080 heptagon cell (K6's row).
PSA_SWEEP_EXPERIMENT, PREAMBLE_EXPERIMENT = 113, 282

# The kernels line's bounds: bytes over the H100 SXM's device memory rate
# or float32 operations over its rate outside the tensor cores, whichever
# is larger. 67 TFLOP/s counts a fused multiply-add as two operations, so
# 33.5 T instructions per second; the kernels are built with
# --fmad=false, so each operation below is one.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 33.5e12
# Float32 operations per test, counted from csrc/common.cuh slab (per axis
# 2 sub, 2 mul, min, max; 4 min/max to combine; 4 comparisons) and the two
# Moeller-Trumbore bodies (crosses, dots, sign or reciprocal, 6-7 tests).
SLAB_OPS, ANYHIT_TRI_OPS, CLOSEST_TRI_OPS = 26, 55, 57
# K1's sub-box gate (csrc/anyhit.cu grown_slab): the slab test plus the
# two moves of each axis's entry and exit.
ANYHIT_SUBBOX_OPS = SLAB_OPS + 6
# K1's slot entry's traffic: 28 B a slot ray (b, direction, t_max, read
# in place from K4's planes), and per pixel its shading point, hit flag,
# base0 and base in and its colors out.
K1_RAY_BYTES = 4 * 7
K1_PIXEL_BYTES = 4 * 3 + 1 + 4 * 3 + 4 * 3 + 4 * 3
# K6's plane traffic per pixel: in, K3's 18 attribute planes, prim, t_hit
# and the ray direction; out, the 62 shading planes.
K6_PIXEL_BYTES = 4 * (18 + 1 + 1 + 3) + 4 * 62
# K3's float32 operations per hit ray, counted from csrc/closest.cu
# attrs_kernel as K4's and K5's counting builds count (csrc/count_ops.cuh:
# add, sub, mul, div, sqrt, rsqrt, compare, max one each): barycentrics 42,
# the two UV-derivative rows 2 x 43, normal, UV, tangent frame 88. A miss
# does none.
K3_OPS_PER_HIT = 216


def hit_mask(planes):
    """The hit row (1 or 0 per pixel) of K4's or K5's (62, P) planes."""
    from vulkan_renderer_tpu_torch.render import fused
    return planes[fused.BASE_PLANES.index("hit")]


def cuda_ms(torch, fn, reps):
    """Device time per call over `reps` calls after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_once(torch, fn):
    """(device ms, result) of one call, timed with CUDA events."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def card_name():
    """nvidia-smi's name and power limit of the first card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def settings(spp=1, shadows=True):
    from vulkan_renderer_tpu_torch.render import fused
    return fused.RenderSettings(
        sampling_strategy=fused.SamplingStrategy.DIFFUSE_SPECULAR_MIS,
        polygon_sampling_technique=(
            fused.PolygonSamplingTechnique.PROJECTED_SOLID_ANGLE),
        sample_count=spp, trace_shadow_rays=shadows)


def light_layout():
    """The SceneStatic of the four quad lights, known before the scene
    loads, so that the kernels can build meanwhile."""
    from vulkan_renderer_tpu_torch.render.shading import SceneStatic
    return SceneStatic(light_count=4, light_texturing=(0,) * 4,
                       light_vertex_counts=(4,) * 4)


def kernel_defines(s, static, kernel="K4"):
    """The defines of K4's or K5's library (trees that predate
    fused.library_defines compose them as the wrappers did)."""
    from vulkan_renderer_tpu_torch.render import fused
    if hasattr(fused, "library_defines"):
        return fused.library_defines(kernel, static, s)
    return {**fused.kernel_defines(s),
            "VR_NV_MASK": fused.vertex_count_mask(static)}


def kernel_jobs(s):
    """build.build_many jobs of the kernels the bench frame launches under
    s: K1-K4 and K6 with shadows, K2, K3, K5 and K6 without."""
    if not s.trace_shadow_rays:
        return [("closest", {}), ("preamble", {}),
                ("fused_resolved", kernel_defines(s, light_layout(), "K5"))]
    return [("anyhit", {}), ("closest", {}), ("preamble", {}),
            ("fused_shading", kernel_defines(s, light_layout()))]


def suite_jobs():
    """build.build_many jobs of the libraries that the gpu-marked tests
    load, so that they build in parallel before the first test: the bench
    frame's with shadows and without; K4 and K5 for the 13 techniques
    under DIFFUSE_ONLY at every vertex count the timing sweep renders, one
    light of it (the sweep frames) and one light of each (the tests'
    roughness planes); K4 under the arcade's clamped-optimal MIS on a
    heptagon; K4 and K5 for the PSA pair under DIFFUSE_SPECULAR_MIS with
    every heuristic at the bench frame's lights and at one light of each
    count."""
    from vulkan_renderer_tpu_torch.render import fused
    from vulkan_renderer_tpu_torch.render.shading import SceneStatic
    s = settings()

    def shading(kernel, s, static):
        return (fused._KERNELS[kernel][0],
                kernel_defines(s, static, kernel))

    def lights_of(counts):
        return SceneStatic(light_count=len(counts),
                           light_texturing=(0,) * len(counts),
                           light_vertex_counts=counts)

    every_count = lights_of(VERTEX_COUNTS)
    jobs = kernel_jobs(s) + kernel_jobs(settings(shadows=False))
    for tech in fused.PolygonSamplingTechnique:
        t = fused.RenderSettings(
            sampling_strategy=fused.SamplingStrategy.DIFFUSE_ONLY,
            polygon_sampling_technique=tech)
        jobs += [shading(k, t, static) for static in [every_count] + [
            lights_of((nv,)) for nv in VERTEX_COUNTS] for k in ("K4", "K5")]
    jobs.append(shading("K4", dataclasses.replace(
        s, mis_heuristic=fused.MisHeuristic.OPTIMAL_CLAMPED),
        lights_of((ARCADE_VERTEX_COUNT,))))
    psa_pair = (fused.PolygonSamplingTechnique.PROJECTED_SOLID_ANGLE,
                fused.PolygonSamplingTechnique.PROJECTED_SOLID_ANGLE_BIASED)
    jobs += [shading(k, dataclasses.replace(
        s, polygon_sampling_technique=tech, mis_heuristic=heuristic),
        static)
        for static in (light_layout(), every_count) for tech in psa_pair
        for heuristic in fused.MisHeuristic for k in ("K4", "K5")]
    return [(n, dict(d)) for n, d in dict.fromkeys(
        (n, tuple(sorted(d.items()))) for n, d in jobs)]


def city_stem(scene="city", buildings=300, detail=10, materials=6):
    """The scale-tagged name of a bench city (bench.py: changing its scale
    writes a new city instead of reusing a cached one)."""
    return f"{scene}_{buildings}x{detail}" + (
        f"_m{materials}" if materials != 6 else "")


CITY = city_stem()


def city_files(data_dir, scene="city", buildings=300, detail=10,
               materials=6):
    """Write (once) a bench city, by default the bench frame's: (its .vks
    path, its texture directory)."""
    from vulkan_renderer_tpu_torch.tools.city import write_city_scene
    stem = city_stem(scene, buildings, detail, materials)
    vks = os.path.join(data_dir, f"{stem}.vks")
    if not os.path.exists(vks):
        vks = write_city_scene(data_dir, stem, n_buildings=buildings,
                               detail=detail, n_materials=materials)
    return vks, os.path.join(data_dir, f"{stem}_textures")


def lights():
    """The bench frame's four quad street lights."""
    import numpy as np

    from vulkan_renderer_tpu_torch.scene.lights import PolygonalLightSpec
    return [PolygonalLightSpec(
        translation=np.array([-30.0 + 20.0 * i, 0.0, 8.0], np.float32),
        rotation_angles=np.array([np.pi, 0.0, 0.0], np.float32),
        scaling_x=1.5, scaling_y=1.5,
        radiant_flux=np.array([400.0, 380.0, 340.0], np.float32))
        for i in range(4)]


def load_city(data_dir, device, cluster_size=64, **city):
    """Write (once) and load a bench city (city_files' keywords; by
    default the bench frame's) with its four lights: (scene, its
    SceneStatic)."""
    from vulkan_renderer_tpu_torch.render.shading import SceneStatic
    from vulkan_renderer_tpu_torch.scene import scene as scene_module
    vks, textures = city_files(data_dir, **city)
    scene = scene_module.load_scene(vks, textures, lights(), device,
                                    data_directory=data_dir,
                                    cluster_size=cluster_size)
    return scene, SceneStatic.for_scene(scene)


def application(data_dir, device, spp=1):
    """The bench frame as an Application (core/app.py): its scene, camera,
    settings (at spp samples a pixel) and size, three frames in flight."""
    from vulkan_renderer_tpu_torch.core.app import (Application,
                                                    SceneSpecification)
    vks, textures = city_files(data_dir)
    return Application(
        SceneSpecification(name=CITY, vks_path=vks, texture_dir=textures,
                           camera=camera(), lights=lights()),
        settings(spp), WIDTH, HEIGHT, data_directory=data_dir,
        device=device)


def camera():
    import numpy as np

    from vulkan_renderer_tpu_torch.render.pipeline import FirstPersonCamera
    return FirstPersonCamera(
        position_world_space=np.array([0.0, 0.0, 2.0], np.float32),
        rotation_x=0.55 * np.pi, rotation_z=0.5 * np.pi)


def noise_numbers():
    import numpy as np
    return (np.arange(4) * 0x123456).astype(np.uint32)


def render(scene, static, s, kernels=None, width=WIDTH, height=HEIGHT,
           stop_after=None):
    """One bench frame (H, W, 3) through `kernels` (default: the port's
    kernels), cut after the stage stop_after if given."""
    from vulkan_renderer_tpu_torch.render import pipeline
    kernels = pipeline.KERNELS if kernels is None else kernels
    return pipeline.render_frame(scene, static, camera(), s, width, height,
                                 noise_numbers(), kernels,
                                 stop_after=stop_after)


def recording_kernels(captured):
    """The port's kernels as a pipeline.FrameKernels whose every call also
    records its arguments into `captured`, keyed by the field called."""
    from vulkan_renderer_tpu_torch.render import pipeline

    def recorder(name, fn):
        def call(*args):
            captured[name] = args
            return fn(*args)
        return call

    return pipeline.FrameKernels(*(
        recorder(f.name, getattr(pipeline.KERNELS, f.name))
        for f in dataclasses.fields(pipeline.FrameKernels)))


def capture_inputs(scene, static, s, width=WIDTH, height=HEIGHT):
    """Render one frame (the bench frame's camera, at width x height) and
    return each kernel's arguments, keyed by the pipeline.FrameKernels
    field that took them."""
    captured = {}
    render(scene, static, s, recording_kernels(captured), width, height)
    return captured


def anyhit_args(captured):
    """The ray-list K1's arguments (clusters, origins, dirs, t_max) of a
    captured frame: the shadow megabatch (render/trace_kernel.py
    shadow_megabatch) of the slot planes K1's slot entry took; a tree
    whose frame traced a ray list (--root) captured them as they were."""
    if "trace_anyhit" in captured:
        return captured["trace_anyhit"]
    from vulkan_renderer_tpu_torch.render import trace_kernel as tk
    clusters, out, slots, hit, position, cam = \
        captured["trace_anyhit_slots"][:6]
    return (clusters, *tk.shadow_megabatch(out, slots, hit, position, cam))


def frame_ms(torch, scene, static, s):
    """ms of FRAMES frames after WARMUP warm-up frames: host clock around
    each frame and a synchronize."""
    for _ in range(WARMUP):
        render(scene, static, s)
    torch.cuda.synchronize()
    times = []
    for _ in range(FRAMES):
        start = time.perf_counter()
        render(scene, static, s)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - start) * 1e3)
    return times


def window_ms(torch, app, warmup):
    """ms a frame of `app` (core/app.py Application) over WINDOW_FRAMES
    frames with its frames in flight: the host clock from the first
    dispatch until the last frame retires, over WINDOW_FRAMES, after
    `warmup` frames rendered one at a time. The garbage of earlier work in
    the process is collected before the clock starts: a full collection
    of a long run's backlog (millions of objects, a profiler's events
    among them) takes long enough to move a 40-frame window by several
    ms a frame."""
    for _ in range(warmup):
        app.render_frame_sync()
    gc.collect()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(WINDOW_FRAMES):
        app.render_frame_async()
    torch.cuda.synchronize()
    return (time.perf_counter() - start) * 1e3 / WINDOW_FRAMES


def kernel_ms(torch, captured):
    """K1-K4 ms at the frame's shapes (CUDA events, warm L2); K1 on the
    frame's ray list, and (where the tree has it) K1's slot entry with the
    combine ("K1_slots")."""
    from vulkan_renderer_tpu_torch.render import pipeline
    k = pipeline.KERNELS
    rays = anyhit_args(captured)
    out = {} if "trace_anyhit_slots" not in captured else {
        "K1_slots": cuda_ms(torch, lambda: k.trace_anyhit_slots(
            *captured["trace_anyhit_slots"]), 5)}
    return {
        **out,
        "K1": cuda_ms(torch, lambda: k.trace_anyhit(*rays), 5),
        "K2": cuda_ms(torch, lambda: k.trace_closest(
            *captured["trace_closest"]), 5),
        "K3": cuda_ms(torch, lambda: k.closest_attrs(
            *captured["closest_attrs"]), 10),
        "K4": cuda_ms(torch, lambda: k.fused_shading(
            *captured["fused_shading"]), 5),
    }


def test_counts(torch, captured):
    """K1's and K2's BVH child-box, sub-box and triangle tests over the
    frame's rays, from their counting builds (-DVR_COUNT_TESTS=1), and
    their live rays (t_max >= 0)."""
    from vulkan_renderer_tpu_torch.render import trace_kernel as tk
    out = {}
    for name, fn, args in (("K1", tk.trace_anyhit, anyhit_args(captured)),
                           ("K2", tk.trace_closest,
                            captured["trace_closest"])):
        counts = torch.zeros(3, dtype=torch.int64, device=args[2].device)
        fn(*args, test_counts=counts)
        out[name] = dict(zip(("boxes", "subboxes", "triangles"),
                             counts.tolist()),
                         rays=int((args[3] >= 0).sum()))
    return out


def bound_ms(bytes_moved, operations):
    """(least ms, the side that binds) at the H100's peak rates."""
    by_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    by_ops = operations / FP32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def tracer_floor_ops(rays, cluster_count, tri_ops):
    """The float32 operations a tracer needs at the least for `rays` live
    rays, whatever tree it walks: one root-to-leaf path of a binary tree
    over the clusters (ceil(log2 K) inner nodes, two child boxes each),
    one sub-box and one triangle test per ray."""
    depth = (cluster_count - 1).bit_length()
    return rays * ((2 * depth + 1) * SLAB_OPS + tri_ops)


def noise_table_bytes(noise, pairs):
    """The table bytes `pairs` noise pairs of this frame need at the least:
    per table layer, the texels its fetches reach (all of them once the
    frame's pixels outnumber a layer's) in the channels they read."""
    th, tw = noise.table.shape[1], noise.table.shape[2]
    reach, channels = {}, {}
    for f, (_, _, layer) in enumerate(noise.fetches.tolist()):
        used = min(4, 2 * pairs - 4 * f)
        if used <= 0:
            break
        reach[layer] = reach.get(layer, 0) + noise.column_count
        channels[layer] = max(channels.get(layer, 0), used)
    return sum(min(th * tw, reach[k]) * channels[k] * 4 for k in reach)


def op_counts(torch, fn, args):
    """Run K4's or K5's counting build (-DVR_COUNT_OPS=1) on args: the
    float32 operations counted, in all."""
    from vulkan_renderer_tpu_torch.render import fused
    counts = torch.zeros(len(fused.OP_KINDS) * len(fused.OP_STAGES),
                         dtype=torch.int64, device=args[0].device)
    fn(*args, op_counts=counts)
    return sum(counts.tolist())


def vertex_count(experiment) -> int:
    """The light vertex count of a timing-sweep experiment's layout
    ('timing:<vertex count>:<case>:<light count>')."""
    return int(experiment.light_layout.split(":")[1])


def sweep_jobs(experiments):
    """build.build_many jobs of K5 for the timing-sweep experiments given:
    one library per distinct technique and light vertex count among
    them."""
    from vulkan_renderer_tpu_torch.render import fused
    from vulkan_renderer_tpu_torch.render.shading import SceneStatic
    jobs = []
    for name, nv in sorted({(e.settings.polygon_sampling_technique.name,
                             vertex_count(e)) for e in experiments}):
        s = fused.RenderSettings(
            sampling_strategy=fused.SamplingStrategy.DIFFUSE_ONLY,
            polygon_sampling_technique=fused.PolygonSamplingTechnique[name])
        static = SceneStatic(light_count=1, light_texturing=(0,),
                             light_vertex_counts=(nv,))
        jobs.append(("fused_resolved", kernel_defines(s, static, "K5")))
    return jobs


def sweep_experiments(data_dir, techniques):
    """(cell, experiment) of the sweep cells for the techniques named
    (PolygonSamplingTechnique names), screenshots under data_dir."""
    from vulkan_renderer_tpu_torch.experiments import harness
    experiments = harness.create_experiment_list()
    out = []
    for cell, first in SWEEP_CELLS:
        for exp in experiments[first:first + 13]:
            if exp.settings.polygon_sampling_technique.name in techniques:
                out.append((cell, dataclasses.replace(
                    exp, screenshot_path=os.path.join(
                        data_dir, "bench_sweep",
                        os.path.basename(exp.screenshot_path)))))
    return out


def experiment_frame(torch, data_dir, exp):
    """Build the experiment's Application: (it, a function that renders its
    first frame through the kernels and returns each kernel's arguments,
    keyed by the pipeline.FrameKernels field that took them)."""
    from vulkan_renderer_tpu_torch.assets.noise import \
        advance_noise_random_numbers
    from vulkan_renderer_tpu_torch.experiments import setups
    from vulkan_renderer_tpu_torch.render import pipeline
    app = setups.build_default_application(exp, data_dir, device="cuda")
    _, randoms = advance_noise_random_numbers(app.noise_seed,
                                              app.settings.animate_noise)
    constants = pipeline.make_frame_constants(
        app.scene_spec.camera, exp.width, exp.height, app.settings, randoms,
        torch.device("cuda"))

    def frame():
        captured = {}
        with torch.no_grad():
            pipeline.render_frame_constants(
                app.scene, app.static, app.settings, constants, exp.width,
                exp.height, recording_kernels(captured))
        return captured
    return app, frame


def recording_application(data_dir, last):
    """A build_application for experiments/harness.py run_experiments:
    the experiment's Application on the card, kept in last["app"], whose
    render_frame_sync keeps the frame it returns in last["image"]."""
    from vulkan_renderer_tpu_torch.experiments import setups

    def build_application(exp):
        app = setups.build_default_application(exp, data_dir, device="cuda")
        render_sync = app.render_frame_sync

        def keep_frame():
            last["image"] = render_sync()
            return last["image"]
        app.render_frame_sync = keep_frame
        last["app"] = app
        return app
    return build_application


def sweep_measurements(torch, data_dir, techniques):
    """For each sweep cell and technique (PolygonSamplingTechnique names):
    the window ms/frame, the harness's median ms/frame, K5's ms on the
    frame's inputs, the device memory allocated before one frame and at
    its peak (GiB), and the hit share."""
    from vulkan_renderer_tpu_torch.experiments import harness, setups
    from vulkan_renderer_tpu_torch.render import pipeline
    rows = {}
    for cell, exp in sweep_experiments(data_dir, techniques):
        app, frame = experiment_frame(torch, data_dir, exp)
        args = frame()["fused_resolved"]
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        frame()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        k5 = cuda_ms(torch, lambda: pipeline.KERNELS.fused_resolved(*args), 3)
        hit = float(hit_mask(args[0]).mean())
        del app, frame, args
        torch.cuda.empty_cache()
        result = harness.run_experiments(
            [exp], min_warmup_seconds=0.0, min_warmup_frames=SWEEP_WARMUP,
            measure_frames=SWEEP_MEASURED, data_directory=data_dir,
            device="cuda")[0]
        window = window_ms(torch, setups.build_default_application(
            exp, data_dir, device="cuda"), SWEEP_WARMUP)
        tech = exp.settings.polygon_sampling_technique
        rows[f"{cell}/{tech.value}"] = {
            "window_ms": round(window, 4),
            "frame_ms": round(result.frame_time_ms, 4),
            "k5_ms": round(k5, 4),
            "allocated_gib": round(before / 2**30, 4),
            "peak_gib": round(peak / 2**30, 4),
            "hit_share": round(hit, 6)}
        torch.cuda.empty_cache()
    return rows


def kernels_line_jobs(s):
    """build.build_many jobs the kernels line needs beyond the bench
    frame's: K1's and K2's test-counting builds, K4's operation-counting
    build at the bench frame, and K5 for its two sweep frames, with its
    operation-counting build on the PSA one."""
    from vulkan_renderer_tpu_torch.experiments import harness
    experiments = harness.create_experiment_list()
    psa = sweep_jobs([experiments[PSA_SWEEP_EXPERIMENT]])
    return ([(name, {"VR_COUNT_TESTS": 1}) for name in ("anyhit", "closest")]
            + [("fused_shading", {**kernel_defines(s, light_layout()),
                                  "VR_COUNT_OPS": 1})]
            + sweep_jobs([experiments[PREAMBLE_EXPERIMENT]]) + psa
            + [(n, {**d, "VR_COUNT_OPS": 1}) for n, d in psa])


def kernels_line(torch, data_dir, scene, static, s, captured):
    """The kernels line: K1's slot entry, K2, K3 and K4 on the bench frame
    (`captured`: its kernels' arguments), K5 on the central 4-gon
    128-light PSA sweep frame (experiment 113), K6 on the 1-light
    1920x1080 sweep frame (experiment 282), each with its launches in one
    bench, sweep (113) and per-pixel bench frame (fused="off"), its ms
    (CUDA events), its plain version's ms (on a pixel subset where
    `plain_shape` says so), and its bound (bound_ms: each input byte read
    once, each output byte written once; the tracers' operations the
    least any tree needs for their live rays, tracer_floor_ops, and what
    this design's counted tests take beside them as design_ops_ms; K3's
    K3_OPS_PER_HIT a hit; K4's and K5's what their counting builds count
    on these inputs)."""
    from vulkan_renderer_tpu_torch.core import trace
    from vulkan_renderer_tpu_torch.experiments import harness
    from vulkan_renderer_tpu_torch.render import fused, preamble
    from vulkan_renderer_tpu_torch.render import trace_kernel as tk
    from vulkan_renderer_tpu_torch.tools import kernel_check

    def launches(frame):
        trace.reset_counters()
        with torch.no_grad():
            out = frame()
        torch.cuda.synchronize()
        return trace.launch_counts(), out

    experiments = harness.create_experiment_list()
    counted = {"bench": launches(lambda: render(scene, static, s))[0],
               "per_pixel": launches(lambda: render(
                   scene, dataclasses.replace(static, fused="off"), s))[0]}
    _, frame = experiment_frame(torch, data_dir,
                                experiments[PSA_SWEEP_EXPERIMENT])
    counted["sweep"], sweep = launches(frame)
    display = experiment_frame(torch, data_dir,
                               experiments[PREAMBLE_EXPERIMENT])[1]()
    ms = kernel_ms(torch, captured)
    tests = test_counts(torch, captured)
    clusters = scene.clusters
    tables = 4 * (clusters.planes.numel() + clusters.subboxes.numel()
                  + clusters.bvh_nodes.numel())
    rows = {}

    def row(name, kernel_ms_, plain_ms, shape, bytes_moved, operations,
            plain_shape=None, **extra):
        bound = bound_ms(bytes_moved, operations)
        rows[name] = {
            "name": name,
            "launches": {k: v[name] for k, v in counted.items()},
            "ms": round(kernel_ms_, 4), "plain_ms": round(plain_ms, 4),
            "bound_ms": round(bound[0], 5), "bound_by": bound[1],
            "bytes": bytes_moved, "operations": operations,
            "shape": shape, **({"plain_shape": plain_shape}
                               if plain_shape else {}), **extra}

    # K1's slot entry, as the bench frame runs it.
    slot_args = captured["trace_anyhit_slots"][:7]
    pixels, slots = slot_args[1].shape[1], slot_args[2]
    sub = kernel_check.slot_args_subset(slot_args, kernel_check.subset_indices(
        kernel_check.PIXEL_SUBSET, pixels, slot_args[1].device))

    def walk(name, sub_ops, tri_ops):
        """(the least walk's operations, design_ops_ms) of K1 or K2."""
        c = tests[name]
        return (tracer_floor_ops(c["rays"], clusters.cluster_count, tri_ops),
                round((c["boxes"] * SLAB_OPS + c["subboxes"] * sub_ops
                       + c["triangles"] * tri_ops) / FP32_OPS_PER_S * 1e3,
                      5))

    ops, design = walk("K1", ANYHIT_SUBBOX_OPS, ANYHIT_TRI_OPS)
    row("K1", ms["K1_slots"], cuda_once(
        torch, lambda: tk.trace_anyhit_slots_plain(*sub))[0],
        f"{pixels} pixels x {slots} slots ({tests['K1']['rays']} live rays)",
        pixels * (slots * K1_RAY_BYTES + K1_PIXEL_BYTES) + tables, ops,
        f"{sub[1].shape[1]} pixels", tests=tests["K1"], design_ops_ms=design,
        ms_at_plain_shape=round(cuda_ms(
            torch, lambda: tk.trace_anyhit_slots(*sub), 5), 4))
    a2 = captured["trace_closest"]
    ops, design = walk("K2", SLAB_OPS, CLOSEST_TRI_OPS)
    row("K2", ms["K2"], cuda_once(
        torch, lambda: tk.trace_closest_plain(*a2))[0],
        f"{a2[2].shape[0]} rays", a2[2].shape[0] * (28 + 8) + tables, ops,
        tests=tests["K2"], design_ops_ms=design)
    a3 = captured["closest_attrs"]
    hits = int((a3[1] >= 0).sum())
    row("K3", ms["K3"], cuda_ms(torch, lambda: tk.closest_attrs_plain(*a3),
                                3),
        f"{a3[3].shape[0]} rays",
        a3[1].numel() * (28 + 18 * 4) + hits * 25 * 4, hits * K3_OPS_PER_HIT)
    a4 = captured["fused_shading"]
    pairs = fused.rays_per_light(s) * static.light_count
    row("K4", ms["K4"], cuda_ms(
        torch, lambda: fused.fused_light_shading_plain(*a4), 1),
        f"{a4[0].shape[1]} pixels x {static.light_count} lights",
        4 * (a4[0].numel() + a4[2].numel()
             + (3 + 7 * pairs) * a4[0].shape[1])
        + noise_table_bytes(a4[1], pairs),
        op_counts(torch, fused.fused_light_shading, a4))
    a5 = sweep["fused_resolved"]
    planes, noise, ls, st, s5 = a5
    idx = kernel_check.subset_indices(kernel_check.PIXEL_SUBSET,
                                      planes.shape[1], planes.device)
    sub5 = kernel_check.subset_args(a5, idx)
    row("K5", cuda_ms(torch, lambda: fused.fused_light_shading_resolved(*a5),
                      2),
        cuda_once(torch,
                  lambda: fused.fused_light_shading_resolved_plain(*sub5))[0],
        f"{planes.shape[1]} pixels x {st.light_count} lights x "
        f"{s5.sample_count} spp (PSA)",
        4 * (planes.numel() + ls.numel() + 3 * planes.shape[1])
        + noise_table_bytes(noise, fused.rays_per_light(s5) * st.light_count),
        op_counts(torch, fused.fused_light_shading_resolved, a5),
        f"{idx.numel()} pixels")
    a6 = display["shading_planes"]
    p6 = a6[3].shape[0]
    row("K6", cuda_ms(torch, lambda: preamble.shading_planes(*a6), 20),
        cuda_once(torch, lambda: preamble.shading_planes_plain(*a6))[0],
        f"{p6} pixels", p6 * K6_PIXEL_BYTES, 0,
        bench_shape_ms=round(cuda_ms(torch, lambda: preamble.shading_planes(
            *captured["shading_planes"]), 20), 4))
    return [rows[name] for name in ("K1", "K2", "K3", "K4", "K5", "K6")]


def main(argv=None) -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(
        here)), help="checkout whose vulkan_renderer_tpu_torch is timed")
    parser.add_argument("--data", default=None,
                        help="directory of the bench city (default: "
                        "ROOT/data)")
    parser.add_argument("--sweep", action="store_true",
                        help="also time PSA and Arvo PSA in both sweep "
                        "cells")
    parser.add_argument("--count-tests", action="store_true",
                        help="also count K1's and K2's box, sub-box and "
                        "triangle tests on the bench frame")
    parser.add_argument("--kernels", action="store_true",
                        help="also print the kernels line (kernels_line)")
    parser.add_argument("--sweep-techniques", default=None,
                        help="with --sweep: 'all', or comma-separated "
                        "PolygonSamplingTechnique names (default: "
                        "PROJECTED_SOLID_ANGLE,PROJECTED_SOLID_ANGLE_ARVO)")
    args = parser.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("bench_frame: needs a CUDA GPU", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from vulkan_renderer_tpu_torch.kernels import build

    card = card_name()
    s = settings()
    counting = [(name, {"VR_COUNT_TESTS": 1})
                for name in ("anyhit", "closest")] if args.count_tests else []
    if args.kernels:
        counting = kernels_line_jobs(s)
    # A tree older than a kernel (--root) builds only the sources it has.
    wall = build.build_many([job for job in kernel_jobs(s) + counting
                             if (build.CSRC_DIR / f"{job[0]}.cu").exists()])
    data_dir = os.path.abspath(args.data or os.path.join(root, "data"))
    scene, static = load_city(data_dir, torch.device("cuda"))
    captured = capture_inputs(scene, static, s)
    times = frame_ms(torch, scene, static, s)
    line = {
        "root": root, "card": card, "build_wall_s": round(wall, 2),
        "frame_ms_median": round(float(np.median(times)), 4),
        "frame_ms": [round(t, 4) for t in times],
        "kernel_ms": {n: round(v, 4)
                      for n, v in kernel_ms(torch, captured).items()},
        "k4_hit_share": round(float(
            hit_mask(captured["fused_shading"][0]).mean()), 6)}
    if args.count_tests:
        line["tests"] = test_counts(torch, captured)
    kernels = None if not args.kernels else kernels_line(
        torch, data_dir, scene, static, s, captured)
    del scene, captured
    torch.cuda.empty_cache()
    line["frame_window_ms"] = round(window_ms(
        torch, application(data_dir, "cuda"), WARMUP), 4)
    if args.sweep:
        from vulkan_renderer_tpu_torch.render import fused
        names = args.sweep_techniques or \
            "PROJECTED_SOLID_ANGLE,PROJECTED_SOLID_ANGLE_ARVO"
        techniques = [t.name for t in fused.PolygonSamplingTechnique] \
            if names == "all" else names.split(",")
        line["sweep_build_wall_s"] = round(build.build_many(sweep_jobs(
            [exp for _, exp in sweep_experiments(data_dir, techniques)])), 2)
        line["sweep"] = sweep_measurements(torch, data_dir, techniques)
    line["ptxas"] = {tag: build.register_report(report)
                     for tag, (_, report) in sorted(
                         build.BUILD_REPORTS.items())
                     if tag.startswith("fused")}
    print(json.dumps(line), flush=True)
    if kernels is not None:
        print(json.dumps({"kernels": kernels, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
