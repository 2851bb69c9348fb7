#!/usr/bin/env python3
"""The bench frame: its one definition, and a timer for it on one GPU.

The bench frame is 960x540 at 1 spp on the procedural city (300
buildings, detail 10), lit by four quad street lights, with PSA +
DIFFUSE_SPECULAR_MIS, clamped-optimal MIS and shadows on: the frame of the
JAX package's bench.py at its defaults. `chip_smoke.py` builds its
main-path run from the functions below, and the port's bench entry
(vulkan_renderer_tpu_torch/bench.py) its frame at bench.py's options
(scene scale, spp, shadows, materials, cluster size).

The two timing-sweep cells that chip_smoke.py runs (SWEEP_CELLS) are
defined here too.

Run as a script, it times the port found under --root (default: the
checkout this file is in), so that two trees can be compared in one run
on one card:

    python3 vulkan_renderer_tpu_torch/tools/bench_frame.py \
        [--root DIR] [--data DIR] [--sweep] [--count-tests]

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
(--sweep-techniques all: for all 13 techniques, as chip_smoke.py phase 8
runs them; their K5 libraries are built first, in parallel): the window
ms/frame as above, the harness's median ms/frame (SWEEP_WARMUP warm-up
and SWEEP_MEASURED measured frames, pipelined; the median of a few
timer-stamp deltas, which bunch when frames overlap), K5's ms on the
frame's inputs, the device memory allocated before a frame and at its
peak (torch.cuda.max_memory_allocated), and the hit share. It uses only the
entry points that every tree of the port has had since the timing sweep
was first ported, and imports no JAX.
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
    s: K1-K4 with shadows, K2, K3 and K5 without."""
    if not s.trace_shadow_rays:
        return [("closest", {}), ("fused_resolved",
                                  kernel_defines(s, light_layout(), "K5"))]
    return [("anyhit", {}), ("closest", {}),
            ("fused_shading", kernel_defines(s, light_layout()))]


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


def application(data_dir, device):
    """The bench frame as an Application (core/app.py): its scene, camera,
    settings and size, three frames in flight."""
    from vulkan_renderer_tpu_torch.core.app import (Application,
                                                    SceneSpecification)
    vks, textures = city_files(data_dir)
    return Application(
        SceneSpecification(name=CITY, vks_path=vks, texture_dir=textures,
                           camera=camera(), lights=lights()),
        settings(), WIDTH, HEIGHT, data_directory=data_dir, device=device)


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
    """K1-K4 ms at the frame's shapes (CUDA events, warm L2)."""
    from vulkan_renderer_tpu_torch.render import pipeline
    k = pipeline.KERNELS
    return {
        "K1": cuda_ms(torch, lambda: k.trace_anyhit(
            *captured["trace_anyhit"]), 5),
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
    for name, fn, field in (("K1", tk.trace_anyhit, "trace_anyhit"),
                            ("K2", tk.trace_closest, "trace_closest")):
        args = captured[field]
        counts = torch.zeros(3, dtype=torch.int64, device=args[2].device)
        fn(*args, test_counts=counts)
        out[name] = dict(zip(("boxes", "subboxes", "triangles"),
                             counts.tolist()),
                         rays=int((args[3] >= 0).sum()))
    return out


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
    wall = build.build_many(kernel_jobs(s) + counting)
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
