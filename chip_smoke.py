#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (vulkan_renderer_tpu_torch) on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It
1. prints the card (nvidia-smi name and power limit) and the versions;
2. builds the CUDA kernels K1-K5 from vulkan_renderer_tpu_torch/csrc with
   nvcc, one process per library, all at once (K4 and K5 for each of the
   13 techniques at the timing sweep's vertex counts), and prints each
   build's time and register report;
3. writes the procedural bench city (300 buildings, detail 10) into data/
   with the port's own writer and loads it onto the card;
4. holds every kernel against its plain PyTorch version on the card at
   the bench frame's shapes (brute-force plain tracers on ray subsets);
5. renders a 128x64 frame through the kernels and through the plain
   versions and compares the images;
6. renders the bench frame (960x540, 1 spp, four quad street lights, PSA
   with DIFFUSE_SPECULAR_MIS and clamped-optimal MIS, shadows on) with
   every kernel launch counter reset just before and read just after,
   checks the image, and times it (warm-up, then the median of 7 frames)
   along with each kernel and its plain version; then, with shadows off
   (the default settings, which take K5 under DIFFUSE_SPECULAR_MIS),
   holds K5 against its plain version bit for bit on 4,096 of the bench
   frame's pixels for PSA and PSA-biased with each of the 5 heuristics;
7. for every technique, captures K5's inputs from the harness's own
   timing-sweep frames at 1920x1080 (the 128-light x 1-spp central
   quadrilaterals, experiment 102 + t, and the 1-light x 128-spp decentral
   pentagon, experiment 193 + t) and holds K5 and K4 under DIFFUSE_ONLY
   against their plain versions on 4,096 evenly spaced pixels, and K4's
   slots resolved with visibility 1 against K5;
8. runs those 26 timing-sweep experiments through the port's harness
   (3 warm-up and 7 measured frames each; the harness's defaults of
   110/100 stay for real sweeps) with every launch counter reset before
   and read after: K5 must run, K4 must not; each frame is checked and each
   cell's median ms printed beside the card.

The line before the last is a JSON object listing the kernels; the last
line is {"ok": true, "device": {...}}. Any failed check, missing GPU or
missing package exits non-zero without that line. JAX is never imported;
the script uses only the PyTorch port.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WIDTH, HEIGHT = 960, 540
SMALL_WIDTH, SMALL_HEIGHT = 128, 64
PRIMARY_SUBSET = 4096
SHADOW_SUBSET = 16384
TIMED_FRAMES = 7
SWEEP_SUBSET = 4096
SWEEP_WIDTH, SWEEP_HEIGHT = 1920, 1080
SWEEP_CELLS = (("central_4_128", 102), ("decentral_5_1x128spp", 193))
SWEEP_WARMUP, SWEEP_MEASURED = 3, 7


class SmokeFailure(RuntimeError):
    pass


def check(ok, message):
    if not ok:
        raise SmokeFailure(message)


def log(message):
    print(message, flush=True)


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


def subset_indices(torch, count, available, device):
    """`count` evenly spaced indices into range(available)."""
    count = min(count, available)
    return torch.linspace(0, available - 1, count, device=device).long()


def run():
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs a CUDA GPU and does not fall back to the CPU",
              file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "vulkan_renderer_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository (the "
              "vulkan_renderer_tpu_torch package is missing next to it)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import numpy as np

    from vulkan_renderer_tpu_torch.assets.noise import \
        advance_noise_random_numbers
    from vulkan_renderer_tpu_torch.core.device import get_device
    from vulkan_renderer_tpu_torch.experiments import harness, setups
    from vulkan_renderer_tpu_torch.kernels import build
    from vulkan_renderer_tpu_torch.render import fused, pipeline
    from vulkan_renderer_tpu_torch.render import trace_kernel as tk
    from vulkan_renderer_tpu_torch.render.fused import (
        MisHeuristic, PolygonSamplingTechnique, RenderSettings,
        SamplingStrategy)
    from vulkan_renderer_tpu_torch.render.pipeline import FirstPersonCamera
    from vulkan_renderer_tpu_torch.render.shading import SceneStatic
    from vulkan_renderer_tpu_torch.scene.scene import (PolygonalLightSpec,
                                                       load_scene)
    from vulkan_renderer_tpu_torch.tools import kernel_check
    from vulkan_renderer_tpu_torch.tools.city import write_city_scene

    def kernel_defines(s, static):
        return {**fused.kernel_defines(s),
                "VR_NV_MASK": fused.vertex_count_mask(static)}

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    device = get_device("cuda")
    if "jax" in sys.modules:
        raise SmokeFailure("jax was imported")

    settings = RenderSettings(
        sampling_strategy=SamplingStrategy.DIFFUSE_SPECULAR_MIS,
        polygon_sampling_technique=(
            PolygonSamplingTechnique.PROJECTED_SOLID_ANGLE),
        sample_count=1, trace_shadow_rays=True)

    # --- 2. kernel builds ------------------------------------------------
    bench_static = SceneStatic(light_count=4, light_texturing=(0,) * 4,
                               light_vertex_counts=(4,) * 4)
    jobs = [("anyhit", {}), ("closest", {}),
            ("fused_shading", kernel_defines(settings, bench_static))]
    for tech in PolygonSamplingTechnique:
        tech_settings = RenderSettings(
            sampling_strategy=SamplingStrategy.DIFFUSE_ONLY,
            polygon_sampling_technique=tech)
        for nv in (4, 5):
            static_nv = SceneStatic(light_count=1, light_texturing=(0,),
                                    light_vertex_counts=(nv,))
            for name in ("fused_shading", "fused_resolved"):
                jobs.append((name, kernel_defines(tech_settings, static_nv)))
    # K5 under DIFFUSE_SPECULAR_MIS (the default settings with shadows off):
    # the PSA pair with every heuristic, at the bench layout.
    mis_variants = [dataclasses.replace(
        settings, polygon_sampling_technique=tech, mis_heuristic=heuristic,
        trace_shadow_rays=False)
        for tech in (PolygonSamplingTechnique.PROJECTED_SOLID_ANGLE,
                     PolygonSamplingTechnique.PROJECTED_SOLID_ANGLE_BIASED)
        for heuristic in MisHeuristic]
    jobs += [("fused_resolved", kernel_defines(s, bench_static))
             for s in mis_variants]
    wall = build.build_many(jobs)
    log(f"kernel build: {len(jobs)} libraries, {wall:.2f} s wall")
    for tag, (seconds, report) in sorted(build.BUILD_REPORTS.items()):
        log(f"  {tag}: nvcc {seconds:.2f} s")
        for line in build.register_report(report):
            if "registers" in line or "spill" in line:
                log(f"    {line}")

    # --- 3. the bench city ---------------------------------------------------
    data_dir = os.path.join(ROOT, "data")
    stem = "city_300x10"
    start = time.perf_counter()
    vks = os.path.join(data_dir, f"{stem}.vks")
    if not os.path.exists(vks):
        vks = write_city_scene(data_dir, stem, n_buildings=300, detail=10)
    specs = [PolygonalLightSpec(
        translation=np.array([-30.0 + 20.0 * i, 0.0, 8.0], np.float32),
        rotation_angles=np.array([np.pi, 0.0, 0.0], np.float32),
        scaling_x=1.5, scaling_y=1.5,
        radiant_flux=np.array([400.0, 380.0, 340.0], np.float32))
        for i in range(4)]
    scene = load_scene(vks, os.path.join(data_dir, f"{stem}_textures"),
                       specs, device, data_directory=data_dir)
    torch.cuda.synchronize()
    static = SceneStatic.for_scene(scene)
    log(f"scene: {scene.triangle_positions.shape[0]} triangles, "
        f"{scene.clusters.cluster_count} clusters of "
        f"{scene.clusters.cluster_size}, built in "
        f"{time.perf_counter() - start:.2f} s")
    camera = FirstPersonCamera(
        position_world_space=np.array([0.0, 0.0, 2.0], np.float32),
        rotation_x=0.55 * np.pi, rotation_z=0.5 * np.pi)
    noise_numbers = (np.arange(4) * 0x123456).astype(np.uint32)
    constants = pipeline.make_frame_constants(camera, WIDTH, HEIGHT,
                                              settings, noise_numbers, device)

    # Capture every kernel's inputs at the bench shapes (not the counted run).
    captured = {}

    def recorder(name, fn):
        def call(*args):
            captured[name] = args
            return fn(*args)
        return call

    recording = pipeline.FrameKernels(*(
        recorder(f.name, getattr(pipeline.KERNELS, f.name))
        for f in dataclasses.fields(pipeline.FrameKernels)))
    with torch.no_grad():
        pipeline.render_frame_constants(scene, static, settings, constants,
                                        WIDTH, HEIGHT, recording)
    torch.cuda.synchronize()

    results = {}

    # --- 4. kernels against their plain versions -----------------------------
    clusters, origins, dirs, t_max = captured["trace_closest"]
    idx = subset_indices(torch, PRIMARY_SUBSET, dirs.shape[0], device)
    sub = [a[idx].contiguous() for a in (origins, dirs, t_max)]
    prim_k, t_k = tk.trace_closest(clusters, *sub)
    prim_p, t_p = tk.trace_closest_plain(clusters, *sub)
    hit_k, hit_p = prim_k >= 0, prim_p >= 0
    both = hit_k & hit_p
    t_err = (t_k - t_p).abs()[both]
    tie = (t_k - t_p).abs() <= 1e-6 * torch.clamp(t_p.abs(), min=1.0)
    wrong = (hit_k != hit_p) | (both & (prim_k != prim_p) & ~tie)
    k2_err = float(t_err.max()) if t_err.numel() else 0.0
    log(f"K2 closest vs plain ({idx.numel()} rays, all clusters): hits "
        f"{int(hit_k.sum())}/{int(hit_p.sum())}, non-tie mismatches "
        f"{int(wrong.sum())} (tolerance 0), max |dt| {k2_err:.3g} "
        f"(tolerance 1e-5 * t)")
    check(int(wrong.sum()) == 0, "K2 disagrees with its plain version")
    check(bool((t_err <= 1e-5 * torch.clamp(t_p[both].abs(), min=1.0))
               .all()), "K2 t outside tolerance")
    results["K2"] = dict(max_abs_err=k2_err, compared=idx.numel())

    clusters, prim, a_orig, a_dirs, dcam = captured["closest_attrs"]
    attrs_k = tk.closest_attrs(clusters, prim, a_orig, a_dirs, dcam)
    attrs_p = tk.closest_attrs_plain(clusters, prim, a_orig, a_dirs, dcam)
    a_err = (attrs_k - attrs_p).abs()
    a_bad = a_err > 1e-4 * (1.0 + attrs_p.abs())
    k3_err = float(a_err.max())
    log(f"K3 attrs vs plain ({prim.numel()} rays): max |d| {k3_err:.3g}, "
        f"outside 1e-4*(1+|ref|): {int(a_bad.sum())} of {a_bad.numel()} "
        f"(tolerance 0)")
    check(int(a_bad.sum()) == 0, "K3 disagrees with its plain version")
    results["K3"] = dict(max_abs_err=k3_err, compared=prim.numel())

    planes, light_scalars, _, _ = captured["fused_shading"]
    out_k = fused.fused_light_shading(planes, light_scalars, static, settings)
    out_p = fused.fused_light_shading_plain(planes, light_scalars, static,
                                            settings)
    fin_p = torch.isfinite(out_p)
    nan_mismatch = int((fin_p != torch.isfinite(out_k)).sum())
    scale = torch.where(fin_p, out_p.abs(), 0.0).amax(dim=1, keepdim=True)
    diff = torch.where(fin_p, (out_k - out_p).abs(), 0.0)
    outside = fin_p & (diff > 1e-4 * scale + 1e-3 * out_p.abs())
    k4_err = float(diff.max())
    frac = int(outside.sum()) / outside.numel()
    log(f"K4 fused shading vs plain ({planes.shape[1]} pixels, "
        f"{out_p.shape[0]} planes): max |d| {k4_err:.3g}, outside "
        f"1e-4*plane scale + 1e-3*|ref|: {int(outside.sum())} "
        f"({frac:.2e}, tolerance 1e-3: sector flips), finite-pattern "
        f"mismatches {nan_mismatch} (tolerance 1e-4 of elements)")
    check(frac <= 1e-3, "K4 disagrees with its plain version")
    check(nan_mismatch <= 1e-4 * out_p.numel(),
          "K4 non-finite pattern differs from its plain version")
    results["K4"] = dict(max_abs_err=k4_err, compared=planes.shape[1])

    clusters, s_orig, s_dirs, s_tmax = captured["trace_anyhit"]
    live = torch.nonzero(s_tmax >= 0.0)[:, 0]
    check(live.numel() > 0, "the bench frame emitted no live shadow ray")
    sidx = live[subset_indices(torch, SHADOW_SUBSET, live.numel(), device)]
    ssub = [a[sidx].contiguous() for a in (s_orig, s_dirs, s_tmax)]
    occ_k = tk.trace_anyhit(clusters, *ssub)
    occ_p = tk.trace_anyhit_plain(clusters, *ssub)
    k1_wrong = int((occ_k != occ_p).sum())
    log(f"K1 any-hit vs plain ({sidx.numel()} live shadow rays of "
        f"{live.numel()} live / {s_tmax.numel()}): occluded "
        f"{int(occ_k.sum())}/{int(occ_p.sum())}, mismatches {k1_wrong} "
        f"(tolerance 0)")
    check(k1_wrong == 0, "K1 disagrees with its plain version")
    results["K1"] = dict(max_abs_err=float(k1_wrong > 0),
                         compared=sidx.numel())

    # --- 5. small frame: kernels vs plain versions ---------------------------
    with torch.no_grad():
        small = {}
        for name, kernels in (("kernels", pipeline.KERNELS),
                              ("plain", pipeline.PLAIN_VERSIONS)):
            start = time.perf_counter()
            small[name] = pipeline.render_frame(
                scene, static, camera, settings, SMALL_WIDTH, SMALL_HEIGHT,
                noise_numbers, kernels)
            torch.cuda.synchronize()
            log(f"small frame {SMALL_WIDTH}x{SMALL_HEIGHT} through {name}: "
                f"{time.perf_counter() - start:.2f} s")
    img_diff = (small["kernels"] - small["plain"]).abs()
    mean_diff = float(img_diff.mean())
    close = float((img_diff.amax(dim=-1) <= 1e-3).float().mean())
    log(f"small frame kernels vs plain: mean |d| {mean_diff:.3g} (tolerance "
        f"5e-4), pixels within 1e-3: {close:.5f} (tolerance >= 0.995)")
    check(bool(torch.isfinite(small["kernels"]).all()),
          "small frame is not finite")
    check(mean_diff <= 5e-4 and close >= 0.995,
          "small frame through the kernels differs from the plain versions")

    # --- 6. the bench frame: counted main-path run ---------------------------
    counters = {"K1": tk.trace_anyhit, "K2": tk.trace_closest,
                "K3": tk.closest_attrs, "K4": fused.fused_light_shading,
                "K5": fused.fused_light_shading_resolved}
    for fn in counters.values():
        fn.launches = 0
    image = pipeline.render_frame(scene, static, camera, settings, WIDTH,
                                  HEIGHT, noise_numbers)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    log(f"bench frame launches: {launches}")
    for name in ("K1", "K2", "K3", "K4"):
        check(launches[name] > 0,
              f"{name} was not launched by the bench frame")
    check(tuple(image.shape) == (HEIGHT, WIDTH, 3),
          f"bench frame shape {tuple(image.shape)}")
    check(bool(torch.isfinite(image).all()), "bench frame is not finite")
    pink = pipeline.linear_to_srgb(torch.tensor([1.0, 0.0, 0.8],
                                                device=device))
    sentinels = int((image == pink).all(dim=-1).sum())
    check(sentinels == 0, f"bench frame has {sentinels} NaN/Inf sentinels")
    mean_rgb = [round(float(v), 4) for v in image.mean(dim=(0, 1))]
    check(0.01 < float(image.mean()) < 0.99,
          f"bench frame mean {mean_rgb} is implausible")
    log(f"bench frame {WIDTH}x{HEIGHT}: finite, no sentinels, mean rgb "
        f"{mean_rgb}")

    frame_ms = []
    with torch.no_grad():
        for _ in range(TIMED_FRAMES):
            start = time.perf_counter()
            pipeline.render_frame(scene, static, camera, settings, WIDTH,
                                  HEIGHT, noise_numbers)
            torch.cuda.synchronize()
            frame_ms.append((time.perf_counter() - start) * 1000.0)
    frame_median = float(np.median(frame_ms))
    log(f"bench frame ms ({TIMED_FRAMES} frames after warm-up, host clock "
        f"with synchronize): median {frame_median:.3f}, all "
        f"{[round(t, 3) for t in frame_ms]} [{card}]")

    # --- per-kernel times at the bench shapes --------------------------------
    c_args = captured["trace_closest"]
    a_args = captured["closest_attrs"]
    f_args = captured["fused_shading"]
    s_args = captured["trace_anyhit"]
    timings = {
        "K2": (cuda_ms(torch, lambda: tk.trace_closest(*c_args), 5),
               cuda_ms(torch, lambda: tk.trace_closest_plain(clusters, *sub),
                       1),
               cuda_ms(torch, lambda: tk.trace_closest(clusters, *sub), 5),
               f"{c_args[2].shape[0]} rays", f"{sub[1].shape[0]} rays"),
        "K3": (cuda_ms(torch, lambda: tk.closest_attrs(*a_args), 10),
               cuda_ms(torch, lambda: tk.closest_attrs_plain(*a_args), 3),
               None, f"{a_args[3].shape[0]} rays", None),
        "K4": (cuda_ms(torch, lambda: fused.fused_light_shading(*f_args), 5),
               cuda_ms(torch,
                       lambda: fused.fused_light_shading_plain(*f_args), 1),
               None, f"{f_args[0].shape[1]} pixels x "
               f"{static.light_count} lights", None),
        "K1": (cuda_ms(torch, lambda: tk.trace_anyhit(*s_args), 3),
               cuda_ms(torch, lambda: tk.trace_anyhit_plain(clusters, *ssub),
                       1),
               cuda_ms(torch, lambda: tk.trace_anyhit(clusters, *ssub), 5),
               f"{s_args[2].shape[0]} rays ({live.numel()} live)",
               f"{ssub[1].shape[0]} live rays"),
    }
    for name, (ms, plain_ms, ms_sub, shape, plain_shape) in timings.items():
        where = f" (plain on {plain_shape}; kernel there {ms_sub:.3f} ms)" \
            if plain_shape else ""
        log(f"{name}: kernel {ms:.3f} ms on {shape}; plain {plain_ms:.3f} ms"
            f"{where} [{card}]")

    # --- 6b. K5 under DIFFUSE_SPECULAR_MIS against its plain version --------
    # The default settings with shadows off take K5 in MIS mode: the bench
    # frame's inputs, the PSA pair with every heuristic. Tolerance: bit for
    # bit (the same float32 operations in the same order).
    mis_rows = []
    for s in mis_variants:
        k5_args = {}

        def record_k5(*args):
            k5_args["args"] = args
            return fused.fused_light_shading_resolved(*args)

        with torch.no_grad():
            pipeline.render_frame_constants(
                scene, static, s, pipeline.make_frame_constants(
                    camera, WIDTH, HEIGHT, s, noise_numbers, device),
                WIDTH, HEIGHT, dataclasses.replace(
                    pipeline.KERNELS, fused_resolved=record_k5))
        planes, noise, ls, st, s = k5_args["args"]
        idx = subset_indices(torch, SWEEP_SUBSET, planes.shape[1], device)
        sub_planes = planes[:, idx].contiguous()
        sub_noise = noise[:, :, idx].contiguous()
        got5 = fused.fused_light_shading_resolved(sub_planes, sub_noise, ls,
                                                  st, s)
        want5 = fused.fused_light_shading_resolved_plain(sub_planes,
                                                         sub_noise, ls, st, s)
        r5 = kernel_check.compare(got5.T, want5.T)
        variant = (f"{s.polygon_sampling_technique.value}/"
                   f"{s.mis_heuristic.value}")
        mis_rows.append(dict(variant=variant, **r5))
        log(f"K5 MIS {variant} vs plain ({idx.numel()} of {planes.shape[1]} "
            f"px x {st.light_count} lights): exact {r5['exact']:.6f} "
            f"(tolerance: bit for bit), max |d| {r5['max_abs_err']:.3g}")
        check(r5["nonfinite_mismatch"] == 0 and r5["exact"] == 1.0,
              f"K5 MIS disagrees with its plain version ({variant})")
        check(float(want5.abs().max()) > 0, f"K5 MIS {variant} is all zero")

    # --- 7. K5 and K4 DIFFUSE_ONLY against their plain versions -------------
    experiments = harness.create_experiment_list()
    arvo = (PolygonSamplingTechnique.SOLID_ANGLE_ARVO,
            PolygonSamplingTechnique.PROJECTED_SOLID_ANGLE_ARVO)
    technique_rows = []
    k5_main = None
    for cell, first in SWEEP_CELLS:
        for t, tech in enumerate(PolygonSamplingTechnique):
            exp = experiments[first + t]
            check(exp.settings.polygon_sampling_technique == tech
                  and (exp.width, exp.height) == (SWEEP_WIDTH, SWEEP_HEIGHT),
                  f"experiment {first + t} is not the {tech.value} sweep "
                  f"cell at {SWEEP_WIDTH}x{SWEEP_HEIGHT}")
            app = setups.build_default_application(exp, data_dir,
                                                   device="cuda")
            _, randoms = advance_noise_random_numbers(
                app.noise_seed, app.settings.animate_noise)
            sweep_constants = pipeline.make_frame_constants(
                app.scene_spec.camera, exp.width, exp.height, app.settings,
                randoms, device)
            k5_args = {}

            def record_k5(*args):
                k5_args["args"] = args
                return fused.fused_light_shading_resolved(*args)

            with torch.no_grad():
                pipeline.render_frame_constants(
                    app.scene, app.static, app.settings, sweep_constants,
                    exp.width, exp.height, dataclasses.replace(
                        pipeline.KERNELS, fused_resolved=record_k5))
            planes, noise, ls, st, s = k5_args["args"]
            idx = subset_indices(torch, SWEEP_SUBSET, planes.shape[1], device)
            sub_planes = planes[:, idx].contiguous()
            sub_noise = noise[:, :, idx].contiguous()
            got5 = fused.fused_light_shading_resolved(sub_planes, sub_noise,
                                                      ls, st, s)
            plain5_ms, want5 = cuda_once(
                torch, lambda: fused.fused_light_shading_resolved_plain(
                    sub_planes, sub_noise, ls, st, s))
            r5 = kernel_check.compare(got5.T, want5.T)
            planes4 = torch.cat([sub_planes,
                                 sub_noise.reshape(-1, idx.numel())])
            got4 = fused.fused_light_shading(planes4, ls, st, s)
            plain4_ms, want4 = cuda_once(
                torch, lambda: fused.fused_light_shading_plain(planes4, ls,
                                                               st, s))
            r4 = kernel_check.compare(got4, want4)
            r45 = kernel_check.compare(kernel_check.k4_resolved(got4, st, s).T,
                                       got5.T)
            ms5 = cuda_ms(torch, lambda: fused.fused_light_shading_resolved(
                planes, noise, ls, st, s), 2)
            ms4 = cuda_ms(torch, lambda: fused.fused_light_shading(
                planes4, ls, st, s), 3)
            # Tolerance: bit for bit where the plain version shares the
            # kernel's formula; the Arvo techniques select azimuth sectors
            # and may flip a boundary sample where an ulp differs, so up
            # to 0.5% of their values (ROADMAP Queue 3).
            limit = 5e-3 if tech in arvo else 0.0
            row = dict(cell=cell, technique=tech.value,
                       pixels=planes.shape[1], lights=st.light_count,
                       spp=s.sample_count, k5_ms=round(ms5, 4),
                       k5_plain_ms_subset=round(plain5_ms, 4),
                       k4_ms_subset=round(ms4, 4),
                       k4_plain_ms_subset=round(plain4_ms, 4),
                       k5_exact=round(r5["exact"], 6),
                       k5_outside=r5["outside"],
                       k5_max_abs_err=r5["max_abs_err"],
                       k4_exact=round(r4["exact"], 6),
                       k4_outside=r4["outside"],
                       k4_max_abs_err=r4["max_abs_err"],
                       k4_resolved_vs_k5_exact=round(r45["exact"], 6))
            technique_rows.append(row)
            log(f"{cell} {tech.value}: K5 {ms5:.3f} ms ({planes.shape[1]} px "
                f"x {st.light_count} lights x {s.sample_count} spp), plain "
                f"{plain5_ms:.1f} ms on {idx.numel()} px; K5 vs plain exact "
                f"{r5['exact']:.5f}, outside {r5['outside']:.2e} (tolerance: "
                f"inexact <= {limit:g}), max |d| {r5['max_abs_err']:.3g}; K4 "
                f"DIFFUSE_ONLY {ms4:.3f} ms on {idx.numel()} px, plain "
                f"{plain4_ms:.1f} ms; vs plain exact {r4['exact']:.5f}, "
                f"outside {r4['outside']:.2e} (tolerance: inexact <= "
                f"{limit:g}), "
                f"max |d| {r4['max_abs_err']:.3g}; K4 resolved vs K5 exact "
                f"{r45['exact']:.5f} (tolerance: bit for bit) [{card}]")
            check(r5["nonfinite_mismatch"] == 0
                  and 1.0 - r5["exact"] <= limit,
                  f"K5 disagrees with its plain version ({cell}, "
                  f"{tech.value})")
            check(r4["nonfinite_mismatch"] == 0
                  and 1.0 - r4["exact"] <= limit,
                  f"K4 DIFFUSE_ONLY disagrees with its plain version ({cell}, "
                  f"{tech.value})")
            check(r45["nonfinite_mismatch"] == 0 and r45["exact"] == 1.0,
                  f"K4 resolved differs from K5 ({cell}, {tech.value})")
            if cell == SWEEP_CELLS[0][0] \
                    and tech == PolygonSamplingTechnique.PROJECTED_SOLID_ANGLE:
                k5_main = (ms5, plain5_ms,
                           f"{planes.shape[1]} pixels x {st.light_count} "
                           f"lights x 1 spp (PSA)", f"{idx.numel()} pixels")
            del app, planes, noise, k5_args
            torch.cuda.empty_cache()
    print(json.dumps({"techniques": technique_rows}), flush=True)

    # --- 8. the timing sweep through the port's harness: counted run --------
    last = {}

    def build_app(exp):
        app = setups.build_default_application(exp, data_dir, device="cuda")
        render_sync = app.render_frame_sync

        def keep_frame():
            last["image"] = render_sync()
            return last["image"]
        app.render_frame_sync = keep_frame
        return app

    for fn in counters.values():
        fn.launches = 0
    sweep_ms = {}
    for cell, first in SWEEP_CELLS:
        for t, tech in enumerate(PolygonSamplingTechnique):
            exp = experiments[first + t]
            exp = dataclasses.replace(exp, screenshot_path=os.path.join(
                data_dir, "smoke", os.path.basename(exp.screenshot_path)))
            result = harness.run_experiments(
                [exp], build_app, min_warmup_seconds=0.0,
                min_warmup_frames=SWEEP_WARMUP, measure_frames=SWEEP_MEASURED,
                data_directory=data_dir, device="cuda")[0]
            frame = last.pop("image")
            check(tuple(frame.shape) == (exp.height, exp.width, 3),
                  f"sweep frame shape {tuple(frame.shape)}")
            check(bool(torch.isfinite(frame).all()),
                  f"sweep frame {first + t} is not finite")
            sentinels = int((frame == pink).all(dim=-1).sum())
            check(sentinels == 0,
                  f"sweep frame {first + t} has {sentinels} NaN sentinels")
            # The 128-light cells divide both the flux and the exposure by
            # 128 (experiment_list.c:364-409), so their frames are dark.
            mean = float(frame.mean())
            check(1e-4 < mean < 0.95,
                  f"sweep frame {first + t} mean {mean:.4f} is implausible")
            sweep_ms[(cell, tech.value)] = result.frame_time_ms
            log(f"sweep {first + t:03d} {cell} {tech.value}: median "
                f"{result.frame_time_ms:.3f} ms/frame ({SWEEP_WARMUP} "
                f"warm-up, "
                f"{SWEEP_MEASURED} measured, pipelined), mean {mean:.4f} "
                f"[{card}]")
            torch.cuda.empty_cache()
    sweep_launches = {name: fn.launches for name, fn in counters.items()}
    log(f"timing sweep launches: {sweep_launches}")
    check(sweep_launches["K5"] > 0, "the timing sweep did not launch K5")
    check(sweep_launches["K4"] == 0, "the timing sweep launched K4")
    print(json.dumps({"sweep_ms": {f"{c}/{t}": round(v, 4)
                                   for (c, t), v in sweep_ms.items()},
                      "card": card}), flush=True)

    log(f"peak device memory: "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    sources = {
        "K1": ("vulkan_renderer_tpu_torch/csrc/anyhit.cu",
               "vulkan_renderer_tpu/render/trace_kernel.py:637"),
        "K2": ("vulkan_renderer_tpu_torch/csrc/closest.cu",
               "vulkan_renderer_tpu/render/trace_kernel.py:949"),
        "K3": ("vulkan_renderer_tpu_torch/csrc/closest.cu",
               "vulkan_renderer_tpu/render/trace_kernel.py:1224"),
        "K4": ("vulkan_renderer_tpu_torch/csrc/fused_shading.cu",
               "vulkan_renderer_tpu/render/fused.py:629"),
        "K5": ("vulkan_renderer_tpu_torch/csrc/fused_resolved.cu",
               "vulkan_renderer_tpu/render/fused.py:720"),
    }
    check(k5_main is not None, "no PSA 128-light K5 measurement")
    timings["K5"] = (k5_main[0], k5_main[1], None, k5_main[2], k5_main[3])
    launches["K5"] = sweep_launches["K5"]
    results["K4"]["max_abs_err"] = max(
        [results["K4"]["max_abs_err"]]
        + [r["k4_max_abs_err"] for r in technique_rows])
    results["K5"] = dict(max_abs_err=max(
        [r["k5_max_abs_err"] for r in technique_rows]
        + [r["max_abs_err"] for r in mis_rows]))
    kernels = []
    for name in ("K1", "K2", "K3", "K4", "K5"):
        ms, plain_ms, ms_sub, shape, plain_shape = timings[name]
        entry = {"name": name, "route": "cuda", "source": sources[name][0],
                 "replaces": sources[name][1], "launches": launches[name],
                 "max_abs_err": results[name]["max_abs_err"],
                 "ms": round(ms, 4), "plain_ms": round(plain_ms, 4),
                 "shape": shape}
        if plain_shape and ms_sub is not None:
            entry.update(plain_shape=plain_shape,
                         ms_at_plain_shape=round(ms_sub, 4))
        elif plain_shape:
            entry.update(plain_shape=plain_shape)
        kernels.append(entry)
    print(json.dumps({"kernels": kernels, "frame_ms_median":
                      round(frame_median, 4), "card": card}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(run())
