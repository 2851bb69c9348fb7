"""RMSE self-reference table of the three quality configurations.

Counterpart of vulkan_renderer_tpu/tools/rmse_table.py. A `spp`-sample
estimate of a frame is compared with an independent, deeper `ref_spp`
estimate of the same frame (the in-renderer reference protocol of
experiment_list.c:96-100), both accumulated from one-sample frames with
the noise advancing per frame (animate_noise), and the RMSE is reported
in sRGB [0, 1] units. The configurations are the JAX tool's, on the same
procedural stand-ins; on the card configuration 1 runs on K5, 2 on the
per-pixel path (DIFFUSE_SPECULAR_SEPARATELY) and 3 on K4 + K1.

Each run appends one row to results/rmse_torch.csv (a file of the port's
own; results/rmse.csv holds the JAX package's rows), with the card's
name and power limit in the `device` column and the mean ms per
accumulated frame (host clock around the frames, each synchronized).

    python -m vulkan_renderer_tpu_torch.tools.rmse_table --config 1 \
        [--spp 128] [--ref-spp 1024] [--device cuda]
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
import os
import time

import torch

from ..core.settings import (MisHeuristic, PolygonSamplingTechnique,
                             RenderSettings, SamplingStrategy)
from ..experiments import harness
from ..experiments.setups import build_default_application
from ..ops.srgb import linear_to_srgb

CSV_PATH = os.path.join("results", "rmse_torch.csv")
CSV_HEADER = ("config", "tag", "width", "height", "spp", "ref_spp", "rmse",
              "ms_per_frame", "backend", "device", "stand_in",
              "primary_uncertain", "shadow_overflow")


def configs():
    """The JAX tool's configurations (_configs): scene, size, tag and
    settings."""
    return {
        1: dict(scene="mis_plane", width=256, height=256,
                tag="quad light over textured plane; diffuse LTC; "
                    "no shadows",
                settings=RenderSettings(
                    sampling_strategy=SamplingStrategy.DIFFUSE_ONLY,
                    polygon_sampling_technique=(
                        PolygonSamplingTechnique.BASELINE),
                    sample_count=1, trace_shadow_rays=False,
                    animate_noise=True, output_linear_rgb=True)),
        2: dict(scene="cornell_box", width=512, height=512,
                tag="cornell box; PSA + GGX specular; light sampling only",
                settings=RenderSettings(
                    sampling_strategy=(
                        SamplingStrategy.DIFFUSE_SPECULAR_SEPARATELY),
                    polygon_sampling_technique=(
                        PolygonSamplingTechnique.PROJECTED_SOLID_ANGLE),
                    sample_count=1, trace_shadow_rays=False,
                    animate_noise=True, output_linear_rgb=True)),
        3: dict(scene="roughness_planes", width=1920, height=1080,
                tag="roughness planes; full MIS + LTC + shadow rays",
                settings=RenderSettings(
                    sampling_strategy=SamplingStrategy.DIFFUSE_SPECULAR_MIS,
                    mis_heuristic=MisHeuristic.OPTIMAL_CLAMPED,
                    mis_visibility_estimate=0.5,
                    polygon_sampling_technique=(
                        PolygonSamplingTechnique.PROJECTED_SOLID_ANGLE),
                    sample_count=1, trace_shadow_rays=True,
                    animate_noise=True, output_linear_rgb=True)),
    }


@dataclasses.dataclass
class RmseResult:
    rmse: float
    ms_per_frame: float
    row: dict


def run_config(n: int, spp: int, ref_spp: int | None = None,
               data_directory: str = "data", csv_path: str | None = CSV_PATH,
               device: str = "cuda", width: int | None = None,
               height: int | None = None) -> RmseResult:
    """Render configuration n's `spp`-frame estimate and its
    `ref_spp`-frame reference (default 8 x spp) and return their RMSE in
    sRGB units; with csv_path, append the row there. width and height
    override the configuration's size."""
    cfg = configs()[n]
    width, height = width or cfg["width"], height or cfg["height"]
    exp = harness.Experiment(width, height, cfg["scene"], cfg["settings"],
                             screenshot_path="unused_%.3f.png")
    app = build_default_application(exp, data_directory, device=device)
    ref_spp = ref_spp or 8 * spp
    counts = (spp, ref_spp)
    sums = []
    start = time.perf_counter()
    for count in counts:
        total = torch.zeros((height, width, 3), dtype=torch.float64,
                            device=app.device)
        for _ in range(count):
            total += app.render_frame_sync().to(torch.float64)
        sums.append(total)
    ms = (time.perf_counter() - start) * 1e3 / sum(counts)
    a, b = (linear_to_srgb(torch.clamp(s / c, 0.0, 1.0).to(torch.float32))
            for s, c in zip(sums, counts))
    rmse = float(torch.sqrt(torch.mean(
        (a.to(torch.float64) - b.to(torch.float64)) ** 2)))
    row = dict(config=n, tag=cfg["tag"], width=width, height=height,
               spp=spp, ref_spp=ref_spp, rmse=f"{rmse:.3e}",
               ms_per_frame=f"{ms:.3f}", backend=app.device.type,
               device=harness.card_description(app.device),
               stand_in=int(bool(getattr(app, "scene_stand_in", False)
                                 or getattr(app, "layout_stand_in", False))),
               primary_uncertain=0, shadow_overflow=0)
    if csv_path:
        append_row(csv_path, row)
    return RmseResult(rmse, ms, row)


def append_row(csv_path: str, row: dict) -> None:
    """Append `row` to the CSV, writing the header first into a new
    file."""
    os.makedirs(os.path.dirname(csv_path) or ".", exist_ok=True)
    new = not os.path.exists(csv_path)
    with open(csv_path, "a", newline="") as f:
        writer = csv.DictWriter(f, CSV_HEADER, lineterminator="\n")
        if new:
            writer.writeheader()
        writer.writerow(row)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--config", type=int, required=True,
                        choices=(1, 2, 3))
    parser.add_argument("--spp", type=int, default=128)
    parser.add_argument("--ref-spp", type=int, default=None,
                        help="reference sample count (default 8x --spp)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the card) or cpu (plain versions)")
    parser.add_argument("--data-directory", default="data")
    parser.add_argument("--csv", default=CSV_PATH)
    parser.add_argument("--width", type=int, default=None,
                        help="override the configuration's width")
    parser.add_argument("--height", type=int, default=None)
    args = parser.parse_args(argv)
    result = run_config(args.config, args.spp, args.ref_spp,
                        args.data_directory, args.csv, args.device,
                        args.width, args.height)
    r = result.row
    print(f"config {args.config} ({r['tag']}): RMSE {r['rmse']} "
          f"({r['spp']} spp vs {r['ref_spp']} spp reference) at "
          f"{r['width']}x{r['height']}, {r['ms_per_frame']} ms per frame, "
          f"stand_in={r['stand_in']} [{r['device']}]")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
