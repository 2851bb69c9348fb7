"""Timing-sweep rows at the reference protocol, each beside its window.

    python -m vulkan_renderer_tpu_torch.tools.sweep_check -e 102 103 ... \
        [--results-csv data/results_torch.csv] [--data-directory data] \
        [--output-dir data/experiments] [--warmup-frames 110] \
        [--measure-frames 100] [--jsonl FILE] [--tolerance 0.05]

On one card, for each timing-sweep experiment given, it
1. runs the harness's measurement through its timing gate
   (experiments/harness.py run_gated: >= 1 s and >= --warmup-frames
   warm-up frames, then --measure-frames frames with 3 in flight, the
   median of the frame-to-frame timer stamps) and writes the row to
   --results-csv as the harness's main does;
2. times the window ms/frame of the experiment's Application just
   measured (tools/bench_frame.py window_ms: WINDOW_FRAMES frames with 3 in
   flight, the host clock from the first dispatch until the last frame
   retires, over WINDOW_FRAMES);
3. prints one JSON line: the harness median, the window, harness over
   window, and the 10th, 50th and 90th percentiles, least and largest of
   the measured stamp deltas (ms); --jsonl files get every delta too.
K5's libraries for the experiments' techniques and vertex counts are
built first, in parallel. A last line gives the largest |harness / window
- 1| and the experiments beyond --tolerance; the exit code is 1 if there
is one. Needs a CUDA GPU.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys

import numpy as np
import torch

from ..core.device import get_device
from ..experiments import harness, setups
from ..kernels import build
from . import bench_frame


def stamp_quantiles(deltas_s) -> dict:
    """Quantiles, least and largest of the stamp deltas, in ms."""
    ms = np.asarray(deltas_s, dtype=np.float64) * 1e3
    return {"p10": round(float(np.percentile(ms, 10)), 4),
            "p50": round(float(np.median(ms)), 4),
            "p90": round(float(np.percentile(ms, 90)), 4),
            "min": round(float(ms.min()), 4),
            "max": round(float(ms.max()), 4), "count": int(ms.size)}


def measure(index: int, experiment, csv_path: str, card: str,
            data_directory: str = "data", warmup_frames: int = 110,
            measure_frames: int = 100) -> dict:
    """Steps 1-3 for one experiment: its line, with every stamp delta
    (ms) under "deltas_ms"."""
    apps = []

    def build_application(e):
        apps[:] = [setups.build_default_application(
            e, data_directory, device="cuda")]
        return apps[0]

    run = functools.partial(
        harness.run_experiments, build_application=build_application,
        min_warmup_frames=warmup_frames, measure_frames=measure_frames,
        data_directory=data_directory, device="cuda")
    result = harness.run_gated(index, experiment, run, csv_path, card)
    harness.record_result(csv_path, index, result, "cuda", card)
    deltas = apps[0].timer.deltas()
    window = bench_frame.window_ms(torch, apps[0], bench_frame.WARMUP)
    apps.clear()
    torch.cuda.empty_cache()
    return {"index": index,
            "cell": harness._timing_cell(experiment.screenshot_path),
            "technique": experiment.settings.polygon_sampling_technique.value,
            "harness_ms": round(result.frame_time_ms, 4),
            "window_ms": round(window, 4),
            "ratio": round(result.frame_time_ms / window, 4),
            "stamps_ms": stamp_quantiles(deltas), "card": card,
            "deltas_ms": [round(d * 1e3, 4) for d in deltas]}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("-e", "--experiments", nargs="+", type=int,
                        required=True, help="timing-sweep indices (50-309)")
    parser.add_argument("--results-csv", default="data/results_torch.csv")
    parser.add_argument("--data-directory", default="data")
    parser.add_argument("--output-dir", default="data/experiments")
    parser.add_argument("--warmup-frames", type=int, default=110)
    parser.add_argument("--measure-frames", type=int, default=100)
    parser.add_argument("--jsonl", default=None,
                        help="also append each line to this file")
    parser.add_argument("--tolerance", type=float, default=0.05,
                        help="largest |harness / window - 1| accepted")
    args = parser.parse_args(argv)
    device = get_device("cuda")
    experiments = harness.create_experiment_list(output_dir=args.output_dir)
    picked = [(i, experiments[i]) for i in args.experiments]
    for i, e in picked:
        if harness._timing_cell(e.screenshot_path) is None:
            raise SystemExit(f"experiment {i} is not a timing-sweep one")
    card = harness.card_description(device)
    os.makedirs(os.path.dirname(args.results_csv) or ".", exist_ok=True)
    jobs = bench_frame.sweep_jobs([e for _, e in picked])
    wall = build.build_many(jobs)
    print(json.dumps({"card": card, "k5_libraries": len(jobs),
                      "build_wall_s": round(wall, 2)}), flush=True)
    beyond = []
    worst = 0.0
    for i, e in picked:
        line = measure(i, e, args.results_csv, card, args.data_directory,
                       args.warmup_frames, args.measure_frames)
        deltas = line.pop("deltas_ms")
        print(json.dumps(line), flush=True)
        if args.jsonl:
            with open(args.jsonl, "a") as f:
                f.write(json.dumps({**line, "deltas_ms": deltas}) + "\n")
        worst = max(worst, abs(line["ratio"] - 1.0))
        if abs(line["ratio"] - 1.0) > args.tolerance:
            beyond.append(i)
    print(json.dumps({"experiments": len(picked),
                      "largest_deviation": round(worst, 4),
                      "beyond_tolerance": beyond,
                      "tolerance": args.tolerance, "card": card}),
          flush=True)
    return 1 if beyond else 0


if __name__ == "__main__":
    sys.exit(main())
