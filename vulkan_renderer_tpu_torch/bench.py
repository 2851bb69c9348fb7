"""The port's benchmark entry: renders the bench frame and prints ONE JSON
line, the record of the JAX package's bench.py.

    python -m vulkan_renderer_tpu_torch.bench            # on the card
    python -m vulkan_renderer_tpu_torch.bench --device cpu --width 64 \\
        --height 32 --buildings 20 --detail 3            # plain versions

The frame is tools/bench_frame.py's (its one definition): the procedural
city `{scene}_{buildings}x{detail}[_m{materials}]` written once under
--data, four quad street lights, the bench camera, PSA with
DIFFUSE_SPECULAR_MIS and clamped-optimal MIS, shadows unless --no-shadows,
the fixed noise numbers for the sync frames. Measurement as bench.py:
- sync latency: the median of --frames frames, each ended by a
  synchronize, after one warm-up frame;
- pipelined: max(2 frames, 6) frames with per-frame noise
  (advance_noise_random_numbers from 3124705 + rep 7919), at most 3 in
  flight; each frame's luminance sum stays on the device and its 4 bytes
  are read back only when the frame retires (a CUDA event a frame, as in
  core/app.py, so the host never waits inside a dispatch); the host clock
  from the first dispatch until the last frame retires, over the frames;
- a contention guard: the pipelined run is repeated, up to
  --pipelined-reps times, while it reads over 1.2x the sync latency (the
  minimum wins, and the record says `host_contended` if every run did);
- `value` is that minimum, `vs_baseline` its 1080p-scaled value over the
  20 ms target.

The record has bench.py's keys (`metric`, `value`, `unit`, `vs_baseline`,
`loadavg`, `pipelined_reps_ms`, `sync_latency_ms`, and `host_contended`
and `exactness_failed` where they apply) and `card`: nvidia-smi's name and
power limit, or "cpu". The tracers K1 and K2 are exact by construction, so
the metric reads `uncertain=0, overflow=0`; the exit code 2 of an
exactness failure stays part of the record's contract.

bench.py's TPU knobs have no counterpart here: --chunk-rows,
--shadow-chunk-rows, --primary-budget, --shadow-budget, --primary-sc,
--shadow-sc, --retrace-factor, --retrace-frac, --retrace-closest-frac,
--retrace-mid-sc, --seed-closest-sc, --seed-shadow-sc, --seed-items,
--raster, --attr-filter, --attr-avg-items and --traversal. --cpu is
--device cpu. On the card every kernel is built (in parallel) before the
first frame, and a failed build or launch ends the run with a non-zero
exit: there is no fallback to the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from collections import deque

import numpy as np
import torch

from .assets.noise import advance_noise_random_numbers
from .core.device import get_device
from .experiments.harness import card_description
from .render.pipeline import (STAGES, make_frame_constants,
                              render_frame_constants)
from .tools import bench_frame

IN_FLIGHT = 3           # bench.py: at most 3 frames in flight
TARGET_MS_1080P = 20.0  # BASELINE.json's north star at 1920x1080
CONTENTION_RATIO = 1.2  # pipelined over sync latency that flags contention


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--width", type=int, default=960)
    parser.add_argument("--height", type=int, default=540)
    parser.add_argument("--frames", type=int, default=5)
    parser.add_argument("--spp", type=int, default=1)
    parser.add_argument("--scene", default="city")
    parser.add_argument("--buildings", type=int, default=300)
    parser.add_argument("--detail", type=int, default=10,
                        help="face subdivision; tris ~= buildings*90*"
                        "(detail/3)^2 (default: ~300k)")
    parser.add_argument("--no-shadows", action="store_true")
    parser.add_argument("--materials", type=int, default=6,
                        help="city material count")
    parser.add_argument("--cluster-size", type=int, default=64,
                        help="triangles per traversal cluster")
    parser.add_argument("--pipelined-reps", type=int, default=3,
                        help="max repeats of the pipelined loop (min wins; "
                        "stops once a rep passes the <=1.2x sync-latency "
                        "contention check)")
    parser.add_argument("--stop-after", default=None, choices=STAGES,
                        help="end each frame after this stage "
                        "(render/pipeline.py render_frame_constants)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the card) or cpu (plain versions)")
    parser.add_argument("--data", default="data",
                        help="directory of the bench city")
    return parser.parse_args(argv)


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class BenchFrame:
    """The bench frame at the options' scale, size and settings on one
    device; render(noise numbers) dispatches one frame, cut after the
    stage stop_after (args.stop_after unless changed)."""

    def __init__(self, args):
        self.args = args
        self.stop_after = args.stop_after
        self.device = get_device(args.device)
        self.settings = bench_frame.settings(args.spp, not args.no_shadows)
        if self.device.type == "cuda":
            from .kernels import build
            build.build_many(bench_frame.kernel_jobs(self.settings))
        self.scene, self.static = bench_frame.load_city(
            args.data, self.device, cluster_size=args.cluster_size,
            scene=args.scene, buildings=args.buildings, detail=args.detail,
            materials=args.materials)
        self.camera = bench_frame.camera()

    def render(self, noise_numbers) -> torch.Tensor:
        a = self.args
        constants = make_frame_constants(self.camera, a.width, a.height,
                                         self.settings, noise_numbers,
                                         self.device)
        with torch.no_grad():
            return render_frame_constants(
                self.scene, self.static, self.settings, constants, a.width,
                a.height, stop_after=self.stop_after)

    def sync_latency_ms(self, frames: int) -> list:
        """ms of each of `frames` frames, each ended by a synchronize,
        after one warm-up frame."""
        self.render(bench_frame.noise_numbers())
        synchronize(self.device)
        times = []
        for _ in range(frames):
            start = time.perf_counter()
            self.render(bench_frame.noise_numbers())
            synchronize(self.device)
            times.append((time.perf_counter() - start) * 1e3)
        return times

    def pipelined_ms(self, frames: int, seed: int) -> float:
        """ms a frame over `frames` frames with per-frame noise, at most
        IN_FLIGHT in flight: each frame's luminance sum is copied in
        stream order to pinned host memory and read when the frame
        retires, after its event."""
        cuda = self.device.type == "cuda"
        in_flight = deque()

        def retire():
            luminance, event = in_flight.popleft()
            if event is not None:
                event.synchronize()
            return float(luminance)

        start = time.perf_counter()
        for _ in range(frames):
            seed, noise_numbers = advance_noise_random_numbers(seed, True)
            luminance = torch.empty((), dtype=torch.float32, pin_memory=cuda)
            luminance.copy_(self.render(noise_numbers).sum(),
                            non_blocking=cuda)
            event = None
            if cuda:
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(self.device))
            in_flight.append((luminance, event))
            if len(in_flight) > IN_FLIGHT:
                retire()
        while in_flight:
            retire()
        return (time.perf_counter() - start) * 1e3 / frames


def record(args, frame: BenchFrame, latency_ms: float, reps: list,
           card: str) -> dict:
    """bench.py's record (bench.py:263-289) and the card."""
    # The CUDA tracers are exact by construction: nothing is left
    # unproven or overflows.
    uncertain = overflow = 0
    ms = min(reps)
    contended = ms > CONTENTION_RATIO * latency_ms
    try:
        loadavg = round(os.getloadavg()[0], 2)
    except OSError:
        loadavg = None
    ms_1080p = ms * (1920 * 1080) / (args.width * args.height)
    tri_count = int(frame.scene.triangle_positions.shape[0])
    stage = f" stop_after={args.stop_after}" if args.stop_after else ""
    contention = (f", CONTENDED host (loadavg {loadavg}, "
                  f"{len(reps)} reps all >1.2x latency)") if contended else ""
    out = {
        "metric": f"ms/frame pipelined{stage} {args.width}x{args.height} "
                  f"{args.spp}spp shadows={not args.no_shadows} "
                  f"{args.scene} ({tri_count} tris, "
                  f"sync latency {round(latency_ms, 1)} ms, "
                  f"uncertain={uncertain}, overflow={overflow}; "
                  f"scaled to 1080p: {round(ms_1080p, 1)} ms"
                  f"{contention})",
        "value": round(ms, 3),
        "unit": "ms",
        "vs_baseline": round(ms_1080p / TARGET_MS_1080P, 4),
        "loadavg": loadavg,
        "pipelined_reps_ms": [round(r, 1) for r in reps],
        "sync_latency_ms": round(latency_ms, 1),
        "card": card,
    }
    if contended:
        out["host_contended"] = True
    if uncertain or overflow:
        out["exactness_failed"] = True
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    frame = BenchFrame(args)
    card = card_description(frame.device)
    latency_ms = float(np.median(frame.sync_latency_ms(args.frames)))
    frames = max(args.frames * 2, 6)
    reps = []
    for rep in range(args.pipelined_reps):
        reps.append(frame.pipelined_ms(frames, 3124705 + rep * 7919))
        if reps[-1] <= CONTENTION_RATIO * latency_ms:
            break
        time.sleep(2.0)
    out = record(args, frame, latency_ms, reps, card)
    print(json.dumps(out), flush=True)
    if out.get("exactness_failed"):
        print("EXACTNESS FAILURE: a tracer left rays unproven",
              file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
