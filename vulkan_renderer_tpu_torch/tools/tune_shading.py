#!/usr/bin/env python3
"""Launch-bound candidates of the shading kernels K4 and K5, timed on one
GPU.

    python3 vulkan_renderer_tpu_torch/tools/tune_shading.py [--data DIR]

For each candidate (threads per block, blocks per SM that
__launch_bounds__ asks the register allocator for; CANDIDATES) it builds
K4 at the bench frame's settings and K5 at PSA's and Arvo PSA's in both
timing-sweep cells (tools/bench_frame.py defines all of them), checks that
each output equals the one of render/fused.py's LAUNCH_BOUNDS bit for bit,
and prints one JSON line per kernel and candidate: registers, stack and
spills (ptxas), theoretical resident warps per SM, and ms (CUDA events on
the captured inputs, warm L2), beside the card's name and power limit.
The wrappers use LAUNCH_BOUNDS only: this tool is how it was chosen, and
is run again whenever the shared body csrc/techniques.cuh changes what a
thread keeps live, or on another card. Its launches go through
fused.launch_kernel, so they add to the wrappers' launch counts.
"""

import argparse
import json
import os
import sys

CANDIDATES = ((128, 1), (128, 3), (128, 4), (128, 5), (64, 8), (256, 1),
              (256, 2))
SWEEP_TECHNIQUES = ("PROJECTED_SOLID_ANGLE", "PROJECTED_SOLID_ANGLE_ARVO")


def main(argv=None) -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.dirname(os.path.dirname(here))
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--data", default=os.path.join(root, "data"),
                        help="directory of the bench city and stand-ins")
    args = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("tune_shading: needs a CUDA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, root)
    from vulkan_renderer_tpu_torch.kernels import build
    from vulkan_renderer_tpu_torch.render import fused
    from vulkan_renderer_tpu_torch.tools import bench_frame as bench

    card = bench.card_name()
    data_dir = os.path.abspath(args.data)
    s = bench.settings()
    scene, static = bench.load_city(data_dir, torch.device("cuda"))
    cases = [("K4", "bench", bench.capture_inputs(scene, static, s)
              ["fused_shading"])]
    for cell, exp in bench.sweep_experiments(data_dir, SWEEP_TECHNIQUES):
        _, frame = bench.experiment_frame(torch, data_dir, exp)
        k5_args = frame()["fused_resolved"]
        tech = exp.settings.polygon_sampling_technique.value
        cases.append(("K5", f"{cell}/{tech}", k5_args))
    jobs = []
    for kernel, _, (_, _, _, st, settings) in cases:
        for threads, blocks in CANDIDATES:
            jobs.append((fused._KERNELS[kernel][0], {
                **fused.library_defines(kernel, st, settings),
                "VR_THREADS": threads, "VR_MIN_BLOCKS": blocks}))
    wall = build.build_many(jobs)
    print(json.dumps({"card": card, "libraries": len(jobs),
                      "build_wall_s": round(wall, 2)}), flush=True)
    for kernel, name, (planes, noise, ls, st, settings) in cases:
        def run(lib):
            out = torch.empty((3 + 7 * fused.rays_per_light(settings)
                               * st.light_count if kernel == "K4" else 3,
                               planes.shape[1]), device=planes.device)
            fused.launch_kernel(kernel, lib, planes, noise, ls, st, settings,
                                out)
            return out
        reference = run(fused.load_kernel(kernel, st, settings))
        for threads, blocks in CANDIDATES:
            extra = {"VR_THREADS": threads, "VR_MIN_BLOCKS": blocks}
            lib = fused.load_kernel(kernel, st, settings, extra)
            same = torch.equal(run(lib).view(torch.int32),
                               reference.view(torch.int32))
            ms = bench.cuda_ms(torch, lambda: run(lib), 3)
            tag = build._tag(fused._KERNELS[kernel][0], {
                **fused.library_defines(kernel, st, settings), **extra})
            rows = build.ptxas_table(build.BUILD_REPORTS[tag][1]) \
                if tag in build.BUILD_REPORTS else []
            print(json.dumps({
                "kernel": kernel, "input": name, "threads": threads,
                "min_blocks": blocks, "ms": round(ms, 4),
                "equal_to_default": same,
                "ptxas": [dict(r, resident_warps=build.resident_warps(
                    r["registers"], threads, r["smem"])) for r in rows],
                "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
