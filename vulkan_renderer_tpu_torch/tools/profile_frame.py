#!/usr/bin/env python3
"""Profile the bench frame (as tools/bench_frame.py defines it), or one
harness experiment's frame, on one GPU with torch.profiler:

    python3 vulkan_renderer_tpu_torch/tools/profile_frame.py [--data DIR]
        [--fused off] [--experiment INDEX] [--pixel-chunks N [N ...]]

(--fused off: the bench frame on the per-pixel shading path.
--experiment: that experiment's frames through its Application, as the
harness builds it from the assets or stand-ins in --data. --pixel-chunks:
profile once per chunk size of the per-pixel path,
render/pipeline.py::PIXEL_CHUNK, which changes no result.)

After bench_frame.WARMUP warm-up frames it profiles PROFILED frames
back to back, then prints one JSON line: the card (nvidia-smi name and
power limit), host ms per frame over the window, device busy ms per frame
(the union of the intervals of every kernel, copy and fill on the card),
the busy share of the window, the device events per frame, the peak
device memory of the profiled frames, the port's kernels K1-K4 beside
everything else, and the largest device kernels by time (ms and calls per
frame). It exits non-zero when the profiler records no device event. It
imports no JAX.
"""

import argparse
import dataclasses
import json
import os
import sys
import time

PROFILED = 5
TOP = 25
# CUDA kernel names of the bench frame's hand-written kernels.
PORT_KERNELS = {"anyhit_kernel": "K1", "closest_kernel": "K2",
                "attrs_kernel": "K3", "fused_shading_kernel": "K4"}


def port_kernel(name):
    return next((k for n, k in PORT_KERNELS.items() if n in name), None)


def summarize(prof, window_ms: float) -> dict | None:
    """The profile's per-frame numbers, or None without a device event."""
    from torch.autograd import DeviceType
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        return None
    busy_us, end = 0.0, float("-inf")
    for lo, hi in spans:
        busy_us += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    rows = []
    for avg in prof.key_averages():
        us = getattr(avg, "self_device_time_total", None)
        if us is None:
            us = avg.self_cuda_time_total
        if us > 0 and avg.device_type == DeviceType.CUDA:
            rows.append((us, avg.count, avg.key))
    rows.sort(reverse=True)
    port_ms = {k: 0.0 for k in PORT_KERNELS.values()}
    for us, _, name in rows:
        if port_kernel(name):
            port_ms[port_kernel(name)] += us / 1e3 / PROFILED
    device_ms = sum(us for us, _, _ in rows) / 1e3 / PROFILED
    return {
        "host_ms_per_frame": round(window_ms / PROFILED, 4),
        "device_busy_ms_per_frame": round(busy_us / 1e3 / PROFILED, 4),
        "busy_share": round(busy_us / 1e3 / window_ms, 4),
        "device_events_per_frame": len(spans) / PROFILED,
        "device_ms_per_frame": round(device_ms, 4),
        "port_kernels_ms_per_frame": {k: round(v, 4)
                                      for k, v in port_ms.items()},
        "other_device_ms_per_frame": round(
            device_ms - sum(port_ms.values()), 4),
        "top": [{"name": name[:120], "ms_per_frame": round(
            us / 1e3 / PROFILED, 4), "calls_per_frame": count / PROFILED}
            for us, count, name in rows[:TOP]]}


def main(argv=None) -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.dirname(os.path.dirname(here))
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--data", default=os.path.join(root, "data"),
                        help="directory of the bench city and stand-ins")
    parser.add_argument("--fused", default="auto", choices=("auto", "off"),
                        help="the bench frame's shading path "
                             "(SceneStatic.fused)")
    parser.add_argument("--experiment", type=int, default=None,
                        help="profile this harness experiment instead of "
                             "the bench frame")
    parser.add_argument("--pixel-chunks", type=int, nargs="+", default=None,
                        help="per-pixel chunk sizes to profile in turn")
    args = parser.parse_args(argv)
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("profile_frame: needs a CUDA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, root)
    from vulkan_renderer_tpu_torch.core.device import get_device
    from vulkan_renderer_tpu_torch.experiments import harness, setups
    from vulkan_renderer_tpu_torch.kernels import build
    from vulkan_renderer_tpu_torch.render import pipeline
    from vulkan_renderer_tpu_torch.tools import bench_frame as bench

    card = bench.card_name()
    data = os.path.abspath(args.data)
    if args.experiment is None:
        s = bench.settings()
        build.build_many(bench.kernel_jobs(s))
        scene, static = bench.load_city(data, get_device("cuda"))
        static = dataclasses.replace(static, fused=args.fused)
        label = {"frame": "bench", "fused": args.fused}

        def frame():
            return bench.render(scene, static, s)
    else:
        exp = harness.create_experiment_list()[args.experiment]
        harness.check_experiment(exp)
        app = setups.build_default_application(exp, data, device="cuda")
        label = {"frame": f"experiment {args.experiment}",
                 "size": [exp.width, exp.height]}
        frame = app.render_frame_sync
    for chunk in args.pixel_chunks or [pipeline.PIXEL_CHUNK]:
        pipeline.PIXEL_CHUNK = chunk
        with torch.no_grad():
            for _ in range(bench.WARMUP):
                frame()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                start = time.perf_counter()
                for _ in range(PROFILED):
                    frame()
                torch.cuda.synchronize()
                window_ms = (time.perf_counter() - start) * 1e3
        summary = summarize(prof, window_ms)
        if summary is None:
            print("profile_frame: the profiler recorded no device event",
                  file=sys.stderr)
            return 1
        print(json.dumps({
            "card": card, "frames": PROFILED, **label, "pixel_chunk": chunk,
            "peak_gib": round(torch.cuda.max_memory_allocated() / 2**30, 3),
            **summary}), flush=True)
        del prof
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
