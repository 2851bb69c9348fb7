#!/usr/bin/env python3
"""Profile the bench frame (as tools/bench_frame.py defines it), or the
frames of harness experiments, on one GPU with torch.profiler:

    python3 vulkan_renderer_tpu_torch/tools/profile_frame.py [--data DIR]
        [--root TREE] [--fused off] [--experiment INDEX [INDEX ...]]
        [--pixel-chunks N [N ...]]

(--fused off: the bench frame on the per-pixel shading path.
--experiment: each experiment's frames through its Application, as the
harness builds it from the assets or stand-ins in --data, one line each.
--pixel-chunks: profile once per chunk size of the per-pixel path,
render/pipeline.py::PIXEL_CHUNK, which changes no result. --root: profile
the port of another checkout, e.g. a parent commit unpacked with git
archive, so that two trees are timed in one call.)

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
import functools
import json
import os
import sys
import time

PROFILED = 5
TOP = 25
# CUDA kernel names of the bench frame's hand-written kernels.
PORT_KERNELS = {"anyhit_kernel": "K1", "closest_kernel": "K2",
                "attrs_kernel": "K3", "fused_shading_kernel": "K4",
                "preamble_kernel": "K6"}


def port_kernel(name):
    return next((k for n, k in PORT_KERNELS.items() if n in name), None)


def summarize(prof, window_ms: float, frames: int = PROFILED) -> dict | None:
    """The profile's per-frame numbers over `frames` profiled frames, or
    None without a device event."""
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
            port_ms[port_kernel(name)] += us / 1e3 / frames
    device_ms = sum(us for us, _, _ in rows) / 1e3 / frames
    return {
        "host_ms_per_frame": round(window_ms / frames, 4),
        "device_busy_ms_per_frame": round(busy_us / 1e3 / frames, 4),
        "busy_share": round(busy_us / 1e3 / window_ms, 4),
        "device_events_per_frame": len(spans) / frames,
        "device_ms_per_frame": round(device_ms, 4),
        "port_kernels_ms_per_frame": {k: round(v, 4)
                                      for k, v in port_ms.items()},
        "other_device_ms_per_frame": round(
            device_ms - sum(port_ms.values()), 4),
        "top": [{"name": name[:120], "ms_per_frame": round(
            us / 1e3 / frames, 4), "calls_per_frame": count / frames}
            for us, count, name in rows[:TOP]]}


def profile_frames(torch, frame, warmup: int, frames: int = PROFILED):
    """frame() `warmup` times, then `frames` times under torch.profiler:
    (summarize's dictionary or None, peak device GiB of the profiled
    frames)."""
    from torch.profiler import ProfilerActivity, profile
    with torch.no_grad():
        for _ in range(warmup):
            frame()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            start = time.perf_counter()
            for _ in range(frames):
                frame()
            torch.cuda.synchronize()
            window_ms = (time.perf_counter() - start) * 1e3
    summary = summarize(prof, window_ms, frames)
    del prof
    return summary, torch.cuda.max_memory_allocated() / 2**30


def _experiment_frame(setups, exp, data):
    """The frame function of experiment `exp`'s Application."""
    return setups.build_default_application(
        exp, data, device="cuda").render_frame_sync


def main(argv=None) -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.dirname(os.path.dirname(here))
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--data", default=os.path.join(root, "data"),
                        help="directory of the bench city and stand-ins")
    parser.add_argument("--fused", default="auto", choices=("auto", "off"),
                        help="the bench frame's shading path "
                             "(SceneStatic.fused)")
    parser.add_argument("--experiment", type=int, nargs="+", default=None,
                        help="profile these harness experiments instead "
                             "of the bench frame")
    parser.add_argument("--root", default=root,
                        help="the checkout whose port is profiled")
    parser.add_argument("--pixel-chunks", type=int, nargs="+", default=None,
                        help="per-pixel chunk sizes to profile in turn")
    args = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("profile_frame: needs a CUDA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
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

        def bench_frame():
            return bench.render(scene, static, s)
        jobs = [({"frame": "bench", "fused": args.fused},
                 lambda: bench_frame)]
    else:
        experiments = harness.create_experiment_list()
        jobs = [({"frame": f"experiment {i}",
                  "size": [experiments[i].width, experiments[i].height]},
                 functools.partial(_experiment_frame, setups, experiments[i],
                                   data)) for i in args.experiment]
    for label, make_frame in jobs:
        frame = make_frame()
        for chunk in args.pixel_chunks or [pipeline.PIXEL_CHUNK]:
            pipeline.PIXEL_CHUNK = chunk
            summary, peak = profile_frames(torch, frame, bench.WARMUP)
            if summary is None:
                print("profile_frame: the profiler recorded no device event",
                      file=sys.stderr)
                return 1
            print(json.dumps({
                "card": card, "frames": PROFILED, **label,
                "pixel_chunk": chunk, "peak_gib": round(peak, 3),
                **summary}), flush=True)
            torch.cuda.empty_cache()
        del frame
    return 0


if __name__ == "__main__":
    sys.exit(main())
