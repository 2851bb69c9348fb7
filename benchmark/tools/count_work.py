#!/usr/bin/env python3
"""Count, once, the work each kernel roofline of a cell is held against,
and write it to benchmark/counts/<workload>.json. On the GPU:

    python3 benchmark/tools/count_work.py WORKLOAD [WORKLOAD ...]

It renders the cell's frame at seed 0 (the first frame of a run with
--seed 0) through the port's kernels, captures each kernel's arguments,
and counts on them:

- K1, K2 (tracers): the float32 operations the least walk of any binary
  tree over the frame's clusters needs per live ray (one root-to-leaf
  path, two child boxes a level, one sub-box and one triangle test), and
  each ray's bytes in and out once plus the scene's tables once;
- K4, K5 (shading): the operations their counting builds
  (-DVR_COUNT_OPS=1) execute on these arguments, and the planes, light
  records and outputs once plus the noise texels the frame's fetches
  reach.

This reads the program's internals as they are at commit b4b0e8b, once:
the counts are frozen, so that a later design that does less or more of
its own work is held against the same work. Later trees never run it.
"""

import dataclasses
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

# Float32 operations of one slab test and of the two Moeller-Trumbore
# bodies (chip_smoke.py at commit b4b0e8b, counted from csrc/common.cuh
# and the kernels' triangle tests).
SLAB_OPS, ANYHIT_TRI_OPS, CLOSEST_TRI_OPS = 26, 55, 57


def tracer_floor_ops(rays: int, cluster_count: int, tri_ops: int) -> int:
    depth = (cluster_count - 1).bit_length()
    return rays * ((2 * depth + 1) * SLAB_OPS + tri_ops)


def noise_table_bytes(noise, pairs: int) -> int:
    """The table bytes `pairs` noise pairs of the frame need at the least
    (chip_smoke.py): per layer, the texels its fetches reach in the
    channels they read."""
    th, tw = noise.table.shape[1], noise.table.shape[2]
    reach, channels = {}, {}
    for f, (_, _, layer) in enumerate(noise.fetches.tolist()):
        used = min(4, 2 * pairs - 4 * f)
        if used <= 0:
            break
        reach[layer] = reach.get(layer, 0) + noise.column_count
        channels[layer] = max(channels.get(layer, 0), used)
    return sum(min(th * tw, reach[k]) * channels[k] * 4 for k in reach)


def count(workload: str) -> dict:
    import torch

    import harness
    import inputs
    from vulkan_renderer_tpu_torch.assets.noise import \
        advance_noise_random_numbers
    from vulkan_renderer_tpu_torch.render import fused, pipeline
    entry, config, traffic = inputs.cell_files(workload)
    app = harness.build_application(workload, config, traffic, "cuda")
    width, height = config["resolution"]
    s = app.settings
    _, randoms = advance_noise_random_numbers(
        0, s.animate_noise and s.frame_bits == 0)
    constants = pipeline.make_frame_constants(
        app.scene_spec.camera, width, height, s, randoms, app.device)
    captured = {}

    def recorder(name, fn):
        def call(*args):
            captured[name] = args
            return fn(*args)
        return call
    kernels = pipeline.FrameKernels(*(
        recorder(f.name, getattr(pipeline.KERNELS, f.name))
        for f in dataclasses.fields(pipeline.FrameKernels)))
    with torch.no_grad():
        pipeline.render_frame_constants(app.scene, app.static, s, constants,
                                        width, height, kernels)
    torch.cuda.synchronize()
    clusters = app.scene.clusters
    tables = 4 * (clusters.planes.numel() + clusters.subboxes.numel()
                  + clusters.bvh_nodes.numel())
    out = {"frame": f"seed 0's first frame, {width}x{height}",
           "clusters": clusters.cluster_count}
    for kernel, field, out_bytes, tri_ops in (
            ("K1", "trace_anyhit", 1, ANYHIT_TRI_OPS),
            ("K2", "trace_closest", 8, CLOSEST_TRI_OPS)):
        if field in captured:
            args = captured[field]
            rays = int((args[3] >= 0).sum())
            out[kernel] = {
                "operations": tracer_floor_ops(rays, clusters.cluster_count,
                                               tri_ops),
                "bytes": args[2].shape[0] * (28 + out_bytes) + tables,
                "live_rays": rays, "rays": args[2].shape[0],
                "how": "least walk of any binary tree over the clusters"}
    for kernel, field, fn in (
            ("K4", "fused_shading", fused.fused_light_shading),
            ("K5", "fused_resolved", fused.fused_light_shading_resolved)):
        if field not in captured:
            continue
        planes, noise, light_scalars, static, settings = captured[field]
        counts = torch.zeros(len(fused.OP_STAGES) * len(fused.OP_KINDS),
                             dtype=torch.int64, device=planes.device)
        fn(planes, noise, light_scalars, static, settings,
           op_counts=counts)
        pairs = fused.rays_per_light(settings) * static.light_count
        outputs = 3 + 7 * pairs if kernel == "K4" else 3
        out[kernel] = {
            "operations": int(counts.sum()),
            "bytes": 4 * (planes.numel() + light_scalars.numel()
                          + outputs * planes.shape[1])
            + noise_table_bytes(noise, pairs),
            "pixels": planes.shape[1], "lights": static.light_count,
            "how": "counting build (-DVR_COUNT_OPS=1) on the frame"}
    return out


def main(argv=None) -> int:
    import torch
    if not torch.cuda.is_available():
        print("count_work: needs a CUDA GPU", file=sys.stderr)
        return 1
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("workloads", nargs="+")
    parser.add_argument("--out", default=os.path.join(HERE, "counts"),
                        help="directory of the counts files")
    args = parser.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    for workload in args.workloads:
        counts = count(workload)
        path = os.path.join(args.out, f"{workload}.json")
        with open(path, "w") as f:
            json.dump(counts, f, indent=1)
            f.write("\n")
        print(workload, json.dumps(counts), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
