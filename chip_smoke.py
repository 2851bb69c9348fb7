#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (vulkan_renderer_tpu_torch) on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It
1. prints the card (nvidia-smi name and power limit) and the versions;
2. builds the CUDA kernels K1-K6 from vulkan_renderer_tpu_torch/csrc with
   nvcc, one process per library, all at once (K4 and K5 for each of the
   13 techniques at every light vertex count the timing sweep renders, 3
   to 7, each count a body of its own; both under DIFFUSE_SPECULAR_MIS
   for PSA and PSA-biased with every heuristic, and K4 under the arcade's
   clamped-optimal MIS on a heptagon; the operation-counting builds,
   -DVR_COUNT_OPS=1, of K4 at the bench frame and of K5 for PSA and Arvo
   PSA at each vertex count), and prints each build's time and, for every
   K4 and K5 instantiation, the registers, stack, spills and shared memory
   ptxas reports with the theoretical resident warps per SM that follow;
3. writes the procedural bench city (300 buildings, detail 10) into data/
   with the port's own writer and loads it onto the card, as
   vulkan_renderer_tpu_torch/tools/bench_frame.py defines the bench frame;
4. holds every kernel against its plain PyTorch version on the card at
   the bench frame's shapes: K2 on all 518,400 primary rays (primitive
   and t equal exactly, ties included), K4 on all 518,400 pixels x 4
   lights (bit for bit), K1's slot entry, which the frame runs, on 4,096
   pixels x 8 slots (its colors bit for bit), and the ray-list K1, which
   only the stop_after cuts run, on 131,072 live shadow rays of the
   frame's ray list (0 mismatches); then counts the BVH tracers' box and
   triangle tests per ray with their counting builds (-DVR_COUNT_TESTS=1)
   over the whole bench frame, and K4's float operations with its
   counting build;
4d. holds K6 (the pixel preamble) against its plain version at the bench
   frame's shapes and at the 1-light 1920x1080 sweep cell's (experiment
   282): NaN where the plain version is NaN, every other value bit for
   bit; times K6 (beside its bound, its plane traffic) and the plain
   version; and counts K6's launches in one frame of that cell (1);
5. renders a 128x64 frame through the kernels and through the plain
   versions and compares the images;
6. renders the bench frame (960x540, 1 spp, four quad street lights, PSA
   with DIFFUSE_SPECULAR_MIS and clamped-optimal MIS, shadows on) with
   every kernel launch counter reset just before and read just after,
   checks the image, and times it (bench_frame.frame_ms: the median of 15
   frames after 3 warm-up) along with each kernel and its plain version;
   then, with shadows off (the default settings, which take K5 under
   DIFFUSE_SPECULAR_MIS), holds K5 and K4 against their plain versions bit
   for bit on 4,096 of the bench frame's pixels for PSA and PSA-biased
   with each of the 5 heuristics;
7. for every technique, captures K5's inputs from the harness's own
   timing-sweep frames at 1920x1080 in five cells, one for each light
   vertex count: the two sweep cells (the 128-light x 1-spp central
   quadrilaterals, experiment 102 + t, and the 1-light x 128-spp decentral
   pentagons, 193 + t) and three holding cells (central triangles x 128,
   50 + t; decentral hexagon x 128 spp, 245 + t; central heptagons x 128,
   258 + t), and holds K5 and K4 under DIFFUSE_ONLY against their plain
   versions on 4,096 evenly spaced pixels (bit for bit; Arvo SA and Arvo
   PSA on at most 0.5% of values), and K4's slots resolved with visibility
   1 against K5 (bit for bit); K2 against its plain version on every
   primary ray of each cell's first frame (exact); each frame's peak
   device memory and hit share; and K5's float operations on the whole
   frame for PSA and Arvo PSA with its counting build, with their bound;
7b. captures K4's inputs from the harness's frames of the arcade's
   heptagon (the cornell stand-in, 1024x1024, shadows on): experiment 312
   (PSA, DIFFUSE_ONLY) and 314 (PSA, DIFFUSE_SPECULAR_MIS with
   clamped-optimal MIS), and holds K4 against its plain version bit for
   bit on 4,096 pixels of each; on 314, K2 on every primary ray and K1 on
   up to 131,072 live shadow rays against their plain versions (exact),
   on the one scene of the harness whose triangles are not axis-aligned
   (30 in one cluster), with their box and triangle tests per ray; each
   kernel's ms on the frame;
7c. captures K1's slot-entry arguments from the harness's frame of
   experiment 316 (the benchmark's arcade cell: 1024x1024, 64 spp, 128
   shadow slots a pixel) and holds the entry bit for bit against the
   ray list (the plain megabatch), the ray-list K1 and the plain combine
   on every pixel, and against its plain version on 4,096 pixels; its
   live-ray count against the megabatch's t_max >= 0; and times the entry
   against that route and against the ray-list K1 alone;
8. runs those 26 timing-sweep experiments, and PSA and Arvo PSA of each
   holding cell (6 more), through the port's harness (3 warm-up and 7
   measured frames each; the harness's defaults of 110/100 stay for real
   sweeps) with every launch counter reset before and read after: K5
   must run, K4 must not; each frame is checked, and the median of its
   few stamp deltas is printed beside the window ms/frame of the same
   Application (tools/bench_frame.py window_ms: 40 frames with 3 in
   flight) and the card; phase 22 measures the frame time at the
   reference protocol;
9. renders the bench frame on the per-pixel shading path (SceneStatic
   fused="off": K1-K3, K6 and plain PyTorch shading) with every launch counter
   reset before and read after (K1, K2, K3 and K6 must run, K4 and K5 must
   not), holds it against the kernel frame with shadows on (K4) and off
   (K5) at the CPU parity tests' frame tolerance (mean |sRGB difference|
   <= 1e-3, >= 99% of pixels within 1e-2), and times both paths; the
   per-pixel path computes the JAX per-pixel formulation (ops/sampling*.py)
   and K4/K5 the structure-of-arrays one (ops/soa*.py), so the check holds
   two formulations against each other; one per-pixel frame is profiled
   (tools/profile_frame.py: device launches, busy ms, peak memory);
10. runs the nine experiments that only the per-pixel path renders (error
   displays 6-8, the IES light 46, GGX MIS 315, the linear lights 324-327)
   through the harness at their full sizes (1 warm-up and 2 measured
   frames), counters reset before and read after, and prints each one's
   ms/frame, peak device memory and share of NaN/Inf (pink) pixels, and
   the device launches and busy ms of one more frame under the profiler;
11. renders one configuration of each per-pixel class (tools/
   per_pixel_check.py: separately, random, GGX MIS, an error display,
   IES, a textured area light, a linear light) at 64x32 on the card and
   on the CPU and holds the frames together.
12. dispatches the bench frame (K4 + K1) and the central_4_128 PSA sweep
   frame (K5, experiment 113) twice each through their Application under
   torch.cuda.set_sync_debug_mode("error"): no call may make the host
   wait for the card (tools/host_waits.py); and counts the synchronizing
   calls of one per-pixel dispatch (the bench frame with fused="off",
   experiment 46);
13. renders the two-frame HDR capture (frame_bits 1 and 2, then the
   direct linear frame, noise frozen) of the bench frame (960x540, K4 +
   K1), of experiment 113 (1920x1080, K5) and of experiment 46
   (1280x1024, per-pixel): the recombined frame must equal the direct one
   rounded to float16 bit for bit;
14. runs experiment 113 through the harness with --hdr (1 warm-up, 2
   measured frames) and reads the .hdr back: within RGBE quantization of
   the frame;
15. renders the bench frame as 4 bands of 135 rows on cuda:0
   (parallel/tiles.py), counters reset before: bit-equal to the whole
   frame, K1-K4 and K6 launched once per band;
16. the RMSE table's configurations 1-3 (tools/rmse_table.py) at full
   size, cut to 8 spp against a 64-spp reference: each RMSE and ms per
   frame;
17. the default LTC fit (8 x 32 x 32 texels, 512 samples, 600 steps,
   tools/fit_ltc.py) on the card, timed: finite, m00 and m11 > 0, albedo
   in [0, 1], and the files it writes load with assets/ltc_table.py.
   16 texels are fitted on the CPU too, and card and CPU records are read
   after 1, 50 and 600 Adam steps: after 1 step they agree tightly; the
   steps that follow amplify the last-bit differences of the two
   devices' float32 arithmetic, so after 600 what is held is each
   texel's fit loss (tools/fit_ltc.py records_loss, both records
   evaluated on the CPU), relatively;
18. swaps the bench scene's noise table for the packaged blue-noise table
   (64x64x4, layer mask 3) and for a dithered table (128x128x1, mask 0)
   that the port's void-and-cluster generator writes into data/noise
   (tools/generate_noise.py, timed), and holds K4 (shadows on) and K5
   (shadows off) against their plain versions bit for bit on 4,096 of the
   bench frame's pixels with each table;
19. holds K2 against its plain version exactly (primitive and t, ties
   included) where pruning decides (tools/prune_check.py): 1024 x 1024
   rays aimed at shared tile edges, many at grazing angles, of a floor at
   z = 0.1 in 512 clusters of four layers one ulp apart; and 1024 x 1024
   rays from one eye at that floor's thin_edge_scene, whose edge-on
   triangles, slivers and flat slivers under the floor give computed hits
   short of their own boxes; it prints the rays whose own box the slab
   test enters beyond the triangle's t;
20. holds K4 (PSA, DIFFUSE_SPECULAR_MIS, shadows on) and K5 (PSA and Arvo
   PSA, DIFFUSE_ONLY) against their plain versions by bit pattern where
   two_product's products leave the range in which one FMA equals Dekker's
   split: lights 1e-17 to 1e-15 m from the shading points, near 2^64 m and
   2^116 m out (tools/two_product_probe.py, 64x32 hit pixels of a small
   city);
21. holds K1 against its plain version, which is the Pallas K1's function
   (every triangle of each cluster whose box passes), where a sub-box gate
   decides (tools/anyhit_gate_check.py): rays from the bench frame's four
   street lights through every vertex of the small city (4,484) and of a
   larger one (make_city(60, detail=5): 32,964), and grazing segments
   beside prune_check's edge-on triangles, slivers and flat slivers
   (98,304); 0 mismatches, and 0 rays where the float32 model of K1's
   grown gate parts from the plain version; it prints the rays where a
   bare slab test of the sub-box (K1's gate before) would part;
22. runs the port's bench entry (python -m vulkan_renderer_tpu_torch.bench
   at 4 spp, which the card paces, with 40 pipelined frames) in its own
   process and checks its record (bench.py's keys and the card,
   uncertain=0, overflow=0, exit 0), whose value must lie within 10% of
   the window of the same frame measured here; drives the entry's
   pipelined run at its defaults in this process with every launch
   counter reset before and read after (K1-K4 must run, K5 must not) and
   logs the cumulative ms a frame of each stop_after stage that is a
   prefix of the whole frame ("rays" to "shade") and of the whole frame
   (the median of 5 rounds, the stages taking turns, of 40 pipelined
   frames each), beside
   the median ms the host takes to dispatch one cut frame to an idle card
   and to see it finished (10 frames a round); holds K2 (primitive and
   t) and K1 against their plain versions exactly on 65,536 primary and
   live shadow rays of the bench city built with clusters of 32 and of
   128 triangles; and measures PSA in each sweep cell (experiments 113 and
   204) at the reference protocol (110 warm-up frames and >= 1 s, 100
   measured; tools/sweep_check.py), counters reset before and read after
   (K5 must run), whose harness median must lie within 5% of its window.

It logs the seconds since its start at each phase, and its wall time.
The line before the last is a JSON object listing the kernels (K1 is its
slot entry, as the bench frame runs it), each with
its launches on the main path, time, plain version's time and bound
(bytes over 3.35 TB/s or float32 operations over 33.5 T/s, whichever is
larger, and which side binds; for the tracers the operations are the
least any binary tree over the clusters needs, and the counted tests of
this design are a separate field; K3's are counted from its source per
hit, K4's and K5's by their counting builds on these inputs); the last
line is {"ok": true, "device": {...}}. Any failed check, missing GPU or
missing package exits non-zero without that line.
Neither JAX nor any module of the JAX package (vulkan_renderer_tpu) is
imported; the script uses only the PyTorch port.
"""

import dataclasses
import gc
import json
import os
import re
import sys
import time

START = time.perf_counter()
ROOT = os.path.dirname(os.path.abspath(__file__))
SMALL_WIDTH, SMALL_HEIGHT = 128, 64
SHADOW_SUBSET = 131072
HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory
# H100 SXM float32 outside the tensor cores: 67 TFLOP/s counts a fused
# multiply-add as two operations, so 33.5 T instructions per second. The
# kernels are built with --fmad=false: each operation below is one.
FP32_OPS_PER_S = 33.5e12
# Float32 operations per test, counted from csrc/common.cuh slab (per axis
# 2 sub, 2 mul, min, max; 4 min/max to combine; 4 comparisons) and the two
# Moeller-Trumbore bodies (crosses, dots, sign or reciprocal, 6-7 tests).
SLAB_OPS, ANYHIT_TRI_OPS, CLOSEST_TRI_OPS = 26, 55, 57
# K1's sub-box gate (csrc/anyhit.cu grown_slab): the slab test plus the
# two moves of each axis's entry and exit.
ANYHIT_SUBBOX_OPS = SLAB_OPS + 6
# K1's slot entry's traffic, its bound: 28 B a slot ray (b, direction,
# t_max, read in place from K4's planes), and per pixel its shading point,
# hit flag, base0 and base in and its colors out.
K1_RAY_BYTES = 4 * 7
K1_PIXEL_BYTES = 4 * 3 + 1 + 4 * 3 + 4 * 3 + 4 * 3
# K6's plane traffic per pixel, its bound: in, K3's 18 attribute planes,
# prim, t_hit and the ray direction; out, the 62 shading planes.
K6_PIXEL_BYTES = 4 * (18 + 1 + 1 + 3) + 4 * 62
# Phase 4d's sweep frame: the 1-light 1920x1080 heptagon cell.
PREAMBLE_EXPERIMENT = 282
# K3's float32 operations per hit ray, counted from csrc/closest.cu
# attrs_kernel as K4's and K5's counting builds count (csrc/count_ops.cuh:
# add, sub, mul, div, sqrt, rsqrt, compare, max one each): barycentrics 42,
# the two UV-derivative rows 2 x 43, normal, UV, tangent frame 88. A miss
# does none.
K3_OPS_PER_HIT = 216
SWEEP_SUBSET = 4096
# The light vertex counts the timing sweep renders (experiments 50-309):
# K4 and K5 compile one body per count (csrc/techniques.cuh template <int
# NV>), and phase 2 builds every technique at each.
VERTEX_COUNTS = (3, 4, 5, 6, 7)
# Phase 7's holding cells besides the two sweep cells (bench_frame.
# SWEEP_CELLS): (name, index of the cell's first technique), one for each
# other vertex count, captured from the harness's own 1920x1080 frames.
HOLD_CELLS = (("central_3_128", 50), ("decentral_6_1x128spp", 245),
              ("central_7_128", 258))
# Phase 7b: the arcade's heptagon frames (1024x1024, shadows on) that take
# K4: PSA under DIFFUSE_ONLY and under DIFFUSE_SPECULAR_MIS with
# clamped-optimal MIS; K1 and K2 are held on the second.
ARCADE_EXPERIMENTS = (312, 314)
ARCADE_VERTEX_COUNT = 7
# Phase 7c: the benchmark's arcade frame (64 spp, 128 shadow slots a
# pixel), and the pixels on which K1's slot entry is held against its
# plain version (whose ray list the plain tracer walks).
SLOTS_EXPERIMENT = 316
SLOTS_SUBSET = 4096
# The techniques whose K5 operations are counted over the whole sweep
# frame (the PSA row of the kernels line, and the slowest technique).
COUNTED_TECHNIQUES = ("PROJECTED_SOLID_ANGLE", "PROJECTED_SOLID_ANGLE_ARVO")
# What phases 9-10 log of one profiled per-pixel frame
# (tools/profile_frame.py summarize).
PROFILE_KEYS = ("host_ms_per_frame", "device_busy_ms_per_frame",
                "busy_share", "device_events_per_frame")
# The central 4-gon 128-light PSA sweep experiment (K5), phases 12-14.
PSA_SWEEP_EXPERIMENT = 113
BANDS = 4
# Phase 16's cut of the RMSE table's spp (the table: 128 against 1,024).
RMSE_SPP, RMSE_REF_SPP = 8, 64
# Phase 17: texels of the card's LTC fit refitted on the CPU; the Adam
# step counts at which card and CPU records are read; the tolerance of
# the records after one step and of each texel's loss after the full fit.
# On an H100 (PyTorch 2.11, CUDA 12.8) the records differed by at most
# 7e-7 after 1 step, m20 by 0.0097 after 50 and 0.0108 after 600, and a
# texel's loss by at most 1.85% relative after 600.
LTC_CPU_TEXELS, LTC_READ_STEPS = 16, (1, 50, 600)
LTC_STEP1_ATOL, LTC_STEP1_RTOL = 2e-6, 1e-5
LTC_LOSS_RTOL = 0.03
# Phase 22: the bench entry's value against the bench frame's window; the
# harness median at the reference protocol against the window; the
# cluster sizes K1 and K2 are held at besides 64, on this many rays; the
# sweep experiments (PSA in each sweep cell) measured at the protocol;
# the rounds of stop_after stages, and the frames of each stage timed one
# at a time in a round.
ENTRY_WINDOW_RTOL = 0.10
# Phase 22a's frame: the bench frame at 4 spp, which the card paces (at
# 1 spp the host's dispatch paces it, and both measures read the host's
# jitter); --frames 20 gives the entry's run 40 pipelined frames, the
# window's count.
ENTRY_SPP, ENTRY_FRAMES = 4, 20
STAGE_ROUNDS, STAGE_FRAMES = 5, 10
PROTOCOL_RTOL = 0.05
CLUSTER_SIZES, CLUSTER_SUBSET = (32, 128), 65536
PROTOCOL_EXPERIMENTS = (113, 204)
# bench.py's record (bench.py:270-289) and the card.
RECORD_KEYS = {"metric", "value", "unit", "vs_baseline", "loadavg",
               "pipelined_reps_ms", "sync_latency_ms", "card"}


class SmokeFailure(RuntimeError):
    pass


def check(ok, message):
    if not ok:
        raise SmokeFailure(message)


def log(message):
    print(message, flush=True)


def mark(phase):
    """Log the seconds since the script started at the start of a
    phase."""
    log(f"[{time.perf_counter() - START:.1f} s] phase {phase}")


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


def check_no_reference_modules():
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "vulkan_renderer_tpu"))
    if loaded:
        raise SmokeFailure(f"modules of JAX or the JAX package were "
                           f"imported: {loaded[:8]}")


def bound_ms(bytes_moved, operations):
    """(least ms, the side that binds) at the H100's peak rates."""
    by_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    by_ops = operations / FP32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def tracer_floor_ops(rays, cluster_count, tri_ops):
    """The float32 operations a tracer needs at the least for `rays` live
    rays, whatever tree it walks: one root-to-leaf path of a binary tree
    over the clusters (ceil(log2 K) inner nodes, two child boxes each),
    one sub-box and one triangle test per ray."""
    depth = (cluster_count - 1).bit_length()
    return rays * ((2 * depth + 1) * SLAB_OPS + tri_ops)


def compare_closest(torch, tk, args):
    """K2 against its plain version on the same rays: (plain ms, rays,
    hits kernel/plain, primitive mismatches, t bit mismatches, max |dt|
    where both hit)."""
    prim_k, t_k = tk.trace_closest(*args)
    plain_ms, (prim_p, t_p) = cuda_once(
        torch, lambda: tk.trace_closest_plain(*args))
    both = (prim_k >= 0) & (prim_p >= 0)
    t_err = (t_k - t_p).abs()[both]
    return (plain_ms, args[2].shape[0],
            f"{int((prim_k >= 0).sum())}/{int((prim_p >= 0).sum())}",
            int((prim_k != prim_p).sum()),
            int((t_k.view(torch.int32) != t_p.view(torch.int32)).sum()),
            float(t_err.max()) if t_err.numel() else 0.0)


def subset_indices(torch, count, available, device):
    """`count` evenly spaced indices into range(available)."""
    count = min(count, available)
    return torch.linspace(0, available - 1, count, device=device).long()


def subset_args(args, idx):
    """K4's or K5's arguments (planes, noise, lights, static, settings) at
    plane columns idx."""
    planes, noise, ls, st, s = args
    return (planes[:, idx].contiguous(), noise.subset(idx), ls, st, s)


def noise_table_bytes(noise, pairs):
    """The table bytes `pairs` noise pairs of this frame need at the least:
    per table layer, the texels its fetches reach (all of them once the
    frame's pixels outnumber a layer's) in the channels they read."""
    th, tw = noise.table.shape[1], noise.table.shape[2]
    reach, channels = {}, {}
    for f, (_, _, layer) in enumerate(noise.fetches.tolist()):
        used = min(4, 2 * pairs - 4 * f)
        if used <= 0:
            break
        reach[layer] = reach.get(layer, 0) + noise.column_count
        channels[layer] = max(channels.get(layer, 0), used)
    return sum(min(th * tw, reach[k]) * channels[k] * 4 for k in reach)


def op_counts(torch, fn, args, kinds, stages):
    """Run fn's counting build on args: ({stage: {kind: n}}, total)."""
    counts = torch.zeros(len(kinds) * len(stages), dtype=torch.int64,
                         device=args[0].device)
    fn(*args, op_counts=counts)
    values = counts.tolist()
    table = {stage: {kind: values[i * len(kinds) + k]
                     for k, kind in enumerate(kinds)}
             for i, stage in enumerate(stages)}
    return table, sum(values)


def capture_frame(torch, bench, exp, data_dir):
    """Build experiment exp's Application and render its first frame once
    through the kernels: (the Application, each kernel's arguments keyed
    by its pipeline.FrameKernels field, device memory allocated before
    the frame, the frame's peak)."""
    app, frame = bench.experiment_frame(torch, data_dir, exp)
    allocated = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    captured = frame()
    torch.cuda.synchronize()
    return app, captured, allocated, torch.cuda.max_memory_allocated()


def run_preamble_phase(torch, bench, captured, data_dir, card):
    """Phase 4d: K6 against its plain version on the bench frame's inputs
    (`captured`) and on those of the 1-light sweep cell's first frame;
    K6's launches in one frame of that cell. Returns K6's entry of the
    kernels line."""
    from vulkan_renderer_tpu_torch.core import trace
    from vulkan_renderer_tpu_torch.experiments import harness
    from vulkan_renderer_tpu_torch.render import preamble
    from vulkan_renderer_tpu_torch.tools import kernel_check
    exp = harness.create_experiment_list()[PREAMBLE_EXPERIMENT]
    app, sweep, _, _ = capture_frame(torch, bench, exp, data_dir)
    rows, failed = {}, []
    for shape, args in (("bench", captured["shading_planes"]),
                        ("sweep", sweep["shading_planes"])):
        got = preamble.shading_planes(*args)
        plain_ms, want = cuda_once(
            torch, lambda: preamble.shading_planes_plain(*args))
        r = kernel_check.compare_planes(got, want)
        pixels, hits = got.shape[1], int((args[3] >= 0).sum())
        ms = bench.cuda_ms(torch, lambda: preamble.shading_planes(*args), 20)
        bound = bound_ms(pixels * K6_PIXEL_BYTES, 0)
        rows[shape] = dict(pixels=pixels, hits=hits, ms=ms,
                           plain_ms=plain_ms, bound=bound, **r)
        log(f"K6 preamble vs plain at the {shape} shapes ({pixels} px, "
            f"{hits} hit): NaN mismatches {r['nan_mismatch']}, bit "
            f"mismatches {r['bit_mismatch']} (tolerance 0), planes off "
            f"{json.dumps(r['planes'])}; K6 {ms:.4f} ms, bound "
            f"{bound[0]:.4f} ms ({bound[1]}), plain {plain_ms:.2f} ms "
            f"[{card}]")
        if r["nan_mismatch"] or r["bit_mismatch"]:
            failed.append(shape)
    check(not failed, f"K6 disagrees with its plain version at {failed}")
    trace.reset_counters()
    app.render_frame_sync()
    launches = trace.launch_counts()
    log(f"one frame of experiment {PREAMBLE_EXPERIMENT}: launches "
        f"{launches}")
    check(launches["K6"] == 1, "a frame did not launch K6 once")
    sweep_row = rows["sweep"]
    return {"name": "K6", "route": "cuda",
            "source": "vulkan_renderer_tpu_torch/csrc/preamble.cu",
            "replaces": None, "launches": launches["K6"],
            "max_abs_err": 0.0, "ms": round(sweep_row["ms"], 4),
            "plain_ms": round(sweep_row["plain_ms"], 4),
            "bound_ms": round(sweep_row["bound"][0], 5),
            "bound_by": sweep_row["bound"][1], "library_ms": None,
            "shape": f"{sweep_row['pixels']} pixels",
            "bytes": sweep_row["pixels"] * K6_PIXEL_BYTES,
            "bench_shape_ms": round(rows["bench"]["ms"], 4)}


def run_arcade_phase(torch, device, data_dir, card, experiments, results):
    """Phase 7b: K4 on the arcade's heptagon frames, K1 and K2 on the
    second (the cornell stand-in's rotated blocks: triangles off the
    axes)."""
    mark("7b")
    from vulkan_renderer_tpu_torch.render import fused
    from vulkan_renderer_tpu_torch.render import trace_kernel as tk
    from vulkan_renderer_tpu_torch.tools import bench_frame as bench
    from vulkan_renderer_tpu_torch.tools import kernel_check
    rows = {}
    for index in ARCADE_EXPERIMENTS:
        exp = experiments[index]
        app, captured, _, peak = capture_frame(torch, bench, exp, data_dir)
        args = captured["fused_shading"]
        planes, st, s = args[0], args[3], args[4]
        check(st.light_vertex_counts == (ARCADE_VERTEX_COUNT,)
              and s.trace_shadow_rays
              and s.polygon_sampling_technique.name
              == "PROJECTED_SOLID_ANGLE",
              f"experiment {index} is not PSA on one heptagon with shadows")
        idx = subset_indices(torch, SWEEP_SUBSET, planes.shape[1], device)
        sub = subset_args(args, idx)
        r4 = kernel_check.compare(fused.fused_light_shading(*sub),
                                  fused.fused_light_shading_plain(*sub))
        ms4 = bench.cuda_ms(torch, lambda: fused.fused_light_shading(*args),
                            5)
        plain4_ms, _ = cuda_once(
            torch, lambda: fused.fused_light_shading_plain(*sub))
        row = dict(strategy=s.sampling_strategy.value,
                   heuristic=s.mis_heuristic.value,
                   pixels=planes.shape[1],
                   triangles=int(app.scene.triangle_positions.shape[0]),
                   clusters=app.scene.clusters.cluster_count,
                   hit_share=round(float(bench.hit_mask(planes).mean()), 6),
                   frame_peak_gib=round(peak / 2**30, 4),
                   k4_ms=round(ms4, 4), k4_plain_ms_subset=round(plain4_ms, 4),
                   k4_exact=round(r4["exact"], 6),
                   k4_max_abs_err=r4["max_abs_err"])
        log(f"arcade {index} ({s.sampling_strategy.value}, "
            f"{exp.width}x{exp.height}, one {ARCADE_VERTEX_COUNT}-gon, "
            f"{row['triangles']} triangles in {row['clusters']} clusters): "
            f"K4 vs plain on {idx.numel()} of {planes.shape[1]} px exact "
            f"{r4['exact']:.6f} (tolerance: bit for bit), max |d| "
            f"{r4['max_abs_err']:.3g}; K4 {ms4:.3f} ms on the frame, plain "
            f"{plain4_ms:.1f} ms on {idx.numel()} px [{card}]")
        check(r4["exact"] == 1.0 and r4["nonfinite_mismatch"] == 0,
              f"K4 disagrees with its plain version (experiment {index})")
        results["K4"]["max_abs_err"] = max(results["K4"]["max_abs_err"],
                                           r4["max_abs_err"])
        if index == ARCADE_EXPERIMENTS[-1]:
            c_args = captured["trace_closest"]
            plain2_ms, rays, hits, p_bad, t_bad, dt = compare_closest(
                torch, tk, c_args)
            ms2 = bench.cuda_ms(torch, lambda: tk.trace_closest(*c_args), 5)
            a_args = bench.anyhit_args(captured)
            clusters, s_orig, s_dirs, s_tmax = a_args
            live = torch.nonzero(s_tmax >= 0.0)[:, 0]
            check(live.numel() > 0, f"experiment {index} emitted no live "
                  "shadow ray")
            sidx = live[subset_indices(torch, SHADOW_SUBSET, live.numel(),
                                       device)]
            ssub = [a[sidx].contiguous() for a in (s_orig, s_dirs, s_tmax)]
            occ_k = tk.trace_anyhit(clusters, *ssub)
            plain1_ms, occ_p = cuda_once(
                torch, lambda: tk.trace_anyhit_plain(clusters, *ssub))
            k1_bad = int((occ_k != occ_p).sum())
            ms1 = bench.cuda_ms(torch, lambda: tk.trace_anyhit(*a_args), 5)
            tests = bench.test_counts(torch, captured)
            row.update(k2_ms=round(ms2, 4), k2_plain_ms=round(plain2_ms, 4),
                       k2_rays=rays, k2_hits=hits,
                       k2_prim_mismatches=p_bad, k2_t_bit_mismatches=t_bad,
                       k1_ms=round(ms1, 4), k1_plain_ms_subset=round(
                           plain1_ms, 4), k1_rays=s_tmax.numel(),
                       k1_live=live.numel(), k1_compared=sidx.numel(),
                       k1_occluded=int(occ_p.sum()), k1_mismatches=k1_bad,
                       tests=tests)
            log(f"arcade {index} K2 vs plain on all {rays} primary rays: "
                f"hits {hits}, primitive mismatches {p_bad}, t bit "
                f"mismatches {t_bad} (tolerance 0), max |dt| {dt:.3g}; K2 "
                f"{ms2:.3f} ms, plain {plain2_ms:.1f} ms [{card}]")
            log(f"arcade {index} K1 vs plain on {sidx.numel()} of "
                f"{live.numel()} live shadow rays ({s_tmax.numel()} in "
                f"all): occluded {int(occ_k.sum())}/{int(occ_p.sum())}, "
                f"mismatches {k1_bad} (tolerance 0); K1 {ms1:.3f} ms on all "
                f"rays, plain {plain1_ms:.1f} ms on {sidx.numel()} [{card}]")
            for name, c in tests.items():
                log(f"arcade {index} {name} BVH tests per live ray "
                    f"({c['rays']} rays): child boxes "
                    f"{c['boxes'] / max(c['rays'], 1):.2f}, sub-boxes "
                    f"{c['subboxes'] / max(c['rays'], 1):.2f}, triangles "
                    f"{c['triangles'] / max(c['rays'], 1):.2f}")
            check(p_bad == 0 and t_bad == 0,
                  f"K2 disagrees with its plain version (experiment {index})")
            check(k1_bad == 0,
                  f"K1 disagrees with its plain version (experiment {index})")
            results["K2"]["max_abs_err"] = max(results["K2"]["max_abs_err"],
                                               dt)
        rows[index] = row
        del app, captured, args, sub
        torch.cuda.empty_cache()
    print(json.dumps({"arcade": rows, "card": card}), flush=True)


def slot_args_subset(args, idx):
    """K1's slot-entry arguments (clusters, out, slots, hit, position,
    cam, base0) for the pixels idx."""
    clusters, out, slots, hit, position, cam, base0 = args
    return (clusters, out[:, idx].contiguous(), slots, hit[idx].contiguous(),
            position.T[:, idx].contiguous().T, cam, base0[idx].contiguous())


def hold_slot_entry(torch, captured, device):
    """K1's slot entry on SLOTS_SUBSET pixels of a captured frame against
    its plain version, bit for bit: (kernel_check.compare's row with the
    bit mismatches, the plain version's ms, the pixels' arguments)."""
    from vulkan_renderer_tpu_torch.render import trace_kernel as tk
    from vulkan_renderer_tpu_torch.tools import kernel_check
    args = captured["trace_anyhit_slots"][:7]
    idx = subset_indices(torch, SLOTS_SUBSET, args[1].shape[1], device)
    sub = slot_args_subset(args, idx)
    got = tk.trace_anyhit_slots(*sub)
    plain_ms, want = cuda_once(
        torch, lambda: tk.trace_anyhit_slots_plain(*sub))
    row = kernel_check.compare(got, want)
    row["bit_mismatches"] = kernel_check.bit_mismatches(got, want)
    return row, plain_ms, sub


def run_slots_phase(torch, device, data_dir, card, experiments):
    """Phase 7c: K1's slot entry on the benchmark's arcade frame against
    the ray-list route and its plain version, and timed beside them."""
    mark("7c")
    from vulkan_renderer_tpu_torch.render import trace_kernel as tk
    from vulkan_renderer_tpu_torch.tools import bench_frame as bench
    from vulkan_renderer_tpu_torch.tools import kernel_check
    exp = experiments[SLOTS_EXPERIMENT]
    app, captured, _, peak = capture_frame(torch, bench, exp, data_dir)
    args = captured["trace_anyhit_slots"][:7]
    clusters, out, slots, hit, position, cam, base0 = args
    rays = tk.shadow_megabatch(out, slots, hit, position, cam)

    def route():
        return tk.shadow_combine(
            out, slots, tk.trace_anyhit(clusters, *tk.shadow_megabatch(
                out, slots, hit, position, cam)), base0)

    live = torch.zeros((), dtype=torch.int32, device=device)
    got = tk.trace_anyhit_slots(*args, live)
    bad = kernel_check.bit_mismatches(got, route())
    live_want = int((rays[2] >= 0.0).sum())
    held, plain_ms, sub = hold_slot_entry(torch, captured, device)
    bad_sub = held["bit_mismatches"]
    ms_entry = bench.cuda_ms(torch, lambda: tk.trace_anyhit_slots(*args), 5)
    ms_route = bench.cuda_ms(torch, route, 5)
    ms_k1 = bench.cuda_ms(torch, lambda: tk.trace_anyhit(clusters, *rays), 5)
    row = dict(pixels=out.shape[1], slots=slots, rays=rays[2].numel(),
               live=live_want, live_counted=int(live),
               frame_peak_gib=round(peak / 2**30, 4),
               mismatches=bad, plain_mismatches=bad_sub,
               plain_pixels=sub[1].shape[1],
               plain_ms_subset=round(plain_ms, 2),
               entry_ms=round(ms_entry, 4), route_ms=round(ms_route, 4),
               ray_list_k1_ms=round(ms_k1, 4))
    log(f"arcade {SLOTS_EXPERIMENT} K1 slot entry ({out.shape[1]} px x "
        f"{slots} slots, {live_want} live rays, counted {int(live)}): bit "
        f"mismatches {bad} against the ray list + ray-list K1 + combine, "
        f"{bad_sub} against its plain version on {sub[1].shape[1]} px "
        f"(tolerance 0); entry {ms_entry:.3f} ms, route {ms_route:.3f} ms "
        f"(ray-list K1 {ms_k1:.3f} ms) [{card}]")
    print(json.dumps({"slots": row, "card": card}), flush=True)
    check(bad == 0 and bad_sub == 0,
          "K1's slot entry disagrees with the ray-list route or its plain "
          "version")
    check(int(live) == live_want,
          "K1's slot entry counted another number of live rays")
    del app, captured, args, rays, got, sub, out, position, base0, hit
    torch.cuda.empty_cache()


def run_later_phases(torch, np, device, data_dir, card, experiments, scene,
                     static, settings, build_app, last):
    """Phases 12-17: the modules ported last, at full size."""
    from vulkan_renderer_tpu_torch.core import trace
    from vulkan_renderer_tpu_torch.experiments import harness, setups
    from vulkan_renderer_tpu_torch.parallel.tiles import render_frame_bands
    from vulkan_renderer_tpu_torch.render.screenshot import (
        combine_ldr_screenshots_into_hdr, read_hdr)
    from vulkan_renderer_tpu_torch.assets.ltc_table import (
        load_ltc_table_files, save_ltc_table_files)
    from vulkan_renderer_tpu_torch.tools import bench_frame as bench
    from vulkan_renderer_tpu_torch.tools import (fit_ltc, hdr_capture,
                                                 host_waits, rmse_table)
    sweep_psa = experiments[PSA_SWEEP_EXPERIMENT]
    check(sweep_psa.settings.polygon_sampling_technique.name
          == "PROJECTED_SOLID_ANGLE", "experiment 113 is not the PSA cell")

    # --- 12. no host wait in a frame's dispatch -----------------------------
    mark("12")
    bench_app = bench.application(data_dir, "cuda")
    for label, app in (("bench frame (K4 + K1)", bench_app),
                       ("central_4_128 PSA (K5)",
                        setups.build_default_application(
                            sweep_psa, data_dir, device="cuda"))):
        try:
            host_waits.dispatch_without_host_wait(app, 2)
        except RuntimeError as exc:
            raise SmokeFailure(f"{label}: a synchronizing call in the "
                               f"dispatch: {exc}") from exc
        log(f"no host wait: 2 dispatches of the {label} under "
            "set_sync_debug_mode('error') made no synchronizing call")
        del app
    bench_app.static = dataclasses.replace(bench_app.static, fused="off")
    waits = {"per-pixel bench frame": host_waits.count_host_waits(
        bench_app)}
    del bench_app
    waits["experiment 46 (per-pixel, IES)"] = host_waits.count_host_waits(
        setups.build_default_application(experiments[46], data_dir,
                                         device="cuda"))
    log(f"host waits per dispatch on the per-pixel path (sync debug mode "
        f"'warn'): {waits}")
    torch.cuda.empty_cache()

    # --- 13. two-frame HDR capture at full size -----------------------------
    mark("13")
    def app_render(exp):
        app = setups.build_default_application(exp, data_dir, device="cuda")

        def render(bits):
            app.settings = dataclasses.replace(
                exp.settings, frame_bits=bits, animate_noise=False,
                output_linear_rgb=True)
            return app.render_frame_sync()
        return render

    def bench_render(bits):
        return bench.render(scene, static, dataclasses.replace(
            settings, frame_bits=bits, output_linear_rgb=True))

    hdr_rows = {}
    for label, render in (
            (f"bench frame {bench.WIDTH}x{bench.HEIGHT} (K4 + K1)",
             bench_render),
            (f"central_4_128 PSA {sweep_psa.width}x{sweep_psa.height} (K5)",
             app_render(sweep_psa)),
            (f"experiment 46 {experiments[46].width}x"
             f"{experiments[46].height} (per-pixel)",
             app_render(experiments[46]))):
        start = time.perf_counter()
        with torch.no_grad():
            low, high, direct = hdr_capture.bit_frames(render)
        seconds = time.perf_counter() - start
        combined = combine_ldr_screenshots_into_hdr(low, high)
        wrong = hdr_capture.half_mismatches(combined, direct)
        hdr_rows[label] = dict(mismatches=wrong, seconds=round(seconds, 3),
                               mean=float(direct.mean()))
        log(f"two-frame HDR, {label}: float16 bit mismatches {wrong} of "
            f"{direct.size} (tolerance 0), max relative error "
            f"{hdr_capture.max_relative_error(combined, direct):.3e}, "
            f"3 frames in {seconds:.3f} s [{card}]")
        check(wrong == 0, f"two-frame HDR differs from float16(direct): "
              f"{label}")
        check(np.isfinite(direct).all() and direct.mean() > 0,
              f"two-frame HDR direct frame implausible: {label}")
        torch.cuda.empty_cache()

    # --- 14. the harness with --hdr -----------------------------------------
    mark("14")
    hdr_exp = harness.create_experiment_list(
        take_hdr_screenshots=True)[PSA_SWEEP_EXPERIMENT]
    hdr_exp = dataclasses.replace(hdr_exp, screenshot_path=os.path.join(
        data_dir, "smoke", os.path.basename(hdr_exp.screenshot_path)))
    result = harness.run_experiments(
        [hdr_exp], build_app, min_warmup_seconds=0.0, min_warmup_frames=1,
        measure_frames=2, data_directory=data_dir, device="cuda")[0]
    frame = last.pop("image").cpu().numpy()
    written = read_hdr(result.screenshot_path)
    _, exponent = np.frexp(frame.max(axis=-1, keepdims=True))
    rgbe_bad = int(np.count_nonzero(
        np.abs(written - frame) > np.ldexp(1.0, exponent - 8)))
    log(f"harness --hdr, experiment {PSA_SWEEP_EXPERIMENT}: "
        f"{result.frame_time_ms:.3f} ms/frame (1 warm-up, 2 measured), "
        f"wrote {os.path.basename(result.screenshot_path)}; read back: "
        f"{rgbe_bad} values off by more than RGBE quantization "
        f"(tolerance 0) [{card}]")
    check(result.screenshot_path.endswith(".hdr") and rgbe_bad == 0
          and written.shape == frame.shape,
          "the harness's .hdr does not read back as the frame")

    # --- 15. image-row bands: the bench frame as 4 bands on one card --------
    mark("15")
    whole = bench.render(scene, static, settings)
    trace.reset_counters()
    torch.cuda.synchronize()
    start = time.perf_counter()
    banded = render_frame_bands(["cuda:0"] * BANDS, scene, static,
                                bench.camera(), settings, bench.WIDTH,
                                bench.HEIGHT, bench.noise_numbers())
    torch.cuda.synchronize()
    band_ms = (time.perf_counter() - start) * 1e3
    band_launches = trace.launch_counts()
    equal = bool(torch.equal(banded, whole))
    log(f"bench frame as {BANDS} bands of {bench.HEIGHT // BANDS} rows on "
        f"cuda:0: bit-equal to the whole frame {equal}, launches "
        f"{band_launches}, {band_ms:.3f} ms (one frame, host clock) "
        f"[{card}]")
    check(equal, "the banded bench frame differs from the whole frame")
    for name in ("K1", "K2", "K3", "K4", "K6"):
        check(band_launches[name] == BANDS,
              f"{name} launched {band_launches[name]} times for "
              f"{BANDS} bands")
    del whole, banded

    # --- 16. RMSE table, configurations 1-3 at full size --------------------
    mark("16")
    # Cut: RMSE_SPP / RMSE_REF_SPP in place of the table's 128 / 1,024.
    rmse_rows = {}
    for config in (1, 2, 3):
        r = rmse_table.run_config(config, RMSE_SPP, RMSE_REF_SPP, data_dir,
                                  csv_path=None, device="cuda")
        rmse_rows[config] = dict(rmse=r.rmse, ms_per_frame=r.ms_per_frame,
                                 width=r.row["width"],
                                 height=r.row["height"])
        log(f"RMSE config {config} ({r.row['tag']}) at {r.row['width']}x"
            f"{r.row['height']}: {r.rmse:.3e} ({RMSE_SPP} spp vs "
            f"{RMSE_REF_SPP} spp; cut from 128 vs 1,024), "
            f"{r.ms_per_frame:.3f} ms per frame [{card}]")
        check(0.0 < r.rmse < 0.05, f"RMSE config {config} is implausible")
        torch.cuda.empty_cache()

    # --- 17. LTC fit, the default table on the card -------------------------
    mark("17")
    torch.cuda.synchronize()
    start = time.perf_counter()
    records = fit_ltc.fit_ltc_tables(device="cuda")
    fit_s = time.perf_counter() - start
    check(records.shape == (8, 32, 32, 5), f"fit shape {records.shape}")
    check(bool(np.isfinite(records).all()), "the LTC fit is not finite")
    check(bool((records[..., 0] > 0).all() and (records[..., 2] > 0).all()),
          "the LTC fit has m00 or m11 <= 0")
    check(bool(((records[..., 4] >= 0) & (records[..., 4] <= 1)).all()),
          "the LTC fit's albedo leaves [0, 1]")
    fits = os.path.join(data_dir, "smoke", "ltc_fits")
    save_ltc_table_files(fits, records)
    table, _ = load_ltc_table_files(fits, records.shape[0])
    check(table.shape == (8, 32, 32, 6) and np.isfinite(table).all(),
          "the fit files do not load")
    log(f"LTC fit, 8 x 32 x 32 texels, 512 samples, 600 steps: {fit_s:.3f} "
        f"s on the card [{card}]; loaded back {tuple(table.shape)}")
    grids = fit_ltc.texel_parameters()
    flat = np.arange(records[..., 0].size)
    pick = flat[np.linspace(0, flat.size - 1, LTC_CPU_TEXELS).astype(int)]
    texels = [torch.from_numpy(g.reshape(-1)[pick]) for g in grids]
    ltc_read = {}
    for steps in LTC_READ_STEPS:
        card_records = records if steps == 600 else fit_ltc.fit_ltc_tables(
            steps=steps, device="cuda")
        card_records = torch.from_numpy(card_records.reshape(-1, 5)[pick])
        cpu = fit_ltc.fit_texels(*texels, steps=steps)
        with torch.no_grad():
            loss_card = fit_ltc.records_loss(card_records, *texels)
            loss_cpu = fit_ltc.records_loss(cpu, *texels)
        d = (card_records - cpu).abs()
        ltc_read[steps] = {
            "max_abs": [float(x) for x in d.max(0).values],
            "max_rel": [float(x) for x in (d / cpu.abs().clamp(
                min=1e-6)).max(0).values],
            "loss_rel": float(((loss_card - loss_cpu).abs()
                               / loss_cpu).max())}
        log(f"LTC fit, {LTC_CPU_TEXELS} texels, card vs CPU after {steps} "
            f"Adam steps: max |d| (m00, m02, m11, m20, albedo) "
            f"{[f'{x:.3g}' for x in ltc_read[steps]['max_abs']]}, max "
            f"relative {[f'{x:.3g}' for x in ltc_read[steps]['max_rel']]}, "
            f"largest relative difference of a texel's fit loss "
            f"{ltc_read[steps]['loss_rel']:.3g}")
        if steps == 1:
            step1_ok = bool((d <= LTC_STEP1_ATOL
                             + LTC_STEP1_RTOL * cpu.abs()).all())
    check(step1_ok, f"after one Adam step the card's LTC records differ "
          f"from the CPU's by more than {LTC_STEP1_ATOL:g} + "
          f"{LTC_STEP1_RTOL:g} relative")
    check(ltc_read[600]["loss_rel"] <= LTC_LOSS_RTOL,
          f"a texel's LTC fit loss on the card differs from the CPU's by "
          f"more than {LTC_LOSS_RTOL:g} relative")
    print(json.dumps({"host_waits_per_pixel": waits, "hdr": hdr_rows,
                      "bands_ms": round(band_ms, 3),
                      "rmse": rmse_rows, "ltc_fit_s": round(fit_s, 3),
                      "ltc_card_vs_cpu": ltc_read, "card": card}),
          flush=True)


def run_closing_phases(torch, device, data_dir, card, scene, static,
                       settings):
    """Phases 18-20: the noise tables of other shapes on K4 and K5, K2
    where pruning decides, and two_product outside the FMA's range."""
    import numpy as np

    from vulkan_renderer_tpu_torch.assets.noise import load_noise_table
    from vulkan_renderer_tpu_torch.render import fused
    from vulkan_renderer_tpu_torch.tools import bench_frame as bench
    from vulkan_renderer_tpu_torch.tools import (generate_noise,
                                                 kernel_check, prune_check,
                                                 two_product_probe)

    # --- 18. blue-noise and dithered tables on K4 and K5 --------------------
    mark("18")
    start = time.perf_counter()
    generate_noise.write_blob(data_dir, "dithered_2d",
                              generate_noise.generate_blob(
                                  "dithered_2d", 128, 128, 1))
    dither_s = time.perf_counter() - start
    log(f"dithered_2d 128x128x1 by void-and-cluster (numpy float64 on the "
        f"host): {dither_s:.3f} s")
    no_shadows = dataclasses.replace(settings, trace_shadow_rays=False)
    noise_rows = {}
    for name, shape, mask in (("blue_noise", (4, 64, 64, 4), 3),
                              ("dithered_2d", (1, 128, 128, 4), 0)):
        table = load_noise_table(name, data_dir)
        check(table.noise_type == name and table.table.shape == shape
              and table.texture_index_mask == mask,
              f"{name}: table {table.noise_type} {table.table.shape} mask "
              f"{table.texture_index_mask}")
        noisy = dataclasses.replace(
            scene, noise_table=torch.from_numpy(table.table.astype(
                np.int32)).to(device),
            noise_texture_index_mask=table.texture_index_mask)
        for kernel, s, field in (
                ("K4", settings, "fused_shading"),
                ("K5", no_shadows, "fused_resolved")):
            with torch.no_grad():
                args = bench.capture_inputs(noisy, static, s)[field]
            idx = subset_indices(torch, SWEEP_SUBSET, args[0].shape[1],
                                 device)
            sub = subset_args(args, idx)
            if kernel == "K4":
                r = kernel_check.compare(fused.fused_light_shading(*sub),
                                         fused.fused_light_shading_plain(
                                             *sub))
            else:
                r = kernel_check.compare(
                    fused.fused_light_shading_resolved(*sub).T,
                    fused.fused_light_shading_resolved_plain(*sub).T)
            mismatches = round((1.0 - r["exact"]) * r["values"])
            noise_rows[f"{kernel}/{name}"] = dict(
                mismatches=mismatches, values=r["values"],
                nonfinite_mismatch=r["nonfinite_mismatch"])
            log(f"{kernel} vs plain with the {name} table "
                f"{'x'.join(map(str, shape))} (mask {mask}), {idx.numel()} "
                f"of {args[0].shape[1]} bench-frame px: mismatches "
                f"{mismatches} of {r['values']} values (tolerance: bit for "
                f"bit), max |d| {r['max_abs_err']:.3g}")
            check(mismatches == 0 and r["nonfinite_mismatch"] == 0,
                  f"{kernel} disagrees with its plain version on the "
                  f"{name} table")
        del noisy
    torch.cuda.empty_cache()

    # --- 19. K2 where pruning decides ---------------------------------------
    mark("19")
    prune_rows = {}
    for name in prune_check.SCENES:
        row = prune_check.measure(device, scene=name)
        prune_rows[name] = row
        log(f"K2 vs plain on {name} ({row['triangles']} triangles, "
            f"{row['clusters']} clusters, {row['rays']} rays): hits "
            f"{row['hits'][0]}/{row['hits'][1]}, primitive mismatches "
            f"{row['prim_mismatches']}, t bit mismatches "
            f"{row['t_bit_mismatches']} (tolerance 0, ties included); rays "
            f"whose own sub-box the slab test enters beyond their t "
            f"{row['rays_at_risk']}; K2 {row['kernel_ms']} ms, plain "
            f"{row['plain_s']} s [{card}]")
        check(row["clusters"] >= 64, f"{name} has under 64 clusters")
        check(row["prim_mismatches"] == 0 and row["t_bit_mismatches"] == 0,
              f"K2 disagrees with its plain version on {name}")

    # --- 20. two_product outside the FMA's exact range on K4 and K5 ---------
    mark("20")
    probe_inputs = two_product_probe.base_inputs(data_dir)
    probe_rows = two_product_probe.measure(probe_inputs, device)
    for row in probe_rows:
        log(f"{row['kernel']} {row['technique']} vs plain, two_product probe "
            f"{row['case']} ({row['pixels']} px): mismatches "
            f"{row['mismatches']} of {row['values']} values (bit patterns; "
            f"{row['nonfinite']} non-finite in the plain version's)")
        check(row["mismatches"] == 0,
              f"{row['kernel']} {row['technique']} disagrees with its plain "
              f"version on the two_product probe {row['case']}")
    print(json.dumps({"noise_tables": noise_rows,
                      "dithered_generate_s": round(dither_s, 3),
                      "prune": prune_rows, "two_product_probe": probe_rows,
                      "card": card}), flush=True)


def run_gate_phase(device, card):
    """Phase 21: K1 where a sub-box gate decides."""
    mark("21")
    from vulkan_renderer_tpu_torch.tools import anyhit_gate_check

    rows = {}
    for name in anyhit_gate_check.PROBES:
        row = anyhit_gate_check.measure(device, name)
        rows[name] = row
        log(f"K1 vs plain on {name} ({row['triangles']} triangles, "
            f"{row['clusters']} clusters, {row['rays']} rays): occluded "
            f"{row['k1_occluded']}/{row['occluded']}, mismatches "
            f"{row['k1_mismatches']} (tolerance 0); the model of K1's "
            f"grown gate parts on {row['grown_gate_parts']} rays "
            f"(tolerance 0), a bare sub-box slab gate on "
            f"{row['slab_gate_parts']}; K1 {row['k1_ms']} ms [{card}]")
        check(row["k1_mismatches"] == 0,
              f"K1 disagrees with its plain version on {name}")
        check(row["grown_gate_parts"] == 0,
              f"the model of K1's sub-box gate drops hits on {name}")
    check(rows["city_20x3_vertices"]["slab_gate_parts"] > 0,
          "the vertex rays no longer probe the sub-box gate")
    print(json.dumps({"anyhit_gate": rows, "card": card}), flush=True)


def run_entry_phase(torch, np, device, data_dir, card, settings):
    """Phase 22: the measuring entry points: the bench entry, its stages,
    its cluster sizes, and the harness at the reference protocol."""
    import subprocess

    from vulkan_renderer_tpu_torch import bench as entry
    from vulkan_renderer_tpu_torch.core import trace
    from vulkan_renderer_tpu_torch.experiments import harness
    from vulkan_renderer_tpu_torch.render import pipeline
    from vulkan_renderer_tpu_torch.render import trace_kernel as tk
    from vulkan_renderer_tpu_torch.tools import bench_frame as bench
    from vulkan_renderer_tpu_torch.tools import sweep_check

    # --- 22a. the bench entry at ENTRY_SPP, in its own process -----------
    mark("22a")
    start = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "vulkan_renderer_tpu_torch.bench", "--data",
         data_dir, "--spp", str(ENTRY_SPP), "--frames", str(ENTRY_FRAMES)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    entry_s = time.perf_counter() - start
    check(proc.returncode == 0, f"the bench entry exited {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    record = json.loads(proc.stdout.strip().splitlines()[-1])
    log(f"bench entry record ({entry_s:.1f} s in its own process): "
        f"{json.dumps(record)}")
    check(RECORD_KEYS <= set(record) and record["card"] == card
          and "uncertain=0, overflow=0" in record["metric"]
          and "exactness_failed" not in record,
          "the bench entry's record is not bench.py's")
    start = time.perf_counter()
    garbage = gc.collect()
    log(f"the process's garbage before the window: {garbage} unreachable "
        f"objects, collected in {time.perf_counter() - start:.3f} s "
        f"(bench_frame.window_ms collects before its clock starts)")
    window = bench.window_ms(
        torch, bench.application(data_dir, "cuda", ENTRY_SPP), bench.WARMUP)
    torch.cuda.empty_cache()
    ratio = record["value"] / window
    log(f"bench entry value {record['value']} ms against the bench frame's "
        f"window {window:.3f} ms ({ENTRY_SPP} spp, {bench.WINDOW_FRAMES} "
        f"frames, 3 in flight): ratio {ratio:.4f} (tolerance: within "
        f"{ENTRY_WINDOW_RTOL:.0%}) [{card}]")
    check(abs(ratio - 1.0) <= ENTRY_WINDOW_RTOL,
          "the bench entry's value parts from the window")

    # --- 22b. the entry's main path counted, and its stages ---------------
    mark("22b")
    frame = entry.BenchFrame(entry.parse_args(["--data", data_dir]))
    frame.sync_latency_ms(1)
    trace.reset_counters()
    pipelined = frame.pipelined_ms(10, 3124705)
    entry_launches = trace.launch_counts()
    log(f"bench entry, 10 pipelined frames in this process: {pipelined:.3f} "
        f"ms/frame, launches {entry_launches} [{card}]")
    for name in ("K1", "K2", "K3", "K4"):
        check(entry_launches[name] > 0,
              f"{name} was not launched by the bench entry")
    check(entry_launches["K5"] == 0, "the bench entry launched K5")
    # The stages take turns, STAGE_ROUNDS rounds of each, so that a drift
    # of the shared host's speed falls on every stage alike. The cuts up
    # to "shade" are prefixes of the whole frame; "shadowrays" and
    # "shadow" build and trace a ray list that the whole frame does not
    # (K1's slot entry reads its rays in place), so they are left out.
    prefixes = pipeline.STAGES[:pipeline.STAGES.index("shade") + 1]
    stages = {stage or "whole frame": stage for stage in prefixes + (None,)}
    taken = {name: ([], [], []) for name in stages}
    for _ in range(STAGE_ROUNDS):
        for name, stage in stages.items():
            pipelined_reps, dispatch, sync = taken[name]
            frame.stop_after = stage
            sync += frame.sync_latency_ms(STAGE_FRAMES)
            for _ in range(STAGE_FRAMES):
                torch.cuda.synchronize()
                start = time.perf_counter()
                frame.render(bench.noise_numbers())
                dispatch.append((time.perf_counter() - start) * 1e3)
            torch.cuda.synchronize()
            pipelined_reps.append(
                frame.pipelined_ms(bench.WINDOW_FRAMES, 3124705))

    def medians(i):
        return {name: round(float(np.median(t[i])), 4)
                for name, t in taken.items()}

    stage_ms, stage_dispatch_ms, stage_sync_ms = medians(0), medians(1), \
        medians(2)
    stage_range_ms = {name: [round(min(t[0]), 4), round(max(t[0]), 4)]
                      for name, t in taken.items()}
    log(f"bench entry, cumulative ms/frame to the end of each stop_after "
        f"stage, median of {STAGE_ROUNDS} rounds of {bench.WINDOW_FRAMES} "
        f"pipelined frames: {stage_ms} (least and most {stage_range_ms}); "
        f"median host dispatch of one cut frame to an idle card "
        f"({STAGE_ROUNDS} x {STAGE_FRAMES} frames): {stage_dispatch_ms}; "
        f"median to its synchronize: {stage_sync_ms} [{card}]")
    del frame
    torch.cuda.empty_cache()

    # --- 22c. K1 and K2 at other cluster sizes ----------------------------
    mark("22c")
    cluster_rows = {}
    for size in CLUSTER_SIZES:
        scene, static = bench.load_city(data_dir, device, cluster_size=size)
        with torch.no_grad():
            captured = bench.capture_inputs(scene, static, settings)
        clusters, origins, dirs, t_max = captured["trace_closest"]
        idx = subset_indices(torch, CLUSTER_SUBSET, dirs.shape[0], device)
        _, rays, hits, p_bad, t_bad, dt = compare_closest(torch, tk, (
            clusters, origins[idx].contiguous(), dirs[idx].contiguous(),
            t_max[idx].contiguous()))
        _, s_orig, s_dirs, s_tmax = bench.anyhit_args(captured)
        live = torch.nonzero(s_tmax >= 0.0)[:, 0]
        sidx = live[subset_indices(torch, CLUSTER_SUBSET, live.numel(),
                                   device)]
        ssub = [a[sidx].contiguous() for a in (s_orig, s_dirs, s_tmax)]
        occ_k = tk.trace_anyhit(clusters, *ssub)
        occ_p = tk.trace_anyhit_plain(clusters, *ssub)
        k1_bad = int((occ_k != occ_p).sum())
        cluster_rows[size] = dict(
            clusters=clusters.cluster_count, k2_rays=rays, k2_hits=hits,
            k2_prim_mismatches=p_bad, k2_t_bit_mismatches=t_bad,
            k1_rays=sidx.numel(), k1_occluded=int(occ_p.sum()),
            k1_mismatches=k1_bad)
        log(f"clusters of {size} ({clusters.cluster_count} clusters): K2 vs "
            f"plain on {rays} primary rays: hits {hits}, primitive "
            f"mismatches {p_bad}, t bit mismatches {t_bad}; K1 vs plain on "
            f"{sidx.numel()} live shadow rays: occluded "
            f"{int(occ_k.sum())}/{int(occ_p.sum())}, mismatches {k1_bad} "
            f"(tolerance 0)")
        check(p_bad == 0 and t_bad == 0,
              f"K2 disagrees with its plain version at cluster size {size}")
        check(k1_bad == 0,
              f"K1 disagrees with its plain version at cluster size {size}")
        del scene, captured, clusters, origins, dirs, t_max, ssub
        torch.cuda.empty_cache()

    # --- 22d. the harness at the reference protocol -----------------------
    mark("22d")
    experiments = harness.create_experiment_list(
        output_dir=os.path.join(data_dir, "smoke"))
    csv_path = os.path.join(data_dir, "smoke", "results_protocol.csv")
    os.makedirs(os.path.dirname(csv_path), exist_ok=True)
    if os.path.exists(csv_path):
        os.remove(csv_path)
    trace.reset_counters()
    protocol_rows = []
    for index in PROTOCOL_EXPERIMENTS:
        row = sweep_check.measure(index, experiments[index], csv_path, card,
                                  data_dir)
        row.pop("deltas_ms")
        protocol_rows.append(row)
        log(f"experiment {index} ({row['cell']} {row['technique']}) at the "
            f"reference protocol (110 warm-up frames and >= 1 s, 100 "
            f"measured): harness median {row['harness_ms']} ms, window "
            f"{row['window_ms']} ms, ratio {row['ratio']} (tolerance: "
            f"within {PROTOCOL_RTOL:.0%}), stamp deltas {row['stamps_ms']} "
            f"[{card}]")
        check(abs(row["ratio"] - 1.0) <= PROTOCOL_RTOL,
              f"experiment {index}: the harness median parts from the "
              f"window")
    protocol_launches = trace.launch_counts()
    log(f"reference-protocol runs' launches: {protocol_launches}")
    check(protocol_launches["K5"] > 0 and protocol_launches["K4"] == 0,
          "the reference-protocol sweep runs did not launch K5 alone")
    print(json.dumps({"bench_entry": record, "bench_entry_window_ms":
                      round(window, 4), "bench_entry_launches":
                      entry_launches, "stop_after_ms": stage_ms,
                      "stop_after_dispatch_ms": stage_dispatch_ms,
                      "stop_after_sync_ms": stage_sync_ms,
                      "stop_after_range_ms": stage_range_ms,
                      "cluster_sizes": cluster_rows,
                      "protocol": protocol_rows, "card": card}), flush=True)


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

    from vulkan_renderer_tpu_torch.core import trace
    from vulkan_renderer_tpu_torch.core.device import get_device
    from vulkan_renderer_tpu_torch.experiments import harness, setups
    from vulkan_renderer_tpu_torch.kernels import build
    from vulkan_renderer_tpu_torch.render import fused, pipeline
    from vulkan_renderer_tpu_torch.render import trace_kernel as tk
    from vulkan_renderer_tpu_torch.render.fused import (
        MisHeuristic, PolygonSamplingTechnique, RenderSettings,
        SamplingStrategy)
    from vulkan_renderer_tpu_torch.render.shading import SceneStatic
    from vulkan_renderer_tpu_torch.tools import bench_frame as bench
    from vulkan_renderer_tpu_torch.tools import (kernel_check,
                                                 per_pixel_check,
                                                 profile_frame)

    WIDTH, HEIGHT = bench.WIDTH, bench.HEIGHT
    SWEEP_WIDTH, SWEEP_HEIGHT = bench.SWEEP_WIDTH, bench.SWEEP_HEIGHT
    SWEEP_CELLS = bench.SWEEP_CELLS
    SWEEP_WARMUP, SWEEP_MEASURED = bench.SWEEP_WARMUP, bench.SWEEP_MEASURED
    kinds, stages = fused.OP_KINDS, fused.OP_STAGES
    count_defines = {"VR_COUNT_OPS": 1}
    card = bench.card_name()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    device = get_device("cuda")
    check_no_reference_modules()

    settings = bench.settings()

    # --- 2. kernel builds ------------------------------------------------
    mark("2")
    bench_static = bench.light_layout()
    # The tracers also in their counting builds (box and triangle tests).
    jobs = bench.kernel_jobs(settings) + [
        ("anyhit", {"VR_COUNT_TESTS": 1}),
        ("closest", {"VR_COUNT_TESTS": 1})]
    def shading_job(kernel, s, static_, extra=None):
        return (fused._KERNELS[kernel][0],
                {**fused.library_defines(kernel, static_, s),
                 **(extra or {})})
    # K4's counting build at the bench frame's settings.
    jobs.append(shading_job("K4", settings, bench_static, count_defines))
    def one_light(nv):
        return SceneStatic(light_count=1, light_texturing=(0,),
                           light_vertex_counts=(nv,))

    for tech in PolygonSamplingTechnique:
        tech_settings = RenderSettings(
            sampling_strategy=SamplingStrategy.DIFFUSE_ONLY,
            polygon_sampling_technique=tech)
        for nv in VERTEX_COUNTS:
            jobs += [shading_job(k, tech_settings, one_light(nv))
                     for k in ("K4", "K5")]
            if tech.name in COUNTED_TECHNIQUES:
                jobs.append(shading_job("K5", tech_settings, one_light(nv),
                                        count_defines))
    # K4 under the arcade's clamped-optimal MIS on its heptagon (phase 7b).
    jobs.append(shading_job("K4", dataclasses.replace(
        settings, mis_heuristic=MisHeuristic.OPTIMAL_CLAMPED),
        one_light(ARCADE_VERTEX_COUNT)))
    # K5 and K4 under DIFFUSE_SPECULAR_MIS (the default settings; K5 takes
    # it with shadows off): the PSA pair with every heuristic, at the
    # bench layout.
    mis_variants = [dataclasses.replace(
        settings, polygon_sampling_technique=tech, mis_heuristic=heuristic,
        trace_shadow_rays=False)
        for tech in (PolygonSamplingTechnique.PROJECTED_SOLID_ANGLE,
                     PolygonSamplingTechnique.PROJECTED_SOLID_ANGLE_BIASED)
        for heuristic in MisHeuristic]
    jobs += [shading_job(k, s, bench_static) for s in mis_variants
             for k in ("K4", "K5")]
    jobs = list(dict.fromkeys((n, tuple(sorted(d.items())))
                              for n, d in jobs))
    wall = build.build_many([(n, dict(d)) for n, d in jobs])
    log(f"kernel build: {len(jobs)} libraries, {wall:.2f} s wall")
    ptxas_rows = []
    for tag, (seconds, report) in sorted(build.BUILD_REPORTS.items()):
        log(f"  {tag}: nvcc {seconds:.2f} s")
        if not tag.startswith("fused"):
            for line in build.register_report(report):
                if "registers" in line or "spill" in line:
                    log(f"    {line}")
            continue
        threads = int(re.search(r"_VR_THREADS(\d+)", tag).group(1))
        for row in build.ptxas_table(report):
            nv = re.search(r"kernelILi(\d)E", row["function"])
            row = dict(library=tag, vertex_count=int(nv.group(1)),
                       threads=threads, **{k: v for k, v in row.items()
                                           if k != "function"})
            row["resident_warps"] = build.resident_warps(
                row["registers"], threads, row["smem"])
            ptxas_rows.append(row)
            log(f"    NV={row['vertex_count']}: {row['registers']} "
                f"registers, {row['stack']} B stack, {row['spill_stores']} "
                f"B spill stores, {row['spill_loads']} B spill loads, "
                f"{row['smem']} B shared, {row['resident_warps']} resident "
                f"warps/SM at {threads} threads a block")
    print(json.dumps({"ptxas": ptxas_rows}), flush=True)

    # --- 3. the bench city ---------------------------------------------------
    mark("3")
    data_dir = os.path.join(ROOT, "data")
    start = time.perf_counter()
    scene, static = bench.load_city(data_dir, device)
    torch.cuda.synchronize()
    extent = (scene.clusters.aabb_hi - scene.clusters.aabb_lo).median(
        dim=0).values
    log(f"scene: {scene.triangle_positions.shape[0]} triangles, "
        f"{scene.clusters.cluster_count} clusters of "
        f"{scene.clusters.cluster_size} (median box extent "
        f"{[round(float(e), 2) for e in extent]} m), "
        f"{scene.clusters.bvh_nodes.shape[0]} BVH nodes "
        f"({scene.clusters.bvh_nodes.numel() * 4} bytes), built in "
        f"{time.perf_counter() - start:.2f} s")
    camera = bench.camera()
    noise_numbers = bench.noise_numbers()

    # Capture every kernel's inputs at the bench shapes (not the counted run).
    with torch.no_grad():
        captured = bench.capture_inputs(scene, static, settings)
    torch.cuda.synchronize()

    results = {}

    # --- 4. kernels against their plain versions -----------------------------
    mark("4")
    # K2 on every primary ray of the bench frame. Tolerance: exact. The
    # kernel walks the BVH in another order than the plain version scans,
    # and both return the lexicographic minimum of (t, primitive id).
    plain2_ms, rays, hits, prim_wrong, t_wrong, k2_err = compare_closest(
        torch, tk, captured["trace_closest"])
    log(f"K2 closest vs plain (all {rays} primary rays): hits {hits}, "
        f"primitive mismatches {prim_wrong}, t bit mismatches {t_wrong} "
        f"(tolerance 0, ties included), max |dt| {k2_err:.3g}")
    check(prim_wrong == 0 and t_wrong == 0,
          "K2 disagrees with its plain version")
    results["K2"] = dict(max_abs_err=k2_err, compared=rays)

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

    # K4 on every pixel of the bench frame. Tolerance: bit for bit (the
    # same float32 operations in the same order; the one FMA, two_product's
    # error term, is exact).
    f_args = captured["fused_shading"]
    planes = f_args[0]
    out_k = fused.fused_light_shading(*f_args)
    out_p = fused.fused_light_shading_plain(*f_args)
    r4 = kernel_check.compare(out_k, out_p)
    k4_err = r4["max_abs_err"]
    k4_hits = float(bench.hit_mask(planes).mean())
    log(f"K4 fused shading vs plain ({planes.shape[1]} pixels x "
        f"{static.light_count} lights, {out_p.shape[0]} planes, hit share "
        f"{k4_hits:.4f}): exact {r4['exact']:.6f} (tolerance: bit for "
        f"bit), max |d| {k4_err:.3g}, finite-pattern mismatches "
        f"{r4['nonfinite_mismatch']}")
    check(r4["exact"] == 1.0 and r4["nonfinite_mismatch"] == 0,
          "K4 disagrees with its plain version")
    results["K4"] = dict(max_abs_err=k4_err, compared=planes.shape[1])

    # K1 as the frame runs it: its slot entry, which reads the rays from
    # K4's planes and does the combine. Tolerance: bit for bit (the same
    # occlusion bits, and the slots summed in the same groups and order).
    slot_args = captured["trace_anyhit_slots"][:7]
    r1, plain1_ms, psub = hold_slot_entry(torch, captured, device)
    log(f"K1 slot entry vs plain ({psub[1].shape[1]} of "
        f"{slot_args[1].shape[1]} pixels x {slot_args[2]} slots): bit "
        f"mismatches {r1['bit_mismatches']} (tolerance 0), max |d| "
        f"{r1['max_abs_err']:.3g}")
    check(r1["bit_mismatches"] == 0,
          "K1's slot entry disagrees with its plain version")
    results["K1"] = dict(max_abs_err=r1["max_abs_err"],
                         compared=psub[1].shape[1])
    # The ray-list K1 (off the frame's path: the stop_after cuts) on the
    # frame's rays, built by the plain megabatch.
    s_args = bench.anyhit_args(captured)
    clusters, s_orig, s_dirs, s_tmax = s_args
    live = torch.nonzero(s_tmax >= 0.0)[:, 0]
    check(live.numel() > 0, "the bench frame emitted no live shadow ray")
    sidx = live[subset_indices(torch, SHADOW_SUBSET, live.numel(), device)]
    ssub = [a[sidx].contiguous() for a in (s_orig, s_dirs, s_tmax)]
    occ_k = tk.trace_anyhit(clusters, *ssub)
    plain_list_ms, occ_p = cuda_once(
        torch, lambda: tk.trace_anyhit_plain(clusters, *ssub))
    k1_wrong = int((occ_k != occ_p).sum())
    log(f"K1 ray-list entry vs plain ({sidx.numel()} live shadow rays of "
        f"{live.numel()} live / {s_tmax.numel()}): occluded "
        f"{int(occ_k.sum())}/{int(occ_p.sum())}, mismatches {k1_wrong} "
        f"(tolerance 0)")
    check(k1_wrong == 0, "K1's ray-list entry disagrees with its plain "
          "version")

    # --- 4b. box and triangle tests per ray ----------------------------------
    mark("4b")
    # Rays are live where t_max >= 0 (the kernels return the others at once).
    test_counts = bench.test_counts(torch, captured)
    for name, c in test_counts.items():
        rays = c["rays"]
        log(f"{name} BVH tests per live ray ({rays} rays): child boxes "
            f"{c['boxes'] / rays:.2f}, sub-boxes {c['subboxes'] / rays:.2f}, "
            f"triangles {c['triangles'] / rays:.2f}")

    # --- 4c. K4's float operations on the bench frame ------------------------
    mark("4c")
    k4_ops_table, k4_ops = op_counts(torch, fused.fused_light_shading,
                                     f_args, kinds, stages)
    k4_hit_lights = int(bench.hit_mask(planes).sum()) * static.light_count
    log(f"K4 float operations (counting build, {planes.shape[1]} px x "
        f"{static.light_count} lights, {k4_hit_lights} hit pixel-lights): "
        f"{k4_ops} = {k4_ops / max(k4_hit_lights, 1):.1f} per hit "
        f"pixel-light; by stage and kind {json.dumps(k4_ops_table)}")

    # --- 4d. K6 against its plain version ------------------------------------
    mark("4d")
    k6_entry = run_preamble_phase(torch, bench, captured, data_dir, card)

    # --- 5. small frame: kernels vs plain versions ---------------------------
    mark("5")
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
    mark("6")
    trace.reset_counters()
    with torch.no_grad():
        image = bench.render(scene, static, settings)
    torch.cuda.synchronize()
    launches = trace.launch_counts()
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

    with torch.no_grad():
        frame_ms = bench.frame_ms(torch, scene, static, settings)
    frame_median = float(np.median(frame_ms))
    log(f"bench frame ms ({bench.FRAMES} frames after {bench.WARMUP} "
        f"warm-up, host clock with synchronize): median {frame_median:.3f}, "
        f"all {[round(t, 3) for t in frame_ms]} [{card}]")

    # --- per-kernel times at the bench shapes --------------------------------
    c_args = captured["trace_closest"]
    a_args = captured["closest_attrs"]
    kernel_ms = bench.kernel_ms(torch, captured)
    timings = {
        "K2": (kernel_ms["K2"], plain2_ms, None,
               f"{c_args[2].shape[0]} rays", f"{c_args[2].shape[0]} rays"),
        "K3": (kernel_ms["K3"],
               bench.cuda_ms(torch, lambda: tk.closest_attrs_plain(*a_args),
                             3),
               None, f"{a_args[3].shape[0]} rays", None),
        "K4": (kernel_ms["K4"],
               bench.cuda_ms(
                   torch, lambda: fused.fused_light_shading_plain(*f_args),
                   1),
               None, f"{f_args[0].shape[1]} pixels x "
               f"{static.light_count} lights", None),
        "K1": (kernel_ms["K1_slots"], plain1_ms,
               bench.cuda_ms(torch, lambda: tk.trace_anyhit_slots(*psub),
                             5),
               f"{slot_args[1].shape[1]} pixels x {slot_args[2]} slots "
               f"({live.numel()} live rays)",
               f"{psub[1].shape[1]} pixels"),
    }
    for name, (ms, plain_ms, ms_sub, shape, plain_shape) in timings.items():
        where = "" if plain_shape is None else \
            f" (plain on {plain_shape})" if ms_sub is None else \
            f" (plain on {plain_shape}; kernel there {ms_sub:.3f} ms)"
        log(f"{name}: kernel {ms:.3f} ms on {shape}; plain {plain_ms:.3f} ms"
            f"{where} [{card}]")
    log(f"K1 ray-list entry (off the frame's path): kernel "
        f"{kernel_ms['K1']:.3f} ms on {s_tmax.numel()} rays; plain "
        f"{plain_list_ms:.3f} ms (plain on {sidx.numel()} live rays) "
        f"[{card}]")

    # --- 6b. K5 under DIFFUSE_SPECULAR_MIS against its plain version --------
    mark("6b")
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
        args = k5_args["args"]
        planes, st, s = args[0], args[3], args[4]
        idx = subset_indices(torch, SWEEP_SUBSET, planes.shape[1], device)
        sub = subset_args(args, idx)
        got5 = fused.fused_light_shading_resolved(*sub)
        want5 = fused.fused_light_shading_resolved_plain(*sub)
        r5 = kernel_check.compare(got5.T, want5.T)
        # K4 under the same settings on the same pixels (its shadow-ray
        # slots), against its plain version.
        r4m = kernel_check.compare(fused.fused_light_shading(*sub),
                                   fused.fused_light_shading_plain(*sub))
        variant = (f"{s.polygon_sampling_technique.value}/"
                   f"{s.mis_heuristic.value}")
        mis_rows.append(dict(variant=variant, **r5))
        results["K4"]["max_abs_err"] = max(results["K4"]["max_abs_err"],
                                           r4m["max_abs_err"])
        log(f"K5 and K4 MIS {variant} vs plain ({idx.numel()} of "
            f"{planes.shape[1]} px x {st.light_count} lights, hit share "
            f"{float(bench.hit_mask(sub[0]).mean()):.4f}): K5 exact "
            f"{r5['exact']:.6f}, K4 exact {r4m['exact']:.6f} (tolerance: "
            f"bit for bit), max |d| {r5['max_abs_err']:.3g} / "
            f"{r4m['max_abs_err']:.3g}")
        check(r5["nonfinite_mismatch"] == 0 and r5["exact"] == 1.0,
              f"K5 MIS disagrees with its plain version ({variant})")
        check(r4m["nonfinite_mismatch"] == 0 and r4m["exact"] == 1.0,
              f"K4 MIS disagrees with its plain version ({variant})")
        check(float(want5.abs().max()) > 0, f"K5 MIS {variant} is all zero")

    # --- 7. K5 and K4 DIFFUSE_ONLY against their plain versions -------------
    mark("7")
    experiments = harness.create_experiment_list()
    arvo = (PolygonSamplingTechnique.SOLID_ANGLE_ARVO,
            PolygonSamplingTechnique.PROJECTED_SOLID_ANGLE_ARVO)
    technique_rows = []
    k5_main = None
    for cell, first in SWEEP_CELLS + HOLD_CELLS:
        cell_nv = int(cell.split("_")[1])
        for t, tech in enumerate(PolygonSamplingTechnique):
            exp = experiments[first + t]
            check(exp.settings.polygon_sampling_technique == tech
                  and (exp.width, exp.height) == (SWEEP_WIDTH, SWEEP_HEIGHT),
                  f"experiment {first + t} is not the {tech.value} sweep "
                  f"cell at {SWEEP_WIDTH}x{SWEEP_HEIGHT}")
            app, k5_args, allocated, frame_peak = capture_frame(
                torch, bench, exp, data_dir)
            check(set(app.static.light_vertex_counts) == {cell_nv},
                  f"experiment {first + t}'s lights are not {cell_nv}-gons")
            if t == 0:
                # K2 on every primary ray of the cell's frame: exact, ties
                # included, as on the bench frame.
                _, rays, hits, p_bad, t_bad, dt = compare_closest(
                    torch, tk, k5_args["trace_closest"])
                log(f"{cell} K2 closest vs plain (all {rays} primary rays, "
                    f"{app.scene.clusters.cluster_count} clusters): hits "
                    f"{hits}, primitive mismatches {p_bad}, t bit mismatches "
                    f"{t_bad} (tolerance 0), max |dt| {dt:.3g}")
                check(p_bad == 0 and t_bad == 0,
                      f"K2 disagrees with its plain version ({cell})")
                results["K2"]["max_abs_err"] = max(
                    results["K2"]["max_abs_err"], dt)
            args = k5_args["fused_resolved"]
            planes, noise, ls, st, s = args
            hits = float(bench.hit_mask(planes).mean())
            idx = subset_indices(torch, SWEEP_SUBSET, planes.shape[1], device)
            sub = subset_args(args, idx)
            got5 = fused.fused_light_shading_resolved(*sub)
            plain5_ms, want5 = cuda_once(
                torch, lambda: fused.fused_light_shading_resolved_plain(*sub))
            r5 = kernel_check.compare(got5.T, want5.T)
            # K4 takes K5's arguments.
            got4 = fused.fused_light_shading(*sub)
            plain4_ms, want4 = cuda_once(
                torch, lambda: fused.fused_light_shading_plain(*sub))
            r4 = kernel_check.compare(got4, want4)
            r45 = kernel_check.compare(kernel_check.k4_resolved(got4, st, s).T,
                                       got5.T)
            ms5 = bench.cuda_ms(
                torch, lambda: fused.fused_light_shading_resolved(*args), 2)
            ms4 = bench.cuda_ms(torch, lambda: fused.fused_light_shading(
                *sub), 3)
            k5_ops = None
            if tech.name in COUNTED_TECHNIQUES:
                k5_ops_table, k5_ops = op_counts(
                    torch, fused.fused_light_shading_resolved, args, kinds,
                    stages)
                k5_bytes = 4 * (planes.numel() + ls.numel()
                                + 3 * planes.shape[1]) + noise_table_bytes(
                    noise, fused.rays_per_light(s) * st.light_count)
                k5_bound = bound_ms(k5_bytes, k5_ops)
                log(f"{cell} {tech.value}: K5 float operations (counting "
                    f"build, whole frame) {k5_ops}, by stage and kind "
                    f"{json.dumps(k5_ops_table)}; bound {k5_bound[0]:.4f} ms "
                    f"({k5_bound[1]}; bytes {k5_bytes})")
            # Tolerance: bit for bit where the plain version shares the
            # kernel's formula; the Arvo techniques select azimuth sectors
            # and may flip a boundary sample where an ulp differs, so up
            # to 0.5% of their values (ROADMAP Queue 3).
            limit = 5e-3 if tech in arvo else 0.0
            row = dict(cell=cell, technique=tech.value,
                       vertex_count=cell_nv, pixels=planes.shape[1],
                       lights=st.light_count,
                       spp=s.sample_count, hit_share=round(hits, 6),
                       frame_allocated_gib=round(allocated / 2**30, 4),
                       frame_peak_gib=round(frame_peak / 2**30, 4),
                       k5_ms=round(ms5, 4),
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
            if k5_ops is not None:
                row.update(k5_ops=k5_ops, k5_bound_ms=round(k5_bound[0], 5),
                           k5_bound_by=k5_bound[1])
            technique_rows.append(row)
            log(f"{cell} {tech.value} (NV={cell_nv}): K5 {ms5:.3f} ms "
                f"({planes.shape[1]} px x {st.light_count} lights x "
                f"{s.sample_count} spp, hit share "
                f"{hits:.4f}, frame peak {frame_peak / 2**30:.3f} GiB of "
                f"which {allocated / 2**30:.3f} allocated before), plain "
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
                k5_main_bound = (k5_bound, k5_bytes, k5_ops, k5_ops_table)
            del app, planes, noise, args, sub, k5_args
            torch.cuda.empty_cache()
    print(json.dumps({"techniques": technique_rows}), flush=True)
    run_arcade_phase(torch, device, data_dir, card, experiments, results)
    run_slots_phase(torch, device, data_dir, card, experiments)

    # --- 8. the timing sweep through the port's harness: counted run --------
    mark("8")
    last = {}

    def build_app(exp):
        app = setups.build_default_application(exp, data_dir, device="cuda")
        last["app"] = app
        render_sync = app.render_frame_sync

        def keep_frame():
            last["image"] = render_sync()
            return last["image"]
        app.render_frame_sync = keep_frame
        return app

    trace.reset_counters()
    sweep_ms = {}
    # Every technique of the two sweep cells; PSA and Arvo PSA of the
    # holding cells.
    sweep_runs = [(cell, first + t, tech) for cell, first in SWEEP_CELLS
                  for t, tech in enumerate(PolygonSamplingTechnique)] + [
        (cell, first + t, tech) for cell, first in HOLD_CELLS
        for t, tech in enumerate(PolygonSamplingTechnique)
        if tech.name in COUNTED_TECHNIQUES]
    for cell, index, tech in sweep_runs:
        exp = experiments[index]
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
              f"sweep frame {index} is not finite")
        sentinels = int((frame == pink).all(dim=-1).sum())
        check(sentinels == 0,
              f"sweep frame {index} has {sentinels} NaN sentinels")
        # The 128-light cells divide both the flux and the exposure by
        # 128 (experiment_list.c:364-409), so their frames are dark.
        mean = float(frame.mean())
        check(1e-4 < mean < 0.95,
              f"sweep frame {index} mean {mean:.4f} is implausible")
        window = bench.window_ms(torch, last.pop("app"), SWEEP_WARMUP)
        last.pop("image")
        sweep_ms[(cell, tech.value)] = (result.frame_time_ms, window)
        log(f"sweep {index:03d} {cell} {tech.value}: harness median "
            f"of the stamp deltas of {SWEEP_MEASURED} measured frames "
            f"after {SWEEP_WARMUP} warm-up {result.frame_time_ms:.3f} ms, "
            f"window {window:.3f} ms/frame ({bench.WINDOW_FRAMES} frames, "
            f"3 in flight), mean {mean:.4f} [{card}]")
        torch.cuda.empty_cache()
    sweep_launches = trace.launch_counts()
    log(f"timing sweep launches: {sweep_launches}")
    check(sweep_launches["K5"] > 0, "the timing sweep did not launch K5")
    check(sweep_launches["K4"] == 0, "the timing sweep launched K4")
    print(json.dumps({"sweep_harness_median_ms": {
        f"{c}/{t}": round(v[0], 4) for (c, t), v in sweep_ms.items()},
        "sweep_window_ms": {f"{c}/{t}": round(v[1], 4)
                            for (c, t), v in sweep_ms.items()},
        "card": card}), flush=True)

    log(f"peak device memory: "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # --- 9. the bench frame on the per-pixel path: counted run --------------
    mark("9")
    pp_static = dataclasses.replace(static, fused="off")
    trace.reset_counters()
    with torch.no_grad():
        pp_image = bench.render(scene, pp_static, settings)
    torch.cuda.synchronize()
    pp_launches = trace.launch_counts()
    log(f"per-pixel bench frame launches: {pp_launches}")
    for name in ("K1", "K2", "K3", "K6"):
        check(pp_launches[name] > 0,
              f"{name} was not launched by the per-pixel bench frame")
    check(pp_launches["K4"] == pp_launches["K5"] == 0,
          "the per-pixel bench frame launched K4 or K5")
    no_shadows = dataclasses.replace(settings, trace_shadow_rays=False)
    with torch.no_grad():
        pp_image_k5 = bench.render(scene, pp_static, no_shadows)
        k5_image = bench.render(scene, static, no_shadows)
    for name, got, want in (("K4", image, pp_image),
                            ("K5", k5_image, pp_image_k5)):
        ok, stats = per_pixel_check.frames_agree(got.cpu().numpy(),
                                                 want.cpu().numpy())
        log(f"bench frame, {name} path vs per-pixel path: {stats} "
            "(tolerance: mean <= 1e-3, >= 99% within 1e-2)")
        check(ok, f"the {name} bench frame differs from the per-pixel one")
    path_ms = {}
    with torch.no_grad():
        for label, st, s in (("per-pixel, shadows", pp_static, settings),
                             ("per-pixel, no shadows", pp_static,
                              no_shadows),
                             ("K5, no shadows", static, no_shadows)):
            path_ms[label] = float(np.median(bench.frame_ms(torch, scene,
                                                            st, s)))
    path_ms["K4, shadows"] = frame_median
    for label, ms in path_ms.items():
        log(f"bench frame ms, {label}: median {ms:.3f} ({bench.FRAMES} "
            f"frames after {bench.WARMUP} warm-up) [{card}]")
    # One profiled per-pixel frame: its device launches and peak memory.
    pp_profile, pp_peak = profile_frame.profile_frames(
        torch, lambda: bench.render(scene, pp_static, settings), 1, 1)
    check(pp_profile is not None, "the profiler saw no per-pixel launch")
    pp_profile = {k: pp_profile[k] for k in PROFILE_KEYS}
    log(f"per-pixel bench frame, profiled: {pp_profile}, peak device "
        f"memory {pp_peak:.3f} GiB [{card}]")
    print(json.dumps({"bench_frame_ms": {k: round(v, 4)
                                         for k, v in path_ms.items()},
                      "per_pixel_launches": pp_launches,
                      "per_pixel_profile": pp_profile,
                      "per_pixel_peak_gib": round(pp_peak, 3),
                      "card": card}), flush=True)
    del pp_image, pp_image_k5, k5_image
    torch.cuda.empty_cache()

    # --- 10. the experiments only the per-pixel path renders ----------------
    mark("10")
    trace.reset_counters()
    experiment_rows = {}
    for index in (6, 7, 8, 46, 315, 324, 325, 326, 327):
        exp = experiments[index]
        exp = dataclasses.replace(exp, screenshot_path=os.path.join(
            data_dir, "smoke", os.path.basename(exp.screenshot_path)))
        torch.cuda.reset_peak_memory_stats()
        result = harness.run_experiments(
            [exp], build_app, min_warmup_seconds=0.0, min_warmup_frames=1,
            measure_frames=2, data_directory=data_dir, device="cuda")[0]
        frame = last.pop("image")
        peak = torch.cuda.max_memory_allocated() / 2**30
        check(tuple(frame.shape) == (exp.height, exp.width, 3),
              f"experiment {index} frame shape {tuple(frame.shape)}")
        check(bool(torch.isfinite(frame).all()),
              f"experiment {index} frame is not finite")
        check(float(frame.mean()) > 0.0, f"experiment {index} is black")
        pink_share = float((frame == pink).all(dim=-1).float().mean())
        del frame
        # One more frame of a fresh Application under the profiler.
        profiled, _ = profile_frame.profile_frames(
            torch, build_app(exp).render_frame_sync, 1, 1)
        last.pop("image")
        last.pop("app")
        check(profiled is not None,
              f"the profiler saw no launch of experiment {index}")
        profiled = {k: profiled[k] for k in PROFILE_KEYS}
        experiment_rows[index] = dict(
            ms=round(result.frame_time_ms, 3), peak_gib=round(peak, 3),
            pink_share=pink_share, width=exp.width, height=exp.height,
            **profiled)
        log(f"experiment {index:03d} {exp.width}x{exp.height}: "
            f"{result.frame_time_ms:.3f} ms/frame (1 warm-up, 2 measured), "
            f"peak device memory {peak:.3f} GiB, NaN/Inf (pink) pixels "
            f"{pink_share:.6f}, one profiled frame {profiled} [{card}]")
        check(peak < 40.0, f"experiment {index} took {peak:.1f} GiB")
        torch.cuda.empty_cache()
    exp_launches = trace.launch_counts()
    log(f"per-pixel experiments launches: {exp_launches}")
    for name in ("K1", "K2", "K3", "K6"):
        check(exp_launches[name] > 0,
              f"{name} was not launched by the per-pixel experiments")
    check(exp_launches["K4"] == exp_launches["K5"] == 0,
          "a per-pixel experiment launched K4 or K5")
    print(json.dumps({"per_pixel_experiments": experiment_rows,
                      "card": card}), flush=True)

    # --- 11. the per-pixel classes, card against CPU -------------------------
    mark("11")
    files = per_pixel_check.write_scene_files(
        os.path.join(data_dir, "per_pixel"))
    scenes_card = per_pixel_check.load_scenes(files, "cuda")
    scenes_cpu = per_pixel_check.load_scenes(files, "cpu")
    for name in per_pixel_check.CLASSES:
        with torch.no_grad():
            got = per_pixel_check.render_class(scenes_card, name)
            want = per_pixel_check.render_class(scenes_cpu, name)
        ok, stats = per_pixel_check.compare_class(name, got.cpu().numpy(),
                                                  want.numpy())
        log(f"per-pixel class {name}, card vs CPU at "
            f"{per_pixel_check.WIDTH}x{per_pixel_check.HEIGHT}: {stats}")
        check(ok, f"per-pixel class {name}: the card's frame differs from "
              "the CPU's")

    run_later_phases(torch, np, device, data_dir, card, experiments,
                     scene, static, settings, build_app, last)
    run_closing_phases(torch, device, data_dir, card, scene, static,
                       settings)
    run_gate_phase(device, card)
    run_entry_phase(torch, np, device, data_dir, card, settings)

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
    # Bounds from this run's inputs: each input byte read once, each
    # output byte written once; the tracers' operations are the least any
    # tree needs for their live rays (tracer_floor_ops), and what this
    # design's counted box and triangle tests take goes beside them as
    # design_ops_ms. K3's operations are K3_OPS_PER_HIT per hit; K4's and
    # K5's what their counting builds counted on these inputs (each
    # operation one issue at 33.5 T/s: the one FMA kind, counted as two
    # flops at 67 TFLOP/s, is the same time).
    tables = 4 * (clusters.planes.numel() + clusters.subboxes.numel()
                  + clusters.bvh_nodes.numel())
    bounds, design_ops_ms = {}, {}
    k1_bytes = s_tmax.numel() * K1_RAY_BYTES \
        + slot_args[1].shape[1] * K1_PIXEL_BYTES
    k2_bytes = c_args[2].shape[0] * (28 + 8)
    for name, io_bytes, sub_ops, tri_ops in (
            ("K1", k1_bytes, ANYHIT_SUBBOX_OPS, ANYHIT_TRI_OPS),
            ("K2", k2_bytes, SLAB_OPS, CLOSEST_TRI_OPS)):
        c = test_counts[name]
        bounds[name] = bound_ms(
            io_bytes + tables,
            tracer_floor_ops(c["rays"], clusters.cluster_count, tri_ops))
        design_ops_ms[name] = (c["boxes"] * SLAB_OPS + c["subboxes"]
                               * sub_ops + c["triangles"] * tri_ops) \
            / FP32_OPS_PER_S * 1e3
    a_prim = a_args[1]
    k3_hits = int((a_prim >= 0).sum())
    k3_bytes = a_prim.numel() * (28 + 18 * 4) + k3_hits * 25 * 4
    bounds["K3"] = bound_ms(k3_bytes, k3_hits * K3_OPS_PER_HIT)
    f_planes, f_noise, f_lights = f_args[0], f_args[1], f_args[2]
    k4_out = 3 + 7 * static.light_count * fused.rays_per_light(settings)
    k4_bytes = 4 * (f_planes.numel() + f_lights.numel()
                    + k4_out * f_planes.shape[1]) + noise_table_bytes(
        f_noise, fused.rays_per_light(settings) * static.light_count)
    bounds["K4"] = bound_ms(k4_bytes, k4_ops)
    k5_bound, k5_bytes, k5_ops, k5_ops_table = k5_main_bound
    bounds["K5"] = k5_bound
    bound_sides = {
        "K3": (k3_bytes, k3_hits * K3_OPS_PER_HIT),
        "K4": (k4_bytes, k4_ops), "K5": (k5_bytes, k5_ops)}
    kernels = []
    for name in ("K1", "K2", "K3", "K4", "K5"):
        ms, plain_ms, ms_sub, shape, plain_shape = timings[name]
        entry = {"name": name, "route": "cuda", "source": sources[name][0],
                 "replaces": sources[name][1], "launches": launches[name],
                 "max_abs_err": results[name]["max_abs_err"],
                 "ms": round(ms, 4), "plain_ms": round(plain_ms, 4),
                 "bound_ms": round(bounds[name][0], 5),
                 "bound_by": bounds[name][1], "library_ms": None,
                 "shape": shape,
                 "per_pixel_frame_launches": pp_launches[name]}
        if name in test_counts:
            entry.update(tests=test_counts[name],
                         design_ops_ms=round(design_ops_ms[name], 5))
        if name in bound_sides:
            b, o = bound_sides[name]
            entry.update(bytes=b, operations=o,
                         bytes_ms=round(bound_ms(b, 0)[0], 5),
                         operations_ms=round(bound_ms(0, o)[0], 5))
        if plain_shape and ms_sub is not None:
            entry.update(plain_shape=plain_shape,
                         ms_at_plain_shape=round(ms_sub, 4))
        elif plain_shape:
            entry.update(plain_shape=plain_shape)
        kernels.append(entry)
    kernels.append(k6_entry)
    check_no_reference_modules()
    log(f"chip_smoke wall time {time.perf_counter() - START:.1f} s "
        f"[{card}]")
    print(json.dumps({"kernels": kernels, "frame_ms_median":
                      round(frame_median, 4), "card": card}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(run())
