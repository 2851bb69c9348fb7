"""A probe of two_product's range in kernels K4 and K5.

The kernels' two_product (csrc/techniques.cuh) takes its error term from
one fused multiply-add where that equals the plain version's Dekker split
(ops/math_utils.py two_product), and runs the split elsewhere. The probe
feeds K4 (PSA under DIFFUSE_SPECULAR_MIS, shadows on) and K5 (PSA and Arvo
PSA under DIFFUSE_ONLY) pixel planes and light records whose shading-frame
coordinates, and so the products of the polygon's cross products
(ops/soa.py cross3, kahan_soa), leave the FMA's exact range:

- tiny: the bench frame's four quad lights shrunk to 1e-17, 1e-16, 3e-16
  and 1e-15 m from the shading points, which sit at the world origin, so
  the products fall below 2^-100;
- far_2^64: the lights moved out to 2^63-2^64.5 m, products from 2^126
  past float32's largest;
- far_2^116: two vertices of each light moved 2^116 m out along x, in
  shading frames equal to the world's, so that in the edges that join
  them to the two left in place a * 4097 overflows while a * b stays
  finite.

The pixels are the hit pixels of a 64x32 frame of a small city under the
bench frame's lights and camera, rendered on the CPU (the same inputs on
every device), their positions moved to the origin. Each kernel's output
is compared with its plain version's by bit pattern (an inf or NaN that
both produce is equal). predict() runs the plain version on the CPU with
the bare FMA's error term (float64 a * b - p rounded once to float32, what
the FMA rounds) in place of Dekker's split: the count of values where
that model differs from the plain version is what a kernel with the bare
FMA shows. Arvo PSA calls no two_product (its edge normals use
cross3_fast on normalized vertices), so its count is 0 either way: a
control.

    python -m vulkan_renderer_tpu_torch.tools.two_product_probe [--predict]

prints one JSON line per kernel and case (on the card; with --predict,
the model's counts on the CPU) and exits 1 on a card mismatch.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np
import torch

from ..core.device import get_device
from ..ops import soa
from ..render import fused
from ..tools import bench_frame as bench

WIDTH, HEIGHT = 64, 32
CITY = "probe_city"
CASES = ("tiny", "far_2^64", "far_2^116")
TINY_SCALES = (1e-17, 1e-16, 3e-16, 1e-15)
# (kernel, technique, strategy, shadows)
RUNS = (("K4", "PROJECTED_SOLID_ANGLE", "DIFFUSE_SPECULAR_MIS", True),
        ("K5", "PROJECTED_SOLID_ANGLE", "DIFFUSE_ONLY", False),
        ("K5", "PROJECTED_SOLID_ANGLE_ARVO", "DIFFUSE_ONLY", False))


def run_settings(technique: str, strategy: str, shadows: bool):
    base = bench.settings()
    return dataclasses.replace(
        base, polygon_sampling_technique=type(
            base.polygon_sampling_technique)[technique],
        sampling_strategy=type(base.sampling_strategy)[strategy],
        trace_shadow_rays=shadows)


def base_inputs(data_dir: str) -> dict:
    """{run index: (planes, noise, lights, static, settings)} captured on
    the CPU from one WIDTH x HEIGHT frame of a small city (12 buildings)
    under the bench frame's lights and camera, at its hit pixels."""
    from ..render import pipeline
    from ..render.shading import SceneStatic
    from ..scene import scene as scene_module
    from .city import write_city_scene

    vks = os.path.join(data_dir, f"{CITY}.vks")
    if not os.path.exists(vks):
        vks = write_city_scene(data_dir, CITY, n_buildings=12,
                               texture_resolution=16, detail=1)
    scene = scene_module.load_scene(vks, os.path.join(
        data_dir, f"{CITY}_textures"), bench.lights(), "cpu",
        data_directory=data_dir)
    static = SceneStatic.for_scene(scene)
    inputs = {}
    for i, run in enumerate(RUNS):
        s = run_settings(*run[1:])
        captured = {}
        with torch.no_grad():
            pipeline.render_frame(
                scene, static, bench.camera(), s, WIDTH, HEIGHT,
                bench.noise_numbers(), bench.recording_kernels(captured))
        planes, noise, lights, st, s = captured[
            "fused_shading" if run[0] == "K4" else "fused_resolved"]
        idx = torch.nonzero(bench.hit_mask(planes))[:, 0]
        inputs[i] = (planes[:, idx].contiguous(), noise.subset(idx), lights,
                     st, s)
    return inputs


def _plane_rows(names):
    return [fused.BASE_PLANES.index(n) for n in names]


def case_inputs(args, case: str):
    """K4's or K5's arguments with the planes and light records of `case`
    (see the module docstring)."""
    planes, noise, lights, static, s = args
    planes = planes.clone()
    lights = lights.clone().double()
    nv = static.light_vertex_counts
    # Where the shading points were: the lights are placed around it.
    centre = planes[_plane_rows(["pos0", "pos1", "pos2"])].double() \
        .mean(dim=1)
    planes[_plane_rows(["pos0", "pos1", "pos2"])] = 0.0
    planes[_plane_rows([f"{m}{i}3" for m in ("w2s", "w2c")
                        for i in range(3)])] = 0.0
    if case == "far_2^116":
        # Shading and cosine frames equal to the world's.
        for m in ("w2s", "w2c"):
            for i in range(3):
                for j in range(3):
                    planes[fused.BASE_PLANES.index(f"{m}{i}{j}")] = \
                        float(i == j)
        planes[_plane_rows(["nrm0", "nrm1", "nrm2"])] = torch.tensor(
            [0.0, 0.0, 1.0])[:, None]
    rng = np.random.default_rng(5)
    for i in range(lights.shape[0]):
        verts = lights[i, :3 * nv[i]].reshape(nv[i], 3) - centre
        if case == "tiny":
            new = verts / verts.norm(dim=1).mean() * TINY_SCALES[i % 4]
        elif case == "far_2^64":
            new = verts / verts.norm(dim=1).mean() \
                * 2.0 ** rng.uniform(63.0, 64.5)
        else:
            new = verts.clone()
            new[2:, 0] = 2.0 ** 116 * torch.sign(verts[2:, 0] + 0.5)
        new = new.float().double()
        normal = torch.linalg.cross(new[1] - new[0], new[2] - new[0])
        normal = normal / normal.norm()
        pad = new[:1].expand(8 - nv[i], 3)
        lights[i, fused.LS_VERTS:fused.LS_VERTS + 24] = torch.cat(
            [new, pad]).reshape(-1)
        lights[i, fused.LS_PLANE:fused.LS_PLANE + 3] = normal
        lights[i, fused.LS_PLANE + 3] = -(normal * new[0]).sum()
    return (planes.contiguous(), noise, lights.float().contiguous(), static,
            s)


def _kernel(kernel: str, plain: bool):
    if kernel == "K4":
        return fused.fused_light_shading_plain if plain \
            else fused.fused_light_shading
    return fused.fused_light_shading_resolved_plain if plain \
        else fused.fused_light_shading_resolved


def bit_mismatches(a: torch.Tensor, b: torch.Tensor) -> int:
    """Values whose float32 bits differ, a NaN on both sides counting as
    equal (the card writes one NaN pattern; the CPU's carry signs)."""
    def bits(x):
        return torch.where(torch.isnan(x), float("nan"),
                           x).contiguous().view(torch.int32)
    return int((bits(a) != bits(b)).sum())


def _fma_two_product(a, b):
    """two_product with the bare FMA's error term: a * b - p is exact in
    float64 for float32 a, b and p = fl(a * b), and rounding it once to
    float32 is what the fused multiply-add returns."""
    p = a * b
    return p, (a.double() * b.double() - p.double()).float()


def predict(inputs: dict) -> list[dict]:
    """Per run and case on the CPU: values where the plain version with
    the bare FMA's error term (_fma_two_product) differs from the plain
    version, and the two_product calls whose error terms differ."""
    rows = []
    for i, (kernel, technique, _, _) in enumerate(RUNS):
        for case in CASES:
            args = case_inputs(inputs[i], case)
            plain = _kernel(kernel, True)
            with torch.no_grad():
                want = plain(*args)
                calls = [0, 0]
                dekker = soa.two_product

                def fma(a, b):
                    p, e = _fma_two_product(a, b)
                    calls[0] += e.numel()
                    calls[1] += bit_mismatches(e, dekker(a, b)[1])
                    return p, e

                soa.two_product = fma
                try:
                    got = plain(*args)
                finally:
                    soa.two_product = dekker
            rows.append(dict(kernel=kernel, technique=technique, case=case,
                             values=want.numel(),
                             predicted_mismatches=bit_mismatches(got, want),
                             error_terms=calls[0],
                             error_terms_differing=calls[1]))
    return rows


def measure(inputs: dict, device) -> list[dict]:
    """Per run and case: the kernel against its plain version on `device`
    (a card), values and bit mismatches, and the non-finite values."""
    device = get_device(device)
    rows = []
    for i, (kernel, technique, _, _) in enumerate(RUNS):
        for case in CASES:
            planes, noise, lights, static, s = case_inputs(inputs[i], case)
            noise = dataclasses.replace(
                noise, table=noise.table.to(device),
                fetches=noise.fetches.to(device),
                pixels=noise.pixels.to(device))
            args = (planes.to(device), noise, lights.to(device), static, s)
            with torch.no_grad():
                got = _kernel(kernel, False)(*args)
                want = _kernel(kernel, True)(*args)
            rows.append(dict(kernel=kernel, technique=technique, case=case,
                             pixels=planes.shape[1], values=want.numel(),
                             mismatches=bit_mismatches(got, want),
                             nonfinite=int((~torch.isfinite(want)).sum())))
    return rows


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--data", default="data")
    parser.add_argument("--predict", action="store_true",
                        help="the bare FMA's counts on the CPU instead")
    args = parser.parse_args(argv)
    inputs = base_inputs(args.data)
    rows = predict(inputs) if args.predict else measure(inputs, "cuda")
    for row in rows:
        print(json.dumps(row), flush=True)
    return int(not args.predict and any(r["mismatches"] for r in rows))


if __name__ == "__main__":
    sys.exit(main())
