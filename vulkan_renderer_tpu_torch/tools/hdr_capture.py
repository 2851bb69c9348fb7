"""Two-frame HDR capture through the frame_bits path.

Counterpart of vulkan_renderer_tpu/tools/hdr_capture.py. The reference
captures HDR screenshots without a float swapchain by rendering the same
frame twice, with HDR_COPY_LOW_BYTES and HDR_COPY_HIGH_BYTES
(main.c:1700-1763): each pass writes one byte of the float16 radiance
into an 8-bit target, and the host puts the pair back together. This tool
renders frame_bits 1 and 2 and a direct linear frame (frame_bits 0) of
one experiment-style setup with the noise frozen, recombines the pair
(render/screenshot.py combine_ldr_screenshots_into_hdr), checks it
against the direct frame and writes it as a Radiance .hdr named after
the card it ran on. The recombined frame is the direct frame rounded to
float16, bit for bit; exit code 2 if it is off by more than float16
quantization.

    python -m vulkan_renderer_tpu_torch.tools.hdr_capture \
        [--scene cornell_box] [--width 256] [--height 256] [--device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import re

import numpy as np

from ..core.settings import (PolygonSamplingTechnique, RenderSettings,
                             SamplingStrategy)
from ..experiments import harness
from ..experiments.setups import build_default_application
from ..render.screenshot import combine_ldr_screenshots_into_hdr, write_hdr

# float16 keeps 10 mantissa bits.
FP16_RELATIVE = 2.0 ** -10


def bit_frames(render) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(low bytes, high bytes, direct linear frame) as float32 arrays;
    render(frame_bits) returns that frame of one fixed view and noise."""
    low, high, direct = (np.asarray(render(bits).detach().cpu().numpy(),
                                    np.float32) for bits in (1, 2, 0))
    return low, high, direct


def half_mismatches(combined: np.ndarray, direct: np.ndarray) -> int:
    """Values whose float16 bits differ between the recombined frame and
    the direct frame rounded to float16."""
    return int(np.count_nonzero(
        combined.astype(np.float16).view(np.uint16)
        != direct.astype(np.float16).view(np.uint16)))


def max_relative_error(combined: np.ndarray, direct: np.ndarray) -> float:
    err = np.abs(combined.astype(np.float64) - direct.astype(np.float64))
    return float((err / np.maximum(np.abs(direct), 2.0 ** -14)).max())


def card_tag(device) -> str:
    """The card as a file-name tag: 'cpu', or nvidia-smi's name and power
    limit with runs of other characters as '-'."""
    return re.sub(r"[^A-Za-z0-9.]+", "-",
                  harness.card_description(device)).strip("-")


def capture(scene: str = "cornell_box", width: int = 256, height: int = 256,
            out_dir: str = os.path.join("data", "hdr_capture"),
            device: str = "cuda", data_directory: str = "data"):
    """Render, recombine, check and write the capture: (path, max relative
    error against the direct frame, float16 bit mismatches)."""
    # animate_noise=False: the three frames sample the same radiance (the
    # reference freezes the frame for its two captures).
    settings = RenderSettings(
        sampling_strategy=SamplingStrategy.DIFFUSE_ONLY,
        polygon_sampling_technique=(
            PolygonSamplingTechnique.PROJECTED_SOLID_ANGLE),
        sample_count=1, trace_shadow_rays=False, animate_noise=False,
        output_linear_rgb=True)
    exp = harness.Experiment(width, height, scene, settings,
                             screenshot_path="unused_%.3f.png")
    app = build_default_application(exp, data_directory, device=device)

    def render(bits):
        app.settings = dataclasses.replace(settings, frame_bits=bits)
        return app.render_frame_sync()

    low, high, direct = bit_frames(render)
    combined = combine_ldr_screenshots_into_hdr(low, high)
    max_rel = max_relative_error(combined, direct)
    mismatches = half_mismatches(combined, direct)
    stand_in = "_standin" if getattr(app, "scene_stand_in", False) else ""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{scene}_hdr_2frame_capture{stand_in}_"
                        f"{card_tag(device)}.hdr")
    write_hdr(path, combined)
    return path, max_rel, mismatches


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--scene", default="cornell_box")
    parser.add_argument("--width", type=int, default=256)
    parser.add_argument("--height", type=int, default=256)
    parser.add_argument("--device", default="cuda",
                        help="cuda (the card) or cpu (plain versions)")
    parser.add_argument("--data-directory", default="data")
    parser.add_argument("--out-dir", default=os.path.join("data",
                                                          "hdr_capture"))
    args = parser.parse_args(argv)
    path, max_rel, mismatches = capture(
        args.scene, args.width, args.height, args.out_dir, args.device,
        args.data_directory)
    ok = max_rel <= FP16_RELATIVE
    print(f"wrote {path}: max relative error vs the direct frame "
          f"{max_rel:.3e} ({'within' if ok else 'EXCEEDS'} float16 "
          f"quantization 2^-10), float16 bit mismatches {mismatches} "
          f"[{harness.card_description(args.device)}]")
    return 0 if ok else 2


if __name__ == "__main__":
    raise SystemExit(main())
