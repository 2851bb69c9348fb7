#!/usr/bin/env python3
"""The port's on-card check in one command, on a machine with a CUDA card
(it imports no JAX). Run from the repository root:

    python3 chip_smoke.py [pytest arguments]

It runs the gpu-marked suite, tests/test_torch_gpu*.py, without the
repository's conftest (which imports JAX), so every kernel is held
against its plain version on the card there (tests/test_torch_gpu.py
says what each file holds); then prints the kernels line
(vulkan_renderer_tpu_torch/tools/bench_frame.py --kernels: the bench
frame's JSON line, then each kernel's launches, ms, plain ms, bound and
side). The last line is {"ok": ..., "suite_rc": ..., "kernels_rc": ...};
the exit code is the suite's, else the kernels line's."""

import glob
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))


def main(argv=None) -> int:
    suite = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-p",
         "no:cacheprovider", "-m", "gpu", "-q", "-rfE",
         *sorted(glob.glob(os.path.join(ROOT, "tests", "test_torch_gpu*.py"))),
         *(sys.argv[1:] if argv is None else argv)], cwd=ROOT)
    kernels = subprocess.run(
        [sys.executable, os.path.join(ROOT, "vulkan_renderer_tpu_torch",
                                      "tools", "bench_frame.py"),
         "--kernels"], cwd=ROOT)
    print(json.dumps({"ok": suite.returncode == kernels.returncode == 0,
                      "suite_rc": suite.returncode,
                      "kernels_rc": kernels.returncode}), flush=True)
    return suite.returncode or kernels.returncode


if __name__ == "__main__":
    sys.exit(main())
