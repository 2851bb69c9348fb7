#!/usr/bin/env python3
"""Run one cell of the benchmark once on this machine's GPU:

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

NAME is a workload of BENCHMARK.json. The last line of standard output is
one JSON object: correct, attempted (frames retired in the window),
failed (checked frames out of their limits), metrics (the cell's
end-to-end metrics with --trace 0, its per-layer metrics with --trace 1),
device, with --trace 1 breakdown, and last the check: each number compared
beside its limit, which also end standard error. Without a CUDA device, or
with fewer than the cell asks for, it exits non-zero and prints no result;
so it does when a module of JAX or of the JAX package is loaded.
"""

import time

START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))


def process_age() -> float:
    """Seconds since this process started (Linux /proc), so that set-up
    counts the interpreter's start too; 0 where /proc does not say."""
    try:
        with open("/proc/self/stat") as f:
            started = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
    except (OSError, IndexError, ValueError):
        return 0.0
    return max(0.0, uptime - started / os.sysconf("SC_CLK_TCK"))


def card() -> str:
    """nvidia-smi's name and power limit of the first card: the rooflines
    assume its 700 W peaks."""
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def main(argv=None) -> int:
    started = START - process_age()
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    sys.path.insert(0, os.path.dirname(HERE))  # the port, at the checkout
    # Kernel caches at fixed paths inside the checkout.
    os.environ["TRITON_CACHE_DIR"] = os.path.join(HERE, "cache", "triton")
    import torch

    import harness
    import inputs
    entry, config, traffic = inputs.cell_files(args.workload)
    if not torch.cuda.is_available():
        print("benchmark: no CUDA device (torch.cuda.is_available() is "
              "False); the benchmark measures only on the GPU",
              file=sys.stderr)
        return 3
    if torch.cuda.device_count() < entry["chips"]:
        print(f"benchmark: {args.workload} needs {entry['chips']} GPUs, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 3
    result, lines = harness.run(args.workload, entry, config, traffic,
                                args.seed, args.seconds, bool(args.trace),
                                "cuda", started)
    result = {**{k: v for k, v in result.items() if k != "check"},
              "card": card(), "check": result["check"]}
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"benchmark: modules of JAX or the JAX package were loaded: "
              f"{loaded}", file=sys.stderr)
        return 4
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    print("\n".join(lines), file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
