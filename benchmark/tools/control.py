#!/usr/bin/env python3
"""Read the check's control at a cell's own size: the reference computed
in bfloat16 (reference/render.py), put in the program's place, against
the float32 reference, on the pixels and frames a run would check. On
the GPU:

    python3 benchmark/tools/control.py WORKLOAD --seeds N [N ...]

One JSON line a seed: the worst of each number over the checked frames.
The frames are drawn from the seed among the first 500 of a window.
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("workload")
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    import numpy as np

    import harness
    import inputs
    entry, config, traffic = inputs.cell_files(args.workload)
    inputs.write_noise(inputs.settings_fields(config, traffic)["noise_type"])
    for seed in args.seeds:
        frames = sorted(np.random.default_rng([seed, 2]).choice(
            500, traffic["check"]["frames"], replace=False).tolist())
        rows = harness.check_frames(args.workload, config, traffic,
                                    [(i, None) for i in frames], seed,
                                    args.device)
        worst = {k: max(r[k] for r in rows) for k in rows[0] if k != "frame"}
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "frames": frames, **worst}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
