"""Summarize the port's experiment CSV into a markdown report.

Counterpart of vulkan_renderer_tpu/tools/experiment_report.py. The port's
harness CLI keeps one row per experiment index in data/results_torch.csv
(experiments/harness.py main), with the card's name and power limit in
its `device` column. This tool renders the same tables as the JAX tool —
the timing sweep pivot (experiment_list.c:364-409: technique rows x
{central, decentral} x {128 lights 1 spp, 1 light 128 spp} columns), the
vertex-count scaling pivot, the RMSE table of tools/rmse_table.py and the
table of all experiments — with the device beside each number. The JAX
tool's prose on what its TPU rows show is not repeated.

    python -m vulkan_renderer_tpu_torch.tools.experiment_report \
        [data/results_torch.csv] [-o data/experiments/RESULTS_torch.md] \
        [--rmse-csv results/rmse_torch.csv]
"""

from __future__ import annotations

import argparse
import csv
import os
import re

_TIMING_RE = re.compile(
    r"timings_(central|decentral)_(\d)(_128)?_([a-z0-9_]+?)_[-0-9.]+"
    r"(?:_standin)?(?:_cpu)?\.(?:png|hdr)$")


def _timing_key(row):
    m = _TIMING_RE.search(row["screenshot"])
    if not m:
        return None
    case, nv, lights128, tech = m.groups()
    return tech, int(nv), case, "128L 1spp" if lights128 else "1L 128spp"


def write_report(csv_path: str, out_path: str,
                 rmse_path: str | None = None) -> int:
    """Write the report of csv_path (and of rmse_path, default rmse.csv
    beside it, where it exists) to out_path; returns the experiments
    reported."""
    with open(csv_path) as f:
        rows = list(csv.DictReader(f))
    # Last run of each experiment index wins.
    latest: dict[str, dict] = {}
    for row in rows:
        latest[row["index"]] = row
    rows = sorted(latest.values(), key=lambda r: int(r["index"]))
    lines = [
        "# Experiment results",
        "",
        f"{len(rows)} experiments (latest run per index). Frame times on "
        "the `cpu` backend are NOT card measurements (tagged `_cpu` in "
        "filenames); `stand_in` marks procedural stand-in scenes/layouts "
        "(reference assets are a separate download).",
        "",
    ]

    # --- timing-sweep pivot (the reference's headline benchmark) ---------
    timing = {}
    nvs = set()
    for r in rows:
        key = _timing_key(r)
        if key:
            tech, nv, case, lcfg = key
            nvs.add(nv)
            timing[(tech, nv, case, lcfg)] = r
    if timing:
        techs = []
        for r in rows:
            key = _timing_key(r)
            if key and key[0] not in techs:
                techs.append(key[0])
        cols = [(case, lcfg) for case in ("central", "decentral")
                for lcfg in ("128L 1spp", "1L 128spp")]
        for nv in sorted(nvs):
            any_rows = [t for t in techs
                        if any((t, nv, c, l) in timing for c, l in cols)]
            if not any_rows:
                continue
            backend = next(iter(timing.values()))["device"]
            res = next(iter(timing.values()))
            lines += [
                f"## Timing sweep — {nv}-gon lights, "
                f"{res['width']}x{res['height']}, diffuse-only, no "
                f"shadows ({backend})",
                "",
                "ms/frame, median with frames in flight (reference "
                "protocol, frame_timer.c:47-72). Reference sweep: "
                "experiment_list.c:364-409.",
                "",
                "| technique | " + " | ".join(f"{c} {l}" for c, l in cols)
                + " |",
                "|---|" + "---|" * len(cols),
            ]
            for tech in any_rows:
                cells = []
                for c, l in cols:
                    r = timing.get((tech, nv, c, l))
                    if r is None:
                        cells.append("—")
                    else:
                        exact = (r["primary_uncertain"] == "0"
                                 and r["shadow_overflow"] == "0")
                        cells.append(r["frame_ms"]
                                     + ("" if exact else " (INEXACT)"))
                lines.append(f"| {tech} | " + " | ".join(cells) + " |")
            lines.append("")

    # --- vertex-count scaling pivot (cost vs polygon vertex count — the
    # per-vertex-count axis of the paper's timing figures) ----------------
    if timing and len(nvs) > 1:
        nv_list = sorted(nvs)
        techs = []
        for r in rows:
            key = _timing_key(r)
            if key and key[0] not in techs:
                techs.append(key[0])
        for case, lcfg in (("central", "128L 1spp"),
                           ("central", "1L 128spp"),
                           ("decentral", "128L 1spp"),
                           ("decentral", "1L 128spp")):
            have = [t for t in techs
                    if any((t, nv, case, lcfg) in timing for nv in nv_list)]
            if not have:
                continue
            lines += [
                f"## Vertex-count scaling — {case} case, {lcfg}",
                "",
                "ms/frame by polygon vertex count (the sampling "
                "techniques' setup cost grows with the vertex count; "
                "clipping-based techniques additionally pay the clip "
                "jump table — experiment_list.c:364-409's sweep axis).",
                "",
                "| technique | " + " | ".join(f"{nv}-gon"
                                              for nv in nv_list) + " |",
                "|---|" + "---|" * len(nv_list),
            ]
            for tech in have:
                cells = []
                for nv in nv_list:
                    r = timing.get((tech, nv, case, lcfg))
                    cells.append("—" if r is None else r["frame_ms"])
                lines.append(f"| {tech} | " + " | ".join(cells) + " |")
            lines.append("")

    # --- RMSE self-reference table (BASELINE configs 1-3) -----------------
    if rmse_path is None:
        rmse_path = os.path.join(os.path.dirname(csv_path) or ".",
                                 "rmse.csv")
    if os.path.exists(rmse_path):
        with open(rmse_path) as f:
            rrows = list(csv.DictReader(f))
        latest_r = {}
        for r in rrows:
            latest_r[(r["config"], r.get("spp"), r["device"])] = r
        lines += [
            "## RMSE self-reference (BASELINE rebuild-target configs)",
            "",
            "A `spp`-sample estimate vs an independent `ref_spp` deeper "
            "reference of the same frame (frame-accumulated; the "
            "in-renderer reference protocol of experiment_list.c:96-100), "
            "RMSE in sRGB [0, 1]. True cross-implementation RMSE needs "
            "the reference's data downloads (absent here); this is the "
            "runnable half of BASELINE.md's <1e-3 target — see "
            "tools/rmse_table.py.",
            "",
            "| config | resolution | spp | ref spp | RMSE | backend | "
            "stand-in | uncertain | overflow | device |",
            "|---|---|---|---|---|---|---|---|---|---|",
        ]
        for r in sorted(latest_r.values(),
                        key=lambda r: (int(r["config"]), -int(r["spp"]))):
            lines.append(
                f"| {r['config']}: {r['tag']} | "
                f"{r['width']}x{r['height']} | {r['spp']} | "
                f"{r.get('ref_spp', '?')} | {r['rmse']} | "
                f"{r['backend']} | "
                f"{'yes' if r['stand_in'] == '1' else 'no'} | "
                f"{r['primary_uncertain']} | {r['shadow_overflow']} | "
                f"{r['device']} |")
        lines.append("")
        # Named causes for rows over the 1e-3 target (the target's own
        # contract: "any config failing 1e-3 gets a named cause").
        causes = {
            "2": ("GGX-specular Monte-Carlo variance at 128 spp with pure "
                  "light sampling (no MIS, per the config's contract): the "
                  "residual halves when spp quadruples (see the 32-spp row's "
                  "~2x RMSE), i.e. it is unbiased estimator variance, not "
                  "bias; ~192 spp would cross 1e-3."),
        }
        over = [r for r in latest_r.values()
                if float(r["rmse"]) >= 1e-3]
        if over:
            lines.append("Named causes for rows over 1e-3:")
            lines.append("")
            for r in sorted(over, key=lambda r: int(r["config"])):
                cause = causes.get(r["config"],
                                   "unexplained — investigate")
                lines.append(f"- config {r['config']} at {r['spp']} spp "
                             f"(RMSE {r['rmse']}): {cause}")
            lines.append("")

    lines += [
        "## All experiments",
        "",
        "| # | scene | technique | strategy | spp | res | ms/frame | "
        "backend | stand-in | uncertain | overflow | device |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        lines.append(
            f"| {r['index']} | {r['scene']} | {r['technique']} | "
            f"{r['strategy']} | {r['spp']} | {r['width']}x{r['height']} | "
            f"{r['frame_ms']} | {r['backend']} | "
            f"{'yes' if r['stand_in'] == '1' else 'no'} | "
            f"{r['primary_uncertain']} | {r['shadow_overflow']} | "
            f"{r['device']} |")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return len(rows)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("csv", nargs="?",
                        default=os.path.join("data", "results_torch.csv"))
    parser.add_argument("-o", "--output", default=os.path.join(
        "data", "experiments", "RESULTS_torch.md"))
    parser.add_argument("--rmse-csv", default=os.path.join(
        "results", "rmse_torch.csv"))
    args = parser.parse_args(argv)
    n = write_report(args.csv, args.output, args.rmse_csv)
    print(f"{n} experiments -> {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
