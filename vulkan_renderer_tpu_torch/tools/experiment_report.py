"""Summarize the port's experiment CSV into a markdown report.

Counterpart of vulkan_renderer_tpu/tools/experiment_report.py. The port's
harness CLI keeps one row per experiment index in data/results_torch.csv
(experiments/harness.py main), with the card's name and power limit in
its `device` column. This tool renders the same tables as the JAX tool —
the timing sweep pivot (experiment_list.c:364-409: technique rows x
{central, decentral} x {128 lights 1 spp, 1 light 128 spp} columns), the
vertex-count scaling pivot, the RMSE table of tools/rmse_table.py and the
table of all experiments — with the device beside each number. The JAX
tool's prose on what its TPU rows show is not repeated. It adds a summary
by vertex count (per light configuration the median over the techniques,
PSA, Arvo PSA and PSA over the baseline; per technique the steps up in
vertex count at which its cost rose) and, with --windows, each timing
cell's harness medians against their windows (tools/sweep_check.py).

    python -m vulkan_renderer_tpu_torch.tools.experiment_report \
        [data/results_torch.csv] [-o data/experiments/RESULTS_torch.md] \
        [--rmse-csv results/rmse_torch.csv] [--windows FILE.jsonl]
"""

from __future__ import annotations

import argparse
import csv
import json
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


# The timing sweep's light configurations (experiment_list.c:364-409).
CELLS = (("central", "128L 1spp"), ("central", "1L 128spp"),
         ("decentral", "128L 1spp"), ("decentral", "1L 128spp"))
# The techniques of the per-vertex-count summary, beside the median.
SUMMARY_TECHNIQUES = ("projected_solid_angle", "projected_solid_angle_arvo")


def _ms(row) -> float:
    return float(row["frame_ms"])


def _vertex_count_summary(timing: dict, nv_list: list) -> list:
    """The port's summary of the sweep by vertex count: per light
    configuration the median over the techniques measured, PSA, Arvo PSA
    and PSA over the baseline; and per technique the steps up in vertex
    count at which its cost rose."""
    header = "| " + " | ".join(f"{nv}-gon" for nv in nv_list) + " |"
    lines = [
        "### Per-vertex-count summary",
        "",
        "ms/frame for each light configuration and vertex count: the "
        "median over the techniques measured there, PSA and Arvo PSA, and "
        "PSA over the baseline technique (the frame outside the sampler).",
        "",
        "| configuration | statistic " + header,
        "|---|---|" + "---|" * len(nv_list),
    ]
    techs = sorted({t for t, _, _, _ in timing})
    for case, lcfg in CELLS:
        def cell(nv, tech=None):
            if tech is not None:
                r = timing.get((tech, nv, case, lcfg))
                return None if r is None else _ms(r)
            values = sorted(_ms(r) for (t, n, c, l), r in timing.items()
                            if (n, c, l) == (nv, case, lcfg))
            if not values:
                return None
            mid = len(values) // 2
            return values[mid] if len(values) % 2 else \
                (values[mid - 1] + values[mid]) / 2

        def fmt(v, digits=3):
            return "—" if v is None else f"{v:.{digits}f}"

        stats = [("median", [cell(nv) for nv in nv_list])]
        stats += [(t, [cell(nv, t) for nv in nv_list])
                  for t in SUMMARY_TECHNIQUES]
        ratios = [None if cell(nv, "baseline") in (None, 0.0)
                  or cell(nv, "projected_solid_angle") is None
                  else cell(nv, "projected_solid_angle")
                  / cell(nv, "baseline") for nv in nv_list]
        for name, values in stats:
            lines.append(f"| {case} {lcfg} | {name} | "
                         + " | ".join(fmt(v) for v in values) + " |")
        lines.append(f"| {case} {lcfg} | PSA / baseline | "
                     + " | ".join(fmt(v, 4) for v in ratios) + " |")
    lines += [
        "",
        "Steps up in vertex count (from each count to the next) at which "
        "a technique's ms/frame rose, of the steps measured:",
        "",
        "| technique | " + " | ".join(f"{c} {l}" for c, l in CELLS) + " |",
        "|---|" + "---|" * len(CELLS),
    ]
    for tech in techs:
        cells = []
        for case, lcfg in CELLS:
            ms = [timing.get((tech, nv, case, lcfg)) for nv in nv_list]
            steps = [(a, b) for a, b in zip(ms, ms[1:])
                     if a is not None and b is not None]
            rose = sum(_ms(b) > _ms(a) for a, b in steps)
            cells.append(f"{rose}/{len(steps)}" if steps else "—")
        lines.append(f"| {tech} | " + " | ".join(cells) + " |")
    lines.append("")
    return lines


def _window_summary(windows_path: str) -> list:
    """The harness median against the window of the same Application
    (tools/sweep_check.py's JSON lines; the latest line per experiment):
    per timing cell the rows, the least and largest ratio, and the rows
    more than 5% off."""
    latest = {}
    with open(windows_path) as f:
        for line in f:
            if line.strip():
                row = json.loads(line)
                latest[row["index"]] = row
    cells: dict = {}
    for index in sorted(latest):
        cells.setdefault(latest[index]["cell"], []).append(latest[index])
    lines = [
        "### Harness median against the window",
        "",
        "Each sweep row's harness median over the window ms/frame of the "
        "same Application (tools/sweep_check.py: 40 frames, 3 in flight, "
        "host clock until the last retires), by timing cell.",
        "",
        "| cell | rows | least | largest | more than 5% off | device |",
        "|---|---|---|---|---|---|",
    ]
    for cell, rows in cells.items():
        ratios = [r["ratio"] for r in rows]
        off = [str(r["index"]) for r in rows if abs(r["ratio"] - 1) > 0.05]
        devices = sorted({r["card"] for r in rows})
        lines.append(f"| {cell.removeprefix('timings_').strip('_')} | "
                     f"{len(rows)} | "
                     f"{min(ratios):.4f} | {max(ratios):.4f} | "
                     f"{', '.join(off) or 'none'} | {'; '.join(devices)} |")
    lines.append("")
    return lines


def write_report(csv_path: str, out_path: str,
                 rmse_path: str | None = None,
                 windows_path: str | None = None) -> int:
    """Write the report of csv_path (and of rmse_path, default rmse.csv
    beside it, where it exists; and of windows_path, tools/sweep_check.py's
    JSON lines, where given) to out_path; returns the experiments
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

    if timing and len(nvs) > 1:
        lines += _vertex_count_summary(timing, sorted(nvs))
    if windows_path:
        lines += _window_summary(windows_path)

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
    parser.add_argument("--windows", default=None,
                        help="tools/sweep_check.py's --jsonl lines: each "
                        "sweep row's harness median against its window")
    args = parser.parse_args(argv)
    n = write_report(args.csv, args.output, args.rmse_csv, args.windows)
    print(f"{n} experiments -> {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
