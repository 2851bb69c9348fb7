"""tools/experiment_report.py on the port against the JAX package's on
the same CSVs: the same markdown, apart from the port's device column
(each table row gains it, the sweep headings name the device instead of
the backend), its intro's "card" for "TPU", the JAX report's prose on its
TPU rows, which the port does not repeat, and the port's own sections
(the per-vertex-count summary, the harness medians against their
windows), which are held on their own."""

import csv
import json
import os

from vulkan_renderer_tpu.tools import experiment_report as j_report
from vulkan_renderer_tpu_torch.experiments import harness
from vulkan_renderer_tpu_torch.tools import experiment_report, rmse_table

CARD = "NVIDIA H100 80GB HBM3, 700.00 W"


def _write_csvs(tmp_path):
    """A results CSV as the port's harness writes it (timing rows of two
    vertex counts in both cells, and figure rows) and an RMSE CSV."""
    experiments = harness.create_experiment_list()
    results = str(tmp_path / "results_torch.csv")
    for n, i in enumerate([0, 6, 50, 51, 63, 76, 89, 102, 115, 193, 194]):
        e = experiments[i]
        s = e.settings
        ms = 10.0 + 1.5 * n
        harness.append_csv_row(results, [
            i, e.scene, s.polygon_sampling_technique.value,
            s.sampling_strategy.value, s.sample_count, e.width, e.height,
            f"{ms:.3f}", "cuda", CARD, 1, 0, 0,
            (e.screenshot_path % ms)[:-4] + "_standin.png"])
    rmse = str(tmp_path / "rmse.csv")
    for config, spp, value in ((1, 128, 8.1e-4), (2, 128, 1.2e-3),
                               (2, 256, 8.7e-4)):
        rmse_table.append_row(rmse, dict(
            config=config, tag=f"tag {config}", width=256, height=256,
            spp=spp, ref_spp=1024, rmse=f"{value:.3e}", ms_per_frame="1.0",
            backend="cuda", device=CARD, stand_in=1, primary_uncertain=0,
            shadow_overflow=0))
    return results, rmse


def _without_device(line):
    """A port line as the JAX tool writes it."""
    line = line.replace(f"({CARD})", "(cuda)").replace("NOT card", "NOT TPU")
    for cell in (f" {CARD} |", " device |"):
        if line.endswith(cell):
            return line[:-len(cell)]
    if line in ("|---|" + "---|" * 9, "|---|" + "---|" * 11):
        return line[:-4]
    return line


def _without_section(lines, heading):
    """lines less the section that starts at `heading`, up to the next
    heading."""
    start = lines.index(heading)
    end = next(i for i in range(start + 1, len(lines))
               if lines[i].startswith("#"))
    return lines[:start] + lines[end:]


def test_report_matches_reference(tmp_path):
    results, rmse = _write_csvs(tmp_path)
    out = str(tmp_path / "out" / "RESULTS_torch.md")
    assert experiment_report.write_report(results, out, rmse) == 11
    want_path = str(tmp_path / "RESULTS.md")
    assert j_report.write_report(results, want_path) == 11
    with open(out) as f:
        got = f.read().splitlines()
    with open(want_path) as f:
        want = f.read().splitlines()
    # The JAX report's prose on its TPU rows.
    start = want.index("### Qualitative ordering vs the reference")
    end = next(i for i in range(start + 1, len(want))
               if want[i].startswith("## "))
    want = want[:start] + want[end:]
    got = _without_section(got, "### Per-vertex-count summary")
    assert [_without_device(line) for line in got] == want
    assert any(CARD in line for line in got)
    assert any(line.startswith("## Timing sweep") for line in got)
    assert any(line.startswith("## Vertex-count scaling") for line in got)


def test_cli_defaults(tmp_path, monkeypatch):
    results, rmse = _write_csvs(tmp_path)
    monkeypatch.chdir(tmp_path)
    os.makedirs("data")
    os.replace(results, os.path.join("data", "results_torch.csv"))
    assert experiment_report.main(["--rmse-csv", rmse]) == 0
    with open(os.path.join("data", "experiments", "RESULTS_torch.md")) as f:
        text = f.read()
    assert "## All experiments" in text and "RMSE self-reference" in text
    with open(os.path.join("data", "results_torch.csv"), newline="") as f:
        assert list(csv.DictReader(f))[0]["device"] == CARD


def test_vertex_count_summary(tmp_path):
    """The port's summary by vertex count, from _write_csvs' rows (ms =
    10 + 1.5 n for the n-th row): the central 128-light 3-gon median of
    baseline (row 2) and area_turk (row 3), baseline alone at 4 vertices
    (row 7); the decentral 1-light cell at 3 and 5 vertices (rows 6, 9
    and 10); no PSA row; baseline rose from 3 to 4 vertices in both
    central cells, and the decentral cells have no two adjacent counts."""
    results, rmse = _write_csvs(tmp_path)
    out = str(tmp_path / "RESULTS_torch.md")
    experiment_report.write_report(results, out, rmse)
    with open(out) as f:
        lines = f.read().splitlines()
    start = lines.index("### Per-vertex-count summary")
    rows = {tuple(c.strip() for c in line.split("|")[1:3]):
            [c.strip() for c in line.split("|")[3:-1]]
            for line in lines[start:] if line.startswith("| central")
            or line.startswith("| decentral")}
    assert lines[start + 4] == ("| configuration | statistic | 3-gon | "
                                "4-gon | 5-gon |")
    assert rows[("central 128L 1spp", "median")] == ["13.750", "20.500",
                                                     "—"]
    assert rows[("decentral 1L 128spp", "median")] == ["19.000", "—",
                                                       "24.250"]
    assert rows[("central 128L 1spp", "projected_solid_angle")] == \
        ["—"] * 3
    assert rows[("central 1L 128spp", "PSA / baseline")] == ["—"] * 3
    baseline = next(line for line in lines[start:]
                    if line.startswith("| baseline |"))
    assert baseline == "| baseline | 1/1 | 1/1 | — | — |"


def test_window_summary(tmp_path):
    """--windows: each timing cell's rows, least and largest harness /
    window ratio and the rows more than 5% off, the latest line per
    experiment."""
    results, rmse = _write_csvs(tmp_path)
    windows = tmp_path / "windows.jsonl"
    lines = [dict(index=50, cell="timings_central_3_128_", ratio=1.01),
             dict(index=51, cell="timings_central_3_128_", ratio=0.9),
             dict(index=51, cell="timings_central_3_128_", ratio=0.97),
             dict(index=63, cell="timings_central_3_", ratio=1.06)]
    windows.write_text("".join(json.dumps({**d, "card": CARD}) + "\n"
                               for d in lines))
    out = str(tmp_path / "RESULTS_torch.md")
    assert experiment_report.main([results, "-o", out, "--rmse-csv", rmse,
                                   "--windows", str(windows)]) == 0
    with open(out) as f:
        text = f.read().splitlines()
    assert f"| central_3_128 | 2 | 0.9700 | 1.0100 | none | {CARD} |" in text
    assert f"| central_3 | 1 | 1.0600 | 1.0600 | 63 | {CARD} |" in text
