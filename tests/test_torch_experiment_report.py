"""tools/experiment_report.py on the port against the JAX package's on
the same CSVs: the same markdown, apart from the port's device column
(each table row gains it, the sweep headings name the device instead of
the backend), its intro's "card" for "TPU", and the JAX report's prose
on its TPU rows, which the port does not repeat."""

import csv
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
