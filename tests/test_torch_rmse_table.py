"""tools/rmse_table.py on the port against the JAX package's tool:
configuration 1 (the mis_plane stand-in, DIFFUSE_ONLY baseline, K5's
plain version here) at 32x32, a 2-spp estimate against a 16-spp
reference. Both packages advance the same noise per frame, so the RMSEs
agree to rounding: relative tolerance 1e-3."""

import csv

import pytest

from vulkan_renderer_tpu.tools import rmse_table as j_rmse
from vulkan_renderer_tpu_torch.tools import rmse_table

SIZE = 32


def test_config_1_matches_reference(tmp_path, monkeypatch):
    small = {n: dict(cfg, width=SIZE, height=SIZE)
             for n, cfg in j_rmse._configs().items()}
    monkeypatch.setattr(j_rmse, "_configs", lambda: small)
    want = j_rmse.run_config(1, 2, 16, data_directory=str(tmp_path / "jax"),
                             csv_path=str(tmp_path / "jax.csv"))
    csv_path = tmp_path / "rmse_torch.csv"
    got = rmse_table.run_config(1, 2, 16, data_directory=str(tmp_path
                                                            / "port"),
                                csv_path=str(csv_path), device="cpu",
                                width=SIZE, height=SIZE)
    assert got.rmse > 0.0
    assert got.rmse == pytest.approx(want, rel=1e-3)
    with open(csv_path, newline="") as f:
        (row,) = list(csv.DictReader(f))
    assert (row["config"], row["width"], row["spp"], row["ref_spp"],
            row["backend"], row["device"], row["stand_in"]) == \
        ("1", "32", "2", "16", "cpu", "cpu", "1")
    assert float(row["rmse"]) == pytest.approx(got.rmse, rel=1e-3)
    assert float(row["ms_per_frame"]) > 0.0


def test_cli_appends_rows(tmp_path):
    csv_path = tmp_path / "r.csv"
    for _ in range(2):
        assert rmse_table.main([
            "--config", "1", "--spp", "1", "--ref-spp", "2", "--device",
            "cpu", "--width", "16", "--height", "16", "--data-directory",
            str(tmp_path / "data"), "--csv", str(csv_path)]) == 0
    with open(csv_path, newline="") as f:
        rows = list(csv.DictReader(f))
    assert [r["spp"] for r in rows] == ["1", "1"]
    assert list(rows[0]) == list(rmse_table.CSV_HEADER)
