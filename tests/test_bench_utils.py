"""bench.py parent-side utilities (no jax involved).

Round-3 verdict Weak #3: ``prev_value()`` only understood a bare headline
record, but driver artifacts wrap bench output as {n, cmd, rc, tail,
parsed} with the metric records living as JSON lines inside "tail" — so
``vs_baseline`` silently reported 1.0 every round.  These tests pin the
artifact-shape parsing against synthetic files of every observed shape.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402
import pytest  # noqa: E402


def test_artifact_records_bare_headline():
    d = {"metric": bench.METRIC, "value": 0.94, "unit": "s"}
    recs = bench._artifact_records(d)
    assert any(r.get("metric") == bench.METRIC and r["value"] == 0.94
               for r in recs)


def test_artifact_records_driver_shape():
    # the round-3 driver artifact shape: rc=124, headline only in "tail",
    # "parsed" holding whatever JSON line landed last (gen_david)
    tail = "\n".join([
        'alue": 0.6866, "unit": "s", "ok": true}',  # truncated line: skip
        'WARNING: some log line',
        json.dumps({"metric": bench.METRIC, "value": 0.6866, "unit": "s"}),
        json.dumps({"metric": "spmm_sym_f64_gnnzps", "value": 116.49,
                    "unit": "Gnnz/s"}),
    ])
    d = {"n": 3, "cmd": "python bench.py", "rc": 124, "tail": tail,
         "parsed": {"metric": "gen_david_bsr_n65536_f64_wall",
                    "value": 1.3506, "unit": "s"}}
    recs = bench._artifact_records(d)
    by = {r["metric"]: r["value"] for r in recs if "metric" in r}
    assert by[bench.METRIC] == 0.6866
    assert by["gen_david_bsr_n65536_f64_wall"] == 1.3506
    assert by["spmm_sym_f64_gnnzps"] == 116.49


def test_prev_values_latest_round_wins(tmp_path, monkeypatch):
    monkeypatch.setattr(bench, "REPO", str(tmp_path))
    (tmp_path / "BENCH_r02.json").write_text(json.dumps(
        {"metric": bench.METRIC, "value": 0.94, "unit": "s"}))
    (tmp_path / "BENCH_r03.json").write_text(json.dumps(
        {"n": 3, "rc": 124,
         "tail": json.dumps({"metric": bench.METRIC, "value": 0.6866,
                             "unit": "s"}),
         "parsed": {"metric": "other", "value": 1.0}}))
    vals = bench.prev_values()
    assert vals[bench.METRIC] == 0.6866
    assert bench.prev_value() == 0.6866


@pytest.fixture
def r03_artifact(tmp_path):
    """A driver artifact of the round-3 shape: rc=124 (cut by the driver's
    timeout), a 2000-character "tail" whose first line is truncated, log
    lines between the metric records, and "parsed" holding whatever JSON
    line landed last."""
    lines = [
        'alue": 0.6866, "unit": "s", "ok": true, "iters": 47}',
        json.dumps({"metric": "lobpcg_bsr_n65536_f64_wall", "value": 0.7066,
                    "unit": "s", "ok": True, "iters": 87}),
        json.dumps({"metric": bench.METRIC, "value": 0.6866, "unit": "s",
                    "vs_baseline": 1.0}),
        "[bench] section spmm: ok, 4 metrics, 130s",
        json.dumps({"metric": "spmm_f32_gnnzps", "value": 156.0297,
                    "unit": "Gnnz/s", "ms_per_matvec": 3.01}),
        "caslr_eff ladder n=65536: compile+first solve 20.3s, ok=True",
    ]
    tail = "\n".join(lines)
    path = tmp_path / "BENCH_r03.json"
    path.write_text(json.dumps({
        "n": 3, "cmd": "python bench.py", "rc": 124, "tail": tail[-2000:],
        "parsed": {"metric": "spmm_f32_gnnzps", "value": 156.0297}}))
    return path


def test_prev_values_real_r03_artifact(r03_artifact, monkeypatch):
    # a driver artifact of the round-3 shape must yield the davidson
    # headline, not None (the round-3 bug)
    d = json.load(open(r03_artifact))
    recs = bench._artifact_records(d)
    by = {r["metric"]: r["value"] for r in recs if "metric" in r}
    assert abs(by[bench.METRIC] - 0.6866) < 1e-9
    monkeypatch.setattr(bench, "REPO", str(r03_artifact.parent))
    assert bench.prev_value() == 0.6866


def test_suite_headline_shape(monkeypatch, capsys):
    monkeypatch.setattr(bench, "SUITE", [
        {"metric": bench.METRIC, "value": 0.5, "unit": "s"}])
    monkeypatch.setattr(bench, "prev_value", lambda: 1.0)
    bench.print_headline(final=True)
    out = json.loads(capsys.readouterr().out.strip())
    assert out["metric"] == bench.METRIC
    assert out["value"] == 0.5
    assert out["vs_baseline"] == 2.0
    assert out["suite"]


def test_self_report_path_and_write(tmp_path, monkeypatch):
    """BENCH_SELF_r{N}.json derives N from the latest driver artifact + 1
    and persists the full suite (evidence surviving tail truncation)."""
    monkeypatch.setattr(bench, "REPO", str(tmp_path))
    (tmp_path / "BENCH_r03.json").write_text("{}")
    (tmp_path / "BENCH_r04.json").write_text("{}")
    assert os.path.basename(bench._self_report_path()) == "BENCH_SELF_r05.json"
    monkeypatch.setattr(bench, "SUITE", [
        {"metric": bench.METRIC, "value": 0.5, "unit": "s"},
        {"metric": "spmm_sym_f64_gnnzps", "value": 167.1, "unit": "Gnnz/s"},
    ])
    bench.write_self_report()
    d = json.load(open(tmp_path / "BENCH_SELF_r05.json"))
    assert d["value"] == 0.5 and len(d["suite"]) == 2
    # the self report is itself parseable by the artifact reader
    recs = bench._artifact_records(d)
    assert any(r.get("metric") == "spmm_sym_f64_gnnzps" for r in recs)
