"""The harness is driven by its files: every cell names a configuration
and a traffic module that exist, every per-layer metric is a module that
declares what BENCHMARK.json says of it and is reported only where its
end-to-end metric is, a new cell file is found by its name alone, and a
run's last line carries the keys the result line is defined with."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from _portbench_small import ROOT, run
from portbench import harness

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_each_pair_of_configuration_and_traffic_once():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files_match_benchmark(w):
    cell, cfg = harness.cell_files(w["name"])
    for k in ("name", "config", "traffic", "chips", "why"):
        assert cell[k] == w[k], k
    assert cfg["name"] == w["config"]
    assert (ROOT / "portbench" / "traffic"
            / f"{cell['generator']}.py").exists()
    assert (ROOT / "portbench" / "counts" / f"{w['config']}.py").exists()
    assert set(cell["checks"]) and all(
        0 < c["limit"] for c in cell["checks"].values())


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(c):
    cfg = json.loads((ROOT / c["file"]).read_text())
    assert cfg["name"] == c["name"]
    assert cfg["reduced"] == c["reduced"] == []


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_modules_declare_what_benchmark_says(m):
    mod = harness.metric_module(m["name"])
    assert (mod.LAYER, mod.UNIT, mod.SOURCE, mod.MOVES) == \
        (m["layer"], m["unit"], m["source"], m["moves"])
    e2e = {e["name"]: e for e in BENCH["end_to_end"]}
    moved = e2e[m["moves"]]
    for cell in m["workloads"]:
        assert cell in moved.get("workloads", [cell]), (m["name"], cell)


def test_every_cell_reports_setup_another_e2e_and_a_layer_metric():
    for w in BENCH["workloads"]:
        e2e = [m["name"] for m in harness.reported(BENCH, "end_to_end",
                                                  w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.reported(BENCH, "per_layer", w["name"])


def test_a_new_cell_file_is_found_by_name(tmp_path, monkeypatch):
    copy = tmp_path / "portbench"
    shutil.copytree(ROOT / "portbench", copy,
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    mix = json.loads((copy / "traffic" / "closed_int8_b8.json").read_text())
    mix.update(name="closed_int8_b4", params=dict(mix["params"], batch=4))
    (copy / "traffic" / "closed_int8_b4.json").write_text(json.dumps(mix))
    cell = json.loads((copy / "workloads" / "msrb7_512.int8_b8.json")
                      .read_text())
    cell.update(name="msrb7_512.int8_b4", traffic="closed_int8_b4")
    (copy / "workloads" / "msrb7_512.int8_b4.json").write_text(
        json.dumps(cell))
    monkeypatch.setattr(harness, "HERE", copy)
    got, cfg = harness.cell_files("msrb7_512.int8_b4")
    assert got["params"]["batch"] == 4 and cfg["netG"] == "UNet"
    assert harness.traffic(got).__name__ == "portbench.traffic.infer_closed"


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
def test_result_line_keys(trace):
    result, _ = run("global_512.int8_b16", trace=trace)
    keys = list(result)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "checks"
    assert set(keys) - {"breakdown"} == {"correct", "attempted", "failed",
                                         "metrics", "device", "checks"}
    assert result["correct"] is True and result["failed"] == 0
    assert set(result["device"]) >= {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    want = harness.reported(BENCH, "per_layer" if trace else "end_to_end",
                            "global_512.int8_b16")
    if trace:
        # no card: the trace readers find nothing and are left out
        assert set(result["metrics"]) <= {m["name"] for m in want}
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(result["metrics"]) == {m["name"] for m in want}
        assert all(v["value"] > 0 for v in result["metrics"].values())
    for c in result["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(result)


def test_run_without_a_card_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "msrb7_512.int8_b8", "--seed", "2147483999",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, env=env, timeout=120)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA device" in p.stderr
