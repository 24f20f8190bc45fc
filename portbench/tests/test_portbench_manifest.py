"""``BENCHMARK.json`` against the benchmark's contract, and the harness
finding a cell, a configuration and a metric added as new files alone.
"""
import json
import re
import shutil
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
TEXT = re.compile(r"[^\t\n\r]{1,200}")
METRICS = MANIFEST["end_to_end"] + MANIFEST["per_layer"]
CELLS = {w["name"]: w for w in MANIFEST["workloads"]}


def _cells_reporting(metric: str) -> set:
    m = next(e for e in MANIFEST["end_to_end"] if e["name"] == metric)
    return set(m.get("workloads", CELLS))


def _reader(metric: str) -> Path:
    """The reader's file: a split quantity ``<metric>.<part>`` without one
    of its own is read by ``<metric>.py``."""
    own = ROOT / "portbench" / "metrics" / f"{metric}.py"
    return own if own.is_file() else ROOT / "portbench" / "metrics" / f"{metric.split('.')[0]}.py"


def test_top_level_keys_and_sizes():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert MANIFEST["command"] == ["python3", "portbench/run.py"]
    assert MANIFEST["paths"] == ["portbench"]
    assert isinstance(MANIFEST["run_seconds"], int) and 1 <= MANIFEST["run_seconds"] <= 51
    assert 1 <= len(MANIFEST["configs"]) <= 24 and 1 <= len(CELLS) <= 24
    assert 1 <= len(MANIFEST["end_to_end"]) <= 16 and 1 <= len(MANIFEST["per_layer"]) <= 128
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_texts_use_the_allowed_characters():
    names = [e["name"] for e in METRICS + MANIFEST["configs"] + MANIFEST["workloads"]]
    names += [w["config"] for w in CELLS.values()] + [w["traffic"] for w in CELLS.values()]
    names += [k for c in MANIFEST["configs"] for k in c["reduced"]]
    assert all(NAME.fullmatch(n) for n in names), names
    assert all(UNIT.fullmatch(m["unit"]) for m in METRICS)
    texts = [e["why"] for e in MANIFEST["configs"] + MANIFEST["workloads"]]
    texts += [m["layer"] for m in MANIFEST["per_layer"]] + [c["source"] for c in MANIFEST["configs"]]
    assert all(TEXT.fullmatch(t) for t in texts)
    for group in (METRICS, MANIFEST["configs"], MANIFEST["workloads"]):
        assert len({e["name"] for e in group}) == len(group)


def test_entries_have_just_their_keys():
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in CELLS.values():
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in MANIFEST["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
    for m in MANIFEST["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert all(m["better"] in ("lower", "higher") for m in METRICS)


def test_bounds():
    for m in MANIFEST["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m
    assert next(m for m in MANIFEST["end_to_end"] if m["name"] == "setup_s")["bound"] == 0.25


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_each_cell_names_an_existing_config_and_loop(cell):
    w = CELLS[cell]
    assert cell == f"{w['config']}.{w['traffic']}"
    traffic = json.loads((ROOT / "portbench" / "workloads" / f"{cell}.json").read_text())
    assert traffic["config"] == w["config"]
    assert (ROOT / "portbench" / "loops" / f"{traffic['loop']}.py").is_file()
    config = next(c for c in MANIFEST["configs"] if c["name"] == w["config"])
    assert config["file"] == f"portbench/configs/{w['config']}.json"
    assert json.loads((ROOT / config["file"]).read_text())["name"] == w["config"]


def test_every_config_is_used_and_no_cell_takes_four_chips():
    assert {c["name"] for c in MANIFEST["configs"]} == {w["config"] for w in CELLS.values()}
    assert all(w["chips"] == 1 for w in CELLS.values())


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_every_metric_has_a_reader_and_its_moves_target_is_reported(metric):
    assert _reader(metric["name"]).is_file()
    if "moves" in metric:
        assert set(metric["workloads"]) <= set(CELLS)
        assert set(metric["workloads"]) <= _cells_reporting(metric["moves"])


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    for cell in CELLS:
        ends = {m["name"] for m in MANIFEST["end_to_end"] if cell in m.get("workloads", CELLS)}
        assert "setup_s" in ends and len(ends) >= 2
        assert any(cell in m["workloads"] for m in MANIFEST["per_layer"])


def test_a_new_cell_config_and_metric_are_found_from_new_files(tmp_path):
    """A copy of the benchmark gains a configuration, a traffic mix and a
    per-layer metric as new files (and their entries in the manifest):
    a CPU run of the new cell finds all three."""
    from portbench.harness import cell

    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    manifest = json.loads(json.dumps(MANIFEST))
    config = json.loads((ROOT / "portbench/configs/router-1k.json").read_text())
    config.update(name="router-2k", replicas=2000, capacity=2048)
    (tmp_path / "portbench/configs/router-2k.json").write_text(json.dumps(config))
    traffic = json.loads((ROOT / "portbench/workloads/router-1k.storm.json").read_text())
    traffic.update(config="router-2k", batch_keys=4096, compare_batches=2,
                   bursts={"every_s": 0.05, "size": 8})
    (tmp_path / "portbench/workloads/router-2k.flap.json").write_text(json.dumps(traffic))
    (tmp_path / "portbench/metrics/bursts_per_s.py").write_text(
        "def read(run):\n    return len(run.window.burst_s) / run.window.seconds\n")
    manifest["configs"].append({"name": "router-2k", "source": "https://arxiv.org/abs/2306.09783",
                                "file": "portbench/configs/router-2k.json", "reduced": [],
                                "why": "a larger fleet"})
    manifest["workloads"].append({"name": "router-2k.flap", "config": "router-2k",
                                  "traffic": "flap", "chips": 1, "why": "bursts of 8"})
    manifest["per_layer"].append({"name": "bursts_per_s", "unit": "1/s", "better": "higher",
                                  "source": "program_span", "layer": "fleet lifecycle",
                                  "moves": "keys_per_s", "workloads": ["router-2k.flap"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    result, _ = cell.run(tmp_path, "router-2k.flap", 2**31 + 99, 0.4, True,
                         t_start=time.perf_counter(), device="cpu", overrides={"profile_s": 0.1})
    assert result["correct"]
    assert result["metrics"]["bursts_per_s"]["value"] > 0
    assert set(result["metrics"]) == {"bursts_per_s"}  # the others name their cells
    assert list(result)[-1] == "checks"
