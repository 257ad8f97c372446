"""BENCHMARK.json against the contract, and the harness finding a cell's
files by name, also for a cell added as data files only."""

import json
import re
import shutil
import subprocess
import sys

import pytest

import bench_paths  # noqa: F401
from bench_paths import BENCH_DIR, ROOT
from harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.benchmark(ROOT)


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_configs_cells_and_metrics_follow_the_contract():
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).exists()
        assert spec.load_json(ROOT / c["file"])["reduced"] == c["reduced"]
    cells = {w["name"]: w for w in BENCH["workloads"]}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert w["config"] in configs and w["chips"] in (1, 4) and len(w["why"]) <= 200
    assert {w["config"] for w in BENCH["workloads"]} == set(configs)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= set(cells)
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert all(m["moves"] in [x["name"] for x in spec.cell(BENCH, c, ROOT)["end_to_end"]]
                   for c in m["workloads"])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_files_by_name(cell):
    c = spec.cell(BENCH, cell, ROOT)
    assert spec.driver(c["traffic"]).__name__ == "Driver"
    assert c["limits"] and all(v >= 0 for v in c["limits"].values())
    names = [m["name"] for m in c["end_to_end"]]
    assert "setup_s" in names and len(names) >= 2 and c["per_layer"]
    for m in c["end_to_end"] + c["per_layer"]:
        assert callable(spec.reader(m["name"]))


NEW_CELL = r"""
import json, sys
sys.path[:0] = [sys.argv[1] + "/benchmark", sys.argv[1]]
from pathlib import Path
from harness import spec
root = Path(sys.argv[1])
cell = spec.cell(spec.benchmark(root), "recon.short8", root)
print(json.dumps({"traffic": cell["traffic"]["frames"], "limits": cell["limits"],
                  "driver": spec.driver(cell["traffic"]).__module__,
                  "metrics": [m["name"] for m in cell["per_layer"]],
                  "value": spec.reader("frames_seen.recon")({"work": {"frames": 24}})}))
"""


def test_a_cell_added_as_data_files_only_is_found(tmp_path):
    shutil.copytree(BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "recon.short8", "config": "geo4d_recon",
                               "traffic": "short8", "chips": 1, "why": "a test cell"})
    bench["per_layer"].append({"name": "frames_seen.recon", "unit": "frames", "better": "higher",
                               "source": "host_clock", "layer": "pipeline", "moves": "s_per_frame",
                               "workloads": ["recon.short8"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    traffic = spec.load_json(BENCH_DIR / "traffic" / "sintel32.json")
    (tmp_path / "benchmark/traffic/short8.json").write_text(json.dumps(dict(traffic, frames=24)))
    (tmp_path / "benchmark/cells/recon.short8.json").write_text(json.dumps({"limits": {"x": 1}}))
    (tmp_path / "benchmark/metrics/frames_seen.recon.py").write_text(
        "def read(record):\n    return record['work']['frames']\n")
    out = subprocess.run([sys.executable, "-c", NEW_CELL, str(tmp_path)], capture_output=True,
                         text=True, check=True)
    got = json.loads(out.stdout)
    assert got == {"traffic": 24, "limits": {"x": 1}, "driver": "drivers.reconstruct",
                   "metrics": ["frames_seen.recon"], "value": 24}
