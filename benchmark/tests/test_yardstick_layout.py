"""BENCHMARK.json against the files it names, the contract's shapes of
names and keys, and the data-driven layout: a new configuration, traffic
mix and per-layer metric are new files and new entries, no edit."""
import json
import re
import shutil
import sys

import pytest

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
SPEC = harness.spec()


def test_every_piece_a_cell_names_exists_and_parses():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    configs = {c["name"]: c for c in SPEC["configs"]}
    for w in SPEC["workloads"]:
        cfg = harness.load_json("configs", w["config"])
        assert configs[w["config"]]["file"] == f"benchmark/configs/{w['config']}.json"
        assert cfg["name"] == w["config"] and cfg["source"] == configs[w["config"]]["source"]
        assert sorted(cfg["reduced"]) == sorted(configs[w["config"]]["reduced"])
        traffic = harness.load_json("traffic", w["traffic"])
        harness.module("drivers", traffic["driver"])
        harness.module("families", cfg["family"])
        harness.port_config(cfg)  # the file states the program's config
        assert harness.load_json("limits", w["name"])
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in SPEC["per_layer"]:
        assert callable(harness.metric_reader(m["name"]))


def test_names_units_and_keys():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in SPEC[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert re.match(r"^[A-Za-z0-9_/%.\-]{1,16}$", m["unit"]) and m["better"] in (
            "lower", "higher")
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert {m["name"] for m in SPEC["end_to_end"]} >= {"setup_s"}
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_each_cell_reports_what_its_metrics_move(cell):
    e2e = {m["name"] for m in SPEC["end_to_end"] if harness.applies(m, cell)}
    layers = [m for m in SPEC["per_layer"] if harness.applies(m, cell)]
    assert "setup_s" in e2e and len(e2e) >= 2 and layers
    for m in layers:
        assert m["moves"] in e2e, (m["name"], m["moves"])
    assert any("mfu" in m["name"] for m in layers)


def test_a_new_config_traffic_and_metric_are_new_files(tmp_path, monkeypatch):
    """Copy the benchmark, add a configuration, a traffic mix, limits and a
    per-layer metric as new files and entries, and find each by name."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads(json.dumps(SPEC))
    bench = root / "benchmark"
    cfg = json.loads((bench / "configs" / "imagenet256_uvit_large.json").read_text())
    cfg["name"] = "imagenet256_uvit_large_b64"
    cfg["config"]["train"]["batch_size"] = 64
    (bench / "configs" / "imagenet256_uvit_large_b64.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "requests_b8.json").write_text(json.dumps(
        {"driver": "generate", "why": "x", "request_images": 8, "check_images": 4}))
    (bench / "limits" / "new_cell.json").write_text(json.dumps({"image_rel_l2": 0.1}))
    (bench / "metrics" / "requests.gen.py").write_text(
        "def read(record):\n    return record['requests']\n")
    spec["configs"].append({"name": cfg["name"], "source": cfg["source"], "reduced": ["train"],
                            "file": "benchmark/configs/imagenet256_uvit_large_b64.json",
                            "why": "x"})
    spec["workloads"].append({"name": "new_cell", "config": cfg["name"],
                              "traffic": "requests_b8", "chips": 1, "why": "x"})
    spec["per_layer"].append({"name": "requests.gen", "unit": "requests", "better": "higher",
                              "source": "host_clock", "layer": "serving", "moves":
                              "gen_images_per_s", "workloads": ["new_cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    before = {p: p.read_bytes() for p in harness.BENCH.rglob("*") if p.is_file()
              and "__pycache__" not in p.parts}
    for mod in [m for m in sys.modules if m == "benchmark" or m.startswith("benchmark.")]:
        monkeypatch.delitem(sys.modules, mod)
    monkeypatch.syspath_prepend(str(root))
    import benchmark.harness as copied

    assert copied.ROOT == root
    ctx = copied.make_context("new_cell", 1, 1, 1, "cpu")
    assert ctx.traffic["request_images"] == 8 and ctx.cfg["name"] == cfg["name"]
    assert copied.port_config(ctx.cfg).train.batch_size == 64
    assert copied.metric_reader("requests.gen")({"requests": 3}) == 3
    record = {"requests": 3, "attempted": 3, "failed": 0, "peak_bytes": 0}
    assert copied.result(ctx, record)["metrics"] == {"requests.gen": {"value": 3,
                                                                      "unit": "requests"}}
    after = {p: p.read_bytes() for p in harness.BENCH.rglob("*") if p.is_file()
             and "__pycache__" not in p.parts}
    assert before == after
