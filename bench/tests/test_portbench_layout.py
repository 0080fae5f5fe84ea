"""The harness finds each piece of a cell by the name BENCHMARK.json
gives: a configuration, a traffic mix, a cell and a metric added as new files and entries run with no other change."""

import json

import torch

from bench.harness import env
from bench.harness.cell import load_cell
from bench.run import run_cell
from bench.tests import tiny

env.prepare()


def _add_cell(root):
    """A new configuration, traffic mix, cell, limits and metric, as
    files and entries only."""
    bench = root / "bench"
    cf = dict(tiny.DENSE, name="tiny-dense-wide", intermediate_size=256)
    (bench / "configs" / "tiny-dense-wide.json").write_text(json.dumps(cf))
    tr = dict(tiny.SERVE, new_tokens=3, clients=1)
    (bench / "traffic" / "tiny_three.json").write_text(json.dumps(tr))
    # docs_done.three has no file: it reads as docs_done.py
    (bench / "metrics" / "docs_done.py").write_text(
        "def read(run):\n    return float(len(run['docs']))\n")
    (bench / "limits" / "enrich.tiny-dense-wide.three.json").write_text(
        json.dumps(tiny.LIMITS["serve"]))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": cf["name"], "source": "test",
                            "file": "bench/configs/tiny-dense-wide.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "enrich.tiny-dense-wide.three",
                              "config": cf["name"], "traffic": "tiny_three",
                              "chips": 1, "why": "test"})
    spec["end_to_end"].append({"name": "docs_done.three", "unit": "docs",
                               "better": "higher", "bound": 0.05,
                               "source": "host_clock",
                               "workloads": ["enrich.tiny-dense-wide.three"]})
    for m in spec["end_to_end"]:
        if m["name"] in ("enrich_docs_per_s", "enrich_latency_p95_ms"):
            m["workloads"].append("enrich.tiny-dense-wide.three")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))


def test_a_cell_added_as_files_and_entries_runs(tmp_path):
    root = tiny.make(tmp_path)
    _add_cell(root)
    cell = load_cell("enrich.tiny-dense-wide.three", root)
    assert cell.config["intermediate_size"] == 256
    assert cell.traffic["clients"] == 1
    assert [m["name"] for m in cell.end_to_end] == [
        "setup_s", "enrich_docs_per_s", "enrich_latency_p95_ms",
        "docs_done.three"]
    line, _ = run_cell(cell, 7, 1.0, False, torch.device("cpu"), 0.0)
    assert line["correct"], line
    assert line["metrics"]["docs_done.three"]["value"] == \
        line["attempted"] > 0
    assert set(line["checks"]) == {"served_logit_gap"}


def test_each_cell_names_its_files():
    """Every cell of the repository's BENCHMARK.json has its
    configuration, traffic, driver, limits and a reader per metric."""
    spec = json.loads((env.ROOT / "BENCHMARK.json").read_text())
    for w in spec["workloads"]:
        cell = load_cell(w["name"])
        cell.driver()
        for m in cell.end_to_end + cell.per_layer:
            assert hasattr(cell.reader(m["name"]), "read"), m["name"]
        assert cell.limits, w["name"]
        assert any(m["name"] != "setup_s" for m in cell.end_to_end)
        assert cell.per_layer
