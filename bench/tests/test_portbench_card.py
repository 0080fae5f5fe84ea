"""Each cell once on the card, short: it prints a correct result line.
Skips without a card (run on one: ``python -m pytest -m cuda
bench/tests``)."""

import json
import subprocess
import sys

import pytest

from bench.harness import env

CELLS = [w["name"] for w in json.loads(
    (env.ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_correct_on_the_card(workload):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run([sys.executable, str(env.BENCH / "run.py"),
                        "--workload", workload, "--seed", "2147483659",
                        "--seconds", "5", "--trace", "0"],
                       cwd=env.ROOT, capture_output=True, text=True,
                       timeout=1200)
    assert p.returncode == 0, p.stderr[-4000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"], line
    assert line["device"]["platform"] == "gpu"
