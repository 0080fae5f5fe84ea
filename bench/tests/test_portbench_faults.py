"""A run with the timed path broken underneath comes out not correct:
the harness's look for a card skipped, the rest of a run driven at a
tiny size on the CPU, once for each fault a cell can have.  The control
(the reference in float8 in the program's place) fails too."""

import pytest
import torch

from bench.control import planted
from bench.harness import env
from bench.harness.cell import load_cell
from bench.run import run_cell
from bench.tests import tiny

env.prepare()
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make(tmp_path_factory.mktemp("tiny"))


CASES = [("enrich.tiny-dense.serve", "none", True),
         ("enrich.tiny-dense.serve", "token", False),
         ("train.tiny-moe.feed", "none", True),
         ("train.tiny-moe.feed", "token", False),
         ("train.tiny-moe.feed", "half_batch", False),
         ("train.tiny-moe.feed", "frozen_state", False),
         ("train.tiny-dense.feed", "half_batch", False)]


@pytest.mark.parametrize("workload,fault,correct", CASES,
                         ids=[f"{w}-{f}" for w, f, _ in CASES])
def test_fault_reads_not_correct(root, workload, fault, correct):
    cell = load_cell(workload, root)
    with planted(fault):
        line, checks = run_cell(cell, 11, 1.0, False, CPU, 0.0)
    assert line["correct"] is correct, checks


@pytest.mark.parametrize("workload", ["enrich.tiny-dense.serve",
                                      "train.tiny-moe.feed"])
def test_control_fails_a_limit(root, workload):
    cell = load_cell(workload, root)
    driver = cell.driver()
    rec = driver.run(cell, 12, 1.0, False, CPU, 0.0)
    sound = driver.check(rec, CPU)
    control = driver.check(rec, CPU, precision="fp8")
    assert all(sound[k] <= lim for k, lim in cell.limits.items()), sound
    assert any(control[k] > lim for k, lim in cell.limits.items()), control


def test_token_fault_counts_batch_positions(root):
    cell = load_cell("train.tiny-dense.feed", root)
    with planted("token"):
        _, checks = run_cell(cell, 13, 0.5, False, CPU, 0.0)
    assert checks["batch_mismatch"][0] >= 1
