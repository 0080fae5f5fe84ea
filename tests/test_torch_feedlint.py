"""The port's feedlint (``repro_torch.analysis``) against ``repro``'s.

Every fixture of tests/test_feedlint.py goes through both linters, which
must give the same (rule, line) findings: each of that file's test
functions runs with its ``run_paths`` replaced by one that runs both
linters and compares them (its own assertions still hold on ``repro``'s
findings), and each module-level fixture source is linted as it stands
and in its ``repro_torch.analysis.annotations`` form.  The fixtures are
read from that file, never edited.  Then the port's own rules: its R3
table names the PyTorch calls that block (``torch.cuda.synchronize``,
``torch.save``, ``torch.load``) and the hand kernels' launch, not
``jax``'s; its CLI's exit codes; and the port's tree linted to zero
findings."""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.analysis import annotations as j_ann
from repro.analysis import feedlint as j_lint
from repro_torch.analysis import annotations as t_ann
from repro_torch.analysis import feedlint as t_lint

REPO = Path(__file__).resolve().parents[1]


def _load_fixtures():
    spec = importlib.util.spec_from_file_location(
        "_feedlint_fixtures", REPO / "tests" / "test_feedlint.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


FIX = _load_fixtures()
# the CLI and the real-tree pin run repro's own tree and command
NOT_FIXTURES = {"test_cli_nonzero_on_violation_zero_on_clean",
                "test_real_tree_is_finding_free"}
FIXTURE_TESTS = sorted(n for n in vars(FIX) if n.startswith("test_")
                       and n not in NOT_FIXTURES)
FIXTURE_SOURCES = sorted(n for n, v in vars(FIX).items()
                         if n.isupper() and isinstance(v, str))


def _key(findings):
    return [(f.rule, f.line) for f in findings]


def rules_of(findings):
    return sorted({f.rule for f in findings})


def _torch_form(path: Path) -> Path:
    """The fixture with its annotations import in the port's form (the
    same lines), in a sibling directory under the same file name."""
    out = path.parent / "torch_form" / path.name
    out.parent.mkdir(exist_ok=True)
    out.write_text(path.read_text().replace("repro.analysis.",
                                            "repro_torch.analysis."))
    return out


def _both(paths, extra_order=()):
    """repro's findings, after holding the port's to them: on the same
    files, and on their repro_torch form."""
    want = j_lint.run_paths(paths, extra_order=extra_order)
    got = t_lint.run_paths(paths, extra_order=extra_order)
    assert _key(got) == _key(want)
    torch_paths = [str(_torch_form(Path(p))) for p in paths]
    assert _key(t_lint.run_paths(torch_paths, extra_order=extra_order)) \
        == _key(want)
    _both.calls += 1
    return want


_both.calls = 0


@pytest.mark.parametrize("name", FIXTURE_TESTS)
def test_fixture_test_gives_the_same_findings(name, tmp_path, monkeypatch):
    monkeypatch.setattr(FIX, "run_paths", _both)
    before = _both.calls
    getattr(FIX, name)(tmp_path)
    assert _both.calls > before


@pytest.mark.parametrize("name", FIXTURE_SOURCES)
def test_fixture_source_gives_the_same_findings(name, tmp_path):
    f = tmp_path / "fixture.py"
    f.write_text(getattr(FIX, name))
    want = _both([str(f)])
    # a violation fixture fires, a clean one does not
    assert bool(want) == ("VIOLATION" in name or "NESTED" in name)


def test_fixtures_were_found():
    assert len(FIXTURE_TESTS) >= 28
    assert {"R1_VIOLATION", "R1_CLEAN", "R3_VIOLATION", "R5_VIOLATION",
            "R6_VIOLATION"} <= set(FIXTURE_SOURCES)


def test_annotations_keep_repro_rules_and_lock_names():
    """The same rules and every one of repro's declared edges; the port
    adds only edges of its own kernel-build locks."""
    assert set(t_ann.RULES) == set(j_ann.RULES)
    assert set(j_ann.LOCK_ORDER) <= set(t_ann.LOCK_ORDER)
    extra = set(t_ann.LOCK_ORDER) - set(j_ann.LOCK_ORDER)
    assert extra and all("kernel-build" in b for _, b in extra)
    assert t_ann.guarded_by("_lock") == j_ann.guarded_by("_lock")
    assert t_ann.write_guarded_by("_l") == j_ann.write_guarded_by("_l")


# ---------------------------------------------------------------------------
# R3 in the port: PyTorch's blocking calls and the hand kernels' launch
# ---------------------------------------------------------------------------

R3_TORCH_VIOLATION = '''
import threading
import torch

class Uploader:
    def __init__(self):
        self._lock = threading.Lock()   # lock-name: uploader
        self._n = 0                     # guarded-by: _lock

    def flush(self, x, path):
        with self._lock:
            self._n += 1
            torch.cuda.synchronize()    # BAD: waits for the device
            torch.save(x, path)         # BAD: file I/O
            return torch.load(path)     # BAD: file I/O
'''

R3_TORCH_CLEAN = '''
import threading
import torch

class Uploader:
    def __init__(self):
        self._lock = threading.Lock()   # lock-name: uploader
        self._n = 0                     # guarded-by: _lock

    def flush(self, x, path):
        with self._lock:
            self._n += 1
        torch.cuda.synchronize()
        torch.save(x, path)
        return torch.load(path)
'''

R3_LAUNCH = '''
import threading

class CudaKernel:
    def launch(self, symbol, device, *args):
        pass

class Stage:
    def __init__(self, kernel: CudaKernel):
        self._lock = threading.Lock()   # lock-name: stage
        self._kernel = kernel
        self._rows = 0                  # guarded-by: _lock

    def push(self, n):
        with self._lock:
            self._rows += n
            self._kernel.launch("k", None, n)   # BAD: a launch
'''


def _lint(tmp_path, linter, source):
    f = tmp_path / "fixture.py"
    f.write_text(source)
    return linter.run_paths([str(f)])


def _line(source, marker):
    return next(i for i, text in enumerate(source.splitlines(), 1)
                if marker in text)


def test_r3_torch_sync_save_load_under_lock_fire(tmp_path):
    found = _lint(tmp_path, t_lint, R3_TORCH_VIOLATION)
    assert _key(found) == [
        ("blocking-under-lock", _line(R3_TORCH_VIOLATION, marker))
        for marker in ("synchronize", "torch.save", "torch.load")]
    assert "torch.cuda.synchronize()" in found[0].msg
    assert "uploader" in found[0].msg
    # repro's table names jax's calls, not torch's
    assert _lint(tmp_path, j_lint, R3_TORCH_VIOLATION) == []


def test_r3_torch_calls_after_release_are_clean(tmp_path):
    assert _lint(tmp_path, t_lint, R3_TORCH_CLEAN) == []


def test_r3_torch_allow_comment_and_blocking_ok_lock(tmp_path):
    allowed = R3_TORCH_VIOLATION.replace(
        "        with self._lock:",
        "        with self._lock:  # feedlint: allow[blocking-under-lock] rig")
    assert _lint(tmp_path, t_lint, allowed) == []
    exempt = R3_TORCH_VIOLATION.replace("# lock-name: uploader",
                                        "# lock-name: uploader blocking-ok")
    assert _lint(tmp_path, t_lint, exempt) == []


def test_r3_kernel_launch_under_lock_fires(tmp_path):
    found = _lint(tmp_path, t_lint, R3_LAUNCH)
    assert _key(found) == [("blocking-under-lock",
                            _line(R3_LAUNCH, "BAD"))]
    assert "CudaKernel.launch() kernel launch" in found[0].msg
    clean = R3_LAUNCH.replace(
        '            self._kernel.launch("k", None, n)   # BAD: a launch',
        "        self._kernel.launch(\"k\", None, n)")
    assert _lint(tmp_path, t_lint, clean) == []


def test_r3_jax_calls_are_not_the_ports_blocking_calls(tmp_path):
    src = FIX.R3_VIOLATION.replace("time.sleep(0.1)", "jax.jit(f)").replace(
        "import time", "import jax")
    assert rules_of(_lint(tmp_path, j_lint, src)) == ["blocking-under-lock"]
    assert _lint(tmp_path, t_lint, src) == []


def test_module_names_root_at_repro_torch():
    assert t_lint._dotted_of(Path("src/repro_torch/core/feed.py")) == \
        "repro_torch.core.feed"
    assert t_lint._dotted_of(
        Path("src/repro_torch/core/enrich/__init__.py")) == \
        "repro_torch.core.enrich"
    assert j_lint._dotted_of(Path("src/repro/core/feed.py")) == \
        "repro.core.feed"


# ---------------------------------------------------------------------------
# CLI and the port's tree
# ---------------------------------------------------------------------------

def _cli(*args, module=True):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    if module:
        env["PYTHONPATH"] = str(REPO / "src")
        cmd = [sys.executable, "-m", "repro_torch.analysis.feedlint"]
    else:   # a bare runner: the file, no package on the path
        cmd = [sys.executable, str(REPO / "src" / "repro_torch" / "analysis"
                                   / "feedlint.py")]
    return subprocess.run(cmd + list(args), capture_output=True, text=True,
                          env=env, cwd=str(REPO))


@pytest.mark.parametrize("module", [True, False])
def test_cli_nonzero_on_violation_zero_on_clean(tmp_path, module):
    bad = tmp_path / "bad.py"
    bad.write_text(R3_TORCH_VIOLATION)
    good = tmp_path / "good.py"
    good.write_text(R3_TORCH_CLEAN)
    r = _cli(str(bad), module=module)
    assert r.returncode != 0
    assert "blocking-under-lock" in r.stdout
    assert "3 findings" in r.stdout
    r = _cli(str(good), module=module)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "0 findings" in r.stdout


def test_port_tree_is_finding_free():
    """src/repro_torch has zero findings under the port's linter."""
    findings = t_lint.run_paths([str(REPO / "src" / "repro_torch")])
    assert findings == [], "\n".join(str(f) for f in findings)


def test_port_cli_over_its_tree_exits_zero():
    r = _cli("src/repro_torch")
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.strip().startswith("feedlint: 0 findings")
