"""tft-torch-lint, the port's copy of tft-lint: the whole suite runs clean
over torchft_tpu_torch/ with empty baselines, every pass's selftest passes,
and every seeded violation draws the same findings from the port's pass as
from the JAX package's pass over the same temporary tree."""

import importlib
import json
import os
import subprocess
import sys
import textwrap

import pytest

from torchft_tpu.analysis import PASSES as JAX_PASSES
from torchft_tpu.analysis import core as jax_core
from torchft_tpu_torch.analysis import PASSES, Project, run_passes
from torchft_tpu_torch.analysis.cli import main as lint_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "torchft_tpu_torch")

#: pass id -> (module under analysis/, the function its selftest runs)
_ENTRY = {
    "lock-discipline": ("lock_discipline", "run"),
    "env-hygiene": ("env_hygiene", "run"),
    "metrics-sync": ("metrics_sync", "run"),
    "metrics-cardinality": ("metrics_cardinality", "run"),
    "retry-ban": ("retry_ban", "run"),
    "fault-coverage": ("coverage", "run"),
    "wire-drift": ("wire_schema", "run_checks"),
    "span-vocab": ("span_vocab", "run"),
    "plan-discipline": ("plan_discipline", "run"),
}


def _key(findings):
    """What the two packages must agree on: code, file, line and symbol
    exactly; the message up to the package name in a path."""
    return sorted(
        (f.pass_id, f.code, f.file.replace("torchft_tpu_torch", "torchft_tpu"),
         f.line, f.symbol,
         f.message.replace("torchft_tpu_torch", "torchft_tpu"))
        for f in findings
    )


def _twin(monkeypatch, pass_id):
    """Make the port's pass also run the JAX pass on every input its
    selftest builds; returns the ``(port, jax)`` finding pairs."""
    mod_name, fn_name = _ENTRY[pass_id]
    port_mod = importlib.import_module(f"torchft_tpu_torch.analysis.{mod_name}")
    jax_mod = importlib.import_module(f"torchft_tpu.analysis.{mod_name}")
    port_fn, jax_fn = getattr(port_mod, fn_name), getattr(jax_mod, fn_name)
    pairs = []

    def both(*args, **kwargs):
        got = list(port_fn(*args, **kwargs))
        if fn_name == "run":
            args = (jax_core.Project(args[0].root, args[0].py_files),) + args[1:]
        pairs.append((got, list(jax_fn(*args, **kwargs))))
        return got

    monkeypatch.setattr(port_mod, fn_name, both)
    return pairs


_ENTRYPOINT = """
import json, runpy, sys
sys.argv = ["tft-torch-lint", "torchft_tpu_torch/", "--json"]
try:
    runpy.run_module("torchft_tpu_torch.analysis", run_name="__main__")
    rc = 0
except SystemExit as e:
    rc = e.code
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "torchft_tpu"))
print(json.dumps({"rc": rc, "bad": bad}))
"""


@pytest.fixture(scope="module")
def tree_lint():
    """`python -m torchft_tpu_torch.analysis torchft_tpu_torch/ --json` in a
    fresh interpreter: its report, exit code, and the jax or JAX-package
    modules it imported on the way."""
    proc = subprocess.run(
        [sys.executable, "-c", _ENTRYPOINT], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    out = proc.stdout.strip()
    tail = json.loads(out.splitlines()[-1])
    report = json.loads(out[: out.rindex("\n")])
    return proc, report, tail


class TestSuiteIsClean:
    def test_tree_lints_clean_with_empty_baselines(self, tree_lint):
        """The CI invocation exits 0: every invariant holds on the port,
        with nothing grandfathered."""
        proc, report, tail = tree_lint
        assert tail["rc"] == 0, proc.stdout + proc.stderr
        assert sorted(report["passes"]) == sorted(p.id for p in PASSES)
        for pass_id, res in report["passes"].items():
            assert res == {"findings": [], "baselined": 0}, (pass_id, res)
        assert report["files"] >= 90

    def test_entrypoint_imports_neither_jax_nor_the_jax_package(self, tree_lint):
        proc, _report, tail = tree_lint
        assert tail["bad"] == [], proc.stdout

    def test_baseline_files_ship_empty(self):
        bdir = os.path.join(PKG, "analysis", "baselines")
        assert sorted(os.listdir(bdir)) == sorted(f"{p.id}.txt" for p in PASSES)
        for p in PASSES:
            lines = [
                ln for ln in open(os.path.join(bdir, f"{p.id}.txt"),
                                  encoding="utf-8").read().splitlines()
                if ln.strip() and not ln.lstrip().startswith("#")
            ]
            assert lines == [], f"{p.id} baseline is not empty: {lines}"

    def test_passes_are_the_jax_suites_in_its_order(self):
        assert [p.id for p in PASSES] == [p.id for p in JAX_PASSES]
        assert [p.doc for p in PASSES] == [p.doc for p in JAX_PASSES]


class TestSelftests:
    @pytest.mark.parametrize("pass_id", list(_ENTRY), ids=str)
    def test_pass_selftest_matches_jax(self, monkeypatch, pass_id):
        """The port's selftest passes, and each snippet it plants (bad and
        good) draws the JAX pass's findings."""
        pairs = _twin(monkeypatch, pass_id)
        next(p for p in PASSES if p.id == pass_id).selftest()
        assert pairs, f"{pass_id}: the selftest ran nothing"
        assert any(got for got, _ in pairs), f"{pass_id}: no seeded finding"
        for got, want in pairs:
            assert _key(got) == _key(want)

    def test_selftest_cli(self, capsys):
        assert lint_main(["--selftest"]) == 0
        out = capsys.readouterr().out
        assert out.count(": ok") == len(PASSES)


# One seeded violation per pass (the JAX package's tier-1 set, in the
# port's idiom), planted in a synthetic tree.
_SEEDED = {
    "lock-discipline": {
        "pkg/bad.py": textwrap.dedent(
            """
            import time, threading
            _lock = threading.Lock()
            def f():
                with _lock:
                    time.sleep(1)
            """
        ),
    },
    "env-hygiene": {
        "pkg/bad.py": 'import os\nX = os.environ.get("TORCHFT_SNEAKY", "")\n',
    },
    "metrics-sync": {
        "pkg/bad.py": (
            "from torchft_tpu_torch.utils.metrics import counter\n"
            'M = counter("myapp_rogue_total", "wrong namespace")\n'
        ),
    },
    "metrics-cardinality": {
        "pkg/bad.py": textwrap.dedent(
            """
            from torchft_tpu_torch.utils.metrics import gauge
            G = gauge("torchft_peer_lag", "d")
            def export(peers):
                for p in peers:
                    G.labels(peer=p.addr).set(p.lag)
            """
        ),
    },
    "retry-ban": {
        "pkg/bad.py": textwrap.dedent(
            """
            import time
            def fetch():
                while True:
                    try:
                        return do()
                    except ConnectionError:
                        time.sleep(1)
            """
        ),
    },
    "fault-coverage": {
        "pkg/utils/faults.py": 'KNOWN_SITES = ("pg.allreduce",)\n',
        "pkg/bad.py": (
            "from torchft_tpu_torch.utils import faults\n"
            'faults.check("pg.allreduce")\n'
            'faults.check("pg.not_a_site")\n'
        ),
    },
    "plan-discipline": {
        "pkg/bad.py": textwrap.dedent(
            """
            from torchft_tpu_torch.ops import topology

            def sneaky_side_channel(world):
                topo = topology.parse_topology("hosts:2", world)
                return topology.synthesize_plan(topo, 0)
            """
        ),
    },
    "span-vocab": {
        "pkg/manager.py": 'PROTOCOL_PHASES = ("ring", "commit")\n',
        "pkg/bad.py": textwrap.dedent(
            """
            def emit(tracer):
                tracer.export_span("made_up_phase", "t", 0, 1)
            """
        ),
    },
}


def _plant(tmp_path, files):
    (tmp_path / "docs").mkdir(exist_ok=True)
    (tmp_path / "docs" / "observability.md").write_text("")
    (tmp_path / "docs" / "robustness.md").write_text("`pg.allreduce`\n")
    paths = []
    for rel, src in files.items():
        path = tmp_path / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(src)
        paths.append(str(path))
    return paths


class TestSeededViolations:
    @pytest.mark.parametrize("pass_id", sorted(_SEEDED), ids=str)
    def test_seeded_violation_is_caught_as_jax_catches_it(self, tmp_path, pass_id):
        paths = _plant(tmp_path, _SEEDED[pass_id])
        nobase = str(tmp_path / "nobase")
        port = next(p for p in PASSES if p.id == pass_id)
        jax = next(p for p in JAX_PASSES if p.id == pass_id)
        got = [f for r in run_passes([port], Project(str(tmp_path), paths), nobase)
               for f in r.findings]
        want = [f for r in jax_core.run_passes(
            [jax], jax_core.Project(str(tmp_path), paths), nobase) for f in r.findings]
        assert any(f.pass_id == pass_id for f in got), f"{pass_id} missed its seed"
        assert _key(got) == _key(want)

    def test_cli_exits_nonzero_on_seeded_violation(self, tmp_path, capsys):
        paths = _plant(tmp_path, _SEEDED["retry-ban"])
        rc = lint_main([*paths, "--passes", "retry-ban", "--baseline-dir",
                        str(tmp_path / "nb")])
        assert rc == 1
        assert "sleep-in-loop" in capsys.readouterr().out


class TestPortConstants:
    """Where the JAX pass names something the port lacks, the port's pass
    names its counterpart; no rule is added or dropped."""

    def _env_findings(self, tmp_path, src):
        paths = _plant(tmp_path, {"pkg/knobs.py": src})
        lint_pass = next(p for p in PASSES if p.id == "env-hygiene")
        return [f for r in run_passes([lint_pass], Project(str(tmp_path), paths),
                                      str(tmp_path / "nb")) for f in r.findings]

    @pytest.mark.parametrize("name,allowed", [
        ("CUDA_HOME", True), ("XDG_CACHE_HOME", True),
        ("XLA_FLAGS", False), ("JAX_PLATFORMS", False),
    ])
    def test_external_env_names_are_the_ports(self, tmp_path, name, allowed):
        found = self._env_findings(
            tmp_path,
            "from torchft_tpu_torch.utils.env import env_str\n"
            f'x = env_str("{name}")\n',
        )
        assert [f.code for f in found] == ([] if allowed else ["non-torchft-knob"])

    def test_the_kernel_build_reads_env_through_the_helpers(self):
        """`_kernels.py` reads CUDA_HOME and XDG_CACHE_HOME through
        utils/env.py, never os.environ directly."""
        path = os.path.join(PKG, "_kernels.py")
        lint_pass = next(p for p in PASSES if p.id == "env-hygiene")
        results = run_passes([lint_pass], Project(REPO, [path]))
        assert [f for r in results for f in r.findings] == []
        src = open(path, encoding="utf-8").read()
        assert 'env_str("CUDA_HOME"' in src and 'env_str("XDG_CACHE_HOME")' in src


class TestBaselineWorkflow:
    def test_write_baseline_then_clean(self, tmp_path, capsys):
        paths = _plant(tmp_path, _SEEDED["retry-ban"])
        bdir = str(tmp_path / "baselines")
        base = [*paths, "--passes", "retry-ban", "--baseline-dir", bdir]
        assert lint_main([*base, "--write-baseline"]) == 0
        assert lint_main([*base, "--write-baseline"]) == 0  # idempotent
        capsys.readouterr()
        assert lint_main(base) == 0
        assert "1 baselined" in capsys.readouterr().out
        bad = tmp_path / "pkg" / "bad.py"
        bad.write_text("# moved\n# down\n" + bad.read_text())
        assert lint_main(base) == 0
