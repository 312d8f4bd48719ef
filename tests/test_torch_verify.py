"""tft-torch-verify, the port's copy of tft-verify, held against the JAX
package's model checker: every scenario, mutation and liveness schedule
gives the same verdict, caught invariant, state and transition counts; a
counterexample renders through the port's post-mortem CLI; and the port's
Manager records exactly the phase vocabulary the model speaks."""

import ast
import inspect
import json
import subprocess
import sys

import pytest

from torchft_tpu.analysis import model_checker as jax_mc
from torchft_tpu.analysis import plan_verify as jax_pv
from torchft_tpu.analysis import protocol_model as jax_pm
from torchft_tpu_torch import diagnose
from torchft_tpu_torch import manager as mgr
from torchft_tpu_torch.analysis import model_checker as mc
from torchft_tpu_torch.analysis import protocol_model as pm
from torchft_tpu_torch.analysis import plan_verify as pv
from torchft_tpu_torch.analysis.verify_cli import main as verify_main
from torchft_tpu_torch.manager import PROTOCOL_PHASES


def _summary(r):
    """What the two checkers must agree on."""
    v = r.violation
    return {
        "ok": r.ok, "states": r.states, "transitions": r.transitions,
        "goals": r.goal_states, "trace": [tuple(t) for t in r.trace],
        "violation": None if v is None else (
            v.invariant, v.replica_id, v.phase, v.message),
    }


_EXPLORE = (
    [(name, "explore", name) for name in mc.SCENARIOS]
    + [("votes", "explore_votes", None)]
    + [(name, "explore_resize", name) for name in mc.RESIZE_SCENARIOS]
    + [(name, "explore_election", name) for name in mc.ELECTION_SCENARIOS]
    + [(name, "explore_restore", name) for name in mc.RESTORE_SCENARIOS]
)
_TABLES = {"explore": "SCENARIOS", "explore_resize": "RESIZE_SCENARIOS",
           "explore_election": "ELECTION_SCENARIOS",
           "explore_restore": "RESTORE_SCENARIOS"}


class TestSameAsTheJaxChecker:
    def test_tables_are_the_jax_tables(self):
        assert mc.SCENARIOS.keys() == jax_mc.SCENARIOS.keys()
        for table in _TABLES.values():
            assert repr(getattr(mc, table)) == repr(getattr(jax_mc, table))
        assert mc.LIVENESS_SCHEDULES == jax_mc.LIVENESS_SCHEDULES
        assert [(m.name, m.catches) for m in pm.MUTATIONS] == [
            (m.name, m.catches) for m in jax_pm.MUTATIONS]
        assert [(m.name, m.catches) for m in pv.PLAN_MUTATIONS] == [
            (m.name, m.catches) for m in jax_pv.PLAN_MUTATIONS]

    @pytest.mark.parametrize("name,fn,key", _EXPLORE, ids=[e[0] for e in _EXPLORE])
    def test_scenario_explores_as_jax(self, name, fn, key):
        def run(mod):
            if key is None:
                return getattr(mod, fn)()
            return getattr(mod, fn)(getattr(mod, _TABLES[fn])[key])

        got = _summary(run(mc))
        assert got == _summary(run(jax_mc))
        # the one deliberately stuck scenario excepted, each reaches a goal
        assert got["ok"] and (got["goals"] > 0 or name == "partition")

    @pytest.mark.parametrize("name", [m.name for m in pm.MUTATIONS])
    def test_mutation_is_caught_as_jax(self, name):
        got = mc.check_mutation(name)
        assert _summary(got) == _summary(jax_mc.check_mutation(name))
        catches = next(m.catches for m in pm.MUTATIONS if m.name == name)
        assert not got.ok and got.violation.invariant == catches

    @pytest.mark.parametrize("name,scenario,rotation", mc.LIVENESS_SCHEDULES,
                             ids=[s[0] for s in mc.LIVENESS_SCHEDULES])
    def test_schedule_runs_as_jax(self, name, scenario, rotation):
        got = mc.run_schedule(mc.SCENARIOS[scenario], rotation)
        want = jax_mc.run_schedule(jax_mc.SCENARIOS[scenario], rotation)
        assert got[0] and (got[0], got[1], [tuple(t) for t in got[2]]) == (
            want[0], want[1], [tuple(t) for t in want[2]])

    def test_counterexample_dump_is_the_jax_dump(self, tmp_path):
        for name in ("heal_from_stale", "serve_torn_blob"):
            a, b = tmp_path / f"{name}_port.jsonl", tmp_path / f"{name}_jax.jsonl"
            mc.write_flight_dump(mc.check_mutation(name), str(a))
            jax_mc.write_flight_dump(jax_mc.check_mutation(name), str(b))
            assert a.read_text() == b.read_text()


class TestDiagnoseRoundTrip:
    def test_counterexample_names_replica_and_phase(self, tmp_path):
        r = mc.check_mutation("heal_from_stale")
        assert not r.ok
        path = str(tmp_path / "cex.jsonl")
        mc.write_flight_dump(r, path)
        entries, warnings = diagnose.load_records([path])
        report = diagnose.analyze(entries)
        v = r.violation
        assert report["failure"]["reported_by"] == v.replica_id
        assert report["failure"]["phase"] == pm.MODEL_PHASE_OPS[v.phase] == "heal_recv"
        assert v.invariant in report["failure"]["detail"]
        assert report["culprit"]["replica_id"] == v.replica_id
        text = diagnose.render_text(entries, report, warnings)
        assert v.replica_id in text and v.invariant in text

    def test_cli_dump_renders_through_the_ports_diagnose_cli(self, tmp_path):
        """`--mutate heal_from_stale --dump` exits 1, and
        `python -m torchft_tpu_torch.diagnose <dump> --json` names the
        violating replica as culprit and the failed op's phase."""
        path = str(tmp_path / "cex.jsonl")
        assert verify_main(["--mutate", "heal_from_stale", "--dump", path]) == 1
        proc = subprocess.run(
            [sys.executable, "-m", "torchft_tpu_torch.diagnose", path, "--json"],
            capture_output=True, text=True, timeout=120,
        )
        assert proc.returncode == 0, proc.stderr
        doc = json.loads(proc.stdout)
        v = mc.check_mutation("heal_from_stale").violation
        assert doc["culprit"]["replica_id"] == doc["failure"]["reported_by"] == v.replica_id
        assert doc["failure"]["phase"] == "heal_recv"


def _recorded_phases(module):
    recorded = set()
    for node in ast.walk(ast.parse(inspect.getsource(module))):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "_record_phase" and node.args
                and isinstance(node.args[0], ast.Constant)):
            recorded.add(node.args[0].value)
    return recorded


class TestPhaseVocabulary:
    def test_manager_phase_vocabulary_matches_recorded_phases(self):
        """PROTOCOL_PHASES is the closed set the port's Manager calls
        _record_phase with, each name a literal."""
        assert _recorded_phases(mgr) == set(PROTOCOL_PHASES)

    def test_model_ops_render_in_manager_phase_vocabulary(self):
        assert set(pm.MODEL_PHASE_OPS.values()) <= set(PROTOCOL_PHASES) | {"crash"}
        assert pm.MODEL_PHASE_OPS == jax_pm.MODEL_PHASE_OPS


class TestVerifyCli:
    def test_full_gate_exits_zero(self, capsys):
        assert verify_main([]) == 0
        out = capsys.readouterr().out
        assert "MISSED" not in out and "VIOLATION" not in out
        assert "wire drift: 0 finding(s)" in out

    def test_selftest_exits_zero(self, capsys):
        assert verify_main(["--selftest"]) == 0
        out = capsys.readouterr().out
        assert "caught" in out and "MISSED" not in out

    def test_unknown_scenario_exits_two(self):
        assert verify_main(["--scenario", "nope"]) == 2

    @pytest.mark.parametrize("scenario", ["plan", "resize", "churn"])
    def test_scenario_cli(self, scenario, capsys):
        assert verify_main(["--scenario", scenario]) == 0

    def test_list_cli(self, capsys):
        assert verify_main(["--list"]) == 0
        out = capsys.readouterr().out
        for name in mc.SCENARIOS:
            assert f"scenario {name}" in out
        for m in pm.MUTATIONS:
            assert f"mutation {m.name}" in out
