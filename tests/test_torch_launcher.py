"""The port's launcher: replica-group env injection, restart budget, chaos
hook and CLI (counterpart of tests/test_launcher.py), against the JAX
package's app spec.
"""

import os
import signal
import subprocess
import sys
import textwrap
import threading
import time

import pytest

from torchft_tpu import launcher as jlauncher
from torchft_tpu_torch.launcher import ReplicaGroupLauncher, main, replica_app_spec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script(tmp_path, body):
    path = tmp_path / "worker.py"
    path.write_text(textwrap.dedent(body))
    return str(path)


@pytest.mark.parametrize("env", [None, {"REPLICA_GROUP_ID": "7",
                                        "NUM_REPLICA_GROUPS": "99", "FOO": "x"}])
def test_app_spec_equals_the_jax_package_s(env):
    kw = dict(replicas=3, script="train.py", lighthouse="lh:1234", env=env)
    spec = replica_app_spec("--steps", "5", **kw)
    ref = jlauncher.replica_app_spec("--steps", "5", **kw)
    assert spec["name"] == "torchft_tpu_torch"
    assert spec["roles"] == ref["roles"]
    for i, role in enumerate(spec["roles"]):
        # the caller's env never overrides the role identity
        assert role["env"]["REPLICA_GROUP_ID"] == str(i)
        assert role["env"]["NUM_REPLICA_GROUPS"] == "3"
        assert role["env"]["TORCHFT_LIGHTHOUSE"] == "lh:1234"
        assert role["args"] == ["train.py", "--steps", "5"]
    with pytest.raises(ValueError):
        replica_app_spec(replicas=0)
    with pytest.raises(ValueError):
        ReplicaGroupLauncher(["true"], replicas=0, lighthouse_addr="lh:1")


def test_env_injection_and_success(tmp_path):
    script = _script(tmp_path, f"""
        import os
        out = os.path.join({str(tmp_path)!r}, "out_" + os.environ["REPLICA_GROUP_ID"])
        with open(out, "w") as f:
            f.write(os.environ["NUM_REPLICA_GROUPS"] + " " +
                    os.environ["TORCHFT_LIGHTHOUSE"])
        """)
    launcher = ReplicaGroupLauncher([sys.executable, script], replicas=2,
                                    lighthouse_addr="lh:9999")
    assert launcher.run(timeout=60) == {0: 0, 1: 0}
    for r in range(2):
        assert (tmp_path / f"out_{r}").read_text() == "2 lh:9999"
    assert launcher.restarts() == {0: 0, 1: 0}
    assert launcher.pids() == {0: None, 1: None}


@pytest.mark.parametrize("exit_code,max_restarts,want,restarts", [
    (3, 2, 0, 1),  # fails once, then succeeds: exactly one restart
    (7, 1, 7, 1),  # always fails: the budget runs out
], ids=["restart_until_success", "budget_exhausted"])
def test_restart_budget(tmp_path, exit_code, max_restarts, want, restarts):
    script = _script(tmp_path, f"""
        import os, sys
        marker = os.path.join({str(tmp_path)!r}, "m_" + os.environ["REPLICA_GROUP_ID"])
        if {exit_code} == 7 or not os.path.exists(marker):
            open(marker, "w").close()
            sys.exit({exit_code})
        sys.exit(0)
        """)
    launcher = ReplicaGroupLauncher(
        [sys.executable, script], replicas=1, max_restarts=max_restarts,
        lighthouse_addr="lh:9999", restart_backoff=0.0,
    )
    assert launcher.run(timeout=60) == {0: want}
    assert launcher.restarts() == {0: restarts}


def test_kill_replica_is_restarted_once(tmp_path):
    """The chaos hook: a SIGKILLed group is restarted within its budget,
    and its new incarnation runs to success."""
    script = _script(tmp_path, f"""
        import os, sys, time
        path = os.path.join({str(tmp_path)!r}, "inc_" + os.environ["REPLICA_GROUP_ID"])
        n = len(open(path).read()) if os.path.exists(path) else 0
        open(path, "a").write("x")
        if os.environ["REPLICA_GROUP_ID"] == "1" and n == 0:
            time.sleep(60)  # the first incarnation waits to be killed
        """)
    launcher = ReplicaGroupLauncher([sys.executable, script], replicas=2,
                                    max_restarts=1, lighthouse_addr="lh:1",
                                    restart_backoff=0.0)
    codes = {}
    t = threading.Thread(target=lambda: codes.update(launcher.run(timeout=60)))
    t.start()
    deadline = time.monotonic() + 30
    while not (tmp_path / "inc_1").exists() and time.monotonic() < deadline:
        time.sleep(0.02)
    first = launcher.pids()[1]
    assert first is not None
    launcher.kill_replica(1, signal.SIGKILL)
    t.join(timeout=60)
    assert codes == {0: 0, 1: 0}
    assert launcher.restarts() == {0: 0, 1: 1}
    assert (tmp_path / "inc_1").read_text() == "xx"


def test_local_lighthouse_is_the_port_s(tmp_path, monkeypatch):
    monkeypatch.delenv("TORCHFT_LIGHTHOUSE", raising=False)
    script = _script(tmp_path, f"""
        import os
        with open(os.path.join({str(tmp_path)!r}, "lh"), "w") as f:
            f.write(os.environ["TORCHFT_LIGHTHOUSE"])
        """)
    launcher = ReplicaGroupLauncher([sys.executable, script], replicas=1)
    from torchft_tpu_torch.coordination import LighthouseServer

    assert isinstance(launcher._lighthouse, LighthouseServer)
    assert launcher.run(timeout=60) == {0: 0}
    assert ":" in (tmp_path / "lh").read_text()
    assert launcher._lighthouse is None  # shut down with the run


def test_cli_roundtrip(tmp_path):
    ok = _script(tmp_path, "import sys; sys.exit(0)\n")
    assert main(["--replicas", "1", "--lighthouse", "lh:9", "--timeout", "60",
                 "--", sys.executable, ok]) == 0
    out = subprocess.run(
        [sys.executable, "-m", "torchft_tpu_torch.launcher", "--replicas", "2",
         "--max-restarts", "0", "--lighthouse", "lh:9", "--", sys.executable,
         "-c", "import os, sys; sys.exit(int(os.environ['REPLICA_GROUP_ID']))"],
        cwd=REPO, capture_output=True, text=True, timeout=60,
    )
    assert out.returncode == 1, out.stderr
    assert "failed replica groups: {1: 1}" in out.stderr
