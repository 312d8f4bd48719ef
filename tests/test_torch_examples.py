"""The port's examples (``examples/torch/``) run on the CPU at demo size.

Each case mirrors a JAX-package test that runs the matching example:
tests/test_durable_checkpoint.py:62 (train_ddp saves, then resumes at the
saved step), tests/test_hsdp_integ.py:163 (train_hsdp), tests/
test_launcher.py:133-159 (slurm_runner's dry run), tests/
test_multihost_integ.py (train_multihost across real processes, a group
killed and healed, DiLoCo and its int8 wire) and tests/
test_actor_example.py (actor_trainer with chaos).  Every example runs with
``--device cpu`` (``--cpu`` for train_ddp's JAX flag); without it, an
example asks for the card and fails here, which the last case checks.

The examples start together, one thread each, when the first case asks
for its result, and each case checks its own, so the file takes about as
long as its slowest example.
"""

import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EX = "examples/torch"


def _run(*args, timeout=240):
    return subprocess.run([sys.executable, *args], capture_output=True, text=True,
                          cwd=REPO, timeout=timeout)


def _ddp_save_then_resume(save_dir):
    common = [f"{EX}/train_ddp.py", "--cpu", "--local-replicas", "2",
              "--min-replicas", "2", "--batch-size", "4", "--save-dir", save_dir,
              "--save-every", "2"]
    first = _run(*common, "--steps", "6")
    second = _run(*common, "--steps", "10", "--resume") if first.returncode == 0 else None
    return first, second


CASES = {
    "train_ddp": lambda tmp: _ddp_save_then_resume(str(tmp / "ckpts")),
    "train_diloco": lambda tmp: _run(
        f"{EX}/train_diloco.py", "--device", "cpu", "--local-replicas", "2",
        "--steps", "12", "--sync-every", "4", "--batch-size", "8", "--quantize"),
    "train_hsdp": lambda tmp: _run(
        f"{EX}/train_hsdp.py", "--device", "cpu", "--local-replicas", "2",
        "--steps", "6"),
    "train_multihost": lambda tmp: _run(
        f"{EX}/train_multihost.py", "--device", "cpu", "--groups", "2",
        "--procs-per-group", "2", "--algo", "diloco", "--steps", "6", "--chaos",
        "--step-sleep", "0.25"),
    "actor_trainer": lambda tmp: _run(
        f"{EX}/actor_trainer.py", "--device", "cpu", "--replicas", "2", "--steps", "12",
        "--chaos", "--step-time", "0.3"),
    "slurm_runner": lambda tmp: _run(
        f"{EX}/slurm_runner.py", "--replicas", "2", "--dry-run", "--", sys.executable,
        f"{EX}/train_ddp.py", "--steps", "10"),
    "asks_for_the_card": lambda tmp: _run(
        f"{EX}/train_ddp.py", "--local-replicas", "1", "--steps", "1"),
}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("examples")
    with ThreadPoolExecutor(max_workers=len(CASES)) as ex:
        futures = {name: ex.submit(fn, tmp) for name, fn in CASES.items()}
        yield futures


def _ok(out):
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-4000:]
    return out.stdout


def test_train_ddp_saves_then_resumes_at_the_saved_step(results):
    first, second = results["train_ddp"].result()
    assert "saved checkpoint" in _ok(first)
    assert "ckpt_step6.tft" in first.stdout
    out = _ok(second)
    assert "resumed from" in out and "at step 6" in out
    assert "ckpt_step10.tft" in out
    assert out.strip().splitlines()[-1] == (
        "done: 2 replica groups, 10 committed steps each on cpu")


def test_train_diloco_int8_outer_syncs(results):
    out = _ok(results["train_diloco"].result())
    assert out.strip().splitlines()[-1] == (
        "done: 2 replica groups, 12 inner steps each on cpu")
    # 12 inner steps at sync_every 4 over 2 fragments: 6 outer steps
    assert "outer 5]" in out


def test_train_hsdp_fsdp_by_tp(results):
    out = _ok(results["train_hsdp"].result())
    assert out.count("done: 6 committed steps") == 2


def test_train_multihost_diloco_group_killed_and_healed(results):
    out = _ok(results["train_multihost"].result())
    assert "after chaos kill+rejoin" in out, out
    assert "restarted group healed to step" in out, out


def test_actor_trainer_restarts_a_killed_trainer(results):
    out = _ok(results["actor_trainer"].result())
    assert "[chaos] killing trainer" in out
    assert "restart 1" in out
    assert "weights converged bitwise" in out


def test_slurm_runner_dry_run(results):
    out = _ok(results["slurm_runner"].result())
    lines = [line for line in out.splitlines() if line.startswith("sbatch")]
    assert len(lines) == 2
    assert "REPLICA_GROUP_ID=0" in lines[0] and "REPLICA_GROUP_ID=1" in lines[1]
    assert "NUM_REPLICA_GROUPS=2" in lines[0] and "--gres=gpu:8" in lines[0]
    assert lines[0].count(f"{EX}/train_ddp.py") == 1 and "--steps 10" in lines[0]


def test_an_example_without_device_cpu_asks_for_the_card(results):
    out = results["asks_for_the_card"].result()
    assert out.returncode != 0
    assert "no CUDA device is available" in out.stdout + out.stderr
