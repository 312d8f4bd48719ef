"""Phase 13 of chip_smoke.py on the CPU at a tiny width: a supervised fleet
of trainer processes on the subprocess-isolated process group.

Three lighthouse peers (the port's CLI) and the port's
``ReplicaGroupLauncher`` supervising two trainer processes, each a tiny
transformer under a Manager over ``ProcessGroupBabyTCP`` with FT-DDP and
AdamW, its batches drawn by a ``StatefulDistributedSampler``.  The same
three faults as on the card: group 1's Baby worker SIGKILLed mid-allreduce
(neither trainer dies, neither group commits that step, fresh workers
re-run it), the lighthouse leader SIGKILLed (quorum ids keep rising under
the new leader's term), and group 1's trainer SIGKILLed and restarted once
by the launcher (it heals live from group 0 and trains to the end).  The
phase itself asserts all of that, the two groups bitwise equal at the end
(parameters, AdamW state, sampler state), an int8 quantized allreduce over
the Baby equal on both groups and within the codec's bound, no Baby worker
holding the card and no segment left in ``/dev/shm``.  Every incarnation
writes flight, event and span files; the port's post-mortem CLI, run by the
phase over them and the surviving leader's timeline and link matrix, names
what happened (``chip_smoke.check_fleet_report``), and the JAX package's
CLI gives the same ``--json`` report on the same files.
"""

import json
import os
import signal
import subprocess
import sys

import pytest
import torch

import chip_smoke
from torchft_tpu_torch.models import transformer as tf

#: the file's own time limit: a wedged fleet fails the case, not the run
LIMIT_S = 240


@pytest.fixture(autouse=True)
def _time_limit():
    def expired(signum, frame):
        raise TimeoutError(f"case ran past its {LIMIT_S} s limit")

    old = signal.signal(signal.SIGALRM, expired)
    signal.alarm(LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def test_fleet_path_rehearsal_on_cpu(tmp_path):
    cfg = tf.TransformerConfig(
        vocab_size=4096, d_model=64, n_heads=2, n_kv_heads=1, d_ff=128,
        n_layers=2, max_seq_len=128, dtype=torch.float32, remat=False,
        attn_impl="flash",
    )
    summary = chip_smoke.fleet_path(cfg, batch=2, seq=128, device="cpu",
                                    timeout=200.0, lease_ms=500,
                                    evidence_dir=str(tmp_path))
    assert summary["codes"] == {0: 0, 1: 0}
    assert summary["restarts"] == {0: 0, 1: 1}
    steps = summary["steps"]
    by = {}
    for s in steps:
        by.setdefault((s["group"], s["incarnation"]), []).append(s)
    # group 0: ten commits and the one failed attempt; group 1: the killed
    # incarnation to commit 6, the restarted one from its heal to the end
    assert [s["step"] for s in by[0, 0]] == [0, 1, 2, 3, 3, 4, 5, 6, 7, 8, 9]
    assert [s["step"] for s in by[1, 0]] == [0, 1, 2, 3, 3, 4, 5]
    assert [s["step"] for s in by[1, 1]] == [6, 7, 8, 9]
    assert summary["trainer_kill"]["heal"]["step"] == chip_smoke.FLEET_TRAINER_KILL_AFTER
    assert "worker exited" in summary["worker_kill"]["error"]
    lo, hi = summary["leader_kill"]["quorum_ids"]
    assert (hi >> 32) > (lo >> 32)
    # on CPU tensors the wrappers take the twins, in every incarnation;
    # kernel D's twin quantizes the final allreduce on both groups
    assert summary["launches"] == {"flash_fwd": 0, "flash_bwd_kv": 0, "flash_bwd_q": 0}
    assert all(n > 0 for n in summary["twin_calls"].values())
    assert all(q["twin_calls"] > 0 for q in summary["quantized"].values())
    # the embedding's gradient (4096 x 64 f32, 1 MiB) crosses to the
    # worker through /dev/shm, the rest pickled
    assert summary["shm_in_bytes_per_step"] == 4096 * 64 * 4
    # the keys log_fleet and main read
    assert {"median_step_ms", "median_ms", "baby_split_ms", "shm_in_bytes_per_step",
            "shm_peak_bytes", "worker_kill", "leader_kill", "trainer_kill",
            "pg_configure_ms", "workers", "host_rss_gb", "peak_memory_gb", "quantized",
            "launches", "launches_by_incarnation", "twin_calls", "compute_apps",
            "postmortem", "wall_s"} <= set(summary)
    chip_smoke.log_fleet("cpu", summary, None)
    # the post-mortem: one flight dump (with its .prov companion), event
    # file and span file per incarnation
    for inc in ("g0_inc0", "g1_inc0", "g1_inc1"):
        for suffix in chip_smoke.FLEET_SINKS.values():
            assert (tmp_path / f"{inc}{suffix}").stat().st_size > 0, (inc, suffix)
        assert (tmp_path / f"{inc}.flight.jsonl.prov").exists()
    pm = summary["postmortem"]
    assert pm["culprit"]["replica_id"].startswith("fleet_group1:")
    assert pm["failure"]["step"] == chip_smoke.FLEET_WORKER_KILL_STEP
    assert pm["replicas"] == {"g0": chip_smoke.FLEET_STEPS,
                              "g1_inc0": chip_smoke.FLEET_TRAINER_KILL_AFTER,
                              "g1_inc1": chip_smoke.FLEET_STEPS}
    assert pm["fragment"]["into_g1_inc1"]
    # the JAX package's diagnose gives the same reports on the same files
    argv = [a for a in open(tmp_path / "argv.txt").read().split("\n") if a]
    frag = pm["fragment"]["frag"]
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    for name, extra in (("report", []), ("fragment_report", ["--fragment", frag])):
        jax_run = subprocess.run(
            [sys.executable, "-m", "torchft_tpu.diagnose", *argv, *extra],
            capture_output=True, text=True,
            cwd=os.path.dirname(os.path.abspath(chip_smoke.__file__)), env=env, timeout=120)
        assert jax_run.returncode == 0, jax_run.stderr[-2000:]
        want = json.loads(jax_run.stdout)
        got = json.loads((tmp_path / f"{name}.json").read_text())
        # on a tie between the ledger's categories the JAX package's overall
        # category follows its string hash seed; the port's is the tied
        # category with more seconds (tests/test_torch_diagnose.py)
        dominants = [s["dominant"] for s in want["trace_ledger"]["steps"] if s["dominant"]]
        top = max(map(dominants.count, dominants))
        tied = {d for d in dominants if dominants.count(d) == top}
        if len(tied) > 1:
            assert got["trace_ledger"].pop("dominant_overall") in tied
            want["trace_ledger"].pop("dominant_overall")
        assert got == want
