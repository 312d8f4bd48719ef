"""SLURM adapter for the PyTorch port: one job per replica group, kept alive.

PyTorch port of ``examples/slurm_runner.py`` (reference:
torchft/examples/slurm/runner.py:16-100): each replica group is its own
SLURM job carrying the ``REPLICA_GROUP_ID`` / ``NUM_REPLICA_GROUPS`` /
``TORCHFT_LIGHTHOUSE`` env, so the cluster scheduler can preempt or kill
any one group while the rest keep training; this runner resubmits dead
jobs, and the quorum protocol heals them back in.  With ``--device cuda``
(the default) each job asks for ``--gpus-per-group`` cards; with
``--device cpu`` for none.

Dry-run (no SLURM needed) prints the exact sbatch command lines:

    python examples/torch/slurm_runner.py --replicas 4 --dry-run -- \
        python examples/torch/train_diloco.py --steps 10000

On a real cluster, point TORCHFT_LIGHTHOUSE at a lighthouse reachable from
the compute nodes (`python -m torchft_tpu_torch.lighthouse --bind :29510`).
"""

from __future__ import annotations

import argparse
import os
import shlex
import subprocess
import sys
import time

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from torchft_tpu_torch.launcher import replica_app_spec  # noqa: E402


def sbatch_lines(spec, partition: str, gpus_per_group: int) -> list:
    """One `sbatch --wrap` command per replica-group role."""
    lines = []
    gres = f"--gres=gpu:{gpus_per_group} " if gpus_per_group else ""
    for role in spec["roles"]:
        env = " ".join(f"{k}={shlex.quote(v)}" for k, v in role["env"].items())
        cmd = " ".join(shlex.quote(a) for a in [role["entrypoint"], *role["args"]])
        lines.append(
            f"sbatch --job-name={role['name']} --partition={partition} "
            f"{gres}--wrap={shlex.quote(f'{env} {cmd}')}"
        )
    return lines


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--replicas", type=int, default=2)
    p.add_argument("--partition", default="gpu")
    p.add_argument("--gpus-per-group", type=int, default=8)
    p.add_argument("--device", default="cuda",
                   help="cuda asks SLURM for --gpus-per-group cards a job; cpu for none")
    p.add_argument("--max-restarts", type=int, default=10)
    p.add_argument("--resubmit-interval", type=float, default=30.0)
    p.add_argument("--dry-run", action="store_true")
    p.add_argument("cmd", nargs=argparse.REMAINDER)
    args = p.parse_args(argv)
    cmd = args.cmd[1:] if args.cmd and args.cmd[0] == "--" else args.cmd
    if not cmd:
        p.error("no command; usage: ... -- python train.py [args]")
    # strip a leading interpreter: roles always launch via sys.executable
    if os.path.basename(cmd[0]).startswith("python"):
        if len(cmd) < 2:
            p.error("interpreter given without a script")
        args.script, args.script_args = cmd[1], cmd[2:]
    else:
        args.script, args.script_args = cmd[0], cmd[1:]
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    spec = replica_app_spec(
        *args.script_args, replicas=args.replicas, max_restarts=args.max_restarts,
        script=args.script,
    )
    gpus = args.gpus_per_group if args.device.startswith("cuda") else 0
    lines = sbatch_lines(spec, args.partition, gpus)

    if args.dry_run:
        for line in lines:
            print(line)
        return 0

    # submit + babysit: resubmit any group whose job left the queue
    restarts = {i: 0 for i in range(args.replicas)}
    jobs = {}
    for i, line in enumerate(lines):
        out = subprocess.run(line, shell=True, capture_output=True, text=True, check=True)
        jobs[i] = out.stdout.strip().split()[-1]
        print(f"replica_group {i} -> job {jobs[i]}")

    while jobs:
        time.sleep(args.resubmit_interval)
        probe = subprocess.run(
            ["squeue", "-h", "-o", "%i"], capture_output=True, text=True
        )
        if probe.returncode != 0:
            # a flaky slurmctld must not look like "all jobs dead": that
            # would mass-resubmit duplicates into the same quorum
            print(f"squeue failed ({probe.returncode}); skipping sweep")
            continue
        q = probe.stdout.split()
        for i, jid in list(jobs.items()):
            if jid in q:
                continue
            if restarts[i] >= args.max_restarts:
                print(f"replica_group {i} exhausted restarts; leaving down")
                del jobs[i]
                continue
            restarts[i] += 1
            out = subprocess.run(
                lines[i], shell=True, capture_output=True, text=True, check=True
            )
            jobs[i] = out.stdout.strip().split()[-1]
            print(f"replica_group {i} resubmitted -> job {jobs[i]} "
                  f"({restarts[i]}/{args.max_restarts})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
