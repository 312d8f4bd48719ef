"""Elastic replica-group launcher (reference torchx component analog).

PyTorch port of ``torchft_tpu/launcher.py``.  The reference ships a TorchX
component that turns one training script into N torchrun roles, one per
replica group, each with the env triple ``REPLICA_GROUP_ID`` /
``NUM_REPLICA_GROUPS`` / ``TORCHFT_LIGHTHOUSE`` and a ``--max_restarts``
supervision budget (reference: torchft/torchx.py:11-83).  This module
provides the same three capabilities without TorchX:

- :func:`replica_app_spec` — a scheduler-agnostic spec (plain dicts) that a
  SLURM/k8s adapter can translate (the TorchX ``specs.AppDef`` analog);
- :class:`ReplicaGroupLauncher` — a local supervisor that spawns one
  process per replica group, injects the env triple, and restarts crashed
  groups up to ``max_restarts`` times (the torchrun ``--max_restarts``
  analog; a restarted group live-heals via quorum instead of
  re-rendezvousing the whole world);
- a CLI: ``python -m torchft_tpu_torch.launcher --replicas 2 -- python
  train.py`` (starts an in-process Lighthouse when ``TORCHFT_LIGHTHOUSE``
  isn't set).

One replica group == one process here (one card); a group that spans
several processes (cp, fsdp, tp, pp, ep) is started by the trainer itself,
so there is no ``workers_per_replica``-style nproc fan-out.
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

from torchft_tpu_torch.utils.env import env_str

logger = logging.getLogger(__name__)


def replica_app_spec(
    *script_args: str,
    replicas: int = 2,
    max_restarts: int = 10,
    script: str = "examples/train_ddp.py",
    env: "Optional[Dict[str, str]]" = None,
    lighthouse: "Optional[str]" = None,
) -> "Dict[str, Any]":
    """Build a scheduler-agnostic app spec: one role per replica group.

    Mirrors the reference component's shape (reference torchx.py:11-83)
    without the TorchX dependency: each role carries the entrypoint command
    and the replica-group env triple; a deployment adapter (SLURM sbatch,
    k8s Job, ...) consumes ``roles[i]["args"]`` + ``roles[i]["env"]``.
    """
    if replicas <= 0:
        raise ValueError("replicas must be > 0")
    base_env = dict(env or {})
    base_env.setdefault("LOGLEVEL", "INFO")
    if lighthouse is not None:
        # explicit argument wins over anything in a forwarded caller env
        base_env["TORCHFT_LIGHTHOUSE"] = lighthouse
    else:
        base_env.setdefault(
            "TORCHFT_LIGHTHOUSE",
            env_str("TORCHFT_LIGHTHOUSE", "localhost:29510"),
        )

    roles = []
    for replica_id in range(replicas):
        roles.append(
            {
                "name": f"replica_{replica_id}",
                "entrypoint": sys.executable,
                "args": [script, *script_args],
                "max_restarts": max_restarts,
                # per-role triple last: caller env (e.g. a forwarded
                # os.environ that itself contains REPLICA_GROUP_ID) must
                # never override the role identity
                "env": {
                    **base_env,
                    "REPLICA_GROUP_ID": str(replica_id),
                    "NUM_REPLICA_GROUPS": str(replicas),
                },
            }
        )
    return {"name": "torchft_tpu_torch", "roles": roles}


@dataclass
class _ReplicaProc:
    replica_id: int
    cmd: "List[str]"
    env: "Dict[str, str]"
    max_restarts: int
    proc: "Optional[subprocess.Popen]" = None
    restarts: int = 0
    returncode: "Optional[int]" = None  # terminal result
    history: "List[int]" = field(default_factory=list)

    def start(self) -> None:
        logger.info(
            "starting replica_group %d (attempt %d): %s",
            self.replica_id,
            self.restarts + 1,
            " ".join(self.cmd),
        )
        self.proc = subprocess.Popen(self.cmd, env=self.env)


class ReplicaGroupLauncher:
    """Spawn + supervise one process per replica group.

    A crashed group is restarted with the same env until its
    ``max_restarts`` budget is exhausted; the quorum protocol absorbs the
    membership change, so surviving groups keep training throughout
    (reference semantics: torchrun --max_restarts per role,
    torchx.py:53-58). Exit code 0 is terminal success.
    """

    def __init__(
        self,
        cmd: "Sequence[str]",
        replicas: int,
        max_restarts: int = 10,
        env: "Optional[Dict[str, str]]" = None,
        lighthouse_addr: "Optional[str]" = None,
        restart_backoff: float = 1.0,
    ) -> None:
        if replicas <= 0:
            raise ValueError("replicas must be > 0")
        self._lighthouse = None
        if lighthouse_addr is None:
            lighthouse_addr = env_str("TORCHFT_LIGHTHOUSE") or None
        if lighthouse_addr is None:
            # local mode: host a Lighthouse in this supervisor process
            from torchft_tpu_torch.coordination import LighthouseServer

            self._lighthouse = LighthouseServer(min_replicas=1)
            lighthouse_addr = self._lighthouse.address()
            logger.info("started local lighthouse at %s", lighthouse_addr)
        self.lighthouse_addr = lighthouse_addr
        self._restart_backoff = restart_backoff

        base_env = {**os.environ, **(env or {})}
        base_env["TORCHFT_LIGHTHOUSE"] = lighthouse_addr
        base_env["NUM_REPLICA_GROUPS"] = str(replicas)

        self._replicas = [
            _ReplicaProc(
                replica_id=r,
                cmd=list(cmd),
                env={**base_env, "REPLICA_GROUP_ID": str(r)},
                max_restarts=max_restarts,
            )
            for r in range(replicas)
        ]

    def run(self, timeout: "Optional[float]" = None, poll_interval: float = 0.2) -> "Dict[int, int]":
        """Run all groups to completion; returns {replica_id: exit_code}.

        Raises TimeoutError if ``timeout`` elapses first (all groups are
        terminated).
        """
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            # inside the try: a Popen failure mid-loop must still tear down
            # the replicas (and local Lighthouse) already started
            for rp in self._replicas:
                rp.start()
            while True:
                live = 0
                for rp in self._replicas:
                    if rp.returncode is not None:
                        continue
                    code = rp.proc.poll()
                    if code is None:
                        live += 1
                        continue
                    rp.history.append(code)
                    if code == 0:
                        rp.returncode = 0
                    elif rp.restarts < rp.max_restarts:
                        rp.restarts += 1
                        logger.warning(
                            "replica_group %d exited with %d; restart %d/%d",
                            rp.replica_id, code, rp.restarts, rp.max_restarts,
                        )
                        time.sleep(self._restart_backoff)
                        rp.start()
                        live += 1
                    else:
                        logger.error(
                            "replica_group %d failed permanently (exit %d, "
                            "%d restarts used)", rp.replica_id, code, rp.restarts,
                        )
                        rp.returncode = code
                if live == 0:
                    break
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"launcher timed out after {timeout}s")
                time.sleep(poll_interval)
        finally:
            self.shutdown()
        return {rp.replica_id: rp.returncode for rp in self._replicas}

    def kill_replica(self, replica_id: int, sig: int = signal.SIGKILL) -> None:
        """Chaos hook: deliver ``sig`` to one group (punisher analog)."""
        rp = self._replicas[replica_id]
        if rp.proc is not None and rp.proc.poll() is None:
            rp.proc.send_signal(sig)

    def restarts(self) -> "Dict[int, int]":
        """Restarts used so far, per replica group."""
        return {rp.replica_id: rp.restarts for rp in self._replicas}

    def pids(self) -> "Dict[int, Optional[int]]":
        """The live process of each replica group (None once it exited
        for good or before it started)."""
        return {
            rp.replica_id: (
                rp.proc.pid
                if rp.proc is not None and rp.proc.poll() is None
                else None
            )
            for rp in self._replicas
        }

    def shutdown(self) -> None:
        for rp in self._replicas:
            if rp.proc is not None and rp.proc.poll() is None:
                rp.proc.terminate()
        for rp in self._replicas:
            if rp.proc is not None and rp.proc.poll() is None:
                try:
                    rp.proc.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    rp.proc.kill()
        if self._lighthouse is not None:
            self._lighthouse.shutdown()
            self._lighthouse = None


def main(argv: "Optional[Sequence[str]]" = None) -> int:
    p = argparse.ArgumentParser(
        description="Launch N fault-tolerant replica groups of a training "
        "command (everything after `--`)."
    )
    p.add_argument("--replicas", type=int, default=2)
    p.add_argument("--max-restarts", type=int, default=10)
    p.add_argument("--lighthouse", default=None,
                   help="host:port of an external Lighthouse (default: host one locally)")
    p.add_argument("--timeout", type=float, default=None)
    p.add_argument("cmd", nargs=argparse.REMAINDER,
                   help="-- command to run per replica group")
    args = p.parse_args(argv)

    cmd = args.cmd
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        p.error("no command given; usage: ... -- python train.py [args]")

    logging.basicConfig(level=logging.INFO, format="%(asctime)s launcher: %(message)s")
    launcher = ReplicaGroupLauncher(
        cmd,
        replicas=args.replicas,
        max_restarts=args.max_restarts,
        lighthouse_addr=args.lighthouse,
    )
    codes = launcher.run(timeout=args.timeout)
    bad = {r: c for r, c in codes.items() if c != 0}
    if bad:
        logger.error("failed replica groups: %s", bad)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
