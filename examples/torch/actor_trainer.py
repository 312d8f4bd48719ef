"""Actor-style fault-tolerant trainer on the PyTorch port: supervision trees.

PyTorch port of ``examples/actor_trainer.py``, the analog of the
reference's Monarch example
(reference: examples/monarch/train_distributed.py): the job is a tree of
actors — a LighthouseActor owning the quorum server, one TrainerActor per
replica group running the real Manager/DDP stack, and a FailureActor
injecting chaos — and a supervisor that restarts dead trainers without
touching the rest of the job (the quorum heals them back in).

Monarch provides proc meshes and typed endpoints; this demo keeps the same
shape with stdlib primitives (threads as actors, queues as mailboxes) so it
runs anywhere. On a real cluster each actor maps to a process and a card
via torchft_tpu_torch.launcher / examples/torch/slurm_runner.py.  The
trainers' weights live on the card unless ``--device cpu`` is given.

    python examples/torch/actor_trainer.py --replicas 2 --steps 20 --chaos
"""

from __future__ import annotations

import argparse
import os
import queue
import sys
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, Optional

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import numpy as np


# ---------------------------------------------------------------------------
# minimal actor runtime (threads + mailboxes)
# ---------------------------------------------------------------------------


@dataclass
class _Call:
    method: str
    args: tuple
    reply: "queue.Queue"


class Actor:
    """A thread with a mailbox; ``endpoint`` methods run in actor context."""

    def __init__(self, name: str) -> None:
        self.name = name
        self._inbox: "queue.Queue[Optional[_Call]]" = queue.Queue()
        self._thread = threading.Thread(target=self._loop, name=name, daemon=True)
        self._thread.start()

    def call(self, method: str, *args: Any, timeout: float = 120.0) -> Any:
        reply: "queue.Queue" = queue.Queue()
        self._inbox.put(_Call(method, args, reply))
        ok, value = reply.get(timeout=timeout)
        if not ok:
            raise value
        return value

    def stop(self) -> None:
        self._inbox.put(None)
        self._thread.join(timeout=30)

    def _loop(self) -> None:
        while True:
            call = self._inbox.get()
            if call is None:
                return
            try:
                call.reply.put((True, getattr(self, call.method)(*call.args)))
            except Exception as e:  # noqa: BLE001 - shipped to caller
                call.reply.put((False, e))


# ---------------------------------------------------------------------------
# actors
# ---------------------------------------------------------------------------


class LighthouseActor(Actor):
    def start_lighthouse(self, min_replicas: int = 1) -> str:
        from torchft_tpu_torch.coordination import LighthouseServer

        self._lighthouse = LighthouseServer(
            min_replicas=min_replicas, join_timeout_ms=10000
        )
        return self._lighthouse.address()

    def shutdown(self) -> None:
        self._lighthouse.shutdown()


class _InjectedCrash(RuntimeError):
    """Raised mid-step by kill(): the step dies uncommitted."""


class TrainerActor(Actor):
    """One replica group: real Manager + FT-DDP loop on a tiny MLP."""

    def start_training(
        self, replica_id: str, lighthouse: str, steps: int, step_time: float = 0.0,
        device: str = "cuda",
    ) -> None:
        self._stop = threading.Event()
        self._result: "Dict[str, Any]" = {}
        self._worker = threading.Thread(
            target=self._train,
            args=(replica_id, lighthouse, steps, step_time, device),
            daemon=True,
        )
        self._worker.start()

    def _train(
        self, replica_id: str, lighthouse: str, steps: int, step_time: float,
        device: str,
    ) -> None:
        import torch

        import torchft_tpu_torch as ft
        from torchft_tpu_torch.utils.device import resolve_device

        model = torch.nn.Module()
        model.w = torch.nn.Parameter(
            torch.zeros(1024, device=resolve_device(device)))

        def load_state_dict(sd: "Dict[str, Any]") -> None:
            with torch.no_grad():
                model.w.copy_(sd["w"])

        manager = ft.Manager(
            pg=ft.ProcessGroupTCP(timeout=20.0),
            min_replica_size=1,
            lighthouse_addr=lighthouse,
            replica_id=replica_id,
            group_rank=0,
            group_world_size=1,
            use_async_quorum=False,
            timeout=20.0,
            load_state_dict=load_state_dict,
            state_dict=lambda: {"w": model.w.detach().clone()},
        )
        optimizer = ft.OptimizerWrapper(manager, torch.optim.SGD(model.parameters(), lr=0.1))
        try:
            while manager.current_step() < steps:
                if step_time:
                    time.sleep(step_time)  # simulated compute, keeps the demo's
                    # chaos window open
                optimizer.begin_step()
                grads = {"w": torch.ones_like(model.w)}
                averaged = manager.allreduce(grads).wait(timeout=20)
                if self._stop.is_set():
                    # die mid-step, AFTER the collective and BEFORE the
                    # commit vote: the step aborts uncommitted, like a
                    # crash would leave it
                    raise _InjectedCrash("chaos kill")
                optimizer.step(model, averaged)
            self._result = {"w": model.w.detach().cpu().numpy().copy(),
                            "step": manager.current_step()}
        except _InjectedCrash:
            self._result = {"step": manager.current_step()}
        finally:
            # thread-actor constraint: the manager must be shut down here or
            # its server/heartbeat threads would leak into the shared
            # process. True kill -9 chaos (no teardown at all) lives in the
            # process-isolated paths: launcher.kill_replica, punisher.py
            # and examples/torch/train_multihost.py --chaos.
            manager.shutdown()

    def status(self) -> "Dict[str, Any]":
        alive = self._worker.is_alive()
        return {"alive": alive, **({} if alive else self._result)}

    def kill(self) -> None:
        """Crash the trainer mid-step: the in-flight step aborts without a
        commit vote (see the _InjectedCrash raise in _train)."""
        self._stop.set()

    def join(self, timeout: float = 120.0) -> "Dict[str, Any]":
        self._worker.join(timeout=timeout)
        return dict(self._result)


class FailureActor(Actor):
    """Chaos: periodically kills one trainer via the supervisor."""

    def start_chaos(self, supervisor: "Supervisor", period: float) -> None:
        self._chaos = threading.Thread(
            target=self._loop_chaos, args=(supervisor, period), daemon=True
        )
        self._chaos.start()

    def _loop_chaos(self, supervisor: "Supervisor", period: float) -> None:
        rng = np.random.default_rng(0)
        time.sleep(period)
        victim = int(rng.integers(supervisor.replicas))
        print(f"[chaos] killing trainer {victim}", flush=True)
        supervisor.kill_trainer(victim)


# ---------------------------------------------------------------------------
# supervisor
# ---------------------------------------------------------------------------


class Supervisor:
    """Restarts dead trainers; the quorum absorbs the membership churn."""

    def __init__(
        self, replicas: int, steps: int, chaos: bool, step_time: float = 0.0,
        device: str = "cuda",
    ) -> None:
        self.replicas = replicas
        self.steps = steps
        self.step_time = step_time
        self.device = device
        self.lighthouse = LighthouseActor("lighthouse")
        self.addr = self.lighthouse.call("start_lighthouse")
        self.trainers: "Dict[int, TrainerActor]" = {}
        self.restarts: "Dict[int, int]" = {i: 0 for i in range(replicas)}
        for i in range(replicas):
            self._spawn(i)
        if chaos:
            self.failure = FailureActor("failure")
            self.failure.call("start_chaos", self, 3.0)

    def _spawn(self, i: int) -> None:
        actor = TrainerActor(f"trainer_{i}")
        attempt = self.restarts[i]
        actor.call(
            "start_training",
            f"actor_{i}:a{attempt}",
            self.addr,
            self.steps,
            self.step_time,
            self.device,
        )
        self.trainers[i] = actor

    def kill_trainer(self, i: int) -> None:
        self.trainers[i].call("kill")

    def run(self) -> "Dict[int, Dict[str, Any]]":
        results: "Dict[int, Dict[str, Any]]" = {}
        while len(results) < self.replicas:
            time.sleep(0.5)
            for i, actor in list(self.trainers.items()):
                if i in results:
                    continue
                status = actor.call("status")
                if status["alive"]:
                    continue
                if status.get("step", 0) >= self.steps:
                    results[i] = actor.call("join")
                elif self.restarts[i] < 3:
                    self.restarts[i] += 1
                    print(
                        f"[supervisor] trainer {i} died at step "
                        f"{status.get('step', '?')}; restart "
                        f"{self.restarts[i]}", flush=True,
                    )
                    actor.stop()
                    self._spawn(i)
                else:
                    raise RuntimeError(f"trainer {i} exhausted restarts")
        return results

    def shutdown(self) -> None:
        for actor in self.trainers.values():
            actor.stop()
        self.lighthouse.call("shutdown")
        self.lighthouse.stop()


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--replicas", type=int, default=2)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--chaos", action="store_true")
    p.add_argument("--step-time", type=float, default=0.0,
                   help="simulated per-step compute seconds (keeps the chaos\n"
                        "window open in short demos)")
    p.add_argument("--device", default="cuda",
                   help="device the trainers' weights live on (default cuda)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)

    if args.chaos and args.step_time == 0.0:
        args.step_time = 0.3
    sup = Supervisor(args.replicas, args.steps, args.chaos, args.step_time,
                     args.device)
    try:
        results = sup.run()
    finally:
        sup.shutdown()

    ws = [r["w"] for r in results.values()]
    for w in ws[1:]:
        np.testing.assert_array_equal(ws[0], w)
    print(
        f"done: {len(results)} replicas at step {args.steps}, "
        f"weights converged bitwise, restarts={sup.restarts}"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
