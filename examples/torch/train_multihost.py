"""Multi-host replica groups on the PyTorch port: FT-DDP across groups, an
in-group data-parallel mesh within each.

PyTorch port of ``examples/train_multihost.py``.  The deployment shape of a
real multi-host job (reference wiring: torchft/manager.py:277-325 store
handoff, torchft/fsdp_test.py:96-120 spawned workers):

- each replica GROUP is ``--procs-per-group`` real OS processes joined by
  the port's ``initialize_multihost`` (a TCPStore at the group's
  coordinator; gloo, or NCCL when every process owns a card) — the inner
  data-parallel mean is a psum over the group's ``dp`` axis;
- each process runs one ``Manager`` with ``group_rank = process id``,
  sharing the group's store: rank 0 hosts the ManagerServer, other ranks
  discover it through the store handoff; quorum and commit votes aggregate
  across ranks inside the group's server;
- ACROSS groups, same-rank peers form the elastic ``ProcessGroupTCP`` ring
  that averages gradients — groups can die and rejoin without touching
  the in-group groups of the others.

Every process computes on the card unless ``--device cpu`` is given.

Self-launching demo (spawns groups x procs real processes):

    python examples/torch/train_multihost.py --groups 2 --procs-per-group 2 --steps 4

Streaming DiLoCo across the groups (the BASELINE north-star config),
with optional whole-group kill+rejoin chaos:

    python examples/torch/train_multihost.py --groups 2 --procs-per-group 2 \
        --algo diloco --steps 6 --chaos --step-sleep 0.25

Real deployment: run one process per host with the env/flags below, a
shared Lighthouse, one store + one coordinator per group:

    python examples/torch/train_multihost.py --worker \
        --group-id 0 --process-id $HOST_IDX --procs-per-group 4 \
        --coordinator host0:1234 --store-addr host0:2345 \
        --lighthouse host:port
"""

from __future__ import annotations

import argparse
import hashlib
import os
import socket
import subprocess
import sys

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--groups", type=int, default=2)
    p.add_argument("--procs-per-group", type=int, default=2)
    p.add_argument("--steps", type=int, default=4)
    p.add_argument("--cpu-devices", type=int, default=2,
                   help="the JAX example's virtual devices per process: each "
                        "process takes 4 x this many rows of the group's batch")
    p.add_argument("--device", default="cuda",
                   help="device every process computes on (default cuda)")
    p.add_argument("--min-replicas", type=int, default=1)
    p.add_argument("--algo", choices=["ddp", "diloco"], default="ddp",
                   help="cross-group algorithm: per-step FT-DDP allreduce, "
                        "or Streaming DiLoCo outer syncs every --sync-every "
                        "inner steps (the BASELINE north-star config, over "
                        "real processes)")
    p.add_argument("--sync-every", type=int, default=4,
                   help="diloco: inner steps per outer sync")
    p.add_argument("--quantize", action="store_true",
                   help="int8-quantize the DiLoCo outer pseudograd sync "
                        "across groups (TORCHFT_QUANT_WIRE for fp8)")
    p.add_argument("--chaos", action="store_true",
                   help="kill one whole group's processes mid-run, restart "
                        "them, and require bitwise convergence after the "
                        "supersession rejoin + live heal")
    p.add_argument("--step-sleep", type=float, default=0.0,
                   help="pacing sleep per training step (gives the chaos "
                        "restart a window to overlap the survivors' run)")
    # worker mode (spawned by the launcher above, or run per-host manually)
    p.add_argument("--worker", action="store_true")
    p.add_argument("--group-id", type=int, default=0)
    p.add_argument("--process-id", type=int, default=0)
    p.add_argument("--coordinator", default=None)
    p.add_argument("--coordinator-fd", type=int, default=None,
                   help="process 0: a socket already listening at the "
                        "coordinator's port, for its store to serve on")
    p.add_argument("--store-addr", default=None)
    p.add_argument("--lighthouse", default=None)
    return p.parse_args(argv)


def worker(args) -> int:
    import time

    import numpy as np
    import torch

    import torchft_tpu_torch as ft
    from torchft_tpu_torch.parallel.axis import MeshAxis
    from torchft_tpu_torch.parallel.multihost import (
        host_sharded_array,
        initialize_multihost,
    )
    from torchft_tpu_torch.utils.device import resolve_device

    gid, pid, n = args.group_id, args.process_id, args.procs_per_group
    tag = f"g{gid}p{pid}"
    device = resolve_device(args.device)
    if device.type == "cpu":
        torch.set_num_threads(1)  # every process of every group shares the host

    # ---- inner parallelism: one dp axis over the whole group -------------
    # process 0's store serves on the listener the launcher bound
    listener = None if args.coordinator_fd is None else socket.socket(fileno=args.coordinator_fd)
    world = initialize_multihost(args.coordinator, n, pid, timeout=60.0, listener=listener)
    dp = MeshAxis("dp", world.new_group("dp", range(n)), pid, n)

    dim = 8
    rows = 4 * args.cpu_devices  # this process's rows of the group's batch
    batch = rows * n
    state = {"params": {"w": torch.zeros(dim, dtype=torch.float32, device=device)}}

    # ---- FT layer: one Manager per process, group store shared ---------
    manager = ft.Manager(
        pg=ft.ProcessGroupTCP(timeout=20.0),
        min_replica_size=args.min_replicas,
        load_state_dict=lambda sd: state.update(
            params={k: v.to(device) for k, v in sd["params"].items()}),
        state_dict=lambda: {"params": state["params"]},
        lighthouse_addr=args.lighthouse,
        replica_id=f"mh_group_{gid}",
        group_rank=pid,
        group_world_size=n,
        store_addr=args.store_addr,
        # DiLoCo requires the synchronous quorum (heal applies eagerly
        # before the inner loop resumes)
        use_async_quorum=args.algo != "diloco",
        timeout=20.0,
        quorum_timeout=20.0,
        init_sync=False,
    )

    def grad_step(params, xs, ys):
        """Loss and gradient of the group's mean squared error: each process
        differentiates its rows' share, and the shares sum over dp."""
        w = params["w"].detach().requires_grad_(True)
        loss = ((xs @ w - ys) ** 2).sum() / batch
        loss.backward()
        out = [loss.detach().reshape(1), w.grad]
        dp.psum_(out)
        return out[0][0], {"w": out[1]}

    rng = np.random.default_rng(1000 + gid)  # same data on every group rank
    first_commit = None

    def make_batch():
        xs_np = rng.standard_normal((batch, dim)).astype(np.float32)
        ys_np = xs_np @ np.arange(dim, dtype=np.float32)
        # every process takes only its rows of the group-global batch
        index = (slice(pid * rows, (pid + 1) * rows),)
        xs = host_sharded_array((batch, dim), index, lambda idx: xs_np[idx])
        ys = host_sharded_array((batch,), index, lambda idx: ys_np[idx])
        return xs.to(device), ys.to(device)

    def note_commit():
        # a healed rejoiner's first commit lands at the survivors' step,
        # not 0 — the chaos launcher asserts this to prove the live heal
        # actually ran.  Read the step from the manager (post-commit,
        # minus one): healing updates current_step inside start_quorum.
        nonlocal first_commit
        if first_commit is None:
            first_commit = manager.current_step() - 1

    try:
        if args.algo == "diloco":
            loss = _diloco_loop(
                args, manager, state, grad_step, make_batch, note_commit,
            )
        else:
            while manager.current_step() < args.steps:
                if args.step_sleep:
                    time.sleep(args.step_sleep)
                xs, ys = make_batch()
                manager.start_quorum()
                # loss/grads: dp-mean over the group's processes
                loss, grads = grad_step(state["params"], xs, ys)
                # cross-group: elastic FT ring between same-rank peers
                avg = manager.allreduce({"w": grads["w"]}).wait(timeout=30)
                if manager.should_commit():
                    note_commit()
                    state["params"] = {
                        "w": state["params"]["w"] - 0.1 * avg["w"].to(device)
                    }
        digest = hashlib.sha256(
            state["params"]["w"].cpu().numpy().tobytes()
        ).hexdigest()[:16]
        print(f"[{tag}] done step={manager.current_step()} "
              f"first_commit={first_commit} "
              f"loss={float(loss):.5f} params_sha={digest}", flush=True)
        return 0
    finally:
        manager.shutdown()


def _diloco_loop(args, manager, state, grad_step, make_batch, note_commit):
    """Streaming DiLoCo across replica groups over REAL processes: inner
    steps train on the group's own data (dp-mean over the group's
    processes); every ``--sync-every`` inner steps the pseudogradients
    allreduce across groups and the outer Nesterov step applies.
    ``--steps`` counts OUTER syncs here; the loop exits right after a sync
    boundary, where params are bitwise-identical across groups by
    construction."""
    import time

    import torchft_tpu_torch as ft
    from torchft_tpu_torch.local_sgd import OuterSGD

    def get_params():
        return dict(state["params"])

    def set_params(flat):
        state["params"] = {**state["params"], **flat}

    outer_opt = OuterSGD(0.7, momentum=0.9, nesterov=True)
    committed_before = manager.current_step()
    with ft.DiLoCo(
        manager,
        [["w"]],  # one fragment: the whole (tiny) model
        get_params,
        set_params,
        outer_opt,
        sync_every=args.sync_every,
        fragment_sync_delay=0,
        should_quantize=args.quantize,
    ) as diloco:
        while manager.current_step() < args.steps:
            if args.step_sleep:
                time.sleep(args.step_sleep)
            xs, ys = make_batch()
            loss, grads = grad_step(state["params"], xs, ys)
            # inner step: plain SGD on the group-mean gradient
            state["params"] = {"w": state["params"]["w"] - 0.05 * grads["w"]}
            # gate on batches_committed, NOT current_step: a heal jumps
            # current_step inside start_quorum even when that round's
            # commit vote fails, but batches_committed moves only on a
            # real commit — first_commit must prove a commit happened
            before = manager.batches_committed()
            diloco.step()  # counts inner steps; syncs on its schedule
            if manager.batches_committed() > before:
                note_commit()
    if manager.current_step() <= committed_before:
        raise RuntimeError("no DiLoCo outer step committed")
    return loss


def launch(args) -> int:
    """Spawn groups x procs real worker processes against one Lighthouse.

    ``--chaos``: mid-run, one whole group's processes are SIGKILLed (no
    shutdown, no leave RPC — the hard-failure shape) and respawned with a
    fresh in-group coordinator; the new incarnation supersedes the
    dead one at the lighthouse, heals its state live from a surviving
    group, and the run must still end with every process bitwise-equal.
    Reference analog: restart semantics torchft/manager_integ_test.py:
    236-249 over real spawned workers (fsdp_test.py:96-120).
    """
    import time

    from torchft_tpu_torch.coordination import LighthouseServer, StoreServer
    from torchft_tpu_torch.parallel.multihost import coordinator_listener

    # quorum formation waits for every group — otherwise a fast-starting
    # group trains (and finishes) solo before the others join
    lighthouse = LighthouseServer(
        min_replicas=args.groups, join_timeout_ms=200
    )
    stores = [StoreServer() for _ in range(args.groups)]

    def spawn_group(g: int) -> "list[subprocess.Popen]":
        # the group's coordinator: bound here, served by process 0's store
        coord, listener = coordinator_listener()
        group_procs = []
        for p in range(args.procs_per_group):
            cmd = [
                sys.executable, os.path.abspath(__file__), "--worker",
                "--group-id", str(g), "--process-id", str(p),
                "--procs-per-group", str(args.procs_per_group),
                "--cpu-devices", str(args.cpu_devices),
                "--device", args.device,
                "--steps", str(args.steps),
                "--min-replicas", str(args.min_replicas),
                "--algo", args.algo,
                "--sync-every", str(args.sync_every),
                "--step-sleep", str(args.step_sleep),
                "--coordinator", coord,
                "--store-addr", stores[g].address(),
                "--lighthouse", lighthouse.address(),
            ]
            if args.quantize:
                cmd.append("--quantize")
            fds = (listener.fileno(),) if p == 0 else ()
            cmd += [f"--coordinator-fd={fd}" for fd in fds]
            group_procs.append(subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True, pass_fds=fds,
            ))
        listener.close()  # process 0 holds its own copy
        return group_procs

    groups = [spawn_group(g) for g in range(args.groups)]
    killed_out = ""
    try:
        if args.chaos:
            victim = args.groups - 1
            # kill only after real progress: poll the lighthouse (quorum
            # members report their step) until every group has committed a
            # few steps, then hard-kill the victim group's processes
            # (SIGKILL: no Manager.shutdown, no store cleanup, heartbeats
            # just stop)
            from torchft_tpu_torch.coordination import LighthouseClient

            lc = LighthouseClient(lighthouse.address())
            # member steps are per-step commits for ddp, OUTER syncs for
            # diloco — gate on fewer of the latter (each is sync_every
            # inner steps of real progress)
            gate = 2 if args.algo == "diloco" else 3
            deadline = time.monotonic() + 120
            while time.monotonic() < deadline:
                status = lc.status()
                members = (status.get("prev_quorum") or {}).get(
                    "participants", []
                )
                if members and min(m["step"] for m in members) >= gate:
                    break
                time.sleep(0.25)
            else:
                raise RuntimeError("no training progress before chaos kill")
            lc.close()
            for p in groups[victim]:
                p.kill()
            for p in groups[victim]:
                killed_out += p.communicate()[0] or ""
            print(f"[chaos] killed group {victim} "
                  f"({args.procs_per_group} processes)", flush=True)
            # respawn: new incarnation, fresh coordinator, same store
            groups[victim] = spawn_group(victim)
            print(f"[chaos] restarted group {victim}", flush=True)

        procs = [p for grp in groups for p in grp]
        outs = [p.communicate(timeout=240)[0] for p in procs]
        rc = max(p.returncode for p in procs)
        hashes = set()
        for out in outs:
            print(out, end="")
            for line in out.splitlines():
                if "params_sha=" in line:
                    hashes.add(line.rsplit("params_sha=", 1)[1].strip())
        if killed_out:
            print("[chaos] killed incarnation output:")
            print(killed_out, end="")
        if args.chaos and rc == 0:
            # prove the LIVE HEAL ran: the restarted incarnation's first
            # commit must land at the survivors' step, not replay from 0
            victim_firsts = []
            for p_ in groups[args.groups - 1]:
                i = procs.index(p_)
                for line in outs[i].splitlines():
                    if "first_commit=" in line:
                        val = line.split("first_commit=")[1].split()[0]
                        # "None" = the restarted worker healed straight to
                        # the final step and never committed — counts as
                        # heal-not-proven, not a launcher crash
                        victim_firsts.append(-1 if val == "None" else int(val))
            if not victim_firsts or min(victim_firsts) <= 0:
                print(f"ERROR: restarted group did not heal forward "
                      f"(first commits {victim_firsts}) — kill landed "
                      f"before any survivor commit, or heal was skipped")
                rc = 1
            else:
                print(f"[chaos] restarted group healed to step "
                      f"{min(victim_firsts)} before its first commit")
        if rc == 0 and len(hashes) == 1 and outs:
            n = args.groups * args.procs_per_group
            suffix = " after chaos kill+rejoin" if args.chaos else ""
            print(f"params converged bitwise across {n} processes "
                  f"({args.groups} groups x {args.procs_per_group} hosts)"
                  f"{suffix}")
        elif rc == 0:
            print(f"ERROR: divergent params across processes: {hashes}")
            rc = 1
        return rc
    finally:
        for grp in groups:
            for p in grp:
                if p.poll() is None:
                    p.kill()
        for s in stores:
            s.shutdown()
        lighthouse.shutdown()


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.worker:
        return worker(args)
    return launch(args)


if __name__ == "__main__":
    sys.exit(main())
