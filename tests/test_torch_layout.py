"""The port's online re-shard against the JAX package's, on the CPU.

The planner (``feasible_layouts``, ``plan_layout``), the interval math
(``partition``, ``shard_interval``, ``interval_subtract``, ``plan_fetches``)
and the ``LayoutState`` epoch machine must give the JAX package's answers
over a parametrised grid of worlds and constraints.  The shrink golden
fixture (``reshard_shrink.json``, written by tests/test_reshard_integ.py
with numpy state) is replayed bitwise through port Managers whose sharded
state is torch tensors, and the ``LocalSGD``/``DiLoCo`` listeners must
fire on a committed switch.
"""

import itertools
import json
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import chip_smoke
from torchft_tpu.parallel import layout as jl
from torchft_tpu_torch.coordination import LighthouseServer
from torchft_tpu_torch.local_sgd import DiLoCo, LocalSGD, OuterSGD
from torchft_tpu_torch.manager import Manager
from torchft_tpu_torch.parallel import layout as tl
from torchft_tpu_torch.parallel.process_group import ProcessGroupTCP
from torchft_tpu_torch.utils import faults
from torchft_tpu_torch.utils.faults import FaultRule, InjectedFault

FIXTURES = Path(__file__).parent / "fixtures"

CONSTRAINTS = [
    dict(),
    dict(min_dp=2),
    dict(layers=4, max_pp=4),
    dict(layers=6, max_pp=3, min_dp=2),
    dict(global_batch_size=3),
    dict(param_bytes=4096, shard_memory_bytes=2048),
    dict(param_bytes=4096, shard_memory_bytes=1000, layers=8, max_pp=2),
    dict(param_bytes=10**9, shard_memory_bytes=10),
]


@pytest.mark.parametrize("ci", range(len(CONSTRAINTS)))
def test_planner_matches_the_jax_package(ci):
    jc = jl.LayoutConstraints(**CONSTRAINTS[ci])
    tc = tl.LayoutConstraints(**CONSTRAINTS[ci])
    for world in range(0, 13):
        assert sorted(tl.feasible_layouts(world, tc)) == sorted(
            jl.feasible_layouts(world, jc)
        )
        for prev in (None, (2, 2, 1), (1, 3, 1), (1, 1, 4)):
            jp = None if prev is None else jl.Layout(*prev, epoch=1)
            tp = None if prev is None else tl.Layout(*prev, epoch=1)
            try:
                want = jl.plan_layout(world, jc, prev=jp, epoch=5)
            except jl.LayoutError:
                with pytest.raises(tl.LayoutError):
                    tl.plan_layout(world, tc, prev=tp, epoch=5)
                continue
            got = tl.plan_layout(world, tc, prev=tp, epoch=5)
            assert tuple(got) == tuple(want)
            assert [got.coords(r) for r in range(got.world)] == [
                want.coords(r) for r in range(want.world)
            ]
            assert [got.shard_index(r) for r in range(got.world)] == [
                want.shard_index(r) for r in range(want.world)
            ]


@pytest.mark.parametrize("n", [0, 1, 7, 1024, 1025])
def test_interval_math_matches_the_jax_package(n):
    for k in range(1, 7):
        assert tl.partition(n, k) == jl.partition(n, k)
        for r in range(k):
            assert tl.shard_interval(n, r, k) == jl.shard_interval(n, r, k)
    rng = np.random.default_rng(n)
    for _ in range(50):
        a = tuple(sorted(rng.integers(0, n + 3, 2).tolist()))
        holes = [tuple(sorted(rng.integers(0, n + 3, 2).tolist())) for _ in range(3)]
        assert tl.interval_subtract(a, holes) == jl.interval_subtract(a, holes)
        assert tl.interval_intersect(a, holes[0]) == jl.interval_intersect(a, holes[0])


@pytest.mark.parametrize("old_k,new_k", list(itertools.product([1, 2, 3, 4], repeat=2)))
def test_plan_fetches_matches_the_jax_package(old_k, new_k):
    n = 1001
    for dst in range(new_k):
        need = tl.shard_interval(n, dst, new_k)
        for holder in (None, dst % old_k):
            have = [] if holder is None else [tl.shard_interval(n, holder, old_k)]
            owners = [(r, tl.shard_interval(n, r % old_k, old_k)) for r in range(old_k + 1)]
            owners = owners[dst % len(owners):] + owners[: dst % len(owners)]
            assert tl.plan_fetches(need, have, owners) == jl.plan_fetches(
                need, have, owners
            )
    with pytest.raises(tl.ReshardError):
        tl.plan_fetches((0, 10), [], [(0, (0, 5))])


def _drive(mod, events):
    st = mod.LayoutState()
    out = []
    for ev, arg in events:
        try:
            if ev == "stage":
                st.stage(mod.Layout(*arg))
                res = None
            elif ev == "commit":
                res = tuple(st.commit(arg))
            elif ev == "rollback":
                res = st.rollback(arg)
            else:
                res = st.observe_epoch(arg)
        except mod.LayoutError as e:
            res = ("error", str(e))
        out.append((res, st.active_epoch, st.next_epoch(), st.is_burned(2)))
    return out


@pytest.mark.parametrize("seed", range(6))
def test_epoch_machine_matches_the_jax_package(seed):
    rng = np.random.default_rng(seed)
    events = []
    for _ in range(40):
        ev = ["stage", "commit", "rollback", "observe"][rng.integers(4)]
        e = int(rng.integers(0, 7))
        arg = (int(rng.integers(1, 4)), 2, 1, e) if ev == "stage" else e
        events.append((ev, arg))
    assert _drive(tl, events) == _drive(jl, events)


# ---------------------------------------------------------------------------
# the shrink golden fixture through port Managers, on torch tensors
# ---------------------------------------------------------------------------

N = 1024


class _Group:
    """tests/test_reshard_integ.py's deterministic group on torch tensors:
    params start as arange(N); each committed step applies
    ``owned -= 0.1 * g`` (``g = step``) through ``update_sharded``."""

    def __init__(self, gid, lighthouse_addr, total_steps, die_at=None):
        self.gid, self.addr, self.total = gid, lighthouse_addr, total_steps
        self.die_at = die_at
        self.history, self.final, self.controller = [], None, None

    def run(self):
        try:
            self._train()
        except InjectedFault:
            pass  # simulated process death

    def _train(self):
        shard = {"w": torch.arange(N, dtype=torch.float32)}
        ctrl = tl.LayoutController(
            tl.LayoutConstraints(param_bytes=N * 4, shard_memory_bytes=N * 2)
        )
        self.controller = ctrl
        ctrl.register_sharded_state(
            "model", {"w": N}, lambda: dict(shard),
            lambda new: shard.update({k: v.clone() for k, v in new.items()}),
        )
        user = {"marker": float(self.gid)}
        manager = Manager(
            pg=ProcessGroupTCP(timeout=15.0), min_replica_size=1,
            load_state_dict=lambda sd: user.update(sd),
            state_dict=lambda: dict(user),
            lighthouse_addr=self.addr, replica_id=f"rs_{self.gid}",
            group_rank=0, group_world_size=1, use_async_quorum=True,
            init_sync=False, timeout=15.0, quorum_timeout=15.0,
            max_retries=6 * self.total,
        )
        manager.attach_layout(ctrl)
        try:
            while manager.current_step() < self.total:
                step = manager.current_step()
                if self.die_at is not None:
                    faults.check("train.step", replica=f"rs_{self.gid}", step=step)
                manager.start_quorum()
                g = torch.full((N,), float(step + 1))
                avg = manager.allreduce({"g": g}).wait(timeout=15)
                if manager.should_commit():
                    ctrl.update_sharded(
                        "model",
                        lambda leaf, arr, start: arr.sub_(
                            torch.tensor(0.1) * avg["g"][start : start + arr.numel()]
                        ),
                    )
                    layout = ctrl.active_layout()
                    idx, nsh = ctrl.shard_coords()
                    self.history.append({
                        "step": manager.current_step(),
                        "layout": list(layout.key()) if layout else None,
                        "shard": idx, "nshards": nsh,
                        "first": float(shard["w"][0]),
                        "sum": float(shard["w"].double().sum()),
                    })
            self.final = (*ctrl.shard_coords(), shard["w"].clone())
        finally:
            manager.shutdown()


def test_shrink_fixture_replays_with_torch_tensors():
    golden = json.loads((FIXTURES / "reshard_shrink.json").read_text())
    faults.FAULTS.configure([
        FaultRule(site="train.step", replica="rs_3", step=golden["kill_step"])
    ])
    lh = LighthouseServer(min_replicas=1, join_timeout_ms=100, heartbeat_timeout_ms=1000)
    # Without a hold, min_replicas=1 and the 100 ms join timeout let the
    # first quorum form before a group thread slow to start has joined, and
    # that group joins a step late (tests/test_diagnose.py:410-417 holds
    # its first quorum the same way).
    holder = threading.Thread(target=chip_smoke.hold_first_quorum,
                              args=(lh.address(), 4, 60.0), daemon=True)
    holder.start()
    groups = [
        _Group(i, lh.address(), golden["total_steps"],
               die_at=golden["kill_step"] if i == 3 else None)
        for i in range(4)
    ]
    try:
        threads = [threading.Thread(target=g.run, daemon=True) for g in groups]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 120
        for t in threads:
            t.join(timeout=max(deadline - time.monotonic(), 0.1))
        holder.join(timeout=max(deadline - time.monotonic(), 0.1))
        assert not any(t.is_alive() for t in threads), "fleet wedged mid-switch"
    finally:
        faults.FAULTS.configure([])
        lh.shutdown()
    assert {f"group_{g.gid}": g.history for g in groups} == golden["history"]
    survivors = [g for g in groups if g.gid != 3]
    epochs = {g.controller.active_layout().epoch for g in survivors}
    assert len(epochs) == 1
    for g in survivors:
        assert g.controller.active_layout().key() == (1, 3, 1)
        # every earlier epoch was committed or burned, none reused
        assert g.controller.state.next_epoch() > max(epochs)
    full = torch.cat([g.final[2] for g in sorted(survivors, key=lambda g: g.final[0])])
    assert [float(x) for x in full[:8]] == golden["final_first8"]
    assert float(full.double().sum()) == golden["final_sum"]


# ---------------------------------------------------------------------------
# the LocalSGD / DiLoCo layout listeners
# ---------------------------------------------------------------------------


class _StubManager:
    _use_async_quorum = False

    def __init__(self, controller):
        self._controller = controller

    def register_state_dict_fn(self, key, load_fn, save_fn):
        pass

    def layout_controller(self):
        return self._controller


def _commit_a_switch(ctrl):
    """Stage a (1, 2, 1) layout at epoch 1 and run the commit round."""
    layout = tl.Layout(1, 2, 1, epoch=1)
    ctrl.state.active = tl.Layout(2, 1, 1, epoch=0)
    ctrl.state.stage(layout)
    ctrl._staged = tl._Staged(layout=layout, shard_index=0, data={},
                              starts={}, planned_world=2)
    ctrl.on_step_commit(True)
    quorum = SimpleNamespace(min_layout_epoch=1, max_layout_epoch=1,
                             replica_world_size=2, replica_rank=0,
                             store_address="")
    assert ctrl.maybe_commit(quorum) == "committed"


def test_local_sgd_and_diloco_listen_for_a_committed_switch():
    ctrl = tl.LayoutController(tl.LayoutConstraints())
    manager = _StubManager(ctrl)
    params = {"a": torch.ones(4), "b": torch.zeros(3)}
    lsgd = LocalSGD(manager, lambda: dict(params), params.update, sync_every=4)
    diloco = DiLoCo(manager, [["a"], ["b"]], lambda: dict(params),
                    params.update, OuterSGD(0.7), sync_every=4)
    lsgd._local_step = 3
    params["a"] = torch.full((4,), 5.0)
    diloco._fragments[0]._allreduce_work.append(object())
    _commit_a_switch(ctrl)
    assert lsgd._local_step == 0
    assert diloco._fragments[0]._allreduce_work == []
    assert torch.equal(diloco._fragments[0].original_parameters["a"],
                       torch.full((4,), 5.0))
    assert ctrl.last_switch["result"] == "committed"
