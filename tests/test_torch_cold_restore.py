"""Whole-fleet cold restore through the port's Managers, on the CPU.

The durable store's golden fixture (``cold_restore.json``, written by
tests/test_golden_fixtures.py with numpy state) is replayed bitwise with
torch tensors: two groups spill every committed step under
``TORCHFT_STORE_DIR``, the whole fleet dies at a fixed step with its memory
lost, and the restarted groups restore the newest spilled cut from both
disks.  A store the JAX package wrote restores a port fleet of numpy state,
a torn blob fails over to the other disk, and a restore that cannot
complete falls back to a fresh init.
"""

import json
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from torchft_tpu.checkpointing import store as jstore
from torchft_tpu_torch.checkpointing import store as tstore
from torchft_tpu_torch.coordination import LighthouseServer
from torchft_tpu_torch.manager import Manager
from torchft_tpu_torch.parallel.process_group import ProcessGroupTCP
from torchft_tpu_torch.utils import faults
from torchft_tpu_torch.utils import flightrecorder as flightrec
from torchft_tpu_torch.utils.faults import FaultRule, InjectedFault

FIXTURES = Path(__file__).parent / "fixtures"


@pytest.fixture(autouse=True)
def clean_faults():
    faults.FAULTS.configure([], seed=0)
    yield
    faults.FAULTS.configure([])


def _manager(name, replica_id, lighthouse_addr, load_state_dict, state_dict):
    return Manager(
        pg=ProcessGroupTCP(timeout=10.0), min_replica_size=2,
        load_state_dict=load_state_dict, state_dict=state_dict,
        lighthouse_addr=lighthouse_addr, replica_id=f"{name}_{replica_id}",
        group_rank=0, group_world_size=1, use_async_quorum=False,
        timeout=20.0, quorum_timeout=20.0,
    )


def _fleet(fn, n=2):
    lh = LighthouseServer(
        min_replicas=n, join_timeout_ms=100, heartbeat_timeout_ms=1000
    )
    try:
        with ThreadPoolExecutor(max_workers=n) as ex:
            futures = [ex.submit(fn, i, lh.address()) for i in range(n)]
            return [f.result(timeout=120) for f in futures]
    finally:
        lh.shutdown()


def _cold_restore_replica(replica_id, lighthouse_addr, barrier, infos):
    """tests/test_golden_fixtures.py's cold-restore replica on torch
    tensors: momentum SGD, the whole fleet killed at a fixed step with its
    memory lost (fresh zeros); the barrier holds every group down until
    all have shut down and flushed their final spill."""
    history = []
    for _attempt in range(3):
        params = {"w": torch.zeros(4)}
        momentum = {"w": torch.zeros(4)}

        def load_state_dict(sd):
            params["w"] = sd["params"]["w"].clone()
            momentum["w"] = sd["momentum"]["w"].clone()

        def state_dict():
            return {"params": {"w": params["w"]}, "momentum": {"w": momentum["w"]}}

        manager = _manager("golden_cr", replica_id, lighthouse_addr,
                           load_state_dict, state_dict)
        try:
            while manager.current_step() < 5:
                faults.check("train.step", replica=f"golden_cr_{replica_id}",
                             step=manager.current_step())
                manager.start_quorum()
                step = manager.current_step()
                grads = {"w": torch.full((4,), float(step + 1)) * (1.0 + 0.5 * replica_id)}
                avg = manager.allreduce(grads).wait(timeout=30)
                if manager.should_commit():
                    momentum["w"] = 0.9 * momentum["w"] + avg["w"]
                    params["w"] = params["w"] - 0.1 * momentum["w"]
                    history.append({
                        "step": manager.current_step(),
                        "w": [float(x) for x in params["w"]],
                        "momentum": [float(x) for x in momentum["w"]],
                    })
            infos[replica_id] = manager.heal_info()
            return history
        except InjectedFault:
            barrier.wait(timeout=60)
            continue
        finally:
            manager.shutdown()
    raise RuntimeError(f"replica {replica_id} exhausted attempts")


def test_cold_restore_fixture_replays_with_torch_tensors(tmp_path, monkeypatch):
    monkeypatch.setenv("TORCHFT_STORE_DIR", str(tmp_path))
    golden = json.loads((FIXTURES / "cold_restore.json").read_text())
    faults.FAULTS.configure([
        FaultRule(site="train.step", replica=f"golden_cr_{i}",
                  step=golden["kill_step"])
        for i in range(2)
    ])
    barrier = threading.Barrier(2)
    infos = {}
    flightrec.RECORDER.clear()
    histories = _fleet(
        lambda r, addr: _cold_restore_replica(r, addr, barrier, infos)
    )
    assert faults.FAULTS.injected("train.step") == 2
    assert {f"replica_{i}": h for i, h in enumerate(histories)} == golden["history"]
    # both groups restored the killed step's cut from both disks
    for i in range(2):
        restore = infos[i]["restore"]
        assert restore["version"] == golden["kill_step"]
        assert restore["disks"] == 2
    assert sorted(os.listdir(tmp_path)) == ["golden_cr_0", "golden_cr_1"]
    # disk-served fragments go straight to the Python plane: the native
    # server holds none of them and would park each request for its whole
    # poll window before missing
    assert not [
        r for r in flightrec.RECORDER.snapshot()
        if r.get("op") == "fragment.native_fallback"
        and r.get("step") == golden["kill_step"]
    ]


def _numpy_replica(name, replica_id, lighthouse_addr, steps, out):
    """A group of numpy state that records what it holds after its first
    quorum, then trains ``steps`` steps."""
    state = {"w": np.zeros(8, dtype=np.float32), "b": np.zeros(3, np.float64)}

    def load_state_dict(sd):
        state.update({k: np.array(v) for k, v in sd.items()})

    manager = _manager(name, replica_id, lighthouse_addr, load_state_dict,
                       lambda: dict(state))
    try:
        manager.start_quorum()
        out[replica_id] = (
            manager.current_step(), {k: v.copy() for k, v in state.items()},
            manager.heal_info(),
        )
        for _ in range(steps):
            avg = manager.allreduce({"g": np.ones(8, np.float32)}).wait(timeout=30)
            if manager.should_commit():
                state["w"] = state["w"] - avg["g"]
            manager.start_quorum()
    finally:
        manager.shutdown()


def _jax_spill(tmp_path, name, state, version=3):
    """Each replica's disk as the JAX package's Manager writes it."""
    for i in range(2):
        jstore.FragmentStore(str(tmp_path / f"{name}_{i}")).put_state(
            version,
            {"user": {"default": state},
             "torchft": {"step": version, "batches_committed": 2 * version}},
        )


def test_a_store_the_jax_package_wrote_restores_a_port_fleet(tmp_path, monkeypatch):
    monkeypatch.setenv("TORCHFT_STORE_DIR", str(tmp_path))
    rng = np.random.default_rng(5)
    state = {"w": rng.standard_normal(8).astype(np.float32),
             "b": rng.standard_normal(3)}
    _jax_spill(tmp_path, "jaxcr", state)
    out = {}
    _fleet(lambda r, addr: _numpy_replica("jaxcr", r, addr, 0, out))
    for i in range(2):
        step, got, info = out[i]
        assert step == 3
        assert info["restore"]["version"] == 3
        for k in state:
            assert got[k].dtype == state[k].dtype
            np.testing.assert_array_equal(got[k], state[k])


def test_a_torn_blob_fails_over_to_the_other_disk(tmp_path, monkeypatch):
    monkeypatch.setenv("TORCHFT_STORE_DIR", str(tmp_path))
    state = {"w": np.arange(8, dtype=np.float32), "b": np.arange(3.0)}
    _jax_spill(tmp_path, "torn", state)
    # tear every blob of disk 0 mid-file: its catalog marks the version
    # incomplete, and the cut's union is still covered by disk 1
    blobs = tmp_path / "torn_0" / "blobs"
    for name in os.listdir(blobs):
        raw = bytearray((blobs / name).read_bytes())
        raw[len(raw) // 2] ^= 0xFF
        (blobs / name).write_bytes(bytes(raw))
    cat = tstore.FragmentStore(str(tmp_path / "torn_0")).catalog()
    assert cat[3]["complete"] is False and cat[3]["frags_ok"] == []
    out = {}
    _fleet(lambda r, addr: _numpy_replica("torn", r, addr, 0, out))
    for i in range(2):
        step, got, _ = out[i]
        assert step == 3
        for k in state:
            np.testing.assert_array_equal(got[k], state[k])


def test_a_failed_restore_falls_back_to_a_fresh_init(tmp_path, monkeypatch):
    monkeypatch.setenv("TORCHFT_STORE_DIR", str(tmp_path))
    state = {"w": np.arange(8, dtype=np.float32), "b": np.arange(3.0)}
    _jax_spill(tmp_path, "fresh", state)
    faults.FAULTS.configure([FaultRule(site="store.restore", times=-1)])
    out = {}
    _fleet(lambda r, addr: _numpy_replica("fresh", r, addr, 1, out))
    for i in range(2):
        step, got, info = out[i]
        assert step == 0 and "restore" not in info
        np.testing.assert_array_equal(got["w"], np.zeros(8, np.float32))
    assert faults.FAULTS.injected("store.restore") == 2
    # the fresh fleet trained a step and spilled it over the old version
    cat = tstore.FragmentStore(str(tmp_path / "fresh_0")).catalog()
    assert max(cat) == 3 and 1 in cat
