"""LocalSGD / DiLoCo and bf16 allreduce leaves through the port, held to
the JAX package bit for bit.

- The five LocalSGD / DiLoCo variants of tests/test_diloco_regression.py
  replay their committed golden fixtures (read, never written) through the
  port's Manager, ``LocalSGD`` / ``DiLoCo`` and ``OuterSGD``.
- A quantized DiLoCo with ``device_quantize=True`` on CPU tensors (kernel
  D's plain twin quantizes each sync) matches the JAX ``DiLoCo`` on the
  same numpy inputs bit for bit, as tests/test_local_sgd_integ.py runs it.
  The JAX side's quantizer is the IEEE rule written in numpy, for the
  reason tests/test_torch_collectives.py gives.
- bf16 leaves through the port's ``Manager.allreduce`` equal the JAX
  Manager's through ``ml_dtypes``, for 2 and 3 ranks, alone and in a tree
  mixed with f32 leaves.

Each replica group is a thread with its own Manager and ProcessGroupTCP on
one lighthouse (the threads-as-replicas harness of the JAX tests).
"""

import json
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch

from torchft_tpu.coordination import LighthouseServer as JaxLighthouse
from torchft_tpu.local_sgd import DiLoCo as JaxDiLoCo
from torchft_tpu.manager import Manager as JaxManager
from torchft_tpu.ops import pallas_quant as jpq
from torchft_tpu.parallel.process_group import ProcessGroupTCP as JaxPG
from torchft_tpu_torch import Manager, PGTransport, ProcessGroupTCP
from torchft_tpu_torch.coordination import LighthouseServer
from torchft_tpu_torch.local_sgd import DiLoCo, LocalSGD, OuterSGD
from torchft_tpu_torch.ops import pallas_quant as tpq
from torchft_tpu_torch.parallel.process_group import REDUCE_AVG, REDUCE_SUM

FIXTURES = Path(__file__).parent / "fixtures"

# tests/test_diloco_regression.py:111-139
VARIANTS = {
    "local_sgd": {"algo": "local_sgd", "sync_every": 3, "target_steps": 4},
    "diloco_1frag": {
        "algo": "diloco", "fragments": [["layer0", "layer1"]],
        "sync_every": 2, "target_steps": 3,
    },
    "diloco_2frag": {
        "algo": "diloco", "fragments": [["layer0"], ["layer1"]],
        "sync_every": 4, "target_steps": 6,
    },
    "diloco_2frag_delay1": {
        "algo": "diloco", "fragments": [["layer0"], ["layer1"]],
        "sync_every": 4, "fragment_sync_delay": 1, "target_steps": 6,
    },
    "diloco_2frag_alpha05": {
        "algo": "diloco", "fragments": [["layer0"], ["layer1"]],
        "sync_every": 4, "fragment_update_alpha": 0.5, "target_steps": 6,
    },
}


def _run(n, fn):
    with ThreadPoolExecutor(max_workers=n) as ex:
        futures = [ex.submit(fn, r) for r in range(n)]
        return [f.result(timeout=120) for f in futures]


def _delta(replica: int, i: int) -> float:
    """The golden test's inner step, ``np.float32(0.01 (1+i)(1+replica))``,
    as the exact f32 value."""
    return float(np.float32(0.01 * (1 + i) * (1 + replica)))


def _port_manager(
    replica_id, lighthouse_addr, holder, min_replicas, prefix, init_sync=True
):
    pg = ProcessGroupTCP(timeout=20.0)
    box = {}
    manager = Manager(
        pg=pg, min_replica_size=min_replicas, lighthouse_addr=lighthouse_addr,
        replica_id=f"{prefix}_{replica_id}", group_rank=0, group_world_size=1,
        use_async_quorum=False, timeout=30.0, quorum_timeout=30.0,
        init_sync=init_sync,
        load_state_dict=lambda sd: holder.__setitem__(
            "p", {k: v.clone() for k, v in sd.items()}
        ),
        state_dict=lambda: {k: v.clone() for k, v in holder["p"].items()},
        checkpoint_transport=PGTransport(
            pg, timeout=30.0, state_dict_fn=lambda: box["m"]._manager_state_dict()
        ),
    )
    box["m"] = manager
    return manager


def _port_golden_replica(replica_id, lighthouse_addr, variant, barrier):
    holder = {"p": {"layer0": torch.zeros(4), "layer1": torch.zeros(4)}}
    manager = _port_manager(replica_id, lighthouse_addr, holder, 2, "golden")
    get_params = lambda: dict(holder["p"])  # noqa: E731
    set_params = lambda p: holder.__setitem__("p", dict(p))  # noqa: E731
    history = []
    try:
        if variant["algo"] == "local_sgd":
            algo = LocalSGD(manager, get_params, set_params, variant["sync_every"])
        else:
            algo = DiLoCo(
                manager, variant["fragments"], get_params, set_params,
                OuterSGD(0.5, momentum=0.9, nesterov=True),
                sync_every=variant["sync_every"],
                fragment_sync_delay=variant.get("fragment_sync_delay", 0),
                fragment_update_alpha=variant.get("fragment_update_alpha", 0.0),
            )
        barrier.wait(timeout=60)
        last_step = manager.current_step()
        while manager.current_step() < variant["target_steps"]:
            p = dict(holder["p"])
            for i, k in enumerate(sorted(p)):
                p[k] = p[k] - _delta(replica_id, i)
            holder["p"] = p
            algo.step()
            step = manager.current_step()
            if step != last_step:
                last_step = step
                history.append({
                    "step": step,
                    "params": {k: holder["p"][k].tolist() for k in sorted(holder["p"])},
                })
        return history
    finally:
        manager.shutdown()


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_golden_fixture_replays_through_the_port(name):
    variant = VARIANTS[name]
    lighthouse = LighthouseServer(min_replicas=2, join_timeout_ms=100)
    barrier = threading.Barrier(2)
    try:
        histories = _run(2, lambda r: _port_golden_replica(
            r, lighthouse.address(), variant, barrier))
    finally:
        lighthouse.shutdown()
    golden = json.loads((FIXTURES / f"{name}.json").read_text())
    assert histories[0] == golden
    assert len(histories[1]) == len(golden)


# ---------------------------------------------------------------------------
# quantized DiLoCo, device path on CPU tensors, against the JAX DiLoCo
# ---------------------------------------------------------------------------

# Both replicas start from the same weights with init_sync off, so neither
# heals at the first quorum and every sync reduces two different
# pseudogradients.
ELEMS, SYNCS = 3000, 2  # (rows, 2048) fragments of 2 rows


def _ieee_quantize(mat):
    x = np.asarray(mat, dtype=np.float32)
    absmax = np.abs(x).max(axis=1)
    scales = np.where(absmax > 0, absmax / np.float32(127.0), 1.0).astype(np.float32)
    q = np.clip(np.rint(x / scales[:, None]), -127, 127).astype(np.int8)
    return jnp.asarray(scales), jnp.asarray(q)


def _init(replica_id):
    rng = np.random.default_rng(7)  # the same start on every replica
    return {k: rng.standard_normal(ELEMS).astype(np.float32) for k in ("layer0", "layer1")}


def _inner(replica_id, step, k):
    rng = np.random.default_rng(1000 * replica_id + 10 * step + (k == "layer1"))
    return rng.standard_normal(ELEMS).astype(np.float32) * np.float32(0.01)


def _jax_quant_replica(replica_id, lighthouse_addr):
    holder = {"p": _init(replica_id)}
    manager = JaxManager(
        pg=JaxPG(timeout=20.0), min_replica_size=2, lighthouse_addr=lighthouse_addr,
        replica_id=f"qd_{replica_id}", group_rank=0, group_world_size=1,
        use_async_quorum=False, timeout=30.0, quorum_timeout=30.0,
        load_state_dict=lambda sd: None, state_dict=lambda: {}, init_sync=False,
    )
    try:
        algo = JaxDiLoCo(
            manager, [["layer0"], ["layer1"]], lambda: dict(holder["p"]),
            lambda p: holder.__setitem__("p", dict(p)),
            optax.sgd(0.7, momentum=0.9, nesterov=True), sync_every=4,
            should_quantize=True, fragment_sync_delay=1, device_quantize=True,
        )
        n = 0
        while manager.current_step() < 2 * SYNCS:
            holder["p"] = {
                k: np.asarray(v) - _inner(replica_id, n, k) for k, v in holder["p"].items()
            }
            n += 1
            algo.step()
        return {k: np.asarray(v) for k, v in holder["p"].items()}
    finally:
        manager.shutdown()


def _port_quant_replica(replica_id, lighthouse_addr):
    holder = {"p": {k: torch.from_numpy(v) for k, v in _init(replica_id).items()}}
    manager = _port_manager(
        replica_id, lighthouse_addr, holder, 2, "qd", init_sync=False
    )
    try:
        algo = DiLoCo(
            manager, [["layer0"], ["layer1"]], lambda: dict(holder["p"]),
            lambda p: holder.__setitem__("p", dict(p)),
            OuterSGD(0.7, momentum=0.9, nesterov=True), sync_every=4,
            should_quantize=True, fragment_sync_delay=1, device_quantize=True,
        )
        n = 0
        while manager.current_step() < 2 * SYNCS:
            holder["p"] = {
                k: v - torch.from_numpy(_inner(replica_id, n, k))
                for k, v in holder["p"].items()
            }
            n += 1
            algo.step()
            if n == 3:  # the first sync's Work, after its wait
                last = algo.last_sync
                assert last["fragment"] == 0 and last["committed"]
                assert last["device_quantized"] and last["wire_dtype"] == "int8"
                # alltoall + allgather of one packed 2048-wide row slice
                # (header, f32 scale, int8 codes) per peer
                assert last["wire_bytes"] == 2 * (4 + 4 + 2048)
                assert last["unquantized_wire_bytes"] == 4 * ELEMS
        return {k: v.numpy() for k, v in holder["p"].items()}
    finally:
        manager.shutdown()


def test_quantized_diloco_device_path_matches_jax(monkeypatch):
    monkeypatch.setattr(jpq, "fused_quantize_into_int8", _ieee_quantize)
    jlh = JaxLighthouse(min_replicas=2, join_timeout_ms=100)
    try:
        want = _run(2, lambda r: _jax_quant_replica(r, jlh.address()))
    finally:
        jlh.shutdown()
    calls = tpq.quantize_int8_plain.calls
    lh = LighthouseServer(min_replicas=2, join_timeout_ms=100)
    try:
        got = _run(2, lambda r: _port_quant_replica(r, lh.address()))
    finally:
        lh.shutdown()
    # one device quantize per sync per replica, through the twin on the CPU
    assert tpq.quantize_int8_plain.calls - calls == 2 * 2 * SYNCS
    for g, w in zip(got, want):
        for k in w:
            np.testing.assert_array_equal(g[k].view(np.int32), w[k].view(np.int32))
    # the last sync (fragment 1) left that fragment equal on both replicas
    np.testing.assert_array_equal(got[0]["layer1"], got[1]["layer1"])


# ---------------------------------------------------------------------------
# bf16 leaves through Manager.allreduce
# ---------------------------------------------------------------------------


def _tree(world, kind):
    rng = np.random.default_rng(world)
    trees = []
    for r in range(world):
        t = {"a": (rng.standard_normal((5, 7)) * (r + 1)).astype(np.float32),
             "c": (rng.standard_normal(300) * 3).astype(np.float32)}
        if kind == "mixed":
            t["b"] = rng.standard_normal(11).astype(np.float32)
        trees.append(t)
    return trees


def _bf16(kind, k):
    return k != "b"  # "b", in the mixed tree only, stays f32


@pytest.mark.parametrize("world,kind,op", [
    (2, "bf16", REDUCE_AVG), (3, "bf16", REDUCE_SUM), (3, "mixed", REDUCE_AVG),
])
def test_bf16_allreduce_leaves_match_jax_manager(world, kind, op):
    """The ring sums a bf16 leaf in f32 and rounds the sum to bf16 (nearest
    even).  Under AVG the JAX Manager then divides that bf16 array by the
    participant count, which numpy (2.x, with ml_dtypes) promotes to f32:
    the averaged leaf comes back f32, the summed one bf16."""
    trees = _tree(world, kind)

    def jax_replica(r):
        m = JaxManager(
            pg=JaxPG(timeout=20.0), min_replica_size=world,
            lighthouse_addr=jlh.address(), replica_id=f"bf_{r}", group_rank=0,
            group_world_size=1, use_async_quorum=False, timeout=30.0,
            quorum_timeout=30.0, load_state_dict=lambda sd: None,
            state_dict=lambda: {},
        )
        try:
            m.start_quorum()
            out = m.allreduce({
                k: v.astype(ml_dtypes.bfloat16) if _bf16(kind, k) else v
                for k, v in trees[r].items()
            }, reduce_op=op).wait(timeout=30)
            assert m.should_commit()
            return {k: np.asarray(v) for k, v in out.items()}
        finally:
            m.shutdown()

    def port_replica(r):
        holder = {"p": {}}
        m = _port_manager(r, lh.address(), holder, world, "bf")
        try:
            m.start_quorum()
            out = m.allreduce({
                k: torch.from_numpy(v).to(torch.bfloat16) if _bf16(kind, k)
                else torch.from_numpy(v)
                for k, v in trees[r].items()
            }, reduce_op=op).wait(timeout=30)
            assert m.should_commit()
            return out
        finally:
            m.shutdown()

    jlh = JaxLighthouse(min_replicas=world, join_timeout_ms=100)
    lh = LighthouseServer(min_replicas=world, join_timeout_ms=100)
    try:
        want = _run(world, jax_replica)
        got = _run(world, port_replica)
    finally:
        jlh.shutdown()
        lh.shutdown()
    for g, w in zip(got, want):
        for k in w:
            if _bf16(kind, k) and op == REDUCE_SUM:
                assert g[k].dtype == torch.bfloat16
                assert w[k].dtype == ml_dtypes.bfloat16
                np.testing.assert_array_equal(
                    g[k].view(torch.int16).numpy(), w[k].view(np.int16)
                )
            else:
                assert g[k].dtype == torch.float32 and w[k].dtype == np.float32
                np.testing.assert_array_equal(g[k].numpy().view(np.int32), w[k].view(np.int32))


def test_ddp_should_quantize_matches_jax_ddp():
    """FT-DDP with ``should_quantize=True``: the gradients ride the int8
    quantized collective through ``Manager.allreduce`` (host codec for CPU
    tensors), bit for bit as in the JAX package, with its wire and codec
    accounting on the returned Work."""
    from torchft_tpu.ddp import DistributedDataParallel as JaxDDP
    from torchft_tpu_torch import DistributedDataParallel

    rng = np.random.default_rng(11)
    grads = [
        {"w": rng.standard_normal((3, 1000)).astype(np.float32),
         "b": rng.standard_normal(7).astype(np.float32)}
        for _ in range(2)
    ]

    def jax_replica(r):
        m = JaxManager(
            pg=JaxPG(timeout=20.0), min_replica_size=2,
            lighthouse_addr=jlh.address(), replica_id=f"qddp_{r}", group_rank=0,
            group_world_size=1, use_async_quorum=False, timeout=30.0,
            quorum_timeout=30.0, load_state_dict=lambda sd: None,
            state_dict=lambda: {}, init_sync=False,
        )
        try:
            m.start_quorum()
            out = JaxDDP(m, should_quantize=True).allreduce_gradients(grads[r]).wait(30)
            assert m.should_commit()
            return {k: np.asarray(v) for k, v in out.items()}
        finally:
            m.shutdown()

    def port_replica(r):
        m = _port_manager(r, lh.address(), {"p": {}}, 2, "qddp", init_sync=False)
        try:
            m.start_quorum()
            work = DistributedDataParallel(m, should_quantize=True).allreduce_gradients(
                {k: torch.from_numpy(v) for k, v in grads[r].items()}
            )
            out = work.wait(30)
            assert m.should_commit()
            assert work.wire_dtype == "int8" and not work.device_quantized
            assert work.quant_stats["n_chunks"] >= 1 and work.wire_bytes > 0
            return out
        finally:
            m.shutdown()

    jlh = JaxLighthouse(min_replicas=2, join_timeout_ms=100)
    lh = LighthouseServer(min_replicas=2, join_timeout_ms=100)
    try:
        want = _run(2, jax_replica)
        got = _run(2, port_replica)
    finally:
        jlh.shutdown()
        lh.shutdown()
    for g, w in zip(got, want):
        for k in w:
            np.testing.assert_array_equal(g[k].numpy().view(np.int32), w[k].view(np.int32))
