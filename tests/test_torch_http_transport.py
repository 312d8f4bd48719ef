"""The port's HTTP heal plane against the JAX package's.

- Fragment bytes: for one numpy state, the port's heal fragments and
  serving payloads (f32 and int8) have the same header and the same bytes
  and sha256 per fragment as the JAX package's.
- Interop: a JAX-package source staged with ``send_checkpoint_streamed``
  heals a port receiver bitwise, over the Python data plane and the native
  one.
- The striped-heal cases of tests/test_heal_striped.py, through the port,
  on torch tensor state: a full heal into retained tensors, a delta heal
  whose wire scales with the changed fragments, an identical state that
  fetches nothing, a source killed mid-heal, a dead source, a poisoned
  fragment, and the whole-document fallback.
- ``send_checkpoint`` snapshots by copy: a staged CPU tensor does not move
  when the source updates its tensors in place.
"""

import hashlib
import threading

import numpy as np
import pytest
import torch

from torchft_tpu.checkpointing import fragdata as jfragdata
from torchft_tpu.checkpointing import fragments as jfrags
from torchft_tpu.checkpointing.http_transport import HTTPTransport as JaxHTTPTransport
from torchft_tpu_torch.checkpointing import fragdata as tfragdata
from torchft_tpu_torch.checkpointing import fragments as tfrags
from torchft_tpu_torch.checkpointing.http_transport import HTTPTransport
from torchft_tpu_torch.utils import faults
from torchft_tpu_torch.utils import metrics as tmetrics
from torchft_tpu_torch.utils.faults import FaultRule


@pytest.fixture(autouse=True)
def clean_faults():
    faults.FAULTS.configure([], seed=0)
    yield
    faults.FAULTS.configure([])


def numpy_state(seed: int = 3) -> dict:
    """Nested numpy state with several dtypes, a 0-d leaf and scalars."""
    rng = np.random.default_rng(seed)
    return {
        "user": {
            "default": {
                "w": rng.standard_normal((33, 17)).astype(np.float32),
                "b": rng.standard_normal(17).astype(np.float32),
                "ids": rng.integers(0, 1000, 9).astype(np.int64),
                "half": rng.standard_normal(8).astype(np.float16),
                "scale": np.float32(rng.standard_normal()) * np.ones((), np.float32),
                "tags": ["x", 2, None],
            },
        },
        "torchft": {"step": 7, "batches_committed": 14},
    }


def tensor_state(leaves: int = 12, seed: int = 7) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "user": {
            f"w{i}": torch.from_numpy(rng.standard_normal(257).astype(np.float32))
            for i in range(leaves)
        },
        "torchft": {"step": 5, "batches_committed": 10},
    }


def clone_state(state: dict) -> dict:
    return {
        "user": {k: v.clone() for k, v in state["user"].items()},
        "torchft": dict(state["torchft"]),
    }


def zeroed(state: dict) -> dict:
    out = clone_state(state)
    for v in out["user"].values():
        v.zero_()
    out["torchft"] = {"step": 0, "batches_committed": 0}
    return out


def assert_state_equal(a: dict, b: dict) -> None:
    assert a["torchft"] == b["torchft"]
    assert set(a["user"]) == set(b["user"])
    for k in a["user"]:
        assert torch.equal(a["user"][k], b["user"][k]), k


# ---------------------------------------------------------------------------
# fragment bytes against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fragments", [1, 3, 8])
def test_heal_fragments_are_byte_identical_to_jax(fragments):
    state = numpy_state()
    th, titer = tfrags.iter_heal_fragments(state, fragments)
    jh, jiter = jfrags.iter_heal_fragments(state, fragments)
    assert th == jh
    tlist, jlist = list(titer), list(jiter)
    assert [n for n, _, _ in tlist] == jh["fragments"]
    for (tn, traw, tsha), (jn, jraw, jsha) in zip(tlist, jlist):
        assert tn == jn and traw == jraw and tsha == jsha
        assert tsha == hashlib.sha256(traw).hexdigest()
    assert tfrags.local_fragment_digests(state, fragments) == (
        jfrags.local_fragment_digests(state, fragments)
    )


@pytest.mark.parametrize("wire", ["f32", "int8"])
def test_serving_payload_is_byte_identical_to_jax(wire):
    state = numpy_state(seed=11)
    tdoc = tfrags.encode_payload(state, 4, wire=wire, fragments=3)
    jdoc = jfrags.encode_payload(state, 4, wire=wire, fragments=3)
    assert set(tdoc) == set(jdoc)
    tman, jman = tdoc["frag:manifest"], jdoc["frag:manifest"]
    for key in ("version", "wire", "fragments", "digests", "skeleton", "num_leaves"):
        assert tman[key] == jman[key], key
    for name in jman["fragments"]:
        assert tdoc[f"frag:{name}"] == jdoc[f"frag:{name}"]
    # and the port decodes the JAX document to the JAX package's values
    tstate, _, _ = tfrags.decode_payload(jdoc)
    jstate, _, _ = jfrags.decode_payload(jdoc)
    for k, v in jstate["user"]["default"].items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(tstate["user"]["default"][k], v)
        else:
            assert tstate["user"]["default"][k] == v


def test_int8_payload_of_a_tensor_leaf_matches_its_numpy_values():
    a = np.random.default_rng(5).standard_normal((6, 40)).astype(np.float32)
    tdoc = tfrags.encode_payload({"w": torch.from_numpy(a)}, 1, wire="int8")
    jdoc = jfrags.encode_payload({"w": a}, 1, wire="int8")
    assert tdoc["frag:0"] == jdoc["frag:0"]


# ---------------------------------------------------------------------------
# a JAX-package source heals a port receiver
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("native", ["0", "1"])
def test_jax_source_heals_port_receiver_bitwise(native, monkeypatch):
    monkeypatch.setenv("TORCHFT_FRAG_NATIVE", native)
    tfragdata.reset_port_cache()
    jfragdata.reset_port_cache()
    state = numpy_state(seed=23)
    sources = [JaxHTTPTransport(timeout=10.0) for _ in range(2)]
    healer = HTTPTransport(timeout=10.0)
    try:
        for src in sources:
            src.send_checkpoint_streamed([1], 6, state, 10.0, 4)
        got, info = healer.recv_checkpoint_striped(
            [s.metadata() for s in sources], 6, timeout=20.0, delta=False,
        )
        served = [
            s._frag_native.counters()["serves"] if s._frag_native else 0
            for s in sources
        ]
    finally:
        healer.shutdown()
        for src in sources:
            src.shutdown()
    assert info["mode"] == "full" and info["sources"] == 2
    assert got["torchft"] == state["torchft"]
    for k, v in state["user"]["default"].items():
        if isinstance(v, np.ndarray):
            g = got["user"]["default"][k]
            assert isinstance(g, np.ndarray) and g.dtype == v.dtype
            np.testing.assert_array_equal(g, v)
        else:
            assert got["user"]["default"][k] == v
    # the fragments rode the plane the gate names
    if native == "1":
        assert sum(served) == info["fragments"]
    else:
        assert sum(served) == 0


# ---------------------------------------------------------------------------
# striped heal through the port
# ---------------------------------------------------------------------------


@pytest.fixture
def sources():
    """Three port transports stream-staging the SAME tensor state at step
    5: bitwise-replicated heal sources."""
    state = tensor_state()
    transports = [HTTPTransport(timeout=10.0) for _ in range(3)]
    threads = [
        threading.Thread(
            target=t.send_checkpoint_streamed, args=([1], 5, state, 10.0, 6)
        )
        for t in transports
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    yield state, transports
    for t in transports:
        t.shutdown()


def _heal(addrs, local, delta, timeout=30.0):
    healer = HTTPTransport(timeout=10.0)
    try:
        return healer.recv_checkpoint_striped(
            addrs, 5, timeout=timeout, local_state_fn=lambda: local, delta=delta,
        )
    finally:
        healer.shutdown()


def test_full_heal_striped_into_retained_tensors(sources):
    state, transports = sources
    local = zeroed(state)
    retained = dict(local["user"])
    got, info = _heal([t.metadata() for t in transports], local, delta=False)
    assert_state_equal(got, state)
    assert info["mode"] == "full" and info["sources"] == 3
    assert info["changed"] == info["fragments"] == 6
    for k, buf in retained.items():
        assert got["user"][k] is buf  # decoded into the live tensor
    assert set(info["phases"]) == {
        "heal_manifest", "heal_diff", "heal_wire", "heal_decode"
    }


@pytest.mark.parametrize("torn", [1, 0])
def test_delta_heal_wire_scales_with_changed_fragments(sources, torn):
    state, transports = sources
    local = clone_state(state)
    if torn:
        local["user"]["w3"][:] = -1.0
    before = tmetrics.HEAL_WIRE_BYTES.labels(mode="delta").get()
    got, info = _heal([t.metadata() for t in transports], local, delta=True)
    assert_state_equal(got, state)
    assert info["mode"] == "delta"
    wire = tmetrics.HEAL_WIRE_BYTES.labels(mode="delta").get() - before
    assert wire == info["wire_bytes"]
    if torn:
        assert 1 <= info["changed"] < info["fragments"]
        assert wire < sum(v.numel() * 4 for v in state["user"].values()) / 2
    else:  # identical state: nothing on the wire
        assert info["changed"] == 0 and wire == 0


@pytest.mark.parametrize("failure", ["killed_mid_heal", "dead_from_start"])
def test_stripe_source_failure_fails_over(sources, failure):
    state, transports = sources
    addrs = [t.metadata() for t in transports]
    killer = None
    if failure == "killed_mid_heal":
        # stretch every fetch past the kill: the victim's fragments are
        # still in flight when it dies, so the failover must fire
        faults.FAULTS.configure(
            [FaultRule(site="transport.heal.frag", action="delay",
                       delay=0.15, times=100)],
            seed=0,
        )
        killer = threading.Timer(0.05, transports[2].shutdown)
        killer.start()
    else:
        dead = HTTPTransport(timeout=5.0)
        addrs = [addrs[0], dead.metadata(), addrs[1]]
        dead.shutdown()
    before = tmetrics.HEAL_FRAG_FAILOVERS.get()
    try:
        got, info = _heal(addrs, zeroed(state), delta=False)
    finally:
        if killer is not None:
            killer.cancel()
    assert_state_equal(got, state)
    assert info["failovers"] >= 1
    if failure == "killed_mid_heal":
        assert info["sources_used"] >= 2
        assert faults.FAULTS.injected("transport.heal.frag") > 0
    else:
        assert tmetrics.HEAL_FRAG_FAILOVERS.get() > before


@pytest.mark.parametrize("delta", [True, False])
def test_poisoned_fragment_fails_over_and_never_lands(sources, delta):
    state, transports = sources
    victim = transports[1]
    with victim._staged_lock.r_lock():
        raw = bytearray(victim._staged[5].sd["frag:2"])
    raw[len(raw) // 2] ^= 0xFF
    victim.stage_streamed_part(5, "frag:2", bytes(raw))
    got, _info = _heal([t.metadata() for t in transports], zeroed(state), delta=delta)
    assert_state_equal(got, state)


def test_legacy_source_falls_back_to_whole_document():
    state = tensor_state(leaves=3)
    src = HTTPTransport(timeout=5.0)
    healer = HTTPTransport(timeout=5.0)
    try:
        src.send_checkpoint([1], 4, state, timeout=5.0)
        got, info = healer.recv_checkpoint_striped(
            [src.metadata()], 4, timeout=10.0, local_state_fn=None, delta=False,
        )
    finally:
        healer.shutdown()
        src.shutdown()
    assert info["mode"] == "legacy"
    assert_state_equal(got, state)


def test_staged_snapshot_is_a_copy_of_cpu_tensors():
    state = tensor_state(leaves=2)
    want = clone_state(state)
    src = HTTPTransport(timeout=5.0)
    healer = HTTPTransport(timeout=5.0)
    try:
        src.send_checkpoint([1], 2, state, timeout=5.0)
        for v in state["user"].values():
            v.add_(1.0)  # the optimizer's in-place update after commit
        got = healer.recv_checkpoint(0, src.metadata(), 2, timeout=10.0)
    finally:
        healer.shutdown()
        src.shutdown()
    assert_state_equal(got, want)
    assert all(isinstance(v, torch.Tensor) for v in got["user"].values())
