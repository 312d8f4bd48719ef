"""The port's weight-serving tier, on the CPU, against the JAX package's.

Modelled on tests/test_serving.py: the tree and its plan epochs through
the port's lighthouse client, a publish relayed down a tree and fetched
bitwise, a delta fetch that moves only the changed fragment, a killed
interior relay routed around, torn-version safety at the transport, the
Manager's publish hook (its snapshot a copy), and a JAX publisher feeding
a port client and the reverse, on numpy leaves with identical bytes.
"""

import threading
import time

import numpy as np
import pytest
import torch

from torchft_tpu.serving import (
    ServingClient as JaxServingClient,
    WeightPublisher as JaxWeightPublisher,
)
from torchft_tpu.serving import payload as jpayload
from torchft_tpu_torch.coordination import LighthouseClient, LighthouseServer
from torchft_tpu_torch.ops import quantization as q
from torchft_tpu_torch.serving import (
    ServingClient,
    ServingReplica,
    WeightPublisher,
    changed_fragments,
    decode_payload,
    encode_payload,
    fetch_resource,
)
from torchft_tpu_torch.serving import fetcher as tfetcher
from torchft_tpu_torch.utils import metrics as tmetrics
from torchft_tpu_torch.utils.bufpool import POOL


def _wait_until(cond, timeout=15.0, interval=0.02, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(interval)
    raise AssertionError(f"timed out waiting for {msg}")


def _numpy_state(seed=0):
    rng = np.random.RandomState(seed)
    return {
        "w": rng.randn(16, 32).astype(np.float32),
        "b": rng.randn(8).astype(np.float32),
        "step": int(seed),
    }


def _tensor_state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "w": torch.randn(16, 32, generator=g),
        "h": torch.randn(4, 8, generator=g).to(torch.bfloat16),
        "b": torch.randn(8, generator=g),
    }


def _int8_roundtrip(a):
    return q.dequantize(*q.quantize(a, q.WIRE_INT8), a.shape, np.dtype(np.float32))


def _chain(n_relays, fragments=2, wire="f32", heartbeat_timeout_ms=1500):
    """fanout=1 lighthouse + publisher + a chain of relays (depth 0..n-1)."""
    lh = LighthouseServer(
        min_replicas=1, heartbeat_timeout_ms=heartbeat_timeout_ms,
        quorum_tick_ms=50, serving_fanout=1,
    )
    pub = WeightPublisher(
        lh.address(), wire=wire, fragments=fragments, heartbeat_interval=0.05
    )
    reps = [
        ServingReplica(
            lh.address(), replica_id=f"chain{i}", poll_interval=0.02,
            fetch_timeout=10.0,
        )
        for i in range(n_relays)
    ]
    return lh, pub, reps


def _teardown(lh, pub, reps, *clients):
    for c in clients:
        c.close()
    for r in reps:
        r.shutdown()
    pub.shutdown()
    lh.shutdown()


def test_tree_and_plan_epochs_through_the_port_client():
    with LighthouseServer(min_replicas=1, serving_fanout=2) as server:
        c = LighthouseClient(server.address())
        c.serving_heartbeat("pub", "http://p:1", role="publisher", version=3)
        e0 = c.serving_heartbeat("s0", "http://s0:1", role="server")["plan_epoch"]
        for i in range(1, 7):
            c.serving_heartbeat(f"s{i}", f"http://s{i}:1", role="server")
        plan = c.serving_plan()
        assert plan["root_source"] == "http://p:1" and plan["latest_version"] == 3
        assert sorted(n["depth"] for n in plan["nodes"]) == [0, 1, 1, 2, 2, 2, 2]
        assert [n["replica_id"] for n in plan["nodes"] if n["parent"] == ""] == ["s0"]
        assert plan["epoch"] > e0  # joins change the tree
        # a version advance alone keeps the epoch
        e1 = c.serving_heartbeat("s0", "http://s0:1", role="server", version=9)["plan_epoch"]
        assert e1 == plan["epoch"]
        # an address change does not
        e2 = c.serving_heartbeat("s0", "http://s0:2", role="server")["plan_epoch"]
        assert e2 > e1
        c.close()


@pytest.mark.parametrize("wire", ["f32", "int8"])
def test_publish_relay_fetch_bitwise(wire):
    lh, pub, reps = _chain(2, wire=wire)
    client = ServingClient(lh.address(), plan_ttl=0.1)
    try:
        sd = _tensor_state(10)
        v = pub.publish(sd)
        state, got = client.fetch(version=v, timeout=20)
        assert got == v
        assert state["h"].dtype == torch.bfloat16
        if wire == "f32":
            assert torch.equal(state["w"], sd["w"])
        else:
            # an int8 leaf's bytes are those of a numpy leaf of its values,
            # so it decodes to a numpy array, as in the JAX package
            np.testing.assert_array_equal(state["w"], _int8_roundtrip(sd["w"].numpy()))
        assert torch.equal(state["h"], sd["h"])  # only f32 leaves quantize
        _wait_until(lambda: all(r.version() == v for r in reps), msg="relays converged")
        # relays pass the publisher's fragment bytes through verbatim
        for name in ("0", "1"):
            src = tfetcher.fetch_raw(pub.address(), v, f"frag_{name}", timeout=10)
            want = bytes(memoryview(src))
            POOL.give(src)
            for r in reps:
                buf = tfetcher.fetch_raw(r.address(), v, f"frag_{name}", timeout=10)
                assert bytes(memoryview(buf)) == want, (r.replica_id(), name)
                POOL.give(buf)
        assert pub.last_publish["version"] == v and pub.last_publish["bytes"] > 0
    finally:
        _teardown(lh, pub, reps, client)


def test_delta_fetch_moves_only_the_changed_fragment():
    lh, pub, reps = _chain(1, fragments=4)
    client = ServingClient(lh.address(), plan_ttl=0.1)
    try:
        g = torch.Generator().manual_seed(3)
        sd = {f"l{i}": torch.randn(256, 32, generator=g) for i in range(4)}
        payload = sum(t.numel() * 4 for t in sd.values())
        v1 = pub.publish(sd)
        client.fetch(version=v1, timeout=20)
        sd2 = dict(sd, l0=sd["l0"] + 1.0)
        v2 = pub.publish(sd2)
        man = encode_payload(sd2, v2, fragments=4)["frag:manifest"]
        assert len(changed_fragments(man, encode_payload(sd, v1, fragments=4)["frag:manifest"])) == 1
        b0 = tmetrics.SERVING_FETCH_BYTES.labels(role="client").get()
        state, got = client.fetch(version=v2, timeout=20)
        moved = tmetrics.SERVING_FETCH_BYTES.labels(role="client").get() - b0
        assert got == v2 and client._held_version == v2
        assert torch.equal(state["l0"], sd2["l0"]) and torch.equal(state["l3"], sd["l3"])
        # the manifest and one fragment of four
        assert payload / 4 <= moved < payload / 2, (moved, payload)
    finally:
        _teardown(lh, pub, reps, client)


def test_interior_relay_kill_fails_over_bitwise(monkeypatch):
    """The root of a two-relay chain dies; the next publish reaches the
    leaf through the publisher (a relay failover), and a client gets it
    bitwise from the leaf."""
    # a dead source costs a pull this much before it moves on
    monkeypatch.setenv("TORCHFT_SERVING_FAILOVER_S", "0.5")
    lh, pub, reps = _chain(2, heartbeat_timeout_ms=5000)
    client = ServingClient(lh.address(), plan_ttl=0.1)
    try:
        v1 = pub.publish(_tensor_state(20))
        _wait_until(lambda: all(r.version() == v1 for r in reps), msg="chain converged")
        plan = client.plan(refresh=True)
        root_id = next(n["replica_id"] for n in plan["nodes"] if n["parent"] == "")
        root = next(r for r in reps if r.replica_id() == root_id)
        leaf = next(r for r in reps if r is not root)
        failovers = tmetrics.SERVING_FAILOVERS.labels(role="relay").get()
        root.shutdown()
        sd2 = _tensor_state(21)
        v2 = pub.publish(sd2)
        # the plan still names the dead root (5 s heartbeat expiry): the
        # leaf's pull must route around it
        _wait_until(lambda: leaf.version() == v2, msg="leaf pulled past the dead root")
        assert tmetrics.SERVING_FAILOVERS.labels(role="relay").get() > failovers
        state, got = client.fetch(version=v2, timeout=30)
        assert got == v2
        for k in sd2:
            assert torch.equal(state[k], sd2[k]), k
    finally:
        reps.remove(root)
        _teardown(lh, pub, reps, client)


def test_torn_version_never_serves_whole_document():
    import urllib.error
    import urllib.request

    from torchft_tpu_torch.checkpointing.http_transport import HTTPTransport

    tr = HTTPTransport(timeout=5.0)
    try:
        doc = encode_payload(_tensor_state(42), 7, fragments=2)
        tr.begin_streamed_checkpoint(7, {"frag:manifest": doc["frag:manifest"]})
        tr.stage_streamed_part(7, "frag:0", doc["frag:0"])
        base = tr.metadata()
        raw = urllib.request.urlopen(f"{base}/checkpoint/7/frag_0", timeout=5).read()
        assert raw == doc["frag:0"]
        for what, code in (("frag_1", 503), ("full", 503), ("metadata", 503)):
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(f"{base}/checkpoint/7/{what}", timeout=5)
            assert ei.value.code == code, what
        tr.stage_streamed_part(7, "frag:1", doc["frag:1"])
        tr.finish_streamed_checkpoint(7)
        state, _, _ = decode_payload(fetch_resource(base, 7, "full", timeout=5))
        assert torch.equal(state["w"], _tensor_state(42)["w"])
    finally:
        tr.shutdown()


class _HeldPublisher:
    """Records what ``publish`` receives, after the test lets it run."""

    def __init__(self):
        self.go = threading.Event()
        self.got = []

    def publish(self, state, version):
        assert self.go.wait(10)
        self.got.append((version, {k: v.clone() for k, v in state["model"].items()}))


def _bare_manager():
    import logging

    from torchft_tpu_torch.manager import Manager
    from torchft_tpu_torch.utils.rwlock import RWLock

    m = object.__new__(Manager)
    m._state_dict_lock = RWLock(timeout=5)
    m._logger = logging.getLogger("test_torch_serving")
    m._weight_publisher = None
    m._publish_executor = None
    m._publish_pending = None
    m._publish_info = {}
    return m


def test_manager_publish_hook_snapshots_a_copy():
    live = {"w": torch.zeros(4, 4)}
    m = _bare_manager()
    m._user_state_dicts = {"model": lambda: live}
    m._publish_pending = 3
    m._flush_pending_publish()  # unattached: no-op, pending cleared
    assert m._publish_pending is None and m.publish_info() == {}
    held = _HeldPublisher()
    m.attach_weight_publisher(held)
    m._publish_pending = 3  # what a committed step 3 sets
    m._flush_pending_publish()  # snapshot here, publish on the worker
    assert m.publish_info()["version"] == 3
    live["w"].add_(1.0)  # the next optimizer step, in place
    held.go.set()
    m._flush_pending_publish(wait=True)
    assert [v for v, _ in held.got] == [3]
    assert torch.equal(held.got[0][1]["w"], torch.zeros(4, 4))

    class _Boom:
        def publish(self, *a, **k):
            raise RuntimeError("publisher down")

    m.attach_weight_publisher(_Boom())
    m._publish_pending = 4
    m._flush_pending_publish(wait=True)  # logged, never raised


def test_manager_publishes_committed_steps_to_a_client():
    lh, pub, reps = _chain(0)
    client = ServingClient(lh.address(), plan_ttl=0.1)
    try:
        live = _tensor_state(12)
        m = _bare_manager()
        m._user_state_dicts = {"model": lambda: live}
        m.attach_weight_publisher(pub)
        m._publish_pending = 3
        m._flush_pending_publish(wait=True)
        assert pub.latest_version() == 3
        state, got = client.fetch(timeout=20)
        assert got == 3
        for k in live:
            assert torch.equal(state["model"][k], live[k]), k
    finally:
        _teardown(lh, pub, reps, client)


def test_payload_bytes_match_jax_on_numpy_leaves():
    sd = _numpy_state(5)
    for wire in ("f32", "int8"):
        ours = encode_payload(sd, 4, wire=wire, fragments=2)
        theirs = jpayload.encode_payload(sd, 4, wire=wire, fragments=2)
        for name in ("0", "1"):
            assert ours[f"frag:{name}"] == theirs[f"frag:{name}"], (wire, name)
        a, b = ours["frag:manifest"], theirs["frag:manifest"]
        assert a["digests"] == b["digests"]
        assert {k: v for k, v in a.items() if k != "created_ns"} == {
            k: v for k, v in b.items() if k != "created_ns"
        }


def test_jax_publisher_feeds_a_port_client_and_back():
    lh = LighthouseServer(min_replicas=1, heartbeat_timeout_ms=1500, quorum_tick_ms=50)
    jpub = JaxWeightPublisher(lh.address(), fragments=2, heartbeat_interval=0.05)
    client = ServingClient(lh.address(), plan_ttl=0.1)
    try:
        sd = _numpy_state(7)
        v = jpub.publish(sd)
        state, got = client.fetch(version=v, timeout=20)
        assert got == v and state["step"] == sd["step"]
        np.testing.assert_array_equal(state["w"], sd["w"])
        np.testing.assert_array_equal(state["b"], sd["b"])
    finally:
        client.close()
        jpub.shutdown()
        lh.shutdown()
    lh = LighthouseServer(min_replicas=1, heartbeat_timeout_ms=1500, quorum_tick_ms=50)
    pub = WeightPublisher(lh.address(), fragments=2, heartbeat_interval=0.05)
    jclient = JaxServingClient(lh.address(), plan_ttl=0.1)
    try:
        sd = _numpy_state(8)
        v = pub.publish(sd)
        state, got = jclient.fetch(version=v, timeout=20)
        assert got == v and state["step"] == sd["step"]
        np.testing.assert_array_equal(state["w"], sd["w"])
    finally:
        jclient.close()
        pub.shutdown()
        lh.shutdown()
