"""The port's wire-schema gate: its protocol.lock is the JAX package's byte
for byte (the same native servers, the same wire), the port's clients
(torchft_tpu_torch/coordination.py) drift-check clean against native/ and
docs/protocol.md, every seeded drift of the JAX package's gate is caught by
the port's ``run_checks`` with the JAX gate's codes, and the port's clients
conform to the lock against one live native stack."""

import dataclasses
import json
import os

import pytest

from torchft_tpu.analysis import wire_schema as jax_ws
from torchft_tpu_torch.analysis import wire_schema as ws
from torchft_tpu_torch.coordination import (
    LighthouseClient,
    LighthouseServer,
    ManagerClient,
    ManagerServer,
    Quorum,
    QuorumMember,
    QuorumResult,
    StoreClient,
    StoreServer,
    compute_quorum_results,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_LOCK = os.path.join(REPO, "torchft_tpu", "analysis", "protocol.lock")

LOCK = ws.load_lock(ws.default_lock_path())
assert LOCK is not None, "torchft_tpu_torch/analysis/protocol.lock must be committed"

_STRUCT_CLASSES = {"QuorumMember": QuorumMember, "Quorum": Quorum,
                   "QuorumResult": QuorumResult}
_SENTINELS = {"string": "sentinel", "int": 7, "bool": True, "double": 1.5,
              "object": {}, "array": [], "any": "opaque"}


def _tree_inputs():
    return ws.gather_inputs(REPO)


class TestLock:
    def test_lock_is_the_jax_packages_byte_for_byte(self):
        assert ws.default_lock_path() == os.path.join(
            REPO, "torchft_tpu_torch", "analysis", "protocol.lock")
        with open(ws.default_lock_path(), "rb") as a, open(JAX_LOCK, "rb") as b:
            assert a.read() == b.read()

    def test_fresh_build_over_the_port_is_the_lock(self):
        """build_lock over torchft_tpu_torch/coordination.py and native/
        dumps to the committed text (--write-lock is idempotent)."""
        py, native, _nf, _docs, lock, lockfile = _tree_inputs()
        assert lockfile == os.path.join("torchft_tpu_torch", "analysis", "protocol.lock")
        assert ws.build_lock(py, native) == lock
        assert ws.dump_lock(ws.build_lock(py, native)) == open(JAX_LOCK).read()

    def test_tree_has_zero_findings(self):
        py, native, nfiles, docs, lock, lockfile = _tree_inputs()
        found = list(ws.run_checks(py, native, docs, lock, native_file_of=nfiles,
                                   lock_file=lockfile))
        assert found == [], "\n".join(f.render() for f in found)

    def test_lock_covers_the_expected_surface(self):
        servers = LOCK["servers"]
        assert set(servers) == {"lighthouse", "manager", "store"}
        assert set(servers["manager"]) == {
            "quorum", "should_commit", "checkpoint_metadata", "kill"}
        assert set(servers["store"]) == {"set", "get", "delete_prefix", "num_keys"}
        assert set(LOCK["structs"]) == set(_STRUCT_CLASSES)
        assert LOCK["envelope"] == ["method", "params", "timeout_ms", "traceparent"]


# (id, surface, native file or None, old, new, codes that must all appear
# or, with a tuple of two, at least one of them) — the JAX package's seeded
# drifts, applied to the port's client where the surface is Python
_DRIFTS = [
    ("py_struct_field", "py", None, '"store_address": self.store_address',
     '"store_addr": self.store_address', ("struct-field-missing", "lock-drift")),
    ("py_param", "py", None, 'params["inflight_op"] = inflight_op',
     'params["inflight"] = inflight_op', {"param-dead"}),
    ("native_struct_field", "native", "lighthouse.cc", 'j["world_size"] = world_size;',
     'j["worldsize"] = world_size;', {"struct-field-missing"}),
    ("native_param", "native", "manager.cc", 'params.get("group_rank")',
     'params.get("grp_rank")', {"param-dead", "param-missing"}),
    ("py_serving_param", "py", None, '"capacity": int(capacity)', '"cap": int(capacity)',
     {"param-dead", "param-missing"}),
    ("native_serving_param", "native", "lighthouse.cc", 'params.get("version").as_int(0)',
     'params.get("ver").as_int(0)', {"param-dead", "param-missing"}),
    ("native_serving_result", "native", "lighthouse.cc",
     'out["plan_epoch"] = serving_epoch_;', 'out["planepoch"] = serving_epoch_;',
     ("result-missing", "lock-drift")),
    ("py_lease_param", "py", None, '"term": int(term)', '"trm": int(term)',
     {"param-dead", "param-missing"}),
    ("native_lease_param", "native", "lighthouse.cc", 'params.get("candidate").as_string()',
     'params.get("cand").as_string()', {"param-dead", "param-missing"}),
    ("native_lease_result", "native", "lighthouse.cc", 'out["holder"] = promised_to_;',
     'out["holdr"] = promised_to_;', ("result-missing", "lock-drift")),
    ("py_links_param", "py", None, 'params["links"] = links', 'params["lnks"] = links',
     {"param-dead", "param-missing"}),
    ("native_links_result", "native", "lighthouse.cc",
     'out["reports_total"] = links_reports_total_;',
     'out["reportstotal"] = links_reports_total_;', ("result-missing", "lock-drift")),
    ("py_fragments_param", "py", None, 'params["fragments"] = fragments',
     'params["frgs"] = fragments', {"param-dead", "param-missing"}),
    ("native_fragments_result", "native", "lighthouse.cc",
     'out["reports_total"] = fragments_reports_total_;',
     'out["reportstotal"] = fragments_reports_total_;', ("result-missing", "lock-drift")),
    ("doc_omission", "docs", None, "| lighthouse | `timeline` |", "| lighthouse |`timeline-x` |",
     {"method-undocumented"}),
    ("py_traceparent", "py", None, 'req["traceparent"] = traceparent',
     'req["trace_parent"] = traceparent', {"envelope-field-dead", "envelope-field-missing"}),
    ("native_traceparent", "native", "net.cc", 'req.get("traceparent")',
     'req.get("trace_parent")', {"envelope-field-dead", "envelope-field-missing"}),
]


def _codes(mod, py, native, docs, lock, nfiles, lockfile):
    return {f.code for f in mod.run_checks(py, native, docs, lock, native_file_of=nfiles,
                                           lock_file=lockfile)}


class TestSeededDrift:
    @pytest.mark.parametrize("case", _DRIFTS, ids=[d[0] for d in _DRIFTS])
    def test_seeded_drift_is_caught_as_jax_catches_it(self, case):
        _id, surface, nfile, old, new, want = case
        py, native, nfiles, docs, lock, lockfile = _tree_inputs()
        if surface == "py":
            assert old in py
            py = py.replace(old, new)
        elif surface == "docs":
            assert old in docs
            docs = docs.replace(old, new)
        else:
            assert old in native[nfile]
            native = dict(native, **{nfile: native[nfile].replace(old, new)})
        got = _codes(ws, py, native, docs, lock, nfiles, lockfile)
        if isinstance(want, tuple):
            assert set(want) & got, got
        else:
            assert want <= got, got
        assert got == _codes(jax_ws, py, native, docs, lock, nfiles, lockfile)

    @pytest.mark.parametrize("lock_case", ["stale", "missing"])
    def test_lock_drift_is_caught(self, lock_case):
        py, native, nfiles, docs, lock, lockfile = _tree_inputs()
        if lock_case == "stale":
            lock = json.loads(json.dumps(lock))
            lock["structs"]["QuorumMember"]["vintage"] = "string"
        else:
            lock = None
        got = _codes(ws, py, native, docs, lock, nfiles, lockfile)
        assert {"stale": "lock-drift", "missing": "lock-missing"}[lock_case] in got
        assert got == _codes(jax_ws, py, native, docs, lock, nfiles, lockfile)


class TestStructConformance:
    @pytest.mark.parametrize("struct", sorted(LOCK["structs"]), ids=str)
    def test_dataclass_round_trips_the_locked_fields(self, struct):
        cls = _STRUCT_CLASSES[struct]
        assert {f.name for f in dataclasses.fields(cls)} == set(LOCK["structs"][struct])
        payload = {k: _SENTINELS[t] for k, t in LOCK["structs"][struct].items()}
        obj = cls.from_dict(payload)
        for k, t in LOCK["structs"][struct].items():
            if t != "array":
                assert getattr(obj, k) == payload[k], f"{struct}.{k} lost on the wire"
        cls.from_dict({})

    def test_native_quorum_math_speaks_the_locked_structs(self):
        members = [
            QuorumMember(replica_id="a:0", address="x:1", store_address="s:1",
                         step=3, world_size=1),
            QuorumMember(replica_id="b:0", address="x:2", store_address="s:2",
                         step=3, world_size=1),
        ]
        res = compute_quorum_results("a:0", 0, Quorum(quorum_id=9, participants=members,
                                                      created_ms=1))
        assert isinstance(res, QuorumResult)
        assert (res.quorum_id, res.max_step, res.heal) == (9, 3, False)


@pytest.fixture(scope="module")
def stack():
    """One native stack for the module: a lighthouse, a store and a
    ManagerServer heartbeating the lighthouse."""
    lh = LighthouseServer(min_replicas=1, join_timeout_ms=50)
    store = StoreServer()
    mgr = ManagerServer(replica_id="conf_0:a", lighthouse_addr=lh.address(),
                        store_address=store.address(), world_size=1)
    yield lh, store, mgr
    mgr.shutdown()
    store.shutdown()
    lh.shutdown()


def _check_result(server, method, result):
    locked = LOCK["servers"][server][method]
    if isinstance(result, dict) and locked["result_struct"] is None:
        extra = set(result) - set(locked["result"])
        assert not extra, f"{server}.{method} reply carries unlocked {sorted(extra)}"


class TestLiveConformance:
    def test_manager_methods(self, stack):
        """First: the lighthouse test's heartbeats would hold this quorum
        behind the majority guard until they expire."""
        _lh, _store, mgr = stack
        c = ManagerClient(mgr.address())
        try:
            res = c._quorum(group_rank=0, step=0, checkpoint_metadata="meta0",
                            shrink_only=False, timeout=20.0)
            assert isinstance(res, QuorumResult)
            assert c._checkpoint_metadata(rank=0, timeout=5.0) == "meta0"
            assert c.should_commit(0, step=0, should_commit=True, timeout=5.0) is True
        finally:
            c.close()

    def test_lighthouse_methods(self, stack):
        """The status, serving, links and fragments methods on the shared
        stack's lighthouse (a direct quorum join is the Manager's, above:
        the ManagerServer's own heartbeats would hold a lone joiner off)."""
        lh, _store, _mgr = stack
        c = LighthouseClient(lh.address())
        try:
            hb = c.heartbeat("live_0:a", step=1, last_step_wall_ms=1, inflight_op="test")
            _check_result("lighthouse", "heartbeat", hb)
            _check_result("lighthouse", "status", c.status())
            _check_result("lighthouse", "timeline", c.timeline())
            sh = c.serving_heartbeat("live_srv", "http://x:1", role="server", version=2,
                                     capacity=1)
            _check_result("lighthouse", "serving_heartbeat", sh)
            sp = c.serving_plan()
            _check_result("lighthouse", "serving_plan", sp)
            assert [n["replica_id"] for n in sp["nodes"]] == ["live_srv"]
            c.heartbeat("live_0:a", links={"host": "h0", "rows": [{
                "peer": "h1", "plane": "reduction", "local": False, "goodput_bps": 1e8,
                "rtt_ms": 1.0, "rtt_p99_ms": 2.0, "samples": 9, "bytes": 1024,
                "age_s": 0.1}]})
            lk = c.links()
            _check_result("lighthouse", "links", lk)
            assert lk["rows_total"] == 1
            c.heartbeat("live_0:a", fragments={"host": "h0", "frags": [{
                "frag": "weights/0", "version": 3, "digest8": "aabbccdd",
                "version_ms": 1000, "held_ms": 900, "pub": True}]})
            fr = c.fragments()
            _check_result("lighthouse", "fragments", fr)
            assert fr["rows_total"] == 1
        finally:
            c.close()

    def test_store_methods(self, stack):
        _lh, store, _mgr = stack
        c = StoreClient(store.address())
        try:
            c.set("conformance/k", "v")
            assert c.get("conformance/k") == "v"
            assert c.num_keys() >= 1
            assert c.delete_prefix("conformance/") == 1
        finally:
            c.close()
