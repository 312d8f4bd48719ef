"""The port's durable fragment store against the JAX package's, on the CPU.

The same seeded numpy state goes through both packages' ``FragmentStore``:
blobs, their sha256 names and the manifests must be byte-identical (the
manifest's ``created_ns`` clock is pinned).  ``cut_id`` and ``select_cut``
must agree on a parametrised set of fleet catalogs, torn and incomplete
ones included, and ``durable`` checkpoints must round-trip and load across
the two packages.  Tensor state carries the ``"torch"`` meta mark, so its
blobs are the port's own; it must still round-trip bitwise.
"""

import os
import time

import numpy as np
import pytest
import torch

from torchft_tpu.checkpointing import durable as jdurable
from torchft_tpu.checkpointing import store as jstore
from torchft_tpu_torch.checkpointing import durable as tdurable
from torchft_tpu_torch.checkpointing import store as tstore


def _state(seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return {
        "user": {
            "default": {
                "w": (scale * rng.standard_normal((33, 17))).astype(np.float32),
                "b": rng.standard_normal(5),
                "i": rng.integers(0, 100, 7).astype(np.int32),
                "nested": {"m": rng.standard_normal(3).astype(np.float16)},
            }
        },
        "torchft": {"step": 3, "batches_committed": 6},
    }


def _tree_bytes(root):
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


@pytest.fixture
def pinned_clock(monkeypatch):
    monkeypatch.setattr(time, "time_ns", lambda: 1_700_000_000_123_456_789)


@pytest.mark.parametrize("fragments", [None, 1, 3])
def test_numpy_blobs_and_manifests_are_byte_identical(tmp_path, pinned_clock, fragments):
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    js, ts = jstore.FragmentStore(str(jdir)), tstore.FragmentStore(str(tdir))
    for version, seed in ((1, 0), (2, 0), (3, 1)):
        jm = js.put_state(version, _state(seed), fragments)
        tm = ts.put_state(version, _state(seed), fragments)
        assert jm["digests"] == tm["digests"]
        assert ts.last_put["version"] == version
    got, want = _tree_bytes(tdir), _tree_bytes(jdir)
    assert got == want
    blobs = [k for k in got if k.startswith("blobs")]
    for name in blobs:
        import hashlib
        assert hashlib.sha256(got[name]).hexdigest() == os.path.basename(name)
    assert ts.catalog() == js.catalog()
    assert tstore.cut_id(ts.manifest(3)) == jstore.cut_id(js.manifest(3))


def test_version_window_retires_and_collects_like_the_jax_package(tmp_path, pinned_clock):
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    js = jstore.FragmentStore(str(jdir), max_versions=2)
    ts = tstore.FragmentStore(str(tdir), max_versions=2)
    for version in range(1, 6):
        js.put_state(version, _state(version), 2)
        ts.put_state(version, _state(version), 2)
    assert ts.versions() == js.versions() == [4, 5]
    assert _tree_bytes(tdir) == _tree_bytes(jdir)


def test_a_torn_blob_reads_as_missing_and_load_refuses(tmp_path):
    ts = tstore.FragmentStore(str(tmp_path))
    manifest = ts.put_state(1, _state(), 2)
    digest = sorted(manifest["digests"].values())[0]
    path = ts.blob_path(digest)
    raw = bytearray(open(path, "rb").read())
    raw[len(raw) // 2] ^= 1
    open(path, "wb").write(bytes(raw))
    assert ts.read_blob(digest) is None
    assert ts.catalog()[1]["complete"] is False
    with pytest.raises(ValueError, match="digest"):
        ts.load_state(manifest)


def test_tensor_state_round_trips_bitwise(tmp_path):
    ts = tstore.FragmentStore(str(tmp_path))
    g = torch.Generator().manual_seed(0)
    state = {
        "w": torch.randn(64, 9, generator=g),
        "h": torch.randn(31, generator=g).to(torch.bfloat16),
        "step": 7,
    }
    ts.put_state(4, state, 2)
    back = ts.load_state(ts.manifest(4))
    assert back["step"] == 7
    for k in ("w", "h"):
        assert back[k].dtype == state[k].dtype
        assert torch.equal(back[k].view(torch.int16) if k == "h" else back[k],
                           state[k].view(torch.int16) if k == "h" else state[k])


def _cat(version_ents):
    return {int(v): dict(e) for v, e in version_ents.items()}


def _ent(cut, names, ok=None):
    ok = list(names) if ok is None else ok
    return {"cut": cut, "fragments": list(names), "frags_ok": list(ok),
            "complete": len(ok) == len(names) and bool(names)}


F = ["0", "1", "2"]
CATALOGS = {
    "all_complete": {
        "http://a:1": _cat({3: _ent("c3", F), 2: _ent("c2", F)}),
        "http://b:1": _cat({3: _ent("c3", F), 2: _ent("c2", F)}),
    },
    "newest_torn_on_one_disk": {
        "http://a:1": _cat({3: _ent("c3", F, ["0"]), 2: _ent("c2", F)}),
        "http://b:1": _cat({3: _ent("c3", F, ["1", "2"])}),
    },
    "newest_torn_everywhere": {
        "http://a:1": _cat({3: _ent("c3", F, ["0"]), 2: _ent("c2", F)}),
        "http://b:1": _cat({3: _ent("c3", F, ["0", "1"]), 2: _ent("c2", F, [])}),
    },
    "split_cuts": {
        "http://a:1": _cat({5: _ent("x", F)}),
        "http://b:1": _cat({5: _ent("y", F, ["0"])}),
        "http://c:1": _cat({5: _ent("y", F, ["1", "2"])}),
    },
    "empty_fragment_list": {
        "http://a:1": _cat({4: _ent("e", [], [])}),
        "http://b:1": _cat({1: _ent("c1", F)}),
    },
    "nothing": {"http://a:1": {}, "http://b:1": {}},
    "incomplete_only": {
        "http://a:1": _cat({2: _ent("c2", F, ["0"])}),
    },
}


@pytest.mark.parametrize("name", sorted(CATALOGS))
def test_select_cut_matches_the_jax_package(name):
    catalogs = CATALOGS[name]
    assert tstore.select_cut(catalogs) == jstore.select_cut(catalogs)


@pytest.mark.parametrize("fragments", [["0", "1"], ["1", "0", "2"], []])
def test_cut_id_matches_the_jax_package(fragments):
    manifest = {"fragments": fragments,
                "digests": {n: f"d{n}" * 8 for n in fragments}}
    assert tstore.cut_id(manifest) == jstore.cut_id(manifest)


def test_durable_checkpoints_round_trip_and_cross_load(tmp_path, pinned_clock):
    for step in (1, 2, 3):
        tdurable.save_checkpoint(str(tmp_path / "port"), step, _state(step))
        jdurable.save_checkpoint(str(tmp_path / "jax"), step, _state(step))
    for mod, d in ((tdurable, "port"), (jdurable, "jax")):
        assert [s for s, _ in mod.list_checkpoints(str(tmp_path / d))] == [2, 3]
    assert _tree_bytes(tmp_path / "port") == _tree_bytes(tmp_path / "jax")
    want = _state(3)["user"]["default"]
    for path in (
        tdurable.latest_checkpoint(str(tmp_path / "port")),
        tdurable.latest_checkpoint(str(tmp_path / "jax")),
    ):
        got = tdurable.load_checkpoint(path)["user"]["default"]
        for k in ("w", "b", "i"):
            np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(got["nested"]["m"], want["nested"]["m"])
    assert jdurable.load_checkpoint(
        tdurable.latest_checkpoint(str(tmp_path / "port"))
    )["torchft"] == {"step": 3, "batches_committed": 6}
    assert tdurable.latest_checkpoint(str(tmp_path / "none")) is None


def test_store_from_env_keys_the_disk_by_replica(tmp_path, monkeypatch):
    monkeypatch.delenv("TORCHFT_STORE_DIR", raising=False)
    assert tstore.store_from_env("r0") is None
    monkeypatch.setenv("TORCHFT_STORE_DIR", str(tmp_path))
    monkeypatch.setenv("TORCHFT_STORE_VERSIONS", "2")
    for rid, rank in (("r0", 0), ("r1", 2)):
        a = tstore.store_from_env(rid, rank)
        b = jstore.store_from_env(rid, rank)
        assert a.directory == b.directory
        assert a._max_versions == b._max_versions == 2


def test_spiller_skips_versions_while_one_is_in_flight(tmp_path):
    import threading

    gate = threading.Event()
    ts = tstore.FragmentStore(str(tmp_path))
    real = ts.put_state

    def slow(version, state, fragments=None):
        gate.wait(10)
        return real(version, state, fragments)

    ts.put_state = slow
    sp = tstore.StoreSpiller(ts)
    assert sp.submit(1, _state(1))
    assert not sp.submit(2, _state(2))
    gate.set()
    sp.flush()
    assert sp.submit(3, _state(3))
    sp.flush()
    sp.shutdown()
    assert sp.skipped == 1 and ts.versions() == [1, 3]
