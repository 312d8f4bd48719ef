"""The port's fragment provenance registry against the JAX package's.

The same ``note_hold``/``note_hop`` sequence gives the same version-vector
snapshot and the same heartbeat digest in both.  One difference is pinned:
the JAX package starts its digest rate limit at a monotonic time of 0.0,
so on a host whose ``time.monotonic()`` still reads below
``TORCHFT_FRAG_REPORT_S`` it holds back the very first digest; the port
starts from "never reported" and sends it.
"""

import time

import pytest

from torchft_tpu.checkpointing import provenance as jprov
from torchft_tpu_torch.checkpointing import provenance as tprov

SEQUENCE = [
    ("hold", "weights/0", 1, "aa11", 1000, "publisher", True),
    ("hold", "weights/1", 1, "bb22", 1000, "publisher", True),
    ("hop", "weights/0", 1, "http://relay:1", "serving", "ok", 4096),
    ("hold", "heal/0", 5, "cc33", 2500, "heal", False),
    ("hold", "weights/0", 2, "dd44", 3000, "relay", False),
    ("hop", "heal/0", 5, "http://src:2", "heal", "mismatch", 128),
    ("hold", "weights/0", 1, "ee55", 900, "relay", False),  # stale re-hold
    ("hold", "heal/1", 5, "ff66", 0, "heal", False),  # unstamped
]


def _replay(mod):
    reg = mod.ProvenanceRegistry()
    reg.set_holder("host:1")
    for op, *args in SEQUENCE:
        if op == "hold":
            fid, version, digest, version_ms, role, pub = args
            reg.note_hold(fid, version, digest, version_ms=version_ms,
                          role=role, publisher=pub)
        else:
            fid, version, source, plane, verdict, nbytes = args
            reg.note_hop(fid, version, source, plane, verdict=verdict,
                         nbytes=nbytes)
    return reg


def _strip_clock(records):
    return [
        {k: v for k, v in r.items() if k not in ("start_ns", "end_ns", "dur_ms", "seq", "tid")}
        for r in records
    ]


def test_same_sequence_gives_same_snapshot_and_digest(monkeypatch):
    monkeypatch.setenv("TORCHFT_FRAG_REPORT_S", "0")
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)
    t, j = _replay(tprov), _replay(jprov)
    assert t.snapshot() == j.snapshot()
    assert _strip_clock(t.hop_records()) == _strip_clock(j.hop_records())
    td, jd = t.maybe_digest("h0"), j.maybe_digest("h0")
    assert td == jd and td is not None
    assert {r["frag"] for r in td["frags"]} == {
        "weights/0", "weights/1", "heal/0", "heal/1"
    }
    # consumed on send: the next digest carries only the stamped worst-K
    assert t.maybe_digest("h0") == j.maybe_digest("h0")
    t.restore_digest(td)
    j.restore_digest(jd)
    assert t.maybe_digest("h0") == j.maybe_digest("h0")


@pytest.mark.parametrize("package", ["port", "jax"])
def test_first_digest_on_a_freshly_booted_host(package, monkeypatch):
    monkeypatch.setenv("TORCHFT_FRAG_REPORT_S", "3600")
    monkeypatch.setattr(time, "monotonic", lambda: 5.0)
    reg = (tprov if package == "port" else jprov).ProvenanceRegistry()
    reg.note_hold("weights/0", 1, version_ms=1000)
    first = reg.maybe_digest("h0")
    if package == "port":
        assert first is not None  # never reported: the first one is due
        reg.note_hold("weights/1", 1, version_ms=1000)
        assert reg.maybe_digest("h0") is None  # the second is held back
    else:
        # the JAX package's clock starts at 0.0: 5 s < 3600 s holds the
        # very first digest back
        assert first is None
