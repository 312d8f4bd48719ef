"""The port's parameter server: session mint and 2-rank PG serving
(counterpart of tests/test_parameter_server.py), over the port's
``ProcessGroupTCP`` and, with torch tensors, its ``ProcessGroupBabyTCP``.
"""

import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from torchft_tpu_torch.parallel.process_group import (
    ProcessGroup,
    ProcessGroupBabyTCP,
    ProcessGroupTCP,
)
from torchft_tpu_torch.parameter_server import ParameterServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _EchoPS(ParameterServer):
    """Serves one allreduce then one broadcast of stored params per
    session."""

    params = np.arange(8, dtype=np.float32)
    pg_cls = ProcessGroupTCP
    pg_timeout = 20.0
    sessions_served = 0
    session_error = None

    @classmethod
    def new_process_group(cls) -> ProcessGroup:
        return cls.pg_cls(timeout=cls.pg_timeout)

    def forward(self, session_id: str, pg: ProcessGroup) -> None:
        try:
            got = pg.allreduce([torch.ones(4)]).wait(timeout=20)
            np.testing.assert_array_equal(got[0], np.full(4, 3.0, np.float32))
            pg.broadcast(torch.from_numpy(self.params), root=0).wait(timeout=20)
            type(self).sessions_served += 1
        except Exception as e:  # noqa: BLE001 - surfaced by the test body
            type(self).session_error = e
            raise


@pytest.fixture
def ps():
    server = _EchoPS(port=0)
    _EchoPS.sessions_served = 0
    _EchoPS.session_error = None
    yield server
    server.shutdown()
    _EchoPS.pg_cls = ProcessGroupTCP
    _EchoPS.pg_timeout = 20.0


def _client_round(pg):
    got = pg.allreduce([np.full(4, 2.0, np.float32)]).wait(timeout=20)
    np.testing.assert_array_equal(got[0], np.full(4, 3.0, np.float32))
    params = pg.broadcast(np.zeros(8, np.float32), root=0).wait(timeout=20)
    np.testing.assert_array_equal(params, _EchoPS.params)


def _wait_served(n, timeout=20.0):
    # server threads finish asynchronously after the client's last op
    deadline = time.monotonic() + timeout
    while _EchoPS.sessions_served < n and time.monotonic() < deadline:
        time.sleep(0.02)
    return _EchoPS.sessions_served


@pytest.mark.parametrize("pg_cls", [ProcessGroupTCP, ProcessGroupBabyTCP],
                         ids=["tcp", "baby"])
def test_session_roundtrip_and_rank_assignment(ps, pg_cls):
    """Server serves rank 0, the minted client configures rank 1 of a
    2-rank session PG (the reference's fixed convention)."""
    _EchoPS.pg_cls = pg_cls
    pg = _EchoPS.new_session(ps.address())
    try:
        assert isinstance(pg, pg_cls)
        assert pg.rank() == 1 and pg.size() == 2
        _client_round(pg)
    finally:
        pg.shutdown()
    assert _wait_served(1) == 1
    assert _EchoPS.session_error is None


def test_multiple_sequential_sessions(ps):
    for _ in range(2):
        pg = _EchoPS.new_session(ps.address())
        try:
            _client_round(pg)
        finally:
            pg.shutdown()
    assert _wait_served(2) == 2


def test_bad_path_rejected_and_session_mint_document(ps):
    # the minted sessions are never joined: their server threads wait for
    # rank 1 until the teardown's shutdown aborts them
    _EchoPS.pg_timeout = 2.0
    with pytest.raises(urllib.error.HTTPError):
        urllib.request.urlopen(ps.address().replace("/new_session", "/nope"))
    docs = []
    for _ in range(2):
        with urllib.request.urlopen(ps.address()) as f:
            docs.append(json.load(f))
    for data in docs:
        assert set(data) == {"session_id", "store_addr"}
        assert f"/session/{data['session_id']}" in data["store_addr"]
        assert data["store_addr"].startswith(ps._store.address())
    # distinct mints -> distinct sessions (each gets its own PG pair)
    assert docs[0]["session_id"] != docs[1]["session_id"]


_SHUTDOWN_UNDER_WAITING_SESSIONS = """
import json, sys, threading, time, urllib.request
from torchft_tpu_torch.coordination import StoreClient
from torchft_tpu_torch.parallel.process_group import ProcessGroupTCP
from torchft_tpu_torch.parameter_server import ParameterServer

case = sys.argv[1]
making = threading.Semaphore(0)

class PS(ParameterServer):
    @classmethod
    def new_process_group(cls):
        making.release()
        if case == "pg_made_after_shutdown_begins":
            time.sleep(1.0)
        return ProcessGroupTCP(timeout=60.0)

    def forward(self, session_id, pg):
        raise AssertionError("no client ever joins")

ps = PS(port=0)
docs = []
for _ in range(3):
    with urllib.request.urlopen(ps.address()) as f:
        docs.append(json.load(f))
for _ in docs:  # every session is registered and making its PG
    assert making.acquire(timeout=30.0)
if case == "waiting_in_configure":
    store = StoreClient(ps._store.address())
    for d in docs:  # each session's rank 0 is up and waits in the store for rank 1
        store.get(f"session/{d['session_id']}/rank_0", timeout=30.0)
    store.close()
    time.sleep(0.2)
sessions = [t for t in threading.enumerate() if "process_request_thread" in t.name]
t0 = time.monotonic()
ps.shutdown()
took = time.monotonic() - t0
print(json.dumps({"sessions": len(sessions), "shutdown_s": took,
                  "alive": [t.name for t in sessions if t.is_alive()]}))
"""


@pytest.mark.parametrize("case", ["waiting_in_configure", "pg_made_after_shutdown_begins"])
def test_shutdown_ends_sessions_that_wait_for_their_client(case):
    """Sessions minted over HTTP and never joined wait in their PG's
    configure (a store get for rank 1), or are still making their PG when
    shutdown begins.  ``shutdown()`` ends them and joins their threads
    before it stops the native store, well inside their 60 s PG timeout;
    stopping the store under a waiting get could kill the process, so this
    runs in a child."""
    out = subprocess.run([sys.executable, "-c", _SHUTDOWN_UNDER_WAITING_SESSIONS, case],
                         cwd=REPO, capture_output=True, text=True, timeout=40,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode == 0, out.stderr[-4000:]
    doc = json.loads(out.stdout.strip().splitlines()[-1])
    assert doc["sessions"] == 3, doc
    assert doc["alive"] == [], doc
    assert doc["shutdown_s"] < 10.0, doc


def test_failed_collective_tears_down_session(ps):
    """A client that dies mid-session fails the server's collective; the
    session thread raises, frees its PG, and the server keeps minting."""
    pg = _EchoPS.new_session(ps.address())
    pg.shutdown()  # abandon the session mid-protocol
    time.sleep(0.2)
    pg2 = _EchoPS.new_session(ps.address())
    try:
        _client_round(pg2)
    finally:
        pg2.shutdown()


def _reserved_port():
    """A port bound here and not listening: a connect to it is refused, no
    other process can bind it, and a server that sets SO_REUSEADDR (as
    ``http.server`` does) can bind it beside this socket."""
    reserved = socket.socket()
    reserved.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    reserved.bind(("127.0.0.1", 0))
    return reserved, reserved.getsockname()[1]


def test_new_session_retries_until_server_up():
    """new_session goes through the unified retry layer: a server that
    binds after the first attempts is polled, not failed."""
    reserved, port = _reserved_port()
    results = {}

    def _mint():
        try:
            results["pg"] = _EchoPS.new_session(
                f"http://127.0.0.1:{port}/new_session", timeout=20.0)
        except Exception as e:  # noqa: BLE001 - surfaced below
            results["error"] = e

    t = threading.Thread(target=_mint, daemon=True)
    t.start()
    t.join(timeout=0.5)  # a few connection-refused attempts first
    server = _EchoPS(port=port)
    reserved.close()
    try:
        t.join(timeout=20)
        assert not t.is_alive(), "new_session never completed"
        assert "error" not in results, results.get("error")
        try:
            _client_round(results["pg"])
        finally:
            results["pg"].shutdown()
    finally:
        server.shutdown()


def test_new_session_deadline_bounded():
    """With nothing listening, new_session fails within its deadline."""
    reserved, port = _reserved_port()
    try:
        t0 = time.monotonic()
        with pytest.raises((TimeoutError, ConnectionError)):
            _EchoPS.new_session(f"http://127.0.0.1:{port}/new_session", timeout=1.5)
        assert time.monotonic() - t0 < 10
    finally:
        reserved.close()
