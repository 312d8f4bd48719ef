"""The port's coordination-plane HA: ``ha/``, the lighthouse CLI, and a
leader SIGKILLed out of a 3-peer subprocess fleet (counterpart of
tests/test_ha_integ.py and the endpoint units of tests/test_ha.py).

The peers run as real subprocesses of the port's CLI (``python -m
torchft_tpu_torch.lighthouse --peers ...``) so the kill is a true SIGKILL:
clients see dead sockets and must walk the ``TORCHFT_LIGHTHOUSE`` list.
Asserted: quorum rounds resume within the failover budget with strictly
monotone, term-advancing ``quorum_id``s, and the native manager's
lighthouse client (a ``ManagerClient`` quorum) rides the same walk.
"""

from __future__ import annotations

import json
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request

import pytest

from torchft_tpu import ha as jha
from torchft_tpu_torch import ha
from torchft_tpu_torch.coordination import (
    LighthouseClient,
    ManagerClient,
    ManagerServer,
    StoreServer,
)

LEASE_MS = 400
#: kill -> next formed quorum: detection (a lease) + election + the walk,
#: ~3 leases here; loose for loaded hosts
FAILOVER_BUDGET_S = 10.0


@pytest.mark.parametrize("full,port,local,want", [
    (["hostA:29510", "hostB:29511", "hostC:29512"], 29511, None,
     ["hostA:29510", "hostC:29512"]),
    (["hostA:29510", "hostB:29510", "hostC:29510"], 29510, {"hostB"},
     ["hostA:29510", "hostC:29510"]),
    ([f"hostA:29510", f"{socket.gethostname()}:29510", "hostC:29512"], 29510,
     None, ["hostA:29510", "hostC:29512"]),
    (["a:1", "b:2"], 9999, None, ["a:1", "b:2"]),
    (["a:1", "b:2"], 0, None, ["a:1", "b:2"]),
    (["a:29510", "b:29510"], 29510, {"nothing"}, ValueError),
])
def test_endpoints_equal_the_jax_package_s(full, port, local, want):
    assert ha.parse_endpoints(" a:1 , ,b:2,  ") == jha.parse_endpoints(
        " a:1 , ,b:2,  ") == ["a:1", "b:2"]
    assert ha.format_endpoints(full) == jha.format_endpoints(full)
    if want is ValueError:
        for mod in (ha, jha):
            with pytest.raises(ValueError):
                mod.exclude_self(full, port, local_hosts=local)
    else:
        assert ha.exclude_self(full, port, local_hosts=local) == want
        assert jha.exclude_self(full, port, local_hosts=local) == want
    ports = ha.pick_free_ports(3)
    assert len(set(ports)) == 3


def test_in_process_fleet_takeover_bumps_term_and_quorum_id():
    with ha.LighthouseFleet(n=3, min_replicas=1, lease_timeout_ms=300) as f:
        f.wait_for_leader(10)
        assert [i for i in f.alive() if f.ha_info(i)["is_leader"]] == [
            f.leader_index()]
        cli = LighthouseClient(f.addresses(), connect_timeout=5.0)
        try:
            q1 = cli.quorum("ha_mono:1", timeout=10.0)
            term0 = f.term()
            killed = f.kill_leader()
            assert f.wait_for_leader(15) != killed
            assert f.term() > term0
            q2 = cli.quorum("ha_mono:2", timeout=15.0)
            assert q2.quorum_id > q1.quorum_id
            assert (q2.quorum_id >> 32) > (q1.quorum_id >> 32)
        finally:
            cli.close()
        with pytest.raises(RuntimeError):
            f.ha_info(killed)


class SubprocessFleet:
    """Three peers of the port's lighthouse CLI, SIGKILL-able, started as
    phase 13 starts them (``chip_smoke.start_lighthouse_peers``: each
    checked to answer, all started again on fresh ports when a port was
    taken before its peer bound it), each peer's output in ``log_dir``."""

    def __init__(self, log_dir: str, n: int = 3, lease_ms: int = LEASE_MS) -> None:
        import chip_smoke

        self.log_dir = log_dir
        procs, self.endpoints, self.ports, self.restarts = chip_smoke.start_lighthouse_peers(
            ["--lease-timeout-ms", str(lease_ms), "--min-replicas", "1",
             "--quorum-tick-ms", "50", "--heartbeat-timeout-ms", "3000",
             "--join-timeout-ms", "100"], log_dir, n=n)
        self.held: "list[socket.socket]" = []
        self.procs: "list[subprocess.Popen | None]" = list(procs)

    def log(self, i: int) -> str:
        """Peer ``i``'s output so far."""
        with open(f"{self.log_dir}/lighthouse{i}_try{self.restarts}.log") as f:
            return f.read()

    def addresses(self) -> str:
        return ha.format_endpoints(self.endpoints)

    def ha_info(self, i: int) -> "dict | None":
        try:
            with urllib.request.urlopen(
                f"http://{self.endpoints[i]}/status.json", timeout=2
            ) as resp:
                return json.load(resp).get("ha")
        except Exception:  # noqa: BLE001 - dead or starting peer
            return None

    def leader_index(self, timeout: float = 60.0) -> int:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            for i, p in enumerate(self.procs):
                if p is None or p.poll() is not None:
                    continue
                info = self.ha_info(i)
                if info and info.get("is_leader"):
                    return i
            time.sleep(0.05)
        raise TimeoutError("no subprocess lighthouse leader elected")

    def sigkill(self, i: int) -> None:
        p = self.procs[i]
        p.send_signal(signal.SIGKILL)
        p.wait(timeout=10)
        self.procs[i] = None
        # the live peers keep dialling the dead one: hold its port (bound,
        # not listening) so no other process picks it up as ephemeral
        s = socket.socket()
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            s.bind(("127.0.0.1", self.ports[i]))
            self.held.append(s)
        except OSError:
            s.close()

    def shutdown(self) -> None:
        for i, p in enumerate(self.procs):
            if p is not None and p.poll() is None:
                p.terminate()
                try:
                    p.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait(timeout=10)
            self.procs[i] = None
        for s in self.held:
            s.close()


@pytest.fixture
def fleet(tmp_path):
    f = SubprocessFleet(str(tmp_path))
    try:
        f.leader_index()  # up and elected before any test logic runs
        yield f
    finally:
        f.shutdown()


def test_cli_banner_names_its_peers(fleet):
    line = fleet.log(0).splitlines()[0]
    assert f"lighthouse serving at 127.0.0.1:{fleet.ports[0]}" in line
    assert "[HA: 2 peer(s)" in line


def test_sigkill_leader_mid_round_requorums_monotone(fleet):
    """Two replica groups quorum continuously; SIGKILL the leader
    mid-round; the fleet re-quorums within the failover budget with
    strictly monotone, term-advancing quorum ids."""
    addrs = fleet.addresses()
    stop = threading.Event()
    ids: "dict[str, list[int]]" = {"a": [], "b": []}
    errors: "list[Exception]" = []

    def rounds(name: str) -> None:
        cli = LighthouseClient(addrs, connect_timeout=5.0)
        inc = 0
        try:
            while not stop.is_set():
                inc += 1
                try:
                    q = cli.quorum(f"grp_{name}:{inc}", timeout=15.0,
                                   address=f"{name}:1",
                                   store_address=f"{name}:2")
                    ids[name].append(q.quorum_id)
                except (TimeoutError, ConnectionError):
                    continue  # mid-election round: retry
        except Exception as e:  # noqa: BLE001 - asserted below
            errors.append(e)
        finally:
            cli.close()

    threads = [threading.Thread(target=rounds, args=(n,), daemon=True)
               for n in ("a", "b")]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 30
    while (not ids["a"] or not ids["b"]) and time.monotonic() < deadline:
        time.sleep(0.05)
    assert ids["a"] and ids["b"], "no quorum rounds before the kill"

    pre_kill_max = max(ids["a"] + ids["b"])
    t_kill = time.monotonic()
    fleet.sigkill(fleet.leader_index())
    while time.monotonic() - t_kill < FAILOVER_BUDGET_S:
        if max(ids["a"] + ids["b"], default=0) > pre_kill_max:
            break
        time.sleep(0.02)
    t_requorum = time.monotonic() - t_kill
    stop.set()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive(), "quorum round thread wedged"
    assert not errors, f"round thread raised: {errors}"
    post_kill_max = max(ids["a"] + ids["b"])
    assert post_kill_max > pre_kill_max, "no quorum after the SIGKILL"
    for name in ("a", "b"):
        assert all(b > a for a, b in zip(ids[name], ids[name][1:])), ids[name]
    assert (post_kill_max >> 32) > (pre_kill_max >> 32)
    assert t_requorum < FAILOVER_BUDGET_S


def test_native_manager_quorum_across_leader_kill(fleet):
    """The native manager's lighthouse client walks the endpoint list: a
    ManagerClient quorum succeeds before and after a leader SIGKILL with
    monotone, term-advancing ids."""
    store = StoreServer()
    server = ManagerServer(
        replica_id="ha_native:1", lighthouse_addr=fleet.addresses(),
        store_address=store.address(), world_size=1, heartbeat_interval=0.1,
        quorum_retries=3,
    )
    client = ManagerClient(server.address(), connect_timeout=5.0)
    try:
        q1 = client._quorum(0, step=0, checkpoint_metadata="",
                            shrink_only=False, timeout=20.0)
        fleet.sigkill(fleet.leader_index())
        q2 = client._quorum(0, step=1, checkpoint_metadata="",
                            shrink_only=False, timeout=30.0)
        assert q2.quorum_id > q1.quorum_id
        assert (q2.quorum_id >> 32) > (q1.quorum_id >> 32)
    finally:
        client.close()
        server.shutdown()
        store.shutdown()
