"""Listeners bound by their owners (ROADMAP §C 29): a port that another
process takes between a harness's pick and its server's bind must not stop
a replica group's coordinator or a lighthouse fleet.

The coordinator has no picker left: its store serves on the socket the
harness bound itself (``multihost.coordinator_listener``), so the port is
never free: another process's bind on it, made where the old pick left it
free (before rank 0 starts), fails, and the group comes up on it.
``LighthouseFleet`` keeps ``pick_free_ports``, patched here to return a
port that another socket holds and listens on, and builds its peers again
on fresh ports.
"""

import errno
import socket

import pytest
import torch

from torchft_tpu_torch.ha import fleet as ha_fleet
from torchft_tpu_torch.parallel import multihost
from torchft_tpu_torch.parallel.axis import MeshAxis


def _coordinator_comes_up(squatter, monkeypatch):
    address, listener = multihost.coordinator_listener()
    port = listener.getsockname()[1]
    # where the old pick closed its probe, another process binds the port
    squatter.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    with pytest.raises(OSError) as taken:
        squatter.bind(("127.0.0.1", port))
    assert taken.value.errno == errno.EADDRINUSE

    def rank(r):
        world = multihost.initialize_multihost(
            address, 2, r, backend="gloo", timeout=30.0, listener=listener if r == 0 else None)
        axis = MeshAxis("dp", world.new_group("dp", range(2)), r, 2)
        x = torch.tensor([r + 1.0])
        axis.psum_([x])
        return x.item(), world.store.port

    out = multihost.run_ranks(rank, 2, timeout=30.0)
    assert [v for v, _ in out] == [3.0, 3.0]
    # rank 0 served its store on the harness's socket
    assert out[0][1] == port


def _fleet_comes_up(squatter, monkeypatch):
    # the port a bind-read-close pick handed out, taken and listening
    squatter.bind(("127.0.0.1", 0))
    squatter.listen(8)
    taken = squatter.getsockname()[1]
    real = ha_fleet.pick_free_ports
    picks = []

    def picker(n):
        picks.append(n)
        return [taken] + real(n - 1) if len(picks) == 1 else real(n)

    monkeypatch.setattr(ha_fleet, "pick_free_ports", picker)
    with ha_fleet.LighthouseFleet(n=3, min_replicas=1, lease_timeout_ms=300) as f:
        f.wait_for_leader(10)
        assert f.restarts == 1 and len(picks) == 2
        assert f"127.0.0.1:{taken}" not in f.endpoints()


@pytest.mark.parametrize("owner", ["coordinator", "lighthouse_fleet"])
def test_a_port_taken_after_its_pick_does_not_stop_its_owner(owner, monkeypatch):
    squatter = socket.socket()
    try:
        {"coordinator": _coordinator_comes_up,
         "lighthouse_fleet": _fleet_comes_up}[owner](squatter, monkeypatch)
    finally:
        squatter.close()


def test_a_fleet_whose_binds_keep_failing_raises_the_bind_error(monkeypatch):
    """Every pick taken: the fleet gives up after ``FLEET_BIND_ATTEMPTS``
    builds and raises the last bind error, its peers all shut down."""
    squatter = socket.socket()
    squatter.bind(("127.0.0.1", 0))
    squatter.listen(8)
    real = ha_fleet.pick_free_ports
    picks = []

    def picker(n):
        picks.append(n)
        return [squatter.getsockname()[1]] + real(n - 1)

    monkeypatch.setattr(ha_fleet, "pick_free_ports", picker)
    try:
        with pytest.raises(RuntimeError, match="Address already in use"):
            ha_fleet.LighthouseFleet(n=3)
        assert len(picks) == ha_fleet.FLEET_BIND_ATTEMPTS
    finally:
        squatter.close()


def test_a_store_serving_a_handed_over_listener_idles():
    """Rank 0's ``TCPStore`` on the harness's listener serves a client and
    then idles: no thread of its server spins on the adopted socket (one
    would cost a core in every group's rank 0 for the whole run)."""
    import time
    from datetime import timedelta

    import torch.distributed as dist

    address, listener = multihost.coordinator_listener()
    host, _, port = address.rpartition(":")
    server = dist.TCPStore(host, int(port), 2, is_master=True, timeout=timedelta(seconds=30),
                           wait_for_workers=False, master_listen_fd=listener.detach())
    client = dist.TCPStore(host, int(port), 2, is_master=False, timeout=timedelta(seconds=30))
    client.set("k", "v")
    assert server.get("k") == b"v"
    t0, c0 = time.monotonic(), time.process_time()
    time.sleep(2.0)
    busy = (time.process_time() - c0) / (time.monotonic() - t0)
    del client, server
    assert busy < 0.25, f"the store's process used {busy:.2f} of a core while idle"
