"""Which names can denote THIS machine.

One source of truth for host-locality decisions: the HA peer-list
self-exclusion (``ha/endpoints.exclude_self``) and the serving-tier
wire shaper's intra-host exemption (``serving/wire.py``) must agree on
what "local" means, or a host addressed one way would be excluded from
its own peer list while the same address is shaped as WAN traffic.
"""

from __future__ import annotations

from typing import FrozenSet

__all__ = ["local_host_identities"]


def local_host_identities() -> "FrozenSet[str]":
    """Hostnames/addresses that denote this machine: loopback and
    wildcard forms, the hostname (full + short), and the hostname's
    resolved address when resolution works."""
    import socket

    name = socket.gethostname()
    ids = {
        "localhost",
        "127.0.0.1",
        "::1",
        "0.0.0.0",
        "",
        name,
        name.split(".")[0],
    }
    try:
        ids.add(socket.gethostbyname(name))
    except OSError:
        pass
    return frozenset(ids)
