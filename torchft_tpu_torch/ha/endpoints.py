"""Endpoint-list plumbing for the replicated lighthouse.

The one parser (`coordination.parse_endpoints`) is re-exported here so
HA tooling has a single import home; `exclude_self` implements the
"same config file on every node" convention — each peer is handed the
FULL ``TORCHFT_LIGHTHOUSE`` list and removes its own entry by port.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence

from torchft_tpu_torch.coordination import parse_endpoints, parse_host_port
from torchft_tpu_torch.utils.hostident import local_host_identities

__all__ = ["parse_endpoints", "format_endpoints", "exclude_self"]


def format_endpoints(endpoints: "Sequence[str]") -> str:
    """The inverse of :func:`parse_endpoints`: a ``TORCHFT_LIGHTHOUSE``
    comma-list value."""
    return ",".join(endpoints)


def exclude_self(
    endpoints: "Sequence[str]",
    bind_port: int,
    local_hosts: "Optional[Iterable[str]]" = None,
) -> "List[str]":
    """Drop this peer's own entry from a full endpoint list.

    Operators hand every lighthouse the SAME ``--peers`` list.  A unique
    entry on this peer's bind port is unambiguously "me".  The standard
    multi-host deployment puts EVERY peer on the same port, so among
    several same-port entries the one whose host is a local identity
    (hostname, short hostname, loopback, the hostname's resolved IP,
    plus any ``local_hosts`` the caller adds — the CLI passes its bind
    host) is removed.  If none can be
    identified the list is ambiguous and this RAISES: a silently wrong
    exclusion would leave the peer in its own peer list, double-counting
    its self-vote toward lease majorities — exactly the split-brain HA
    exists to prevent.  A list that never contained this peer's port
    comes back unchanged (the caller is then a pure witness peer, which
    also works); ``bind_port`` 0 (ephemeral) never matches — an
    ephemeral-port peer cannot appear in a static list.
    """
    eps = list(endpoints)
    if bind_port == 0:
        return eps

    def _port(ep: str) -> "Optional[int]":
        try:
            return parse_host_port(ep)[1]
        except ValueError:
            return None

    candidates = [i for i, ep in enumerate(eps) if _port(ep) == bind_port]
    if not candidates:
        return eps
    if len(candidates) > 1:
        local = local_host_identities() | (
            frozenset(local_hosts) if local_hosts is not None else frozenset()
        )
        candidates = [
            i for i in candidates if parse_host_port(eps[i])[0] in local
        ]
    if len(candidates) != 1:
        raise ValueError(
            f"cannot identify this peer (port {bind_port}) in the peer "
            f"list {eps}: {len(candidates)} entries match by port+host — "
            f"use distinct hostnames (or distinct ports) per peer so the "
            f"self-entry is unambiguous"
        )
    return eps[: candidates[0]] + eps[candidates[0] + 1 :]
