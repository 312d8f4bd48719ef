"""Standalone Lighthouse CLI of the PyTorch port (``torchft_tpu/lighthouse.py``;
reference: src/bin/lighthouse.rs:11-24 and the
``lighthouse_main`` entry in src/lib.rs:329-344).

Run one per job; point every replica group's Manager at it:

    python -m torchft_tpu_torch.lighthouse --bind :29510 --min-replicas 2

Serves the quorum RPC protocol and the HTML dashboard (with per-replica
kill buttons and ``/status.json``) on the same port.

Coordination-plane HA: run N peers, each with the SAME full ``--peers``
list (every peer drops its own entry by bind port), and point clients at
the list — ``TORCHFT_LIGHTHOUSE=h1:p,h2:p,h3:p``::

    python -m torchft_tpu_torch.lighthouse --bind :29510 \
        --peers hostA:29510,hostB:29510,hostC:29510

The peers elect a leader by majority lease acknowledgement; followers
answer leader-only RPCs with a ``NOT_LEADER`` redirect every client
follows transparently (docs/architecture.md "Coordination-plane HA").
"""

from __future__ import annotations

import argparse
import signal
import threading

from torchft_tpu_torch.coordination import LighthouseServer
from torchft_tpu_torch.ha.endpoints import exclude_self, parse_endpoints


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--bind", default=":29510", help="host:port (port 0 = ephemeral)")
    p.add_argument("--min-replicas", type=int, default=1)
    p.add_argument("--join-timeout-ms", type=int, default=60000,
                   help="straggler wait before forming a smaller quorum "
                        "(reference CLI default 60s)")
    p.add_argument("--quorum-tick-ms", type=int, default=100)
    p.add_argument("--heartbeat-timeout-ms", type=int, default=5000)
    p.add_argument("--peers", default="",
                   help="coordination-plane HA: the FULL lighthouse peer "
                        "list (host1:p,host2:p,...); this peer's own entry "
                        "is dropped by bind port")
    p.add_argument("--lease-timeout-ms", type=int, default=None,
                   help="leadership lease duration (default "
                        "$TORCHFT_LIGHTHOUSE_LEASE_MS or 1000)")
    args = p.parse_args(argv)

    bind_host, _, bind_port = args.bind.rpartition(":")
    peers = exclude_self(
        parse_endpoints(args.peers),
        int(bind_port or 0),
        # the bind host is one more way this peer can be named in the list
        local_hosts={bind_host} if bind_host else None,
    )
    server = LighthouseServer(
        bind=args.bind,
        min_replicas=args.min_replicas,
        join_timeout_ms=args.join_timeout_ms,
        quorum_tick_ms=args.quorum_tick_ms,
        heartbeat_timeout_ms=args.heartbeat_timeout_ms,
        peers=peers,
        lease_timeout_ms=args.lease_timeout_ms,
    )
    ha = f" [HA: {len(peers)} peer(s), follower until elected]" if peers else ""
    print(f"lighthouse serving at {server.address()} "
          f"(dashboard: http://{server.address()}/){ha}", flush=True)

    stop = threading.Event()
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    try:
        stop.wait()
    finally:
        server.shutdown()


if __name__ == "__main__":
    main()
