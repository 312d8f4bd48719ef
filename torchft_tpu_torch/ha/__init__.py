"""Coordination-plane HA: a replicated lighthouse with leased leadership.

PyTorch-port copy of ``torchft_tpu/ha`` on the port's ``coordination``.

Run N lighthouse peers (static endpoint list), let them elect a leader by
majority lease acknowledgement (monotone term, heartbeat-renewed lease,
takeover on expiry), and point every client at the full list —
``TORCHFT_LIGHTHOUSE=host1:p,host2:p,host3:p``.  Followers answer
leader-only RPCs with a ``NOT_LEADER`` redirect naming the current
holder; ``LighthouseClient`` and the native manager's lighthouse client
walk the list and follow redirects transparently, so ``Manager``,
serving replicas/clients and ``torchft-torch-diagnose`` need no changes to
survive a lighthouse death.

Because lighthouse state is soft (heartbeats and serving registrations
rebuild through client re-registration), failover transfers nothing —
only monotonicity is preserved: the leader's term prefixes every id the
lighthouse mints (``(term << 32) | seq`` for ``quorum_id`` and the
serving plan epoch), so a new leader's ids strictly dominate its
predecessor's.  See docs/architecture.md "Coordination-plane HA".
"""

from torchft_tpu_torch.ha.endpoints import (
    exclude_self,
    format_endpoints,
    parse_endpoints,
)
from torchft_tpu_torch.ha.fleet import LighthouseFleet, pick_free_ports

__all__ = [
    "LighthouseFleet",
    "exclude_self",
    "format_endpoints",
    "parse_endpoints",
    "pick_free_ports",
]
