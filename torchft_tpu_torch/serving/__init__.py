"""Weight-serving tier: fault-tolerant fan-out checkpoint distribution.

PyTorch port of ``torchft_tpu/serving``.  A :class:`WeightPublisher` next
to training publishes committed weights as versioned, optionally
int8-quantized payloads; :class:`ServingReplica` nodes form a
lighthouse-synthesized fan-out tree (root pulls the publisher, interior
nodes relay, leaves serve); :class:`ServingClient` inference clients fetch
full or delta (changed-fragment) payloads with failover when a server dies
mid-fetch.  Discovery, health and tree synthesis ride the lighthouse
(``serving_heartbeat`` / ``serving_plan`` RPCs, ``/serving.json``); the
wire path is the HTTP checkpoint transport's version-keyed staging.
Relays cut through: each digest-verified fragment is restaged the moment
it arrives, only digest-changed fragments are pulled when the previous
version is held, and payload bytes are never decoded on a relay.
``serving/wire.py`` is the WAN wire model the fetches are priced with.
"""

from torchft_tpu_torch.serving.client import ServingClient, fetch_resource
from torchft_tpu_torch.serving.fetcher import FragmentFetcher
from torchft_tpu_torch.serving.payload import (
    MANIFEST_FRAG,
    WIRE_F32,
    WIRE_INT8,
    changed_fragments,
    decode_manifest,
    decode_payload,
    encode_payload,
    verify_fragment,
)
from torchft_tpu_torch.serving.publisher import WeightPublisher
from torchft_tpu_torch.serving.replica import ServingReplica

__all__ = [
    "WeightPublisher",
    "ServingReplica",
    "ServingClient",
    "FragmentFetcher",
    "fetch_resource",
    "encode_payload",
    "decode_payload",
    "decode_manifest",
    "changed_fragments",
    "verify_fragment",
    "MANIFEST_FRAG",
    "WIRE_F32",
    "WIRE_INT8",
]
