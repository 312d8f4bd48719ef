"""Versioned weight-payload codec for the serving tier — thin alias.

PyTorch port of ``torchft_tpu/serving/payload.py``.  The codec lives in
the shared fragment plane (``checkpointing/fragments.py``), which the
heal path rides too; this module keeps the serving tier's import surface.
Numpy leaves encode to the JAX package's bytes and sha256 digests; tensor
leaves carry the ``"torch"`` meta mark.  See the fragments
module for the format contract (serialized-wire fragments, sha256
digests, zero-decode passthrough, optional int8 leaves).
"""

from __future__ import annotations

from torchft_tpu_torch.checkpointing.fragments import (  # noqa: F401
    HEADER_FRAG,
    MANIFEST_FRAG,
    WIRE_F32,
    WIRE_INT8,
    _ViewReader,
    assemble,
    changed_fragments,
    decode_fragment,
    decode_manifest,
    decode_payload,
    encode_payload,
    fragment_wire,
    verify_fragment,
)

__all__ = [
    "WIRE_F32",
    "WIRE_INT8",
    "MANIFEST_FRAG",
    "encode_payload",
    "decode_fragment",
    "decode_manifest",
    "decode_payload",
    "assemble",
    "changed_fragments",
    "fragment_wire",
    "verify_fragment",
]
