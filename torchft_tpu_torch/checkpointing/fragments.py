"""Shared fragment plane: digest-manifested payloads + pipelined fetches.

PyTorch port of ``torchft_tpu/checkpointing/fragments.py``.  State is
flattened in JAX's leaf order by ``utils.pytree``, so fragment slots and
skeletons match the JAX package's; a fragment of numpy leaves has the
same bytes and sha256 there and here.  A tensor leaf carries
``"torch": True`` in its serialized meta, so fragments of tensor state
hash differently from the same values as numpy arrays.

One fragment data path used by BOTH consumers of bulk weight movement
(promoted out of ``serving/`` so live healing could ride it too):

- the **weight-serving tier** (``serving/``): versioned payload docs,
  cut-through relays, delta client fetches;
- the **heal path** (``checkpointing/http_transport.py`` +
  ``manager.py``): a stale replica stripes disjoint fragment ranges
  across every max-step quorum peer in parallel, verifies each fragment
  against the primary source's manifest digest, and — on a transient
  rejoin — fetches only the fragments whose digest differs from its own
  state (docs/architecture.md "Striped heal").

A payload/heal document is one staged checkpoint-transport document:

.. code-block:: text

    {
      "frag:header":   {version, wire, fragments, skeleton, num_leaves}   (heal only; staged FIRST)
      "frag:manifest": {header fields + digests, created_ns}              (staged last on the heal path)
      "frag:0": <serialized fragment wire bytes>,
      ...
    }

Every fragment is independently fetchable via the transport's
``frag_<name>`` resource.  Fragments are stored (and staged, and
relayed) as the **serialized wire stream itself**
(``checkpointing/serialization.py`` format), and the digest is the
sha256 of exactly those bytes: any node can verify a fragment on receipt
and re-serve it **verbatim** — zero decode passes — and replicas holding
bitwise-identical state produce bitwise-identical fragments by
construction, which is what makes cross-peer striped fetches safe.  A
fragment may appear as ``bytes`` (encoder output), a bufpool-backed
``uint8`` ndarray (fetch/relay passthrough), or a decoded
``{slot: leaf}`` dict (tests/legacy); :func:`fragment_wire` normalizes
the raw forms.

The fetch plane (persistent per-``(thread, netloc)`` HTTP/1.1
connections, bufpool ``readinto`` receive, 503-poll retry, WAN
wire-model charging, flight/span/fault instrumentation) is shared
verbatim; callers select the telemetry identity — the serving tier uses
the ``serving.frag`` site/record/span, heal uses ``transport.heal.frag``
+ ``heal.frag``.

Leaves are optionally int8-quantized through the same per-row absmax
codec the quantized collectives use (``ops/quantization.py``): a float32
leaf becomes ``{"q8": int8 payload, "scale": f32 row scales,
"shape": [...]}``.  The heal path never quantizes — heal is bitwise.
"""

from __future__ import annotations

import hashlib
import http.client
import io
import threading
import time
import urllib.error
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from typing import (
    Any,
    Callable,
    Dict,
    Iterator,
    List,
    Optional,
    Set,
    Tuple,
)
from urllib.parse import urlparse

import numpy as np
import torch

from torchft_tpu_torch.checkpointing import fragdata as _fragdata
from torchft_tpu_torch.checkpointing import provenance as _prov
from torchft_tpu_torch.checkpointing import serialization as ser
from torchft_tpu_torch.utils import faults as _faults
from torchft_tpu_torch.utils import flightrecorder as _flightrec
from torchft_tpu_torch.utils import linkstats as _linkstats
from torchft_tpu_torch.utils import metrics as _metrics
from torchft_tpu_torch.utils import tracing as _tracing
from torchft_tpu_torch.utils.bufpool import POOL
from torchft_tpu_torch.utils.env import env_int
from torchft_tpu_torch.utils.pytree import tree_flatten, tree_map
from torchft_tpu_torch.utils.retry import RetryPolicy

__all__ = [
    # payload codec
    "WIRE_F32",
    "WIRE_INT8",
    "MANIFEST_FRAG",
    "HEADER_FRAG",
    "encode_payload",
    "decode_fragment",
    "decode_manifest",
    "decode_payload",
    "assemble",
    "changed_fragments",
    "fragment_wire",
    "fragment_slots",
    "fragment_into_map",
    "verify_fragment",
    # heal-side helpers
    "heal_fragment_names",
    "iter_heal_fragments",
    "stage_heal_checkpoint",
    "local_fragment_digests",
    "maybe_decode_heal_doc",
    # fetch plane
    "FragmentFetcher",
    "fetch_raw",
    "fetch_serialized",
    "close_connections",
    "striped_fetch",
    "StripeError",
]

WIRE_F32 = "f32"
WIRE_INT8 = "int8"

#: the manifest travels as a fragment itself so the delta path is
#: uniform: fetch ``frag_manifest``, diff digests, fetch what moved.
MANIFEST_FRAG = "manifest"

#: heal-only: the digest-less manifest prefix staged BEFORE any fragment
#: encodes, so the healer's striped fetch can start while the source is
#: still snapshotting — the full manifest (with digests) lands last.
HEADER_FRAG = "header"

_Q8_KEY = "q8"


# ---------------------------------------------------------------------------
# payload codec (digest-manifested fragment documents)
# ---------------------------------------------------------------------------


def _encode_leaf(leaf: Any, wire: str) -> Any:
    if wire != WIRE_INT8:
        return leaf
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype != torch.float32:
            return leaf
        # the host codec quantizes; an f32 tensor leaf travels as the
        # same int8 payload a numpy leaf of its values would
        leaf = leaf.detach().cpu().numpy()
    if not isinstance(leaf, np.ndarray) and hasattr(leaf, "__array__"):
        leaf = np.asarray(leaf)
    if (
        not isinstance(leaf, np.ndarray)
        or leaf.dtype != np.float32
        or leaf.size == 0
    ):
        return leaf
    from torchft_tpu_torch.ops import quantization as q

    # The codec's own row view (``_as_rows``: leading dim = rows, rest
    # flattened) — passing the leaf straight through keeps serving
    # payload bytes in lockstep with the collective wire bytes by
    # construction, not by a mirrored re-implementation.
    scales, payload = q.quantize(np.ascontiguousarray(leaf), q.WIRE_INT8)
    return {
        _Q8_KEY: payload,
        "scale": scales,
        "shape": np.asarray(leaf.shape, dtype=np.int64),
    }


def _decode_leaf(leaf: Any) -> Any:
    if isinstance(leaf, dict) and _Q8_KEY in leaf:
        from torchft_tpu_torch.ops import quantization as q

        shape = tuple(int(d) for d in np.asarray(leaf["shape"]).tolist())
        return q.dequantize(
            np.asarray(leaf["scale"]),
            np.asarray(leaf[_Q8_KEY]),
            shape,
            np.dtype(np.float32),
        )
    return leaf


def fragment_wire(frag: Any) -> "Optional[memoryview]":
    """Raw wire view of a fragment in passthrough form (``bytes`` from
    the encoder, a bufpool-backed ``uint8`` ndarray on a relay/fetch);
    ``None`` for decoded/pytree fragments."""
    return ser.raw_view(frag)


class _ViewReader(io.RawIOBase):
    """Zero-copy BinaryIO over a memoryview: ``deserialize_from`` reads
    straight out of the received buffer into the final leaf arrays —
    ``io.BytesIO(raw)`` would copy the whole fragment first."""

    def __init__(self, view: memoryview) -> None:
        self._view = view
        self._off = 0

    def readable(self) -> bool:
        return True

    def readinto(self, b: Any) -> int:
        n = min(len(b), len(self._view) - self._off)
        b[:n] = self._view[self._off:self._off + n]
        self._off += n
        return n


def verify_fragment(name: str, frag: Any, manifest: "Dict[str, Any]") -> None:
    """Check a raw fragment against the publisher-computed sha256 in the
    manifest; raises ``ValueError`` on mismatch.  Decoded fragments (no
    raw view) and fragments the manifest carries no digest for pass —
    integrity is a property of the wire form."""
    raw = fragment_wire(frag)
    if raw is None:
        return
    want = (manifest.get("digests") or {}).get(name)
    if want is None:
        return
    # wire_digest (not hashlib directly): when the native data plane
    # landed this buffer it already digested it GIL-free — re-hashing
    # every fragment on every hop would throw that work away
    got = wire_digest(frag)
    if got != want:
        raise ValueError(
            f"serving fragment {name!r} v{manifest.get('version')}: digest "
            f"mismatch ({got[:12]} != {want[:12]}) — corrupted or torn "
            f"fragment must never be staged or served"
        )


def encode_payload(
    state_dict: Any,
    version: int,
    wire: str = WIRE_F32,
    fragments: int = 1,
) -> "Dict[str, Any]":
    """Build the staged document for one published weight version.

    ``fragments``: leaf slots are split round-robin into this many
    independently fetchable fragments (the delta unit); pass the DiLoCo
    fragment count to align delta fetches with training's sync unit.
    Fragment values are the serialized wire bytes; ``digests`` is the
    sha256 of those bytes, so relays verify and re-serve them verbatim.
    """
    if wire not in (WIRE_F32, WIRE_INT8):
        raise ValueError(f"serving wire must be f32|int8, got {wire!r}")
    fragments = max(int(fragments), 1)
    leaves, skeleton = tree_flatten(state_dict)
    frag_names = [str(i) for i in range(min(fragments, max(len(leaves), 1)))]
    doc: "Dict[str, Any]" = {}
    digests: "Dict[str, str]" = {}
    for name in frag_names:
        frag: "Dict[str, Any]" = {}
        for slot in fragment_slots(name, len(leaves), len(frag_names)):
            frag[str(slot)] = _encode_leaf(leaves[slot], wire)
        raw = ser.serialize(frag)
        doc[f"frag:{name}"] = raw
        digests[name] = hashlib.sha256(raw).hexdigest()
    doc[f"frag:{MANIFEST_FRAG}"] = {
        "version": int(version),
        "wire": wire,
        "fragments": frag_names,
        "digests": digests,
        "skeleton": skeleton,
        "num_leaves": len(leaves),
        "created_ns": time.time_ns(),
    }
    return doc


def decode_fragment(
    frag: Any, into: "Optional[Dict[int, np.ndarray]]" = None
) -> "Dict[int, Any]":
    """Decode one fragment (raw wire bytes or an already-deserialized
    sub-dict) into ``{GLOBAL leaf slot: decoded leaf}``.

    ``into`` maps the fragment's LOCAL leaf slots (its own flatten
    order — build it with :func:`fragment_into_map`) to arrays received
    **in place** (the heal path's warm retained buffers,
    ``serialization.deserialize_from`` semantics); inapplicable slots
    fall back to fresh arrays."""
    raw = fragment_wire(frag)
    if raw is not None:
        skeleton, leaves, n = ser.deserialize_from(
            _ViewReader(raw), into=into
        )
        frag = ser.reassemble(skeleton, leaves, n)
    return {int(slot): _decode_leaf(leaf) for slot, leaf in frag.items()}


def fragment_slots(
    name: str, num_leaves: int, num_fragments: int
) -> "List[int]":
    """GLOBAL leaf slots belonging to fragment ``name`` — the one
    round-robin layout rule (``serialization.split_chunks``) every
    producer/consumer of the fragment plane shares."""
    return ser.split_chunks(num_leaves, num_fragments)[int(name)]


def fragment_into_map(
    name: str,
    num_leaves: int,
    num_fragments: int,
    into: "Dict[int, np.ndarray]",
) -> "Dict[int, np.ndarray]":
    """Remap a GLOBAL-slot ``into`` buffer map onto fragment ``name``'s
    LOCAL leaf slots, for :func:`decode_fragment`'s in-place receive.

    A fragment serializes as the sub-dict ``{str(global_slot): leaf}``;
    the dict flatten (JAX's order, ``utils.pytree``) sorts keys LEXICOGRAPHICALLY, so the fragment's
    local slot *i* is the *i*-th key in sorted-string order — not the
    numeric order the round-robin assignment suggests."""
    keys = sorted(
        str(s) for s in fragment_slots(name, num_leaves, num_fragments)
    )
    return {
        i: into[int(k)] for i, k in enumerate(keys) if int(k) in into
    }


def decode_manifest(raw: Any) -> "Dict[str, Any]":
    """Decode a raw ``frag_manifest`` (or ``frag_header``) fetch into
    the manifest dict."""
    view = fragment_wire(raw)
    skeleton, leaves, n = ser.deserialize_from(
        _ViewReader(view) if view is not None else io.BytesIO(raw)
    )
    manifest = ser.reassemble(skeleton, leaves, n)
    if not isinstance(manifest, dict) or "fragments" not in manifest:
        raise ValueError("serving fetch: frag_manifest is not a manifest")
    return manifest


def changed_fragments(
    manifest: "Dict[str, Any]", prev_manifest: "Optional[Dict[str, Any]]"
) -> "List[str]":
    """Fragment names whose digest differs from ``prev_manifest`` (all of
    them when there is no previous version or the shape changed)."""
    names = list(manifest["fragments"])
    if prev_manifest is None or prev_manifest.get("num_leaves") != manifest.get(
        "num_leaves"
    ):
        return names
    prev = prev_manifest.get("digests") or {}
    return [n for n in names if manifest["digests"].get(n) != prev.get(n)]


def assemble(
    manifest: "Dict[str, Any]", leaves: "Dict[int, Any]"
) -> Any:
    """Rebuild the state dict from a complete ``{slot: decoded leaf}``
    map and the manifest skeleton (the tail of :func:`decode_payload`,
    split out so pipelined fetchers can merge leaves incrementally)."""
    n = int(manifest["num_leaves"])
    missing = [i for i in range(n) if i not in leaves]
    if missing:
        raise ValueError(
            f"serving payload v{manifest.get('version')}: missing leaf "
            f"slots {missing[:5]}{'...' if len(missing) > 5 else ''} "
            f"(delta fetch without a complete previous version?)"
        )
    return tree_map(lambda slot: leaves[slot], manifest["skeleton"])


def decode_payload(
    doc: "Dict[str, Any]",
    prev: "Optional[Tuple[Dict[str, Any], Dict[int, Any]]]" = None,
) -> "Tuple[Any, Dict[str, Any], Dict[int, Any]]":
    """Decode a full fetched document (or a manifest + changed-fragment
    subset merged over ``prev = (prev_manifest, prev_leaves)``).

    Returns ``(state_dict, manifest, leaves)`` — keep ``(manifest,
    leaves)`` around to decode the next delta fetch.
    """
    manifest = doc[f"frag:{MANIFEST_FRAG}"]
    leaves: "Dict[int, Any]" = dict(prev[1]) if prev is not None else {}
    for name in manifest["fragments"]:
        frag = doc.get(f"frag:{name}")
        if frag is not None:
            verify_fragment(name, frag, manifest)
            leaves.update(decode_fragment(frag))
    state = assemble(manifest, leaves)
    return state, manifest, leaves


# ---------------------------------------------------------------------------
# heal-side encode: streamed staging + local digests
# ---------------------------------------------------------------------------

#: Fragments a heal checkpoint is split into (the stripe/delta unit).
#: More fragments = finer striping + finer deltas but more per-fragment
#: message overhead; both heal endpoints read the count from the header,
#: so the knob only needs to be set on the sources.
DEFAULT_HEAL_FRAGMENTS = 8


def heal_fragment_names(num_leaves: int, fragments: int) -> "List[str]":
    return [str(i) for i in range(min(max(fragments, 1), max(num_leaves, 1)))]


def iter_heal_fragments(
    state_dict: Any, fragments: "Optional[int]" = None
) -> "Tuple[Dict[str, Any], Iterator[Tuple[str, bytes, str]]]":
    """Split ``state_dict`` into heal fragments.

    Returns ``(header, iterator)`` where ``header`` is the digest-less
    manifest prefix (available BEFORE any encoding work) and the
    iterator lazily yields ``(name, wire_bytes, sha256)`` — each
    ``next()`` performs that fragment's host snapshot + serialize +
    hash, which is what lets the streamed staging overlap a healer's
    fetch of fragment *i* with the encode of fragment *i+1*.

    Heal fragments are always ``f32`` wire (bitwise — a healed replica
    must converge exactly), leaf slots split round-robin like
    :func:`encode_payload`.
    """
    if fragments is None:
        fragments = env_int(
            "TORCHFT_HEAL_FRAGMENTS", DEFAULT_HEAL_FRAGMENTS, minimum=1
        )
    leaves, skeleton = tree_flatten(state_dict)
    names = heal_fragment_names(len(leaves), fragments)
    header: "Dict[str, Any]" = {
        "wire": WIRE_F32,
        "fragments": names,
        "skeleton": skeleton,
        "num_leaves": len(leaves),
    }

    def gen() -> "Iterator[Tuple[str, bytes, str]]":
        for name in names:
            frag = {
                str(slot): leaves[slot]
                for slot in fragment_slots(name, len(leaves), len(names))
            }
            raw = ser.serialize(frag)
            yield name, raw, hashlib.sha256(raw).hexdigest()

    return header, gen()


def stage_heal_checkpoint(
    transport: Any,
    step: int,
    state_dict: Any,
    fragments: "Optional[int]" = None,
    timeout: "Optional[float]" = None,
) -> "Dict[str, Any]":
    """Stage ``state_dict`` for heal as a CUT-THROUGH fragment stream.

    The digest-less header is staged first (healers fetch it and start
    striping immediately), each fragment is staged the moment it
    encodes (healer wire overlaps source snapshot/encode — the
    transport's fragment long-poll hands each one out one round trip
    after it lands), and the full manifest (with every digest) lands
    LAST, which is also what flips the slot complete.  Returns the
    manifest so the source can keep its own digests for delta
    bookkeeping."""
    header, frag_iter = iter_heal_fragments(state_dict, fragments)
    header = dict(header, version=int(step))
    transport.begin_streamed_checkpoint(
        step, {f"frag:{HEADER_FRAG}": header}, timeout=timeout
    )
    digests: "Dict[str, str]" = {}
    try:
        for name, raw, digest in frag_iter:
            transport.stage_streamed_part(
                step, f"frag:{name}", raw, timeout=timeout
            )
            digests[name] = digest
    except BaseException:
        # a torn stage must never linger half-served: retire the slot so
        # healers fail over to another source instead of polling forever
        try:
            transport.retire_checkpoint(step)
        except Exception:  # noqa: BLE001 - teardown best-effort
            pass
        raise
    manifest = dict(header, digests=digests, created_ns=time.time_ns())
    transport.stage_streamed_part(
        step, f"frag:{MANIFEST_FRAG}", manifest, timeout=timeout
    )
    transport.finish_streamed_checkpoint(step, timeout=timeout)
    # provenance: the heal source is these fragments' publisher — its
    # manifest stamp is the reference clock fleet staleness compares on
    v_ms = int(manifest["created_ns"] // 1_000_000)
    for name, digest in digests.items():
        _prov.note_hold(
            _prov.frag_id("heal", name), step, digest,
            version_ms=v_ms, role="source", publisher=True,
        )
    return manifest


def local_fragment_digests(
    state_dict: Any, fragments: int
) -> "Tuple[int, Dict[str, str]]":
    """Encode ``state_dict`` locally (no staging, no wire) into the heal
    fragment layout and return ``(num_leaves, {name: sha256})`` — the
    delta-heal diff base: a rejoiner whose fragment hashes to the same
    digest as the source's already holds those bytes bitwise and skips
    their wire entirely."""
    _header, frag_iter = iter_heal_fragments(state_dict, fragments)
    digests = {name: digest for name, _raw, digest in frag_iter}
    return int(_header["num_leaves"]), digests


def maybe_decode_heal_doc(doc: Any) -> Any:
    """Decode a whole-document fetch that turned out to be a fragment
    doc (a legacy ``full`` fetch against a source that staged the
    streamed form); any other value passes through unchanged."""
    if isinstance(doc, dict) and f"frag:{MANIFEST_FRAG}" in doc:
        state, _manifest, _leaves = decode_payload(doc)
        return state
    return doc


# ---------------------------------------------------------------------------
# fetch plane (persistent connections, bufpool receive, 503-poll retry)
# ---------------------------------------------------------------------------

# Fragment fetch retry: 503 = the version/fragment exists fleet-wide but
# this node has not staged it yet (publisher encoding, parent relay
# still streaming it — the cut-through poll) — poll within the source's
# budget.  Connection errors (server killed mid-fetch, stale keep-alive
# connection) retry here too; budget expiry surfaces so the caller fails
# over to the next source.  The backoff ceiling is deliberately LOW:
# cut-through fragments land every few ms–tens of ms, so a 0.5 s ceiling
# would add more cascade latency per hop than the fragment wire itself
# (the polls ride a kept-alive connection, so each one is cheap).


def _frag_retry_if(e: BaseException) -> bool:
    return (
        e.code == 503
        if isinstance(e, urllib.error.HTTPError)
        else isinstance(e, (urllib.error.URLError, ConnectionError, OSError))
    )


_FRAG_POLICY = RetryPolicy(
    name="serving.frag",
    base_delay=0.01,
    multiplier=1.6,
    max_delay=0.1,
    retry_if=_frag_retry_if,
)

#: the heal stripe's identity on the shared policy shape — separate so
#: ``torchft_retries_total{op}`` tells serving churn from heal churn
_HEAL_FRAG_POLICY = RetryPolicy(
    name="transport.heal.frag",
    base_delay=0.01,
    multiplier=1.6,
    max_delay=0.1,
    retry_if=_frag_retry_if,
)

def _role_identity(
    fault_site: str, record: str, policy: RetryPolicy
) -> "Tuple[str, str, RetryPolicy]":
    """One fetch role's telemetry identity; the ``fault_site=`` keyword
    is the fault-coverage pass's deferred-wiring idiom — the literal
    site names here ARE the registered injection points fetch_raw/
    fetch_serialized consult per attempt."""
    return fault_site, record, policy


#: telemetry identities per fetch role: (fault site, flight/span name,
#: retry policy).  The serving tier keeps its own vocabulary; heal
#: fetches are their own site so chaos schedules can kill a stripe
#: source without touching serving traffic.
_ROLE_TELEMETRY: "Dict[str, Tuple[str, str, RetryPolicy]]" = {
    "client": _role_identity(
        fault_site="serving.frag", record="serving.frag",
        policy=_FRAG_POLICY,
    ),
    "relay": _role_identity(
        fault_site="serving.frag", record="serving.frag",
        policy=_FRAG_POLICY,
    ),
    "heal": _role_identity(
        fault_site="transport.heal.frag", record="heal.frag",
        policy=_HEAL_FRAG_POLICY,
    ),
}


def _role_telemetry(role: str) -> "Tuple[str, str, RetryPolicy]":
    return _ROLE_TELEMETRY.get(role, _ROLE_TELEMETRY["client"])


def _count_fetch_bytes(role: str, nbytes: int) -> None:
    if role == "heal":
        _metrics.CHECKPOINT_BYTES.labels(
            transport="http", direction="recv"
        ).inc(nbytes)
    else:
        _metrics.SERVING_FETCH_BYTES.labels(role=role).inc(nbytes)


_wire_mod: "Optional[Any]" = None


def _charge_wire(base: str, nbytes: int) -> float:
    # WAN wire model (serving/wire.py): one RTT + bytes/rate of source-
    # uplink bucket debt per fetch message crossing the topology
    # boundary.  Lazily bound: checkpointing must stay importable
    # without dragging the serving package in at module-import time
    # (serving's own modules alias THIS module).  Returns the seconds
    # charged so the link-state plane can fold the modeled WAN cost into
    # its passive goodput estimate.
    global _wire_mod
    if _wire_mod is None:
        from torchft_tpu_torch.serving import wire as _w

        _wire_mod = _w
    return _wire_mod.get_shaper().charge(base, nbytes)


#: per-thread first-byte latency of the most recent _request_once (the
#: fetch planes are thread-confined, like the keep-alive connections)
_fb_local = threading.local()


def _record_link(base: str, nbytes: int, seconds: float) -> None:
    """Feed the fragment plane's passive link estimator
    (utils/linkstats.py): bytes + whole-message wall (shaper charge
    included — the modeled WAN cost IS the link cost) + first-byte
    latency (connection RTT + the shaper's modeled first-byte leg)."""
    shaper = _wire_mod.get_shaper()
    host = _wire_mod.source_host(base) or "unknown"
    fb = getattr(_fb_local, "seconds", 0.0) + shaper.first_byte_s(base)
    _linkstats.record(
        host,
        "fragments",
        nbytes,
        seconds,
        first_byte_s=fb,
        local=not shaper.crosses_boundary(base),
    )


_conns = threading.local()


def _conn_cache() -> "Dict[str, http.client.HTTPConnection]":
    cache = getattr(_conns, "cache", None)
    if cache is None:
        cache = _conns.cache = {}
    return cache


def _conn_for(base: str, timeout: float) -> http.client.HTTPConnection:
    cache = _conn_cache()
    conn = cache.get(base)
    if conn is None:
        p = urlparse(base)
        conn = http.client.HTTPConnection(
            p.hostname or "127.0.0.1", p.port, timeout=timeout
        )
        cache[base] = conn
    conn.timeout = timeout
    if conn.sock is not None:
        conn.sock.settimeout(timeout)
    return conn


def _drop_conn(base: str) -> None:
    conn = _conn_cache().pop(base, None)
    if conn is not None:
        try:
            conn.close()
        except Exception:  # noqa: BLE001 - teardown best-effort
            pass


def close_connections() -> None:
    """Close THIS thread's cached keep-alive connections (tests; worker
    threads drop theirs when their executor shuts down)."""
    for base in list(_conn_cache()):
        _drop_conn(base)


def _request_once(
    base: str, path: str, timeout: float,
    extra_headers: "Optional[Dict[str, str]]" = None,
) -> http.client.HTTPResponse:
    """One GET over the cached keep-alive connection; returns the live
    200 response (the caller consumes the body).  Raises
    ``urllib.error.HTTPError`` on non-200 (503 = retryable
    not-yet-staged, drained so the connection stays reusable) and
    ``ConnectionError`` / ``OSError`` on transport failure."""
    conn = _conn_for(base, timeout)
    headers = dict(extra_headers) if extra_headers else {}
    traceparent = _tracing.current_traceparent()
    if traceparent:
        headers["traceparent"] = traceparent
    try:
        t0 = time.perf_counter()
        conn.request("GET", path, headers=headers)
        resp = conn.getresponse()
        # observed first-byte latency of this request (headers arrived);
        # the link-state plane adds the shaper's modeled RTT on top
        _fb_local.seconds = time.perf_counter() - t0
        if resp.status != 200:
            body = resp.read()  # drain so the connection could be reused
            if resp.will_close:
                _drop_conn(base)
            raise urllib.error.HTTPError(
                f"{base}{path}",
                resp.status,
                body[:200].decode("utf-8", "replace") or resp.reason,
                resp.headers,
                None,
            )
        return resp
    except (OSError, http.client.HTTPException) as e:
        if isinstance(e, urllib.error.HTTPError):
            raise
        _drop_conn(base)
        if isinstance(e, OSError):
            raise
        raise ConnectionError(f"http fetch {base}{path}: {e}") from e


def _get_raw_once(
    base: str, path: str, timeout: float,
    extra_headers: "Optional[Dict[str, str]]" = None,
) -> np.ndarray:
    """One GET returning a POOLED uint8 buffer the caller owns."""
    resp = _request_once(base, path, timeout, extra_headers)
    try:
        n = int(resp.headers.get("Content-Length") or 0)
        buf = POOL.take(n, np.uint8)
        try:
            view = memoryview(buf)
            off = 0
            while off < n:
                got = resp.readinto(view[off:])
                if not got:
                    raise ConnectionError(
                        f"http fetch {base}{path}: body ended {n - off} "
                        f"bytes short"
                    )
                off += got
        except BaseException:
            POOL.give(buf)
            raise
        if resp.will_close:
            _drop_conn(base)
        return buf
    except (OSError, http.client.HTTPException) as e:
        _drop_conn(base)
        if isinstance(e, OSError):
            raise
        raise ConnectionError(f"http fetch {base}{path}: {e}") from e


_digest_local = threading.local()


def _note_native_digest(buf: np.ndarray, sha_hex: str) -> None:
    """Remember the digest the native receive path already computed
    GIL-free over this exact buffer (one-shot, consumed by
    :func:`wire_digest` on the same thread)."""
    _digest_local.entry = (id(buf), sha_hex)


def _consume_native_digest(buf) -> "Optional[str]":
    """Pop this thread's native-computed digest for ``buf`` (or None) —
    used to HAND the digest across a thread boundary: the pipelined
    fetcher's worker consumes it here and re-notes it on the consumer
    thread so verify still skips the re-hash."""
    entry = getattr(_digest_local, "entry", None)
    if entry is not None and entry[0] == id(buf):
        _digest_local.entry = None
        return entry[1]
    return None


def wire_digest(buf) -> str:
    """sha256 hex of one wire buffer.  Reuses the digest the native
    data plane computed over this buffer as it landed (same thread, same
    object — consumed one-shot so a pool-recycled buffer can never
    inherit a stale digest); otherwise hashes here."""
    entry = getattr(_digest_local, "entry", None)
    if entry is not None and entry[0] == id(buf):
        _digest_local.entry = None
        return entry[1]
    return hashlib.sha256(memoryview(buf)).hexdigest()


def _raw_data_plane(
    base: str, path: str, version: int, resource: str, timeout: float,
    native: bool = True,
) -> np.ndarray:
    """Route one raw fragment GET: native data plane when armed
    (``TORCHFT_FRAG_NATIVE``) and ``native``, Python HTTP otherwise and on
    any native miss.  The miss fallback is what keeps Mock transports,
    gated-off peers, and non-mirrored resources (manifests, legacy docs)
    working unchanged — and it is recorded so a fleet silently running the
    slow path shows up in the flight recorder.  ``native=False`` is for
    versions only the Python plane serves (a durable store's): the native
    server would park each such request for the whole poll window (a
    version newer than anything it staged) before its miss."""
    headers: "Optional[Dict[str, str]]" = None
    if resource.startswith("frag_"):
        # Client-driven cut-through park (X-TFT-Poll-Ms): ask the server
        # to hold a not-yet-staged fragment as long as our own budget
        # allows (bounded) — parking on the server's staging wake beats
        # a 503 + retry-ladder cycle that duplicates request load.  The
        # margin keeps the park ending before our socket deadline.
        poll_ms = int(min(max(timeout * 1000 - 150, 0), 5000))
        if poll_ms > 0:
            headers = {"X-TFT-Poll-Ms": str(poll_ms)}
        if native and _fragdata.enabled():
            got = _fragdata.fetch_native(base, version, resource, timeout)
            if got is not None:
                buf, sha_hex, first_byte_s = got
                _fb_local.seconds = first_byte_s
                _note_native_digest(buf, sha_hex)
                return buf
            _flightrec.record(
                "fragment.native_fallback",
                step=version,
                resource=resource,
                source=base,
            )
    return _get_raw_once(base, path, timeout, headers)


def fetch_raw(
    base: str,
    version: int,
    resource: str,
    timeout: float,
    role: str = "client",
    frag_index: "Optional[int]" = None,
    native: bool = True,
) -> np.ndarray:
    """Fetch one staged resource as raw wire bytes (POOLED uint8 buffer —
    the caller owns giving it back or staging it), with the 503-poll
    retry, the WAN wire-model charge, and per-fragment telemetry.

    ``role`` selects the telemetry identity: serving roles consult the
    ``serving.frag`` chaos site and record ``serving.frag``; ``"heal"``
    consults ``transport.heal.frag`` and records/spans ``heal.frag``
    (the striped-heal vocabulary, docs/robustness.md)."""
    site, record, policy = _role_telemetry(role)
    path = f"/checkpoint/{version}/{resource}"
    t0_ns = time.time_ns()

    def attempt(budget: "Optional[float]") -> np.ndarray:
        # Chaos INSIDE the attempt: an injected drop takes exactly the
        # broken-connection path a real one would — absorbed by this
        # policy's in-budget retries (docs/robustness.md serving.frag),
        # while raise surfaces to the caller's source-failover walk.
        _faults.check(
            site,
            step=frag_index if frag_index is not None else version,
        )
        t = max(budget if budget is not None else 0.001, 0.001)
        return _raw_data_plane(base, path, version, resource, t, native)

    t0p = time.perf_counter()
    buf = policy.run(attempt, timeout=max(timeout, 0.001), op=site)
    wall_s = time.perf_counter() - t0p
    wall_s += _charge_wire(base, buf.nbytes)
    _record_link(base, buf.nbytes, wall_s)
    _count_fetch_bytes(role, buf.nbytes)
    _flightrec.record(
        record, start_ns=t0_ns, step=version, resource=resource,
        bytes=buf.nbytes, source=base, role=role,
    )
    tracer = _tracing.get_tracer()
    ctx = _tracing.get_current()
    if tracer is not None and ctx is not None and ctx.sampled:
        # the per-role span identity resolves via _ROLE_TELEMETRY; both
        # values ("serving.frag" / "heal.frag") live in allowed families
        tracer.export_span(  # tft-lint: allow(span-vocab)
            name=record,
            trace_id=ctx.trace_id,
            parent_span_id=ctx.span_id,
            start_ns=t0_ns,
            end_ns=time.time_ns(),
            attributes={
                "version": version, "resource": resource,
                "bytes": buf.nbytes, "role": role,
            },
        )
    return buf


def fetch_serialized(
    base: str,
    version: int,
    resource: str,
    timeout: float,
    role: str = "client",
) -> "Tuple[Any, Dict[int, Any], int]":
    """Fetch one resource and deserialize it STRAIGHT OFF the socket —
    the whole-payload (``full``) path: a multi-GB document lands
    directly in its final leaf buffers (serialization.py's streaming
    contract) instead of being buffered raw and copied again.  Returns
    ``(skeleton, leaves, num_leaves)``; same retry/wire/telemetry
    envelope as :func:`fetch_raw`."""
    site, record, policy = _role_telemetry(role)
    path = f"/checkpoint/{version}/{resource}"
    t0_ns = time.time_ns()

    def attempt(budget: "Optional[float]") -> "Tuple[Any, Dict[int, Any], int, int]":
        _faults.check(site, step=version)
        t = max(budget if budget is not None else 0.001, 0.001)
        resp = _request_once(base, path, t)
        nbytes = int(resp.headers.get("Content-Length") or 0)
        try:
            out = ser.deserialize_from(resp)
            resp.read()  # drain any trailer so the connection is reusable
        except BaseException as e:
            # mid-body failure: unknown remainder, the conn can't be kept
            _drop_conn(base)
            if isinstance(e, EOFError):
                # truncated stream = broken connection: retryable
                raise ConnectionError(
                    f"http fetch {base}{path}: truncated stream: {e}"
                ) from e
            raise
        if resp.will_close:
            _drop_conn(base)
        return out + (nbytes,)

    t0p = time.perf_counter()
    skeleton, leaves, n, nbytes = policy.run(
        attempt, timeout=max(timeout, 0.001), op=site
    )
    wall_s = time.perf_counter() - t0p
    wall_s += _charge_wire(base, nbytes)
    _record_link(base, nbytes, wall_s)
    _count_fetch_bytes(role, nbytes)
    _flightrec.record(
        record, start_ns=t0_ns, step=version, resource=resource,
        bytes=nbytes, source=base, role=role,
    )
    return skeleton, leaves, n


class FragmentFetcher:
    """Bounded-parallel pipelined fragment fetcher.

    ``parallel`` (default ``TORCHFT_SERVING_PARALLEL``) raw fetches ride
    persistent per-thread connections concurrently; results come back in
    SUBMISSION order so the consumer's verify/decode/stage of fragment
    *i* overlaps the wire of fragments *i+1..i+K*.
    """

    def __init__(
        self, parallel: "Optional[int]" = None, role: str = "client"
    ) -> None:
        self._parallel = (
            parallel
            if parallel is not None
            else env_int("TORCHFT_SERVING_PARALLEL", 4, minimum=1)
        )
        self._role = role
        self._pool: "Optional[ThreadPoolExecutor]" = None
        self._lock = threading.Lock()

    def _executor(self) -> ThreadPoolExecutor:
        with self._lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=self._parallel,
                    thread_name_prefix="tft_serving_fetch",
                )
            return self._pool

    def fetch_raw(
        self, base: str, version: int, resource: str, timeout: float
    ) -> np.ndarray:
        return fetch_raw(base, version, resource, timeout, role=self._role)

    def fetch_stream(
        self,
        base: str,
        version: int,
        resources: "List[str]",
        deadline: float,
    ) -> "Iterator[Tuple[str, np.ndarray, Tuple[float, float]]]":
        """Pipelined raw fetches of ``resources`` from one source; yields
        ``(resource, pooled_buffer, (wire_start, wire_end))`` in
        submission order — the perf-counter interval each fetch occupied
        the wire, so the consumer can compute true (union) wire busy
        time across the concurrent in-flight window.  On failure,
        buffers still in flight are drained back to the pool and the
        error re-raised (the caller fails over to another source;
        already-yielded items stay valid and staged)."""
        if not resources:
            return
        ex = self._executor()
        pending: "deque[Tuple[str, Future]]" = deque()
        it = iter(enumerate(resources))

        def _timed(
            res: str, idx: int
        ) -> "Tuple[np.ndarray, Tuple[float, float], Optional[str]]":
            t0 = time.perf_counter()
            buf = fetch_raw(
                base, version, res,
                timeout=max(deadline - time.monotonic(), 0.001),
                role=self._role, frag_index=idx,
            )
            # the native digest is noted thread-locally on THIS worker;
            # carry it to the consumer thread so verify can reuse it
            sha = _consume_native_digest(buf)
            return buf, (t0, time.perf_counter()), sha

        def _submit_next() -> bool:
            try:
                idx, res = next(it)
            except StopIteration:
                return False
            pending.append((res, ex.submit(_timed, res, idx)))
            return True

        def _drain_pending() -> None:
            while pending:
                _res, fut = pending.popleft()
                try:
                    buf, _, _ = fut.result()
                except BaseException:  # noqa: BLE001 - already failing
                    continue
                POOL.give(buf)

        for _ in range(self._parallel):
            if not _submit_next():
                break
        try:
            while pending:
                res, fut = pending.popleft()
                try:
                    buf, span, sha = fut.result()
                except BaseException:
                    _drain_pending()
                    raise
                _submit_next()
                if sha is not None:
                    _note_native_digest(buf, sha)
                yield res, buf, span
        except GeneratorExit:
            # consumer abandoned the stream mid-flight (failover after a
            # verify failure): nothing may leak out of the pool
            _drain_pending()
            raise

    def close(self) -> None:
        with self._lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=False)


# ---------------------------------------------------------------------------
# striped multi-source fetch (the heal wire plane)
# ---------------------------------------------------------------------------


class StripeError(ConnectionError):
    """Every stripe source died/failed before the fragment set
    completed (the heal falls back to report_error like any other
    recovery failure)."""


class _Stripe:
    """One source's live state inside a striped fetch."""

    __slots__ = ("base", "alive", "is_primary", "first")

    def __init__(self, base: str, is_primary: bool) -> None:
        self.base = base
        self.alive = True
        self.is_primary = is_primary
        # the fragment this source fetches before it takes from the
        # shared queue (its round-robin slot of the stripe plan)
        self.first: "Optional[str]" = None


def striped_fetch(
    sources: "List[str]",
    step: int,
    names: "List[str]",
    deadline: float,
    digests: "Optional[Dict[str, str]]" = None,
    parallel: "Optional[int]" = None,
    source_budget: "Optional[float]" = None,
    role: str = "heal",
    on_buf: "Optional[Callable[[str, np.ndarray, str], None]]" = None,
    plane: str = "heal",
) -> "Dict[str, Any]":
    """Fetch ``names`` striped across ``sources`` in parallel with
    per-fragment failover.

    ``plane`` is the provenance-plane identity of these transfers
    (``heal`` for live heals, ``restore`` when the stripe sources are
    durable-store disks) — every fragment that lands (or is rejected on
    digest mismatch) appends a ``fragment.hop`` audit record.

    ``sources[0]`` is the PRIMARY (the quorum-assigned heal source —
    the one whose manifest defines truth); the rest are max-step quorum
    peers whose state is bitwise-replicated, so any fragment they serve
    must hash to the primary's digest.  Source i opens with fragment i;
    after that, work assignment is dynamic (a shared work queue,
    ``parallel`` concurrent fetches per source):
    faster uplinks finish more fragments, a dead/slow/poisoned source's
    fragments fail over to the survivors, and the fetch only fails when
    EVERY source has been exhausted for some fragment.

    With ``digests``, each fragment is verified the moment it lands
    (mismatch = dead source, fragment requeued — delta-heal mode);
    without, the caller verifies later against the sha256 handed to
    ``on_buf`` (full-heal mode: the manifest lands after the stream).

    ``on_buf(name, pooled_buffer, sha256)`` is invoked on the CALLER
    thread for each completed fragment, in arrival order — decode of
    fragment *i* overlaps the wire of every in-flight stripe.  Buffer
    ownership transfers to the callback.

    Returns stats: ``{"wire_bytes", "failovers", "spans", "hashes",
    "sources_used"}`` — ``sources_used`` is the set of source addresses
    that actually delivered at least one fragment (a degraded stripe is
    visible as fewer used sources than configured).
    """
    if not sources:
        raise StripeError("striped fetch: no sources")
    if parallel is None:
        parallel = env_int("TORCHFT_HEAL_PARALLEL", 2, minimum=1)
    stripes = [_Stripe(s, i == 0) for i, s in enumerate(sources)]
    frag_index = {name: i for i, name in enumerate(names)}
    # Each source opens with its own round-robin fragment, the rest go to
    # the shared queue.  Left to the queue alone, the first stripe threads
    # to run on a loaded host can drain every fragment before a later
    # source's thread is scheduled: the heal then never stripes, and a
    # dead source is never tried (so never failed over).
    for stripe, name in zip(stripes, names):
        stripe.first = name

    # Shared state, all guarded by ``cv``: the dynamic work queue (a
    # requeued fragment lands at the FRONT — it is the oldest debt), the
    # completed set, completed results awaiting the consumer, and the
    # last per-source error (the failure chain when everything dies).
    cv = threading.Condition()
    work: "deque[str]" = deque(names[len(stripes):])
    done: "Set[str]" = set()
    out_q: "deque[Tuple[str, np.ndarray, str, Tuple[float, float]]]" = deque()
    last_err: "List[BaseException]" = []
    stopped = False
    failovers = 0
    wire_bytes = 0
    inflight = 0
    spans: "List[Tuple[float, float]]" = []
    hashes: "Dict[str, str]" = {}
    sources_used: "Set[str]" = set()

    def _alive_locked() -> int:
        return sum(1 for s in stripes if s.alive)

    def _fail_locked(stripe: "_Stripe", name: str, e: BaseException) -> None:
        nonlocal failovers, inflight
        stripe.alive = False
        inflight -= 1
        work.appendleft(name)
        if stripe.first is not None:
            work.appendleft(stripe.first)
            stripe.first = None
        last_err.append(e)
        if _alive_locked() > 0:
            failovers += 1
            _metrics.HEAL_FRAG_FAILOVERS.inc()
        cv.notify_all()

    # the caller's per-step trace context rides into the worker threads
    # so every heal.frag span (and the traceparent header the source's
    # heal.send span joins on) lands in the healer's round trace
    caller_ctx = _tracing.get_current()

    def _worker(stripe: "_Stripe") -> None:
        nonlocal wire_bytes, inflight
        _tracing.set_current(caller_ctx)
        while True:
            with cv:
                while True:
                    if stopped or not stripe.alive or len(done) >= len(names):
                        return
                    if stripe.first is not None:
                        name, stripe.first = stripe.first, None
                        inflight += 1
                        break
                    if work:
                        name = work.popleft()
                        inflight += 1
                        break
                    # idle but not finished: a failing peer may requeue
                    cv.wait(0.02)
                remaining = deadline - time.monotonic()
                # Non-primary sources are capped so a dead one costs the
                # failover bound, not the whole heal; the primary (and
                # the last stripe standing) gets the full remaining
                # deadline — striping must never make the heal LESS
                # available than the single-source path it replaced.
                budget = remaining
                if (
                    source_budget is not None
                    and not stripe.is_primary
                    and _alive_locked() > 1
                ):
                    budget = min(source_budget, remaining)
            if budget <= 0:
                with cv:
                    _fail_locked(
                        stripe, name,
                        TimeoutError("striped fetch: deadline expired"),
                    )
                return
            t0 = time.perf_counter()
            try:
                buf = fetch_raw(
                    stripe.base, step, f"frag_{name}",
                    timeout=budget, role=role,
                    frag_index=frag_index[name],
                    native=plane != "restore",
                )
            except Exception as e:  # noqa: BLE001 - per-fragment failover
                with cv:
                    _fail_locked(stripe, name, e)
                return
            sha = wire_digest(buf)
            fb_ms = getattr(_fb_local, "seconds", 0.0) * 1e3
            if digests is not None and digests.get(name, sha) != sha:
                # poisoned/diverged source: its bytes must never land in
                # the healed state — treat exactly like a dead source
                _prov.note_hop(
                    _prov.frag_id("heal", name), step, stripe.base, plane,
                    verdict="mismatch", nbytes=buf.nbytes,
                    first_byte_ms=fb_ms,
                )
                POOL.give(buf)
                with cv:
                    _fail_locked(
                        stripe, name,
                        ValueError(
                            f"heal fragment {name!r} from {stripe.base}: "
                            f"digest mismatch ({sha[:12]} != "
                            f"{digests.get(name, '')[:12]})"
                        ),
                    )
                return
            _prov.note_hop(
                _prov.frag_id("heal", name), step, stripe.base, plane,
                verdict="ok", nbytes=buf.nbytes, first_byte_ms=fb_ms,
            )
            with cv:
                inflight -= 1
                if stopped or name in done:
                    POOL.give(buf)
                    cv.notify_all()
                    if stopped:
                        return
                    continue
                done.add(name)
                wire_bytes += buf.nbytes
                sources_used.add(stripe.base)
                spans.append((t0, time.perf_counter()))
                hashes[name] = sha
                out_q.append((name, buf, sha, spans[-1]))
                cv.notify_all()

    threads: "List[threading.Thread]" = []
    for si, stripe in enumerate(stripes):
        for w in range(max(min(parallel, len(names)), 1)):
            t = threading.Thread(
                target=_worker, args=(stripe,),
                name=f"tft_heal_stripe{si}_{w}", daemon=True,
            )
            threads.append(t)
            t.start()

    delivered = 0
    try:
        while delivered < len(names):
            with cv:
                while not out_q:
                    # "every source failed" only once nothing is still in
                    # flight: a final fetch racing its stripe's death may
                    # yet deliver the missing fragment
                    if _alive_locked() == 0 and inflight == 0:
                        raise StripeError(
                            f"striped fetch: every source failed with "
                            f"{len(names) - delivered} fragment(s) missing"
                        ) from (last_err[-1] if last_err else None)
                    if time.monotonic() > deadline:
                        raise StripeError(
                            f"striped fetch: deadline expired with "
                            f"{len(names) - delivered} fragment(s) missing"
                        )
                    cv.wait(0.05)
                name, buf, sha, _span = out_q.popleft()
            delivered += 1
            if on_buf is not None:
                on_buf(name, buf, sha)
            else:
                POOL.give(buf)
    finally:
        with cv:
            stopped = True
            cv.notify_all()
        for t in threads:
            t.join(timeout=5.0)
        # drain anything that landed after the consumer stopped
        with cv:
            while out_q:
                _name, buf, _sha, _span = out_q.popleft()
                POOL.give(buf)
    return {
        "wire_bytes": wire_bytes,
        "failovers": failovers,
        "spans": spans,
        "hashes": hashes,
        "sources_used": sources_used,
    }
