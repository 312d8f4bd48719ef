"""ServingClient: the inference-side weight fetch path.

PyTorch port of ``torchft_tpu/serving/client.py``.  A payload of tensor
leaves decodes to CPU tensors, the caller moves them to its device; an
int8-quantized leaf decodes to a numpy f32 array, since its bytes are
those of a numpy leaf of the same values.

Discovers the distribution tree through the lighthouse (cached plan,
refreshed on epoch change or failure), fetches versioned payloads from
serving replicas — leaves first, so client load lands on the tree's
widest tier — and fails over to siblings/the root source when a server
dies mid-fetch.  Holding the previous version enables delta fetches:
manifest + changed fragments only (publisher-computed digests decide).

The fetch rides the shared fragment-fetch plane (``serving/fetcher.py``): persistent HTTP connections against the checkpoint
transport's ``/checkpoint/<version>/<resource>`` surface, the unified
retry layer polling retryable 503s (version staged but not yet on this
node) inside each source's budget slice, and — on the delta path — a
bounded-parallel pipeline that overlaps digest verify + decode of
fragment *i* with the wire of fragment *i+1*.
"""

from __future__ import annotations

import hashlib
import logging
import time
from typing import Any, Dict, List, Optional, Tuple

from torchft_tpu_torch.checkpointing import provenance as _prov
from torchft_tpu_torch.checkpointing import serialization as ser
from torchft_tpu_torch.serving import fetcher as _fetcher
from torchft_tpu_torch.serving import payload as _payload
from torchft_tpu_torch.utils import faults as _faults
from torchft_tpu_torch.utils import flightrecorder as _flightrec
from torchft_tpu_torch.utils import metrics as _metrics
from torchft_tpu_torch.utils import tracing as _tracing
from torchft_tpu_torch.utils.bufpool import POOL
from torchft_tpu_torch.utils.env import env_float
from torchft_tpu_torch.utils.retry import RetryPolicy

logger = logging.getLogger(__name__)

__all__ = ["ServingClient", "fetch_resource"]


class _NoServableNodes(RuntimeError):
    """The current plan names zero servable nodes — transient right
    after a coordination-plane failover (lighthouse serving state is
    soft; a fresh leader serves an EMPTY plan until the serving fleet's
    next heartbeats re-register it)."""


# Empty-plan poll: re-ask the lighthouse until nodes re-register or the
# caller's deadline expires.  Connection errors ride too (the plan RPC
# itself may be walking a mid-election endpoint list).
_PLAN_POLICY = RetryPolicy(
    name="serving.plan",
    base_delay=0.05,
    multiplier=1.5,
    max_delay=0.5,
    retry_if=lambda e: isinstance(
        e, (_NoServableNodes, ConnectionError, OSError, TimeoutError)
    ),
)


def fetch_resource(
    base: str, version: int, resource: str, timeout: float
) -> Any:
    """Fetch + deserialize one resource of a staged version from a
    serving node's transport (``full``, ``frag_<name>``, ...) — decoded
    straight off the socket (a multi-GB ``full`` document lands in its
    final buffers, never a raw intermediate copy)."""
    skeleton, leaves, n = _fetcher.fetch_serialized(
        base, version, resource, timeout, role="client"
    )
    return ser.reassemble(skeleton, leaves, n)


class ServingClient:
    """Pull live weight versions from the serving tier.

    Args:
        lighthouse_addr: serving-tier discovery endpoint.
        plan_ttl: seconds a fetched plan is trusted before re-asking the
            lighthouse (default ``TORCHFT_SERVING_PLAN_TTL_S``); any
            fetch failure refreshes immediately.
        client_id: spreads initial source choice across clients (leaves
            are rotated by its hash) so a client fleet does not dogpile
            one leaf.
        pin_version: serve EXACTLY this weight version: every
            ``fetch()`` without an explicit ``version`` targets it, and
            its eviction from the staging window is an error (the 503
            poll exhausts the deadline), never a silent substitution.
        min_version: rollback floor — a fetch that would RESOLVE OR
            RETURN a version below this raises instead (e.g. a restarted
            publisher re-advertising an older checkpoint must not roll
            an inference fleet back).  The floor also ratchets up to
            every version successfully fetched, so "never serve older
            than what I already serve" needs no bookkeeping by the
            caller.
    """

    def __init__(
        self,
        lighthouse_addr: str,
        plan_ttl: "Optional[float]" = None,
        client_id: "Optional[str]" = None,
        pin_version: "Optional[int]" = None,
        min_version: int = 0,
    ) -> None:
        from torchft_tpu_torch.coordination import LighthouseClient

        self._client = LighthouseClient(lighthouse_addr)
        self._plan_ttl = (
            plan_ttl
            if plan_ttl is not None
            else env_float("TORCHFT_SERVING_PLAN_TTL_S", 2.0, minimum=0.0)
        )
        # Stable rotation seed: hash() varies per process under
        # PYTHONHASHSEED, which would land a RESTARTED client on a
        # different leaf — a sha256 digest keeps the spread deterministic
        # (tests pin it; anonymous clients still spread by identity).
        self._rot = (
            int.from_bytes(
                hashlib.sha256(str(client_id).encode()).digest()[:8], "big"
            )
            if client_id is not None
            else id(self)
        )
        self._frag_fetcher = _fetcher.FragmentFetcher(role="client")
        # non-final sources are capped at the failover bound (a killed
        # server costs seconds, not the fetch deadline)
        self._failover_s = env_float(
            "TORCHFT_SERVING_FAILOVER_S", 2.0, minimum=0.05
        )
        self._plan: "Optional[Dict[str, Any]]" = None
        self._plan_at = 0.0
        # previous decoded version for delta fetches
        self._held: "Optional[Tuple[Dict[str, Any], Dict[int, Any]]]" = None
        self._held_version = 0
        # version pinning / rollback floor (coordination with rolling
        # deploys: a pinned canary, a fleet that must never regress)
        self._pin_version = (
            int(pin_version) if pin_version is not None else None
        )
        if self._pin_version is not None and self._pin_version <= 0:
            raise ValueError("pin_version must be a positive version")
        self._min_version = int(min_version)
        if (
            self._pin_version is not None
            and self._pin_version < self._min_version
        ):
            raise ValueError(
                f"pin_version={self._pin_version} is below "
                f"min_version={self._min_version}"
            )

    # -- discovery ---------------------------------------------------------

    def plan(self, refresh: bool = False) -> "Dict[str, Any]":
        now = time.monotonic()
        if (
            refresh
            or self._plan is None
            or now - self._plan_at > self._plan_ttl
        ):
            self._plan = self._client.serving_plan()
            self._plan_at = now
            _metrics.SERVING_PLAN_EPOCH.labels(role="client").set(
                self._plan["epoch"]
            )
        return self._plan

    def latest_version(self, refresh: bool = True) -> int:
        return int(self.plan(refresh=refresh)["latest_version"])

    def _sources(self, plan: "Dict[str, Any]") -> "List[str]":
        """Fetch order: leaves (deepest first, rotated per client for
        load spread), then interior nodes, then the root source — a
        client can always complete as long as ANY copy is alive."""
        nodes = list(plan["nodes"])
        leaves = [n for n in nodes if n["children"] == 0]
        inner = [n for n in nodes if n["children"] > 0]
        leaves.sort(key=lambda n: (-n["depth"], n["replica_id"]))
        inner.sort(key=lambda n: (-n["depth"], n["replica_id"]))
        if leaves:
            r = self._rot % len(leaves)
            leaves = leaves[r:] + leaves[:r]
        ordered = [n["address"] for n in leaves + inner if n["address"]]
        if plan["root_source"]:
            ordered.append(plan["root_source"])
        return ordered

    # -- fetch -------------------------------------------------------------

    def fetch(
        self,
        version: "Optional[int]" = None,
        timeout: float = 30.0,
        delta: bool = True,
    ) -> "Tuple[Any, int]":
        """Fetch weight ``version`` (default: the fleet's latest);
        returns ``(state_dict, version)``.

        With ``delta`` and a previously fetched version held, only the
        manifest plus changed fragments cross the wire.  Sources are
        tried leaves-first within the deadline; a source failure (killed
        server, staging lag past its budget slice) fails over to the
        next and counts in ``torchft_serving_failovers_total``.

        A client constructed with ``pin_version=`` targets that version
        whenever ``version`` is omitted; one constructed with
        ``min_version=`` (or that has fetched before — the floor
        ratchets) refuses any resolution below the floor with a
        ``RuntimeError`` instead of rolling back."""
        deadline = time.monotonic() + timeout
        plan = self.plan()
        if version is None and self._pin_version is not None:
            version = self._pin_version
        pinned = version is not None
        v = int(version) if pinned else int(plan["latest_version"])
        if v <= 0:
            raise RuntimeError("serving tier has no published version yet")
        if v < self._min_version:
            raise RuntimeError(
                f"serving fetch refused: version {v} is below the "
                f"client's rollback floor (min_version="
                f"{self._min_version}) — the tier would roll this "
                f"client back to an older checkpoint"
            )
        _faults.check("serving.fetch", step=v)
        t0 = time.perf_counter()
        t0_ns = time.time_ns()
        with _flightrec.track("serving.fetch", step=v, role="client") as op:
            state, v, failovers = self._fetch_any(
                v, plan, deadline, delta, pinned
            )
            op.update(failovers=failovers, version=v)
        # ratchet: this client never serves older than what it has served
        self._min_version = max(self._min_version, v)
        dt = time.perf_counter() - t0
        _metrics.SERVING_FETCH_SECONDS.labels(role="client").observe(dt)
        # client-role staleness: publish->in-hand lag, from the fetched
        # manifest's publish stamp (publisher clock vs this host's —
        # subject to cross-host skew; the skew-free ledger is the
        # lighthouse's /serving.json staleness_ms rows).
        held = self._held
        if held is not None:
            v_ms = int(held[0].get("created_ns", 0) // 1_000_000)
            if v_ms > 0:
                _metrics.SERVING_STALENESS.labels(role="client").observe(
                    max(time.time() - v_ms / 1e3, 0.0)
                )
        tracer = _tracing.get_tracer()
        ctx = _tracing.get_current()
        if tracer is not None and ctx is not None and ctx.sampled:
            tracer.export_span(
                name="serving.fetch",
                trace_id=ctx.trace_id,
                parent_span_id=ctx.span_id,
                start_ns=t0_ns,
                end_ns=time.time_ns(),
                attributes={"version": v, "failovers": failovers},
            )
        return state, v

    def _fetch_any(
        self,
        v: int,
        plan: "Dict[str, Any]",
        deadline: float,
        delta: bool,
        pinned: bool,
    ) -> "Tuple[Any, int, int]":
        """Try sources in failover order; returns ``(state, version,
        failovers)``.  An UNPINNED fetch (caller asked for "latest")
        re-resolves the target version on every failover: under a fast
        publish cadence the originally-latest version can be evicted
        from every staging window before a slow start completes, and a
        newer version satisfies the caller strictly better."""
        sources = self._sources(plan)
        if not sources:
            # transient after a lighthouse failover (soft serving state):
            # poll the plan inside the caller's deadline rather than
            # failing the fetch while the fleet re-registers
            def attempt(_budget: "Optional[float]") -> "Tuple[Any, Any]":
                p = self.plan(refresh=True)
                s = self._sources(p)
                if not s:
                    raise _NoServableNodes(
                        "serving plan has no servable nodes"
                    )
                return p, s

            plan, sources = _PLAN_POLICY.run(
                attempt,
                timeout=max(deadline - time.monotonic(), 0.001),
                op="serving.plan",
            )
        failovers = 0
        last: "Optional[Exception]" = None
        i = 0
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            budget = max(remaining / max(len(sources) - i, 1), 0.2)
            # Every non-final slice is capped so a dead source costs
            # seconds.  An UNPINNED fetch caps the final slice too: if
            # the target was evicted fleet-wide (publish cadence outran
            # this fetch), burning the whole deadline polling 503s on
            # one source would be pure loss — re-resolve and go again.
            if i < len(sources) - 1 or not pinned:
                budget = min(budget, self._failover_s, remaining)
            try:
                state = self._fetch_from(sources[i], v, budget, delta)
                if failovers:
                    _metrics.SERVING_FAILOVERS.labels(role="client").inc(
                        failovers
                    )
                return state, v, failovers
            except Exception as e:  # noqa: BLE001 - failover path
                last = e
                failovers += 1
                logger.warning(
                    "serving fetch v%d from %s failed (%s); failing over",
                    v, sources[i], e,
                )
                # mid-fetch plan refresh: the tree may have re-formed
                # around a dead node, and an unpinned target re-resolves
                # to the CURRENT latest version
                restart = False
                try:
                    plan = self.plan(refresh=True)
                    if not pinned and int(plan["latest_version"]) > v:
                        v = int(plan["latest_version"])
                        restart = True  # newer version: walk from the top
                    sources = self._sources(plan) or sources
                except Exception:  # noqa: BLE001 - keep old list
                    pass
                i = 0 if restart else i + 1
                if i >= len(sources):
                    if pinned:
                        break
                    i = 0  # unpinned: keep cycling until the deadline
        # The LAST failed attempt never moved to another source — it is
        # the terminal failure, not a failover (on the success path every
        # earlier failure did move, so the count there is already right).
        failovers = max(failovers - 1, 0)
        if failovers:
            _metrics.SERVING_FAILOVERS.labels(role="client").inc(failovers)
        raise TimeoutError(
            f"serving fetch v{v}: no source completed within deadline "
            f"({failovers} failover(s))"
        ) from last

    def _fetch_from(
        self, base: str, v: int, budget: float, delta: bool
    ) -> Any:
        t_end = time.monotonic() + budget
        if delta and self._held is not None and self._held_version > 0:
            # Delta path, pipelined: manifest first, then the
            # digest-changed fragments through the bounded-parallel
            # fetcher — raw bytes verified against the publisher's
            # sha256, decode of fragment i overlapping the wire of
            # fragment i+1, all on persistent connections.  The timeout
            # clamp matters: an exhausted budget must hand the retry
            # layer a zero-ish deadline, never a negative one.
            mbuf = self._frag_fetcher.fetch_raw(
                base, v, f"frag_{_payload.MANIFEST_FRAG}",
                timeout=max(t_end - time.monotonic(), 0.001),
            )
            try:
                manifest = _payload.decode_manifest(mbuf)
            finally:
                POOL.give(mbuf)
            names = _payload.changed_fragments(manifest, self._held[0])
            leaves: "Dict[int, Any]" = dict(self._held[1])
            for res, buf, _span in self._frag_fetcher.fetch_stream(
                base, v, [f"frag_{n}" for n in names], deadline=t_end
            ):
                name = res[len("frag_"):]
                fid = _prov.frag_id("weights", name)
                try:
                    try:
                        _payload.verify_fragment(name, buf, manifest)
                    except ValueError:
                        _prov.note_hop(
                            fid, v, base, "serving",
                            verdict="mismatch", nbytes=buf.nbytes,
                        )
                        raise
                    _prov.note_hop(
                        fid, v, base, "serving",
                        verdict="ok", nbytes=buf.nbytes,
                    )
                    leaves.update(_payload.decode_fragment(buf))
                finally:
                    POOL.give(buf)
            state = _payload.assemble(manifest, leaves)
        else:
            doc = fetch_resource(base, v, "full", timeout=budget)
            state, manifest, leaves = _payload.decode_payload(doc)
        if int(manifest["version"]) != v:
            raise RuntimeError(
                f"serving fetch: wanted v{v}, source {base} served "
                f"v{manifest['version']}"
            )
        # provenance: the client now holds every fragment of v (fetched
        # and delta-reused alike)
        c_ms = int(manifest.get("created_ns", 0) // 1_000_000)
        c_digests = manifest.get("digests") or {}
        for name in manifest.get("fragments") or ():
            _prov.note_hold(
                _prov.frag_id("weights", name), v,
                c_digests.get(name, ""), version_ms=c_ms, role="client",
            )
        self._held = (manifest, leaves)
        self._held_version = v
        return state

    def close(self) -> None:
        self._frag_fetcher.close()
        self._client.close()
