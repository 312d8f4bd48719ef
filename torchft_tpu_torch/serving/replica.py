"""ServingReplica: one node of the weight-distribution fan-out tree.

PyTorch port of ``torchft_tpu/serving/replica.py``; a relay never
decodes payload bytes, so it serves numpy-leaf and tensor-leaf payloads
alike.

Registers the ``server`` serving role with the lighthouse, adopts the
synthesized plan whenever the plan epoch moves (the layout controller's
epoch-commit idiom: epochs are monotone and name exactly one tree, so adoption is a
local, wedge-free act — a replica mid-switch simply serves the versions
it already holds while it re-parents), pulls new weight versions from
its tree parent (the root pulls from the publisher), and re-stages them
in its own HTTP checkpoint transport for its children and for inference
clients.  A dead parent is routed around: the pull fails over to the
publisher/root source, so a killed interior node degrades depth, never
availability.

The pull is a **cut-through fragment stream** (the default;
``TORCHFT_SERVING_STREAM=0`` restores the whole-payload
store-and-forward path): the relay fetches the ``frag_manifest`` doc
first, then streams fragments one at a time and restages each the
moment its publisher-computed sha256 verifies — a child at depth *d*
overlaps its pull of fragment *i* with this node's pull of fragment
*i+1*, so publish→leaf propagation scales like T_payload + depth×T_frag
instead of depth×T_payload.  Three properties ride along:

- **delta relay pulls** — holding version *v−1*, only digest-changed
  fragments cross the wire; unchanged ones are copied from the local
  staging slot (steady-state relay bytes scale with the update delta,
  not the model);
- **zero-decode passthrough** — fragments are opaque verified bytes
  (bufpool-backed), re-served verbatim: no ``deserialize``/
  ``reassemble``/re-serialize on the relay hot path
  (``torchft_serving_relay_decode_seconds{mode="stream"}`` is
  manifest-only, ~0);
- **torn-version safety** — a streaming version serves ONLY its staged
  fragments (children 503-poll the rest); whole-document reads 503
  until the stream finishes, and the replica advertises the version
  only after the last fragment verified.  A mid-stream parent death
  resumes from the fragments already staged (digests pin content, so
  mixing sources is safe) — and a digest mismatch is treated as a dead
  source, never staged.
"""

from __future__ import annotations

import logging
import socket
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

from torchft_tpu_torch.checkpointing import provenance as _prov
from torchft_tpu_torch.checkpointing import serialization as ser
from torchft_tpu_torch.checkpointing.http_transport import HTTPTransport
from torchft_tpu_torch.ops.codec_pool import merged_seconds
from torchft_tpu_torch.serving import fetcher as _fetcher
from torchft_tpu_torch.serving import payload as _payload
from torchft_tpu_torch.utils import faults as _faults
from torchft_tpu_torch.utils import flightrecorder as _flightrec
from torchft_tpu_torch.utils import metrics as _metrics
from torchft_tpu_torch.utils import tracing as _tracing
from torchft_tpu_torch.utils.bufpool import POOL
from torchft_tpu_torch.utils.env import env_bool, env_float, env_int

logger = logging.getLogger(__name__)

__all__ = ["ServingReplica"]


class ServingReplica:
    """A relay/leaf serving replica.

    Args:
        lighthouse_addr: the lighthouse coordinating the serving tier.
        replica_id: stable id (default ``serve_<uuid8>``); ordering over
            ids determines the synthesized tree position.
        capacity: max children this node accepts (0 = the lighthouse's
            configured fanout).
        max_versions: staged versions retained (default
            ``TORCHFT_SERVING_VERSIONS``).
        poll_interval: heartbeat + version-poll cadence in seconds
            (default ``TORCHFT_SERVING_POLL_S``).
        fetch_timeout: per-pull deadline (default
            ``TORCHFT_SERVING_FETCH_TIMEOUT_S``).
        stream: cut-through fragment streaming (default
            ``TORCHFT_SERVING_STREAM``, on); off = whole-payload
            store-and-forward (the older path, kept for the
            depth-axis bench comparison).
    """

    def __init__(
        self,
        lighthouse_addr: str,
        replica_id: "Optional[str]" = None,
        capacity: int = 0,
        max_versions: "Optional[int]" = None,
        poll_interval: "Optional[float]" = None,
        fetch_timeout: "Optional[float]" = None,
        stream: "Optional[bool]" = None,
    ) -> None:
        from torchft_tpu_torch.coordination import LighthouseClient

        self._replica_id = replica_id or f"serve_{uuid.uuid4().hex[:8]}"
        self._capacity = int(capacity)
        self._client = LighthouseClient(lighthouse_addr)
        self._transport = HTTPTransport(
            max_staged=(
                max_versions
                if max_versions is not None
                else env_int("TORCHFT_SERVING_VERSIONS", 4, minimum=1)
            ),
        )
        self._poll = (
            poll_interval
            if poll_interval is not None
            else env_float("TORCHFT_SERVING_POLL_S", 0.2, minimum=0.01)
        )
        self._fetch_timeout = (
            fetch_timeout
            if fetch_timeout is not None
            else env_float("TORCHFT_SERVING_FETCH_TIMEOUT_S", 30.0, minimum=0.1)
        )
        # Per-source failover bound: a dead source costs at most this
        # before the pull moves on (the LAST candidate gets the full
        # remaining deadline, so a slow-but-alive fleet still completes).
        self._failover_s = env_float("TORCHFT_SERVING_FAILOVER_S", 2.0,
                                     minimum=0.05)
        self._stream = (
            stream
            if stream is not None
            else env_bool("TORCHFT_SERVING_STREAM", True)
        )
        self._frag_fetcher = _fetcher.FragmentFetcher(role="relay")
        self._lock = threading.Lock()
        self._version = 0
        # Staleness ledger: publish wall-stamp (publisher's clock, ms)
        # of the held version, read from the fetched manifest's
        # created_ns and re-advertised unmodified on every heartbeat —
        # the lighthouse compares stamps from the SAME clock, so
        # per-node staleness in /serving.json is skew-free.
        self._version_ms = 0
        # delta base: manifest of the newest COMPLETELY staged version
        # (digest diff against it decides which fragments need wire)
        self._held_manifest: "Optional[Dict[str, Any]]" = None
        self._plan_epoch = -1
        self._parent = ""       # adopted parent address ("" = unplaced)
        self._root_source = ""  # publisher address (failover of last resort)
        self._peers: "List[str]" = []  # other serving-node addresses
        self._depth = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name=f"tft_serving_{self._replica_id}",
            daemon=True,
        )
        self._thread.start()

    # -- introspection -----------------------------------------------------

    def address(self) -> str:
        """HTTP base address children/clients fetch from."""
        return self._transport.metadata()

    def replica_id(self) -> str:
        return self._replica_id

    def version(self) -> int:
        """Newest weight version staged COMPLETE and servable on this
        node (a mid-stream version is never advertised)."""
        with self._lock:
            return self._version

    def plan_epoch(self) -> int:
        with self._lock:
            return self._plan_epoch

    def depth(self) -> int:
        with self._lock:
            return self._depth

    # -- the serving loop --------------------------------------------------

    def _run(self) -> None:
        # Pacing loop (not a retry loop): one heartbeat + pull check per
        # poll interval; every failure inside is logged and re-attempted
        # on the next beat — a serving replica must outlive any
        # lighthouse restart or parent death.
        while not self._stop.is_set():
            try:
                self._beat_once()
            except Exception as e:  # noqa: BLE001 - keep serving
                logger.warning(
                    "serving replica %s beat failed: %s", self._replica_id, e
                )
            self._stop.wait(self._poll)

    def _beat_once(self) -> None:
        with self._lock:
            held_v, held_ms = self._version, self._version_ms
        # provenance piggyback: consumed-on-send; a failed beat hands
        # the digest back so no vector change is lost (as the link-state
        # digest does)
        digest = _prov.PROV.maybe_digest(socket.gethostname())
        try:
            reply = self._client.serving_heartbeat(
                self._replica_id,
                self.address(),
                role="server",
                version=held_v,
                capacity=self._capacity,
                version_ms=held_ms,
                fragments=digest,
            )
        except Exception:
            _prov.PROV.restore_digest(digest)
            raise
        if reply["plan_epoch"] != self.plan_epoch():
            self._adopt_plan()
        target = int(reply["latest_version"])
        if target > self.version():
            self._pull(target)

    def _adopt_plan(self) -> None:
        plan = self._client.serving_plan()
        epoch = int(plan["epoch"])
        # Chaos site: a raise here leaves the OLD tree adopted — the
        # replica keeps serving what it holds (degrade, never wedge) and
        # re-tries adoption on the next heartbeat.
        _faults.check(
            "serving.tree_commit", replica=self._replica_id, step=epoch
        )
        # TORCHFT_PLAN_VERIFY: the lighthouse's BFS tree is a synthesized
        # plan — validate it at the commit point before adopting.
        from torchft_tpu_torch.analysis import plan_verify as _pv

        if _pv.enabled():
            from torchft_tpu_torch.analysis import plan_ir as _pir

            _pv.check_live(_pir.serving_ir(plan))
        t0_ns = time.time_ns()
        me = None
        peers: "List[str]" = []
        for node in plan["nodes"]:
            if node["replica_id"] == self._replica_id:
                me = node
            elif node["address"]:
                peers.append(node["address"])
        with self._lock:
            self._plan_epoch = epoch
            self._root_source = plan["root_source"]
            self._peers = peers
            if me is not None:
                self._parent = me["parent"] or plan["root_source"]
                self._depth = int(me["depth"])
        _metrics.SERVING_PLAN_EPOCH.labels(role="server").set(epoch)
        _metrics.SERVING_TREE_DEPTH.set(int(plan["depth"]))
        _flightrec.record(
            "serving.tree_commit", start_ns=t0_ns, step=epoch,
            parent=self._parent, depth=self._depth,
        )
        tracer = _tracing.get_tracer()
        ctx = _tracing.get_current()
        if tracer is not None and ctx is not None and ctx.sampled:
            tracer.export_span(
                name="serving.tree_commit",
                trace_id=ctx.trace_id,
                parent_span_id=ctx.span_id,
                start_ns=t0_ns,
                end_ns=time.time_ns(),
                attributes={"epoch": epoch, "depth": self._depth},
            )

    # -- pull path ---------------------------------------------------------

    def _sources(self) -> "List[str]":
        """Failover order: parent -> root source -> two peers (bounded
        walk: a stale target is cheaper to re-resolve on the next beat
        than to chase across the whole fleet); self deduped out."""
        with self._lock:
            sources = [s for s in (self._parent, self._root_source) if s]
            peers = list(self._peers)
        own = self.address()
        seen = {own}
        ordered: "List[str]" = []
        for s in sources + peers:
            if s not in seen:
                seen.add(s)
                ordered.append(s)
        return ordered[:4]

    def _source_budget(
        self, deadline: float, i: int, total: int
    ) -> float:
        """Split the remaining deadline over the sources left, capping
        every non-final source at the failover bound so a dead parent
        costs seconds, not the whole deadline."""
        remaining = max(deadline - time.monotonic(), 0.1)
        budget = max(remaining / max(total - i, 1), 0.5)
        if i < total - 1:
            budget = min(budget, self._failover_s)
        return min(budget, remaining)

    def _pull(self, target: int) -> None:
        """Pull version ``target``; fail over to the root source, then
        any peer, when the parent is dead, lags, or serves bytes whose
        digest does not verify."""
        _faults.check("serving.fetch", replica=self._replica_id, step=target)
        ordered = self._sources()
        if not ordered:
            return
        t0 = time.perf_counter()
        with _flightrec.track(
            "serving.fetch", step=target, role="relay",
        ) as op:
            if self._stream:
                self._pull_streamed(target, ordered, op)
            else:
                self._pull_flat(target, ordered, op)
        with self._lock:
            if target > self._version:
                self._version = target
                m = self._held_manifest or {}
                self._version_ms = int(m.get("created_ns", 0) // 1_000_000)
            held_ms = self._version_ms
        dt = time.perf_counter() - t0
        _metrics.SERVING_FETCH_SECONDS.labels(role="relay").observe(dt)
        _metrics.SERVING_VERSION.labels(role="server").set(self.version())
        # server-role staleness: publish->this-node availability lag.
        # Publisher clock vs this host's clock — subject to cross-host
        # skew (the skew-free per-node ledger is the lighthouse's, in
        # /serving.json); on a well-synced fleet this IS publish->leaf.
        if held_ms > 0:
            _metrics.SERVING_STALENESS.labels(role="server").observe(
                max(time.time() - held_ms / 1e3, 0.0)
            )

    def _pull_flat(
        self, target: int, ordered: "List[str]", op: Any
    ) -> None:
        """Whole-payload store-and-forward (the pre-streaming path):
        fetch ``full``, decode the stream, restage — children cannot see
        any byte of ``target`` until this node holds all of them."""
        deadline = time.monotonic() + self._fetch_timeout
        last: "Optional[Exception]" = None
        for i, src in enumerate(ordered):
            budget = self._source_budget(deadline, i, len(ordered))
            try:
                # streamed straight off the socket (no raw intermediate
                # copy); the decode interleaves with the reads, exactly
                # what the store-and-forward baseline always paid
                t_dec = time.perf_counter()
                skeleton, leaves, n = _fetcher.fetch_serialized(
                    src, target, "full", timeout=budget, role="relay"
                )
                doc = ser.reassemble(skeleton, leaves, n)
                _metrics.SERVING_RELAY_DECODE.labels(
                    mode="flat"
                ).observe(time.perf_counter() - t_dec)
                break
            except Exception as e:  # noqa: BLE001 - failover path
                last = e
                if i < len(ordered) - 1:
                    # count only pulls that actually MOVE to another
                    # source; a terminal failure is not a failover
                    _metrics.SERVING_FAILOVERS.labels(role="relay").inc()
                logger.warning(
                    "serving relay %s: pull v%d from %s failed (%s); "
                    "failing over",
                    self._replica_id, target, src, e,
                )
        else:
            op.update(status="error")
            raise ConnectionError(
                f"serving relay {self._replica_id}: no source served "
                f"v{target} within {self._fetch_timeout}s"
            ) from last
        self._transport.send_checkpoint(
            [], target, doc, timeout=self._fetch_timeout
        )
        manifest = doc.get(f"frag:{_payload.MANIFEST_FRAG}") or {}
        m_ms = int(manifest.get("created_ns", 0) // 1_000_000)
        m_digests = manifest.get("digests") or {}
        for name in manifest.get("fragments") or ():
            fid = _prov.frag_id("weights", name)
            raw = _payload.fragment_wire(doc.get(f"frag:{name}"))
            _prov.note_hop(
                fid, target, src, "serving", verdict="ok",
                nbytes=raw.nbytes if raw is not None else 0,
            )
            _prov.note_hold(
                fid, target, m_digests.get(name, ""),
                version_ms=m_ms, role="relay",
            )
        with self._lock:
            self._held_manifest = doc.get(f"frag:{_payload.MANIFEST_FRAG}")

    def _begin_staging(
        self, target: int, manifest: "Dict[str, Any]"
    ) -> "Tuple[List[str], int]":
        """Open (or RESUME) the streamed staging slot for ``target``;
        reuse unchanged fragments from the held version's local staging
        (the delta relay pull — zero wire for fragments whose digest
        did not move).  Returns ``(names still needing wire, reused)``.
        """
        names = list(manifest["fragments"])
        with self._lock:
            held_v, held_m = self._version, self._held_manifest
        existing = self._transport.streamed_parts(target)
        if existing is None:
            self._transport.begin_streamed_checkpoint(
                target,
                {f"frag:{_payload.MANIFEST_FRAG}": manifest},
                timeout=self._fetch_timeout,
            )
            existing = {f"frag:{_payload.MANIFEST_FRAG}"}
        changed = set(_payload.changed_fragments(manifest, held_m))
        todo: "List[str]" = []
        reused = 0
        for name in names:
            key = f"frag:{name}"
            if key in existing:
                continue  # staged by an earlier interrupted pull
            if name not in changed:
                buf = self._transport.copy_staged_part(held_v, key)
                if buf is not None:
                    self._transport.stage_streamed_part(
                        target, key, buf, pooled=True
                    )
                    reused += 1
                    continue
                # held version fell out of the staging window: pay wire
            todo.append(name)
        return todo, reused

    def _pull_streamed(
        self, target: int, ordered: "List[str]", op: Any
    ) -> None:
        deadline = time.monotonic() + self._fetch_timeout
        manifest: "Optional[Dict[str, Any]]" = None
        todo: "List[str]" = []
        reused = 0
        total = 0
        wire_spans: "List[Tuple[float, float]]" = []
        proc_busy = 0.0
        t_stream0 = time.perf_counter()
        last: "Optional[Exception]" = None
        for i, src in enumerate(ordered):
            budget = self._source_budget(deadline, i, len(ordered))
            src_deadline = time.monotonic() + budget
            try:
                if manifest is None:
                    mbuf = self._frag_fetcher.fetch_raw(
                        src, target, f"frag_{_payload.MANIFEST_FRAG}",
                        timeout=budget,
                    )
                    try:
                        t_dec = time.perf_counter()
                        manifest = _payload.decode_manifest(mbuf)
                        _metrics.SERVING_RELAY_DECODE.labels(
                            mode="stream"
                        ).observe(time.perf_counter() - t_dec)
                    finally:
                        POOL.give(mbuf)
                    if int(manifest["version"]) != target:
                        v_got = manifest["version"]
                        manifest = None
                        raise ConnectionError(
                            f"wanted v{target}, {src} served v{v_got}"
                        )
                    todo, reused = self._begin_staging(target, manifest)
                    total = len(manifest["fragments"])
                    t_stream0 = time.perf_counter()
                # Cut-through: stage each fragment the moment its digest
                # verifies — children polling frag_<name> get it while
                # this node is still pulling the next one.  Fragments
                # already staged (earlier source died mid-stream) are
                # skipped; digests pin content, so resuming from another
                # source is bitwise-safe.
                parts = self._transport.streamed_parts(target) or set()
                pend = [
                    f"frag_{n}" for n in todo if f"frag:{n}" not in parts
                ]
                for res, buf, span in self._frag_fetcher.fetch_stream(
                    src, target, pend, deadline=src_deadline
                ):
                    name = res[len("frag_"):]
                    wire_spans.append(span)
                    t_proc = time.perf_counter()
                    fid = _prov.frag_id("weights", name)
                    try:
                        try:
                            _payload.verify_fragment(name, buf, manifest)
                        except ValueError:
                            # provenance: THIS hop is where the poison
                            # entered — diagnose --fragment names it
                            _prov.note_hop(
                                fid, target, src, "serving",
                                verdict="mismatch", nbytes=buf.nbytes,
                            )
                            raise
                        _prov.note_hop(
                            fid, target, src, "serving",
                            verdict="ok", nbytes=buf.nbytes,
                        )
                        self._transport.stage_streamed_part(
                            target, f"frag:{name}", buf, pooled=True
                        )
                        _prov.note_hold(
                            fid, target,
                            (manifest.get("digests") or {}).get(name, ""),
                            version_ms=int(
                                manifest.get("created_ns", 0) // 1_000_000
                            ),
                            role="relay",
                        )
                    except BaseException:
                        # poisoned or unstageable bytes never serve
                        POOL.give(buf)
                        raise
                    proc_busy += time.perf_counter() - t_proc
                break
            except Exception as e:  # noqa: BLE001 - failover path
                last = e
                if i < len(ordered) - 1:
                    _metrics.SERVING_FAILOVERS.labels(role="relay").inc()
                logger.warning(
                    "serving relay %s: streamed pull v%d from %s failed "
                    "(%s); failing over",
                    self._replica_id, target, src, e,
                )
        else:
            # terminal: keep the partial slot — the next beat RESUMES
            # from the staged fragments (or the window evicts it when
            # the fleet moves on)
            op.update(status="error")
            raise ConnectionError(
                f"serving relay {self._replica_id}: no source served "
                f"v{target} within {self._fetch_timeout}s"
            ) from last
        self._transport.finish_streamed_checkpoint(target)
        with self._lock:
            self._held_manifest = manifest
        wall = time.perf_counter() - t_stream0
        # union of fetch intervals, NOT a sum: K-parallel in-flight
        # fetches would otherwise exceed wall on their own and pin the
        # gauge at 1.0 regardless of actual overlap
        wire_busy = merged_seconds(wire_spans)
        if wire_busy > 0.0 and proc_busy > 0.0 and wall > 0.0:
            occ = (wire_busy + proc_busy - wall) / min(wire_busy, proc_busy)
            _metrics.SERVING_CUT_OCCUPANCY.set(min(max(occ, 0.0), 1.0))
        op.update(
            fragments=total, reused=reused,
            wire_s=round(wire_busy, 4),
        )

    # -- lifecycle ---------------------------------------------------------

    def retire_below(self, version: int) -> None:
        """Drop staged versions older than ``version`` (the bounded
        staging window does this on its own; explicit for tests)."""
        for v in self._transport.staged_steps():
            if v < version:
                self._transport.retire_checkpoint(v)

    def shutdown(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)
        self._frag_fetcher.close()
        self._client.close()
        self._transport.shutdown()
