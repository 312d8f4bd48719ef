"""Durable content-addressed fragment store.

PyTorch port of ``torchft_tpu/checkpointing/store.py``.  Live heal and
serving survive *partial* failures, but a whole-fleet outage would lose
the job.  This module adds the spill tier: each rank persists its heal
fragments + manifests to local disk under ``TORCHFT_STORE_DIR``, keyed
by content so steady-state write amplification scales with the update
delta, and on cold start the fleet reassembles from whichever disks
survived via the striped multi-source fetch path — restore is just a
heal whose sources are files.

Blobs of numpy leaves have the JAX package's bytes and sha256 names, so
a store it wrote restores a port fleet whose state is numpy.  A tensor
leaf carries ``"torch": True`` in its serialized meta
(``serialization.py``), so a store of tensor state is the port's alone.

Layout (one directory per rank)::

    <dir>/blobs/<sha256>        # fragment wire bytes, deduped across versions
    <dir>/manifest_v<N>.tft     # serialized manifest: digests + skeleton

Durability contract:

- Blobs and manifests are written tmp + flush + fsync + ``os.replace``
  (the ``durable.py`` idiom), so a crash mid-spill leaves either the
  previous version intact or a fully-written new one — never a torn
  manifest.  The manifest is written LAST: its presence asserts every
  blob it references was durably written first.
- A torn or bit-rotted blob is detected at read time by digest verify
  and treated as a *missing* fragment (counted in
  ``torchft_store_torn_blobs_total``), never served — the striped
  restore path then fails over to another disk holding the same digest.
- Old versions are retired under a ``TORCHFT_STORE_VERSIONS`` window;
  blobs are garbage-collected by scanning the digests still referenced
  by surviving manifests (refcount-by-scan — crash-safe because a
  half-finished GC only ever deletes *unreferenced* blobs).

Cut selection (:func:`select_cut`) is deterministic across replicas:
given the per-disk catalogs the fleet exposes over ``/store/versions``,
every replica picks the same newest version whose fragment set is
covered by the union of digest-valid blobs within one consistent cut
(same manifest content hash), and the same failover-ordered source
list.  Versions are never mixed inside a cut, and an incomplete newer
version degrades to the newest complete older one — degrade, never
wedge.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import re
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterable, List, Optional, Tuple

from torchft_tpu_torch.checkpointing import fragments as frags
from torchft_tpu_torch.checkpointing import provenance as _prov
from torchft_tpu_torch.checkpointing import serialization as ser
from torchft_tpu_torch.utils import faults as _faults
from torchft_tpu_torch.utils import metrics as _metrics
from torchft_tpu_torch.utils.env import env_int, env_str

logger: logging.Logger = logging.getLogger(__name__)

_MANIFEST_RE = re.compile(r"^manifest_v(\d+)\.tft$")
_DURABLE_RE = re.compile(r"^ckpt_step(\d+)\.tft$")

# Marker key stamped into store-format manifests so load paths can
# distinguish them from legacy whole-model ``.tft`` payloads (which are
# arbitrary user state dicts).
STORE_MARKER = "store"
STORE_FORMAT = "blobs"

DEFAULT_STORE_VERSIONS = 4


def _fsync_dir(path: str) -> None:
    """Best-effort fsync of a directory so renames inside it are durable
    (not available on all platforms; durability degrades gracefully)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _atomic_write(path: str, data: bytes) -> None:
    """tmp + flush + fsync + ``os.replace`` — a reader never observes a
    half-written file under the final name."""
    tmp = f"{path}.tmp{os.getpid()}.{threading.get_ident()}"
    try:
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    _fsync_dir(os.path.dirname(path) or ".")


def cut_id(manifest: Dict[str, Any]) -> str:
    """Content hash of a manifest's (fragment name, digest) pairs: two
    disks hold the *same cut* of a version iff their manifests agree on
    every fragment's bytes.  Mixing blobs across different cut ids would
    splice state from different outer syncs — forbidden."""
    h = hashlib.sha256()
    digests = manifest.get("digests") or {}
    for name in sorted(manifest.get("fragments") or []):
        h.update(name.encode())
        h.update(b"\0")
        h.update(str(digests.get(name, "")).encode())
        h.update(b"\0")
    return h.hexdigest()


class FragmentStore:
    """Content-addressed on-disk fragment store for one rank.

    Thread-safety: writes are serialized by callers (the single-worker
    :class:`StoreSpiller`); reads are lock-free because blobs are
    immutable once named (content-addressed) and manifests are replaced
    atomically.
    """

    def __init__(
        self, directory: str, max_versions: Optional[int] = None
    ) -> None:
        self._dir = directory
        self._blob_dir = os.path.join(directory, "blobs")
        if max_versions is None:
            max_versions = env_int(
                "TORCHFT_STORE_VERSIONS", DEFAULT_STORE_VERSIONS, minimum=1
            )
        # max_versions == 0 disables automatic retirement (the durable.py
        # wrapper prunes by its own keep_last policy instead).
        self._max_versions = max_versions
        os.makedirs(self._blob_dir, exist_ok=True)
        #: timings of the last :meth:`put_state`: ``encode_s`` (serialize
        #: + sha256), ``write_s`` (blobs + manifest), ``bytes_written``
        self.last_put: Dict[str, Any] = {}

    @property
    def directory(self) -> str:
        return self._dir

    # ------------------------------------------------------------- blobs

    def blob_path(self, digest: str) -> str:
        return os.path.join(self._blob_dir, digest)

    def write_blob(self, digest: str, raw: Any) -> int:
        """Persist one fragment's wire bytes under its digest.  Returns
        the byte count actually written — 0 when the digest already
        exists (dedup: unchanged fragments cost no disk writes)."""
        path = self.blob_path(digest)
        if os.path.exists(path):
            return 0
        data = bytes(memoryview(raw))
        _atomic_write(path, data)
        return len(data)

    def read_blob(self, digest: str) -> Optional[bytes]:
        """Read one blob, verifying its bytes still hash to the digest
        that names it.  Torn/bit-rotted blobs return ``None`` (treated
        as missing — the caller fails over), never bad bytes."""
        try:
            with open(self.blob_path(digest), "rb") as f:
                data = f.read()
        except OSError:
            return None
        if hashlib.sha256(data).hexdigest() != digest:
            _metrics.STORE_TORN_BLOBS.inc()
            logger.warning(
                f"store blob {digest[:12]} failed digest verify "
                f"(torn or bit-rotted) — treating as missing"
            )
            return None
        return data

    # --------------------------------------------------------- manifests

    def _manifest_path(self, version: int) -> str:
        return os.path.join(self._dir, f"manifest_v{version}.tft")

    def _manifest_files(self) -> List[Tuple[int, str]]:
        """All store + durable-wrapper manifests in the directory, as
        sorted ``(version, path)``.  Durable checkpoints share the blob
        namespace, so GC must see both."""
        out = []
        try:
            names = os.listdir(self._dir)
        except OSError:
            return []
        for n in names:
            m = _MANIFEST_RE.match(n) or _DURABLE_RE.match(n)
            if m:
                out.append((int(m.group(1)), os.path.join(self._dir, n)))
        out.sort()
        return out

    def _read_manifest_file(self, path: str) -> Optional[Dict[str, Any]]:
        try:
            with open(path, "rb") as f:
                obj = ser.reassemble(*ser.deserialize_from(f))
        except Exception:
            return None
        if not isinstance(obj, dict) or "fragments" not in obj:
            return None
        return obj

    def versions(self) -> List[int]:
        return [v for v, p in self._manifest_files() if _MANIFEST_RE.match(os.path.basename(p))]

    def manifest(self, version: int) -> Optional[Dict[str, Any]]:
        """Decode one version's manifest, or ``None`` if absent/torn
        (atomic writes make torn manifests near-impossible; a corrupt
        one is simply not a restorable version)."""
        path = self._manifest_path(version)
        if not os.path.exists(path):
            return None
        return self._read_manifest_file(path)

    def manifest_bytes(self, version: int) -> Optional[bytes]:
        """Raw serialized manifest for wire passthrough (the HTTP
        ``frag_manifest`` resource serves these bytes verbatim)."""
        try:
            with open(self._manifest_path(version), "rb") as f:
                data = f.read()
        except OSError:
            return None
        # Validate decodability so a torn manifest is never served.
        if self._read_manifest_file(self._manifest_path(version)) is None:
            return None
        return data

    def fragment(self, version: int, name: str) -> Optional[bytes]:
        """One fragment's verified wire bytes, or ``None`` when the
        version/fragment is unknown or its blob is torn."""
        manifest = self.manifest(version)
        if manifest is None:
            return None
        digest = (manifest.get("digests") or {}).get(name)
        if digest is None:
            return None
        data = self.read_blob(str(digest))
        if data is None and os.path.exists(self.blob_path(str(digest))):
            # the blob exists but failed its content-address check:
            # a torn/bit-rotted disk read IS a provenance hop verdict —
            # diagnose --fragment names this disk as the poisoned source
            _prov.note_hop(
                _prov.frag_id(self._payload_family(manifest), name),
                version, f"disk:{self._dir}", "restore", verdict="torn",
            )
        return data

    @staticmethod
    def _payload_family(manifest: Dict[str, Any]) -> str:
        """Provenance payload family of a stored manifest: ``weights``
        for serving documents spilled via :meth:`put_doc`, ``heal``
        (the heal fragment layout) otherwise."""
        return str(manifest.get("payload") or "heal")

    # ------------------------------------------------------------- spill

    def put_state(
        self,
        version: int,
        state_dict: Any,
        fragments: Optional[int] = None,
        manifest_path: Optional[str] = None,
    ) -> Dict[str, Any]:
        """Spill one version: encode ``state_dict`` into heal fragments,
        persist each blob (deduped by digest), then atomically publish
        the manifest.  The fault site ``store.spill`` fires here (chaos:
        a failed spill skips the version, it never corrupts an earlier
        one — the manifest is written last).

        ``manifest_path`` overrides the manifest location (the
        ``durable.py`` wrapper points it at ``ckpt_step<N>.tft``)."""
        _faults.check("store.spill", step=version)
        # encode (serialize + sha256, inside the fragment iterator) and
        # the disk writes are timed apart: last_put reports both
        t0 = time.perf_counter()
        header, frag_iter = frags.iter_heal_fragments(state_dict, fragments)
        encode_s = time.perf_counter() - t0
        write_s = 0.0
        digests: Dict[str, str] = {}
        written = 0
        frag_iter = iter(frag_iter)
        while True:
            t0 = time.perf_counter()
            item = next(frag_iter, None)
            t1 = time.perf_counter()
            encode_s += t1 - t0
            if item is None:
                break
            name, raw, digest = item
            written += self.write_blob(digest, raw)
            digests[name] = digest
            write_s += time.perf_counter() - t1
        manifest = dict(header)
        manifest["version"] = int(version)
        manifest["digests"] = digests
        manifest["created_ns"] = time.time_ns()
        manifest[STORE_MARKER] = STORE_FORMAT
        t0 = time.perf_counter()
        _atomic_write(
            manifest_path or self._manifest_path(version),
            ser.serialize(manifest),
        )
        self.last_put = {
            "version": int(version),
            "encode_s": encode_s,
            "write_s": write_s + time.perf_counter() - t0,
            "bytes_written": written,
            "fragments": len(digests),
        }
        if written:
            _metrics.STORE_SPILL_BYTES.inc(written)
        v_ms = int(manifest["created_ns"] // 1_000_000)
        for name, digest in digests.items():
            _prov.note_hold(
                _prov.frag_id("heal", name), version, digest,
                version_ms=v_ms, role="store",
            )
        if manifest_path is None and self._max_versions:
            self.retire()
        return manifest

    def put_doc(self, doc: Dict[str, Any]) -> Optional[int]:
        """Spill an already-encoded fragment document (the serving
        publisher's ``encode_payload`` output: raw wire bytes per
        fragment plus a digest-bearing manifest) without re-encoding."""
        manifest = doc.get(f"frag:{frags.MANIFEST_FRAG}")
        if not isinstance(manifest, dict) or "fragments" not in manifest:
            return None
        version = int(manifest.get("version", 0))
        _faults.check("store.spill", step=version)
        digests = manifest.get("digests") or {}
        written = 0
        for name in manifest["fragments"]:
            raw = doc.get(f"frag:{name}")
            digest = digests.get(name)
            if raw is None or digest is None:
                return None
            written += self.write_blob(str(digest), raw)
        out = dict(manifest)
        out.setdefault(STORE_MARKER, STORE_FORMAT)
        # serving documents keep their payload family on disk so torn
        # reads audit under the same frag id the serving tier uses
        out.setdefault("payload", "weights")
        _atomic_write(self._manifest_path(version), ser.serialize(out))
        if written:
            _metrics.STORE_SPILL_BYTES.inc(written)
        v_ms = int(manifest.get("created_ns", 0) // 1_000_000)
        for name in manifest["fragments"]:
            _prov.note_hold(
                _prov.frag_id("weights", name), version,
                str(digests.get(name, "")), version_ms=v_ms, role="store",
            )
        if self._max_versions:
            self.retire()
        return version

    def load_state(self, manifest: Dict[str, Any]) -> Any:
        """Reassemble a full state dict from a manifest's blobs, digest-
        verifying every read.  Raises ``ValueError`` loudly on a missing
        or corrupt blob — silently wrong weights are never returned."""
        leaves: Dict[int, Any] = {}
        for name in manifest["fragments"]:
            digest = (manifest.get("digests") or {}).get(name)
            raw = self.read_blob(str(digest)) if digest else None
            if raw is None:
                raise ValueError(
                    f"checkpoint blob for fragment {name!r} "
                    f"({str(digest)[:12]}…) is missing or failed digest "
                    f"verify — refusing to return corrupt state"
                )
            leaves.update(frags.decode_fragment(raw))
        return frags.assemble(manifest, leaves)

    # -------------------------------------------------------- retirement

    def retire(self, keep: Optional[int] = None) -> None:
        """Drop manifests beyond the newest ``keep`` store versions, then
        GC blobs no surviving manifest (store OR durable) references."""
        keep = self._max_versions if keep is None else keep
        if keep:
            store_versions = self.versions()
            for v in store_versions[:-keep]:
                try:
                    os.remove(self._manifest_path(v))
                except OSError:
                    pass
        self.gc_blobs()
        _metrics.STORE_VERSIONS.set(len(self.versions()))

    def gc_blobs(self) -> int:
        """Delete blobs unreferenced by any surviving manifest.  Crash-
        safe: manifests are removed before their blobs, so a half-done
        GC only ever deletes already-unreferenced blobs."""
        referenced = set()
        for _v, path in self._manifest_files():
            manifest = self._read_manifest_file(path)
            if manifest is not None:
                referenced.update(
                    str(d) for d in (manifest.get("digests") or {}).values()
                )
        removed = 0
        try:
            names = os.listdir(self._blob_dir)
        except OSError:
            return 0
        for name in names:
            if name in referenced or ".tmp" in name:
                continue
            try:
                os.remove(os.path.join(self._blob_dir, name))
                removed += 1
            except OSError:
                pass
        return removed

    # ----------------------------------------------------------- catalog

    def catalog(self) -> Dict[int, Dict[str, Any]]:
        """Per-version restore inventory for cut selection: the cut id,
        fragment list, and which fragments this disk can actually serve
        (blob present AND digest-valid) — what ``/store/versions``
        exposes fleet-wide."""
        out: Dict[int, Dict[str, Any]] = {}
        for v in self.versions():
            manifest = self.manifest(v)
            if manifest is None:
                continue
            names = list(manifest.get("fragments") or [])
            ok = [n for n in names if self.fragment(v, n) is not None]
            out[v] = {
                "cut": cut_id(manifest),
                "fragments": names,
                "frags_ok": ok,
                "complete": len(ok) == len(names) and bool(names),
            }
        return out


def select_cut(
    catalogs: Dict[str, Dict[int, Dict[str, Any]]],
) -> Optional[Tuple[int, List[str]]]:
    """Pick the restore cut from the fleet's per-disk catalogs.

    Walks versions newest-first; within a version, disks are grouped by
    cut id (manifest content hash) and a cut is selectable iff the UNION
    of its disks' digest-valid fragments covers the fragment list — a
    version torn on every disk degrades to the newest complete older
    one, never a wedge.  Returns ``(version, ordered source bases)``
    with complete disks first (the primary gets the full deadline in
    ``striped_fetch``), or ``None`` when nothing is restorable (a
    genuinely fresh job).  Deterministic: every replica looking at the
    same catalogs picks the same cut and the same source order."""
    all_versions = sorted(
        {v for cat in catalogs.values() for v in cat}, reverse=True
    )
    for version in all_versions:
        holders = [
            (base, cat[version])
            for base, cat in sorted(catalogs.items())
            if version in cat
        ]
        by_cut: Dict[str, List[Tuple[str, Dict[str, Any]]]] = {}
        for base, ent in holders:
            by_cut.setdefault(str(ent.get("cut")), []).append((base, ent))
        for cut in sorted(by_cut, key=lambda c: (-len(by_cut[c]), c)):
            group = by_cut[cut]
            names = set(group[0][1].get("fragments") or [])
            if not names:
                continue
            covered: set = set()
            for _base, ent in group:
                covered.update(ent.get("frags_ok") or [])
            if names <= covered:
                ordered = sorted(
                    group,
                    key=lambda be: (
                        not be[1].get("complete"),
                        -len(be[1].get("frags_ok") or []),
                        be[0],
                    ),
                )
                return version, [base for base, _ent in ordered]
    return None


def fetch_catalog(
    base: str, timeout: float
) -> Optional[Dict[int, Dict[str, Any]]]:
    """Fetch a peer's store catalog from its checkpoint server's
    ``/store/versions`` resource (plain JSON — not a framed RPC, so the
    wire-schema lock is untouched).  Best-effort: any failure means
    'that disk has nothing for us'."""
    try:
        with urllib.request.urlopen(f"{base}/store/versions", timeout=timeout) as r:
            raw = r.read()
        parsed = json.loads(raw.decode())
        return {int(v): ent for v, ent in parsed.items()}
    except Exception as e:
        logger.debug(f"store catalog fetch from {base} failed: {e}")
        return None


def store_from_env(
    replica_id: str, group_rank: int = 0
) -> Optional[FragmentStore]:
    """Build this rank's :class:`FragmentStore` from ``TORCHFT_STORE_DIR``
    (``None`` when unset — the spill tier is opt-in).  Each rank gets a
    namespace keyed by its stable replica id so restarted processes find
    their own disk, and restore stays rank-symmetric."""
    base = env_str("TORCHFT_STORE_DIR", "")
    if not base:
        return None
    name = replica_id or "replica"
    if group_rank:
        name = f"{name}_r{group_rank}"
    return FragmentStore(os.path.join(base, name))


class StoreSpiller:
    """Single-worker spill executor (the serving publish idiom): the
    training thread hands off a state snapshot and returns immediately;
    encode + disk writes happen on the worker.  A failed spill counts
    ``torchft_store_spill_failures_total`` and skips the version — it
    NEVER raises into (or stalls) a training step."""

    def __init__(self, store: FragmentStore) -> None:
        self._store = store
        self._executor = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="tft_store_spill"
        )
        self._inflight: Any = None
        self._lock = threading.Lock()
        self._shutdown = False
        #: versions dropped by the no-backlog rule of :meth:`submit`
        self.skipped = 0

    def submit(
        self, version: int, state_dict: Any, fragments: Optional[int] = None
    ) -> bool:
        """Queue one version for spill.  Returns False (and skips the
        version) when the previous spill is still running — the spill
        tier is best-effort and must never build a backlog that the
        training loop ends up waiting on."""
        with self._lock:
            if self._shutdown:
                return False
            if self._inflight is not None and not self._inflight.done():
                self.skipped += 1
                logger.debug(
                    f"store spill of v{version} skipped: previous spill "
                    f"still in flight"
                )
                return False
            self._inflight = self._executor.submit(
                self._spill, version, state_dict, fragments
            )
        return True

    def _spill(
        self, version: int, state_dict: Any, fragments: Optional[int]
    ) -> None:
        try:
            t0 = time.perf_counter()
            self._store.put_state(version, state_dict, fragments)
            logger.debug(
                f"spilled v{version} to {self._store.directory} in "
                f"{time.perf_counter() - t0:.3f}s"
            )
        except Exception as e:
            _metrics.STORE_SPILL_FAILURES.inc()
            logger.warning(f"store spill of v{version} failed (skipped): {e}")

    def flush(self, timeout: Optional[float] = None) -> None:
        with self._lock:
            inflight = self._inflight
        if inflight is not None:
            try:
                inflight.result(timeout=timeout)
            except Exception:
                pass  # already counted + logged by the worker

    def shutdown(self) -> None:
        with self._lock:
            self._shutdown = True
        self._executor.shutdown(wait=True)
