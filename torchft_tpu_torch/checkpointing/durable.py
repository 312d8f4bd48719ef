"""Durable (on-disk) checkpoints for cold-start resume.

PyTorch port of ``torchft_tpu/checkpointing/durable.py``; a checkpoint of
numpy state has the JAX package's bytes, so either package loads the
other's.

Live healing (HTTP/PG transports) covers the *partial* failure case — some
replicas die, peers hold the state.  Durable checkpoints cover the total
one: every replica died (preemption, maintenance), so on restart there is
no healthy peer to heal from and the job must resume from disk.  The
reference demonstrates this in its trainer: periodic ``torch.save`` of
``{model, optim}`` alongside ``manager.state_dict()``
(reference: train_ddp.py:201-208).

The save path is a thin wrapper over the content-addressed
:class:`~torchft_tpu_torch.checkpointing.store.FragmentStore`: the state dict is
split into heal fragments whose wire bytes land in ``<dir>/blobs/<sha256>``
(deduped across steps — an unchanged fragment costs zero extra disk) and
``ckpt_step<N>.tft`` holds only the digest-bearing manifest, written
atomically (tmp + fsync + ``os.replace``) AFTER every blob it references,
so a kill mid-save can never corrupt the latest checkpoint.  Loads verify
every blob against its manifest sha256 and raise ``ValueError`` loudly on
a missing/corrupt blob — silently wrong weights are never returned.

Legacy format: a pre-store ``ckpt_step<N>.tft`` holding the whole
serialized state dict (no manifest marker) still loads — the single-file
format is supported **read-only**; new saves always use the store layout.
"""

from __future__ import annotations

import os
import re
from typing import Any, List, Optional, Tuple

from torchft_tpu_torch.checkpointing import store as _store
from torchft_tpu_torch.checkpointing.serialization import (
    deserialize_from,
    reassemble,
)

_CKPT_RE = re.compile(r"^ckpt_step(\d+)\.tft$")


def _ckpt_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"ckpt_step{step}.tft")


def save_checkpoint(
    directory: str, step: int, state_dict: Any, keep_last: int = 2
) -> str:
    """Write ``state_dict`` for ``step`` onto the fragment store; prune
    to ``keep_last``.

    Returns the manifest path (``ckpt_step<N>.tft``).  The composite
    Manager layout (``{"user": ..., "torchft": {"step": ..., ...}}``) is
    conventional but not required — any pytree serializes.  A failure at
    any point before the final manifest replace leaves the previous
    checkpoint for ``step`` intact (blobs are content-addressed, so
    half-spilled new blobs are garbage-collected, never referenced).
    """
    os.makedirs(directory, exist_ok=True)
    path = _ckpt_path(directory, step)
    # max_versions=0: pruning follows keep_last below, not the store's
    # own TORCHFT_STORE_VERSIONS window.
    store = _store.FragmentStore(directory, max_versions=0)
    store.put_state(step, state_dict, manifest_path=path)

    if keep_last > 0:
        for old_step, old_path in list_checkpoints(directory)[:-keep_last]:
            if old_step != step:
                try:
                    os.remove(old_path)
                except OSError:
                    pass
        store.gc_blobs()
    return path


def load_checkpoint(path: str) -> Any:
    """Load one checkpoint by manifest path, digest-verifying every
    fragment blob (raises ``ValueError`` on a missing or corrupt blob).
    Legacy single-file ``.tft`` checkpoints load as-is (read-only
    fallback, no integrity metadata to verify)."""
    with open(path, "rb") as f:
        obj = reassemble(*deserialize_from(f))
    if (
        isinstance(obj, dict)
        and obj.get(_store.STORE_MARKER) == _store.STORE_FORMAT
        and "fragments" in obj
        and "digests" in obj
    ):
        store = _store.FragmentStore(
            os.path.dirname(os.path.abspath(path)), max_versions=0
        )
        return store.load_state(obj)
    return obj


def list_checkpoints(directory: str) -> "List[Tuple[int, str]]":
    """All checkpoints in ``directory`` as (step, path), step-ascending."""
    if not os.path.isdir(directory):
        return []
    found = []
    for name in os.listdir(directory):
        m = _CKPT_RE.match(name)
        if m:
            found.append((int(m.group(1)), os.path.join(directory, name)))
    return sorted(found)


def latest_checkpoint(directory: str) -> "Optional[str]":
    """Path of the highest-step checkpoint, or None."""
    ckpts = list_checkpoints(directory)
    return ckpts[-1][1] if ckpts else None
