"""Checkpoint transport interface.

Parity with the reference ABC (reference: torchft/checkpointing/transport.py:14-68):
a transport moves a live state dict (pytree) from a healthy replica to a
recovering one, keyed by step.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, Generic, List, TypeVar

T = TypeVar("T")


class CheckpointTransport(ABC, Generic[T]):
    @abstractmethod
    def metadata(self) -> str:
        """Transport-specific connection info shipped via the quorum
        (e.g. the HTTP endpoint peers fetch from)."""

    @abstractmethod
    def send_checkpoint(
        self, dst_ranks: "List[int]", step: int, state_dict: T, timeout: float
    ) -> None:
        """Make ``state_dict`` available to (or push it to) ``dst_ranks``."""

    @abstractmethod
    def recv_checkpoint(
        self, src_rank: int, metadata: str, step: int, timeout: float
    ) -> T:
        """Fetch the step's state dict from the source replica."""

    def disallow_checkpoint(self) -> None:
        """Stop serving the staged checkpoint (the state is about to mutate)."""

    def shutdown(self, wait: bool = True) -> None:
        """Release resources."""
