"""The one sanctioned reader of environment knobs.

Every ``TORCHFT_*`` configuration knob in this package is read through the
typed helpers below (``env_str`` / ``env_int`` / ``env_float`` /
``env_bool``) instead of ad-hoc ``os.environ`` access.  Centralizing the
reads buys three properties the scattered form can't:

- **uniform garbage handling**: a typo'd value warns and falls back to the
  default instead of crashing training at import (several knobs are read
  at ``import torchft_tpu``);
- **a statically checkable surface**: the ``env-hygiene`` pass of
  ``tft-lint`` (torchft_tpu_torch/analysis/) flags any direct
  ``os.environ``/``os.getenv`` read outside this module, requires helper
  arguments to be ``TORCHFT_*``-named (or allowlisted externals like the
  ``OTEL_*`` standard vars), and cross-checks every knob against the docs
  tables — an undocumented knob fails CI;
- **one grep target** for "what can I configure".

``env_int`` began life as ``flightrecorder.env_int`` (PR 3) and is
re-exported from there for compatibility.

Writes (``os.environ[...] = ...`` for child-process propagation, as the
launcher and test harness do) are not routed through here — the lint pass
only polices reads.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

logger = logging.getLogger(__name__)

__all__ = ["env_str", "env_int", "env_float", "env_bool"]

# Values env_bool treats as true (case-insensitive); everything else —
# including the empty string — is false.  Matches the historical
# TORCHFT_USE_OTEL gate ("true"/"1"/"yes") plus the conventional "on".
_TRUTHY = ("1", "true", "yes", "on")


def env_str(name: str, default: str = "") -> str:
    """Read a string env knob; empty/unset returns ``default``."""
    return os.environ.get(name) or default


def env_int(name: str, default: int, minimum: "Optional[int]" = 1) -> int:
    """Parse an integer env knob: warn-and-default on garbage, clamp to
    ``minimum`` (pass ``minimum=None`` or a smaller bound for knobs where
    0 or negatives are meaningful, e.g. an ephemeral-port 0)."""
    raw = os.environ.get(name, "")
    if not raw:
        return default
    try:
        value = int(raw)
    except ValueError:
        logger.warning("invalid %s=%r, using %d", name, raw, default)
        return default
    return value if minimum is None else max(value, minimum)


def env_float(name: str, default: float, minimum: "Optional[float]" = None) -> float:
    """Parse a float env knob: warn-and-default on garbage, optional clamp."""
    raw = os.environ.get(name, "")
    if not raw:
        return default
    try:
        value = float(raw)
    except ValueError:
        logger.warning("invalid %s=%r, using %s", name, raw, default)
        return default
    return value if minimum is None else max(value, minimum)


def env_bool(name: str, default: bool = False) -> bool:
    """Parse a boolean env knob: truthy values are ``1/true/yes/on``
    (case-insensitive); unset/empty returns ``default``."""
    raw = os.environ.get(name, "")
    if not raw:
        return default
    return raw.lower() in _TRUTHY
