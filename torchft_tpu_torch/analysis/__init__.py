"""tft-torch-lint: project-invariant static analysis for torchft_tpu_torch.

The package keeps a web of cross-cutting invariants — telemetry names
and docs tables in sync, one retry policy, non-blocking signal paths,
every fault site registered — that nothing else enforces.  This package
is the enforcement: stdlib-``ast`` passes encoding *this project's* rules
(not generic style), the JAX package's tft-lint passes with their rules,
codes and flags, run as ``python -m torchft_tpu_torch.analysis
torchft_tpu_torch/`` or the ``tft-torch-lint`` console script, and wired
into tier-1 via tests/test_torch_lint.py so a violation fails CI.

Passes (each with an embedded ``--selftest`` and a checked-in baseline
file for grandfathered findings — all empty):

========================  ==================================================
``lock-discipline``       no blocking calls while holding a lock; no
                          blocking lock acquisition in signal handlers
``env-hygiene``           env reads only via utils/env.py helpers,
                          TORCHFT_*-named, documented
``metrics-sync``          metric names torchft_*, unique, documented;
                          event kinds in both _LOGGERS and _SEVERITY
``metrics-cardinality``   per-replica/per-peer label values bounded or
                          top-K-aggregated (fleet churn must not grow
                          the registry)
``retry-ban``             no time.sleep retry loops outside utils/retry.py
``fault-coverage``        fault sites registered/documented/wired; PG +
                          transport paths feed the flight recorder
``wire-drift``            framed-JSON wire schema in sync across Python
                          clients, native servers, docs/protocol.md, and
                          the committed protocol.lock
``span-vocab``            trace-span names from PROTOCOL_PHASES /
                          quant.* / heal.* / rpc.*; every span emitter
                          also feeds the flight recorder
``plan-discipline``       peer-communication structure (reduction
                          hierarchies, serving trees, stripe rosters)
                          built only via the plan layer's primitives in
                          bless-listed modules — plans stay verifiable
                          data (tft-verify --scenario plan)
========================  ==================================================

The runtime complement is ``utils/lockcheck.py`` (TORCHFT_LOCKCHECK=1
lock-order cycle detection) and the native TSan build
(``make -C native SANITIZE=thread``) — see docs/static_analysis.md.

The sibling subsystem ``tft-verify`` (``torchft_tpu_torch.analysis.verify_cli``,
console script ``tft-torch-verify``) is the *dynamic* half of the same
contract: an executable model of the quorum protocol
(:mod:`torchft_tpu_torch.analysis.protocol_model`) exhaustively explored by
:mod:`torchft_tpu_torch.analysis.model_checker`, plus the wire-schema lock
workflow (``--write-lock`` / ``--drift``).
"""

from torchft_tpu_torch.analysis.core import (  # noqa: F401
    Finding,
    LintPass,
    Project,
    SelftestError,
    run_passes,
)
from torchft_tpu_torch.analysis.coverage import PASS as _coverage
from torchft_tpu_torch.analysis.env_hygiene import PASS as _env_hygiene
from torchft_tpu_torch.analysis.lock_discipline import PASS as _lock_discipline
from torchft_tpu_torch.analysis.metrics_cardinality import PASS as _metrics_cardinality
from torchft_tpu_torch.analysis.metrics_sync import PASS as _metrics_sync
from torchft_tpu_torch.analysis.plan_discipline import PASS as _plan_discipline
from torchft_tpu_torch.analysis.retry_ban import PASS as _retry_ban
from torchft_tpu_torch.analysis.span_vocab import PASS as _span_vocab
from torchft_tpu_torch.analysis.wire_schema import PASS as _wire_drift

#: Every registered pass, in documentation order.
PASSES = (
    _lock_discipline,
    _env_hygiene,
    _metrics_sync,
    _metrics_cardinality,
    _retry_ban,
    _coverage,
    _wire_drift,
    _span_vocab,
    _plan_discipline,
)

__all__ = [
    "PASSES",
    "Finding",
    "LintPass",
    "Project",
    "SelftestError",
    "run_passes",
]
