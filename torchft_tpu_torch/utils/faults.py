"""Chaos layer: first-class, production-grade fault injection.

torchft's value proposition is surviving per-step failures, so the fault
paths must be *continuously exercisable* — not only through test-local
monkeypatching.  Prime's PCCL report and "Reliable and Resilient Collective
Communication Library for LLM Training and Serving" (PAPERS.md) both argue
that reliability features rot unless the failure surface is first-class;
this module is that surface: a process-wide registry of **named injection
sites** that every failure-bearing layer consults, with deterministic
seeded schedules, per-site accounting, metrics, and structured events.

Injection sites wired through the production stack:

====================  =====================================================
site                  fires in
====================  =====================================================
``lighthouse.rpc``    ``LighthouseClient`` framed-JSON calls
                      (coordination.py)
``lighthouse.heartbeat``  ``LighthouseClient.heartbeat`` — the Python
                      heartbeat/progress-piggyback client (tests and
                      custom FT algorithms; the native manager's C++
                      heartbeat loop does not consult this registry)
``lighthouse.lease``  ``LighthouseClient.lease`` — the Python
                      leadership-lease client of the replicated
                      lighthouse (``step`` = proposed term; the native
                      electors' C++ lease exchanges do not consult this
                      registry)
``lighthouse.links``  link-state digest reporting — the Python
                      ``LighthouseClient.heartbeat(links=...)`` /
                      ``links()`` readers and ``ManagerServer.
                      report_links`` handoff (a dropped report degrades
                      the fleet matrix to stale rows; the heartbeat
                      itself never carries the fault)
``lighthouse.fragments``  fragment-provenance digest reporting — the
                      Python ``LighthouseClient.heartbeat(fragments=
                      ...)`` / ``serving_heartbeat(fragments=...)`` /
                      ``fragments()`` readers and ``ManagerServer.
                      report_fragments`` handoff (a dropped digest is
                      restored and retried next beat; the version
                      matrix degrades to older rows, never wedges)
``manager.quorum``    ``Manager._async_quorum`` before the quorum RPC
``manager.heal``      ``Manager._async_quorum`` heal send/recv branches
``pg.reconfigure``    ``ProcessGroupTCP.configure`` /
                      ``ProcessGroupBaby.configure``
``pg.allreduce``      ``Manager.allreduce`` before collective submission;
                      also per chunk in the quantized pipeline drivers
``pg.allreduce.chunk``  quantized pipeline drivers, per chunk
                      (``step`` = chunk index)
``pg.allreduce.hop``  hierarchical plan driver before each chunk's
                      inter-host hops (``step`` = chunk index)
``mesh.reshard``      ``parallel/layout.py`` reshard staging, before each
                      per-source slice-diff fetch (``step`` = layout
                      epoch)
``manager.layout_commit``  ``Manager._async_quorum`` before the layout
                      commit round is resolved (``step`` = quorum
                      max_step)
``transport.send``    ``send_checkpoint`` of both checkpoint transports
``transport.recv``    ``recv_checkpoint`` of both checkpoint transports
``transport.heal.frag`` each striped-heal fragment fetch
                      (checkpointing/fragments.py ``fetch_raw`` with the
                      heal role; ``step`` = the fragment's stripe index)
``serving.publish``   ``WeightPublisher.publish`` before a weight
                      version is encoded/staged (``step`` = version)
``serving.fetch``     serving-tier fetch attempts — relay pull from the
                      tree parent and client fetches (``step`` =
                      version)
``serving.frag``      serving-tier per-fragment raw fetches
                      (serving/fetcher.py) — manifest and fragment
                      pulls of the streaming relay and the pipelined
                      client delta path (``step`` = fragment index in
                      the stream, version for single fetches)
``serving.tree_commit``  ``ServingReplica`` adopting a new
                      distribution-tree plan epoch (``step`` = epoch)
``store.barrier``     blocking ``StoreClient.get(wait=True)`` (the
                      rendezvous-barrier wait PG configure relies on)
``store.spill``       durable fragment-store spill — ``FragmentStore.
                      put_state`` / ``put_doc`` before blobs are written
                      (checkpointing/store.py; ``step`` = version; a
                      failed spill skips the version, never stalls a
                      training step)
``store.restore``     ``Manager`` whole-fleet cold-start restore before
                      catalog discovery (``step`` = 0; a failed restore
                      degrades to fresh initialization, never a wedge)
``local_sgd.sync``    ``LocalSGD.sync`` / DiLoCo fragment sync entry
``train.step``        user training loops that opt in by calling
                      :func:`check` at the top of each step (the chaos
                      suite's replica-crash hook)
====================  =====================================================

Schedules are :class:`FaultRule` objects — fail replica R at step S, fail
with probability p after step S, inject latency, drop the connection vs.
raise — registered programmatically (``FAULTS.configure([...], seed=...)``)
or via ``TORCHFT_FAULTS=<spec>`` (grammar below) + ``TORCHFT_FAULTS_SEED``.
Every injection increments ``torchft_faults_injected_total{site,action}``
and emits a structured ``fault`` event, so a chaos run can assert that the
faults observed match the schedule.

Spec grammar (round-trips through :func:`parse_spec` / :func:`format_spec`)::

    spec  := rule (';' rule)*
    rule  := site [':' kv (',' kv)*]
    kv    := key '=' value
    keys  := action  (raise | drop | delay; default raise)
             replica (match the id prefix before ':'; default any)
             step    (fire only at exactly this step)
             after_step (eligible once step >= N)
             prob    (fire with this probability per eligible check; 0..1)
             times   (max firings; -1 = unlimited; default 1)
             delay   (seconds slept for action=delay)

Example::

    TORCHFT_FAULTS="pg.allreduce:replica=replica_1,step=2;\
transport.recv:after_step=0,action=drop;\
manager.quorum:prob=0.05,after_step=3,times=-1,action=delay,delay=0.2"

Failure policy: with no rules registered, :func:`check` is a single
attribute test — safe on the allreduce hot path.
"""

from __future__ import annotations

import logging
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)

__all__ = [
    "KNOWN_SITES",
    "ACTIONS",
    "InjectedFault",
    "InjectedConnectionDrop",
    "FaultRule",
    "FaultRegistry",
    "FAULTS",
    "check",
    "parse_spec",
    "format_spec",
    "configure_from_env",
]

# The production injection sites (module docstring documents where each
# fires).  Rules may name other sites — e.g. a test harness's own hook —
# but a typo'd production site should be loud, so parse_spec warns on
# unknown names instead of silently never firing.
KNOWN_SITES: "Tuple[str, ...]" = (
    "lighthouse.rpc",
    "lighthouse.heartbeat",
    "lighthouse.lease",
    "lighthouse.links",
    "lighthouse.fragments",
    "manager.quorum",
    "manager.heal",
    "pg.reconfigure",
    "pg.allreduce",
    "pg.allreduce.chunk",
    "pg.allreduce.hop",
    "mesh.reshard",
    "manager.layout_commit",
    "transport.send",
    "transport.recv",
    "transport.heal.frag",
    "serving.publish",
    "serving.fetch",
    "serving.frag",
    "serving.tree_commit",
    "store.barrier",
    "store.spill",
    "store.restore",
    "local_sgd.sync",
    "train.step",
)

ACTIONS: "Tuple[str, ...]" = ("raise", "drop", "delay")


class InjectedFault(RuntimeError):
    """A chaos-injected hard failure (action=raise)."""


class InjectedConnectionDrop(ConnectionError):
    """A chaos-injected connection drop (action=drop).

    Subclasses :class:`ConnectionError` so it takes exactly the code path a
    real peer reset takes (retry loops, error latching, reconnects)."""


@dataclass
class FaultRule:
    """One scheduled fault at one site.

    Matching: the rule fires when the site matches exactly, the caller's
    replica matches ``replica`` (prefix before the ``:<uuid>`` incarnation
    suffix; ``None`` matches any), the caller's step satisfies ``step`` /
    ``after_step``, the rule is not exhausted (``times``), and a seeded
    per-rule RNG draw passes ``prob``.  A rule with a replica/step
    constraint never matches a check that did not supply that context.
    """

    site: str
    action: str = "raise"
    replica: "Optional[str]" = None
    step: "Optional[int]" = None
    after_step: "Optional[int]" = None
    prob: float = 1.0
    times: int = 1
    delay: float = 0.0
    # runtime state, not part of the spec round-trip
    fired: int = field(default=0, compare=False)

    def __post_init__(self) -> None:
        if self.action not in ACTIONS:
            raise ValueError(
                f"fault action must be one of {ACTIONS}, got {self.action!r}"
            )
        if not self.site:
            raise ValueError("fault rule needs a site")
        if not (0.0 <= self.prob <= 1.0):
            raise ValueError(f"prob must be in [0, 1], got {self.prob}")
        if self.delay < 0:
            raise ValueError(f"delay must be >= 0, got {self.delay}")

    def exhausted(self) -> bool:
        return 0 <= self.times <= self.fired


def _base_replica(replica_id: "Optional[str]") -> "Optional[str]":
    """Strip the ``:<uuid>`` incarnation suffix the Manager appends."""
    if replica_id is None:
        return None
    return replica_id.split(":", 1)[0]


class FaultRegistry:
    """Process-wide registry of fault rules with deterministic scheduling.

    Every rule owns a :class:`random.Random` seeded from the registry seed
    and the rule's index, so a fixed seed plus a deterministic sequence of
    :meth:`check` calls replays the identical schedule — the property the
    chaos soak relies on to assert "faults injected == faults scheduled".
    """

    def __init__(self, seed: "Optional[int]" = None) -> None:
        from torchft_tpu_torch.utils import lockcheck

        self._lock = lockcheck.lock("faults.registry")
        self._seed = 0 if seed is None else int(seed)
        self._rules: "List[FaultRule]" = []
        self._rngs: "List[random.Random]" = []
        self._counts: "Dict[Tuple[str, str], int]" = {}

    # -- configuration -----------------------------------------------------

    def _rule_rng(self, index: int) -> random.Random:
        # distinct, stable stream per rule: schedule determinism survives
        # reordering of checks across *other* rules
        return random.Random((self._seed & 0xFFFFFFFF) * 1000003 + index)

    def configure(
        self, rules: "List[FaultRule]", seed: "Optional[int]" = None
    ) -> None:
        """Replace the whole schedule (and reset all accounting)."""
        with self._lock:
            if seed is not None:
                self._seed = int(seed)
            self._rules = list(rules)
            for r in self._rules:
                r.fired = 0
            self._rngs = [self._rule_rng(i) for i in range(len(self._rules))]
            self._counts = {}

    def register(self, rule: FaultRule) -> FaultRule:
        """Append one rule to the live schedule."""
        with self._lock:
            self._rules.append(rule)
            self._rngs.append(self._rule_rng(len(self._rules) - 1))
        return rule

    def clear(self) -> None:
        self.configure([])

    # -- introspection -----------------------------------------------------

    def rules(self) -> "List[FaultRule]":
        with self._lock:
            return list(self._rules)

    def counts(self) -> "Dict[Tuple[str, str], int]":
        """{(site, action): fired} since the last configure()."""
        with self._lock:
            return dict(self._counts)

    def injected(self, site: "Optional[str]" = None) -> int:
        """Total faults injected (optionally for one site)."""
        with self._lock:
            return sum(
                n
                for (s, _a), n in self._counts.items()
                if site is None or s == site
            )

    # -- the injection point -----------------------------------------------

    def check(
        self,
        site: str,
        replica: "Optional[str]" = None,
        step: "Optional[int]" = None,
    ) -> None:
        """Consult the schedule at ``site``; act on the first firing rule.

        Raises :class:`InjectedFault` (action=raise) or
        :class:`InjectedConnectionDrop` (action=drop), or sleeps
        (action=delay).  No-op (one attribute test) with no rules.
        """
        if not self._rules:
            return
        fired: "Optional[FaultRule]" = None
        base = _base_replica(replica)
        with self._lock:
            for rule, rng in zip(self._rules, self._rngs):
                if rule.site != site or rule.exhausted():
                    continue
                if rule.replica is not None and rule.replica != base:
                    continue
                if rule.step is not None and step != rule.step:
                    continue
                if rule.after_step is not None and (
                    step is None or step < rule.after_step
                ):
                    continue
                if rule.prob < 1.0 and rng.random() >= rule.prob:
                    continue
                rule.fired += 1
                key = (site, rule.action)
                self._counts[key] = self._counts.get(key, 0) + 1
                fired = rule
                break
        if fired is None:
            return
        self._emit(fired, site, replica, step)
        if fired.action == "delay":
            time.sleep(fired.delay)
            return
        msg = (
            f"injected {fired.action} at {site}"
            f" (replica={replica}, step={step})"
        )
        if fired.action == "drop":
            raise InjectedConnectionDrop(msg)
        raise InjectedFault(msg)

    @staticmethod
    def _emit(
        rule: FaultRule, site: str, replica: "Optional[str]", step: "Optional[int]"
    ) -> None:
        # Metrics + structured event, never allowed to mask the injection
        # itself (a chaos layer that crashes on telemetry is its own chaos).
        try:
            from torchft_tpu_torch.utils import metrics as _metrics

            _metrics.FAULTS_INJECTED.labels(site=site, action=rule.action).inc()
        except Exception:  # noqa: BLE001
            logger.exception("fault metrics emit failed")
        try:
            from torchft_tpu_torch.utils.logging import log_event

            log_event(
                "fault",
                f"injected {rule.action} at {site}",
                site=site,
                action=rule.action,
                replica_id=replica or "",
                step=step if step is not None else -1,
                rule_times=rule.times,
                rule_fired=rule.fired,
            )
        except Exception:  # noqa: BLE001
            logger.exception("fault event emit failed")
        try:
            from torchft_tpu_torch.utils import flightrecorder as _fr

            # fault-tagged flight record: torchft-torch-diagnose attributes a
            # chaos-killed replica from exactly this tag
            extra = {} if step is None else {"step": step}
            _fr.record(
                "fault",
                status="fault",
                fault=f"{site}:{rule.action}",
                site=site,
                action=rule.action,
                replica_id=replica or "",
                **extra,
            )
        except Exception:  # noqa: BLE001
            logger.exception("fault flight record failed")


#: The process-wide registry every production site consults.
FAULTS = FaultRegistry()


def check(
    site: str, replica: "Optional[str]" = None, step: "Optional[int]" = None
) -> None:
    """Module-level shorthand for ``FAULTS.check(...)`` (the form the
    production call sites use)."""
    FAULTS.check(site, replica=replica, step=step)


# ---------------------------------------------------------------------------
# TORCHFT_FAULTS spec
# ---------------------------------------------------------------------------

# fixed key order so format_spec output is stable and round-trips
_SPEC_KEYS = ("action", "replica", "step", "after_step", "prob", "times", "delay")
_DEFAULTS = FaultRule(site="_defaults_")


def parse_spec(spec: str) -> "List[FaultRule]":
    """Parse a ``TORCHFT_FAULTS`` spec string (grammar in module docstring)."""
    rules: "List[FaultRule]" = []
    for raw in spec.split(";"):
        raw = raw.strip()
        if not raw:
            continue
        site, _, rest = raw.partition(":")
        site = site.strip()
        if site not in KNOWN_SITES:
            logger.warning(
                "TORCHFT_FAULTS: site %r is not a known injection site %s — "
                "the rule only fires if something checks it explicitly",
                site,
                KNOWN_SITES,
            )
        kw: "Dict[str, Any]" = {}
        for item in rest.split(","):
            item = item.strip()
            if not item:
                continue
            key, sep, value = item.partition("=")
            key = key.strip()
            value = value.strip()
            if not sep or key not in _SPEC_KEYS:
                raise ValueError(
                    f"TORCHFT_FAULTS: bad entry {item!r} in rule {raw!r} "
                    f"(keys: {_SPEC_KEYS})"
                )
            if key in ("step", "after_step", "times"):
                kw[key] = int(value)
            elif key in ("prob", "delay"):
                kw[key] = float(value)
            else:
                kw[key] = value
        rules.append(FaultRule(site=site, **kw))
    return rules


def format_spec(rules: "List[FaultRule]") -> str:
    """Render rules back to the spec grammar (non-default fields only);
    ``parse_spec(format_spec(rules)) == rules``."""
    parts: "List[str]" = []
    for r in rules:
        kvs: "List[str]" = []
        for key in _SPEC_KEYS:
            value = getattr(r, key)
            if value == getattr(_DEFAULTS, key):
                continue
            if isinstance(value, float):
                kvs.append(f"{key}={value:g}")
            else:
                kvs.append(f"{key}={value}")
        parts.append(r.site + (":" + ",".join(kvs) if kvs else ""))
    return ";".join(parts)


def configure_from_env(env: "Optional[Dict[str, str]]" = None) -> bool:
    """Install the schedule from ``TORCHFT_FAULTS`` / ``TORCHFT_FAULTS_SEED``.

    Returns True if a schedule was installed.  Called once at import; a
    malformed spec raises (a chaos run with a silently-empty schedule would
    report a vacuous pass)."""
    if env is None:
        from torchft_tpu_torch.utils.env import env_str

        spec = env_str("TORCHFT_FAULTS")
        seed_raw = env_str("TORCHFT_FAULTS_SEED")
    else:
        spec = env.get("TORCHFT_FAULTS", "")
        seed_raw = env.get("TORCHFT_FAULTS_SEED")
    if not spec.strip():
        return False
    seed = int(seed_raw) if seed_raw else 0
    FAULTS.configure(parse_spec(spec), seed=seed)
    logger.info(
        "chaos schedule installed from TORCHFT_FAULTS (%d rules, seed=%d)",
        len(FAULTS.rules()),
        seed,
    )
    return True


configure_from_env()
