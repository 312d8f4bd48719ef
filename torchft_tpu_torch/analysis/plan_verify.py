"""tft-plan verifier: named invariants over any :class:`~.plan_ir.PlanIR`
— the dynamic half of plan validation, proved the tft-verify
way.

PyTorch port of ``torchft_tpu/analysis/plan_verify.py``.

Three legs, mirroring :mod:`torchft_tpu.analysis.model_checker` (JAX package):

1. :func:`verify_plan` — the invariant catalog, checked in a fixed
   severity order so a seeded bug's FIRST reported violation is its
   named invariant:

   ==================  ====================================================
   ``acyclic``         the distribution tree (tree edges) has no cycle
   ``single-parent``   every node has at most one inbound TREE edge
   ``root-reaches-all``  every node is reachable from the plan roots
   ``fanout-bound``    tree out-degree <= per-node capacity (else the
                       plan fanout; 0 = unbounded)
   ``full-coverage``   every consumer's ownership ranges tile
                       ``[0, units)`` with no gap
   ``single-owner``    ...and with no overlap (no unit arrives twice)
   ``byte-conservation``  a relay's outbound payload equals SOME inbound
                       payload unless the node is a requant boundary
   ``requant-boundary``  wire format changes only at declared boundaries
                       (DynamiQ's requant-at-boundaries, generalized)
   ``elastic-stability``  ``hosts:K`` group assignment of surviving
                       ranks is identical across world sizes
   ==================  ====================================================

2. :func:`explore_plans` — exhaustive enumeration over small worlds ×
   topologies × churn: every reduction topology to world 8, every
   serving membership to 6 servers × fanout × capacity overrides ×
   publisher counts (plus drop-one churn resynthesis), every stripe
   (sources × fragments × leaves) plus per-source failover requeue.
   All must verify clean.

3. :data:`PLAN_MUTATIONS` / :func:`check_plan_mutation` — seeded plan
   bugs (orphaned subtree, cycle, double owner, dropped fragment, ...)
   each caught by its named invariant; ``tft-verify --scenario plan``
   and tests/test_plan_verify.py gate on the full catalog.

The runtime complement is :func:`check_live` — behind
``TORCHFT_PLAN_VERIFY`` every live plan is validated at its
monotone-epoch commit point (reduction plan build, serving
tree_commit, stripe resolution), counting verdicts in
``torchft_plan_verify_total{plane,verdict}`` and emitting a
``plan.verify`` flight record so ``torchft-torch-diagnose`` can name a bad
plan (signal ``bad_plan``).  The hook OBSERVES — a rejected plan is
loud telemetry, never a wedge.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, replace
from typing import Any, Dict, Iterable, List, Mapping, Optional, Tuple

from torchft_tpu_torch.analysis import plan_ir as pir
from torchft_tpu_torch.ops import topology as topo_mod

__all__ = [
    "INVARIANTS",
    "PlanViolation",
    "PlanMutation",
    "PLAN_MUTATIONS",
    "verify_plan",
    "elastic_stability",
    "explore_plans",
    "check_plan_mutation",
    "enabled",
    "check_live",
    "base_serving_ir",
    "base_reduction_ir",
    "base_stripe_ir",
]

logger = logging.getLogger(__name__)

#: Catalog order IS severity order: :func:`verify_plan` sorts its output
#: by this index, so a mutated plan's first violation names the seeded
#: bug's invariant deterministically.
INVARIANTS: Tuple[str, ...] = (
    "acyclic",
    "single-parent",
    "root-reaches-all",
    "fanout-bound",
    "full-coverage",
    "single-owner",
    "byte-conservation",
    "requant-boundary",
    "elastic-stability",
)


@dataclass(frozen=True)
class PlanViolation:
    """One named-invariant failure; ``subject`` is the node/edge/range
    the violation anchors to."""

    invariant: str
    message: str
    subject: str = ""


# ---------------------------------------------------------------------------
# The verifier
# ---------------------------------------------------------------------------


def verify_plan(ir: pir.PlanIR) -> List[PlanViolation]:
    """All invariant violations in ``ir``, ordered by the
    :data:`INVARIANTS` severity index (then discovery order).  Raises
    ``ValueError`` on a malformed IR (dangling edge endpoint, range
    outside ``[0, units)``) — that is an adapter bug, not a plan bug."""

    ids = {n.id for n in ir.nodes}
    for e in ir.edges:
        if e.src not in ids or e.dst not in ids:
            raise ValueError(f"malformed plan: edge {e.src}->{e.dst} "
                             f"references unknown node")
    for o in ir.coverage:
        if o.consumer not in ids or not 0 <= o.lo <= o.hi <= ir.units:
            raise ValueError(f"malformed plan: ownership {o} out of "
                             f"[0, {ir.units}) for {o.consumer}")

    out: List[PlanViolation] = []
    out.extend(_check_acyclic(ir))
    out.extend(_check_single_parent(ir))
    out.extend(_check_reachability(ir))
    out.extend(_check_fanout(ir))
    out.extend(_check_coverage(ir))
    out.extend(_check_bytes(ir))
    out.extend(_check_requant(ir))
    order = {name: i for i, name in enumerate(INVARIANTS)}
    out.sort(key=lambda v: order[v.invariant])
    return out


def _check_acyclic(ir: pir.PlanIR) -> List[PlanViolation]:
    # Tree edges only: the pairwise inter-leader exchange and the
    # many-to-one reduce leg are bidirectional/converging by design —
    # it is the DISTRIBUTION tree that must never chase its own tail.
    adj: Dict[str, List[str]] = {n.id: [] for n in ir.nodes}
    for e in ir.edges:
        if e.tree:
            adj[e.src].append(e.dst)
    WHITE, GREY, BLACK = 0, 1, 2
    color = {n.id: WHITE for n in ir.nodes}
    for start in adj:
        if color[start] != WHITE:
            continue
        stack: List[Tuple[str, int]] = [(start, 0)]
        color[start] = GREY
        while stack:
            node, i = stack[-1]
            if i < len(adj[node]):
                stack[-1] = (node, i + 1)
                nxt = adj[node][i]
                if color[nxt] == GREY:
                    return [PlanViolation(
                        "acyclic",
                        f"transfer cycle through {nxt} (via {node})",
                        subject=nxt,
                    )]
                if color[nxt] == WHITE:
                    color[nxt] = GREY
                    stack.append((nxt, 0))
            else:
                color[node] = BLACK
                stack.pop()
    return []


def _check_single_parent(ir: pir.PlanIR) -> List[PlanViolation]:
    parents: Dict[str, List[str]] = {}
    for e in ir.edges:
        if e.tree:
            parents.setdefault(e.dst, []).append(e.src)
    return [
        PlanViolation(
            "single-parent",
            f"{dst} has {len(ps)} tree parents: {sorted(ps)}",
            subject=dst,
        )
        for dst, ps in sorted(parents.items())
        if len(ps) > 1
    ]


def _check_reachability(ir: pir.PlanIR) -> List[PlanViolation]:
    if not ir.roots:
        return []
    adj: Dict[str, List[str]] = {n.id: [] for n in ir.nodes}
    for e in ir.edges:
        adj[e.src].append(e.dst)
    seen = set(ir.roots)
    frontier = list(ir.roots)
    while frontier:
        node = frontier.pop()
        for nxt in adj.get(node, ()):
            if nxt not in seen:
                seen.add(nxt)
                frontier.append(nxt)
    lost = sorted(n.id for n in ir.nodes if n.id not in seen)
    if lost:
        return [PlanViolation(
            "root-reaches-all",
            f"{len(lost)} node(s) unreachable from roots "
            f"{sorted(ir.roots)}: {lost}",
            subject=lost[0],
        )]
    return []


def _check_fanout(ir: pir.PlanIR) -> List[PlanViolation]:
    out: List[PlanViolation] = []
    degree: Dict[str, int] = {}
    for e in ir.edges:
        if e.tree:
            degree[e.src] = degree.get(e.src, 0) + 1
    for n in ir.nodes:
        bound = n.capacity if n.capacity > 0 else ir.fanout
        deg = degree.get(n.id, 0)
        if bound > 0 and deg > bound:
            out.append(PlanViolation(
                "fanout-bound",
                f"{n.id} has {deg} tree children, bound {bound}"
                + (" (capacity)" if n.capacity > 0 else " (fanout)"),
                subject=n.id,
            ))
    return out


def _check_coverage(ir: pir.PlanIR) -> List[PlanViolation]:
    out: List[PlanViolation] = []
    rows: Dict[str, List[pir.Ownership]] = {c: [] for c in ir.consumers}
    for o in ir.coverage:
        rows.setdefault(o.consumer, []).append(o)
    for consumer in ir.consumers:
        spans = sorted(
            ((o.lo, o.hi) for o in rows[consumer] if o.hi > o.lo)
        )
        pos = 0
        for lo, hi in spans:
            if lo > pos:
                out.append(PlanViolation(
                    "full-coverage",
                    f"{consumer} misses {ir.unit} range [{pos}, {lo})",
                    subject=consumer,
                ))
            elif lo < pos:
                out.append(PlanViolation(
                    "single-owner",
                    f"{consumer} receives {ir.unit} range "
                    f"[{lo}, {min(pos, hi)}) more than once",
                    subject=consumer,
                ))
            pos = max(pos, hi)
        if pos < ir.units:
            out.append(PlanViolation(
                "full-coverage",
                f"{consumer} misses {ir.unit} range [{pos}, {ir.units})",
                subject=consumer,
            ))
    return out


def _check_bytes(ir: pir.PlanIR) -> List[PlanViolation]:
    out: List[PlanViolation] = []
    inbound: Dict[str, List[int]] = {}
    for e in ir.edges:
        if e.nbytes >= 0:
            inbound.setdefault(e.dst, []).append(e.nbytes)
    boundaries = set(ir.boundaries)
    for e in ir.edges:
        if e.nbytes < 0 or e.src in boundaries:
            continue
        seen = inbound.get(e.src)
        if seen and e.nbytes not in seen:
            out.append(PlanViolation(
                "byte-conservation",
                f"{e.src}->{e.dst} ({e.hop}) sends {e.nbytes} B but "
                f"{e.src} received {sorted(set(seen))} B and is not a "
                f"boundary",
                subject=f"{e.src}->{e.dst}",
            ))
    return out


def _check_requant(ir: pir.PlanIR) -> List[PlanViolation]:
    out: List[PlanViolation] = []
    inbound: Dict[str, List[str]] = {}
    for e in ir.edges:
        if e.wire:
            inbound.setdefault(e.dst, []).append(e.wire)
    boundaries = set(ir.boundaries)
    for e in ir.edges:
        if not e.wire or e.src in boundaries:
            continue
        seen = inbound.get(e.src)
        if seen and e.wire not in seen:
            out.append(PlanViolation(
                "requant-boundary",
                f"{e.src}->{e.dst} ({e.hop}) requantizes "
                f"{sorted(set(seen))} -> {e.wire!r} but {e.src} is not "
                f"a declared boundary",
                subject=f"{e.src}->{e.dst}",
            ))
    return out


# ---------------------------------------------------------------------------
# Elastic-rerank stability (cross-plan: hosts:K under resize)
# ---------------------------------------------------------------------------


def _assignment_stability(
    assignments: Mapping[int, Mapping[int, int]],
) -> List[PlanViolation]:
    """Core check behind :func:`elastic_stability`: for every pair of
    world sizes, the common rank prefix must map to the same group in
    both — a shrink/grow must never silently reshuffle survivors."""

    out: List[PlanViolation] = []
    worlds = sorted(assignments)
    for i, wa in enumerate(worlds):
        for wb in worlds[i + 1:]:
            a, b = assignments[wa], assignments[wb]
            for rank in range(min(wa, wb)):
                if a.get(rank) != b.get(rank):
                    out.append(PlanViolation(
                        "elastic-stability",
                        f"rank {rank} moves from group {a.get(rank)} "
                        f"(world {wa}) to group {b.get(rank)} "
                        f"(world {wb}) under resize",
                        subject=f"r{rank}",
                    ))
    return out


def elastic_stability(spec: str, worlds: Iterable[int]) -> List[PlanViolation]:
    """``hosts:K`` re-rank stability across ``worlds``: the group of a
    surviving rank must not depend on the world size (contiguous
    ``r // K`` guarantees it; explicit lists are rejected at parse time
    instead — this invariant is why)."""

    assignments: Dict[int, Dict[int, int]] = {}
    for world in worlds:
        topo = topo_mod.parse_topology(spec, world)
        if topo is None:
            assignments[world] = {r: 0 for r in range(world)}
        else:
            assignments[world] = {
                r: topo.group_index(r) for r in range(world)
            }
    return _assignment_stability(assignments)


# ---------------------------------------------------------------------------
# Base plans (shared by the mutation catalog and tests)
# ---------------------------------------------------------------------------

_PAYLOAD = 1 << 20


def base_serving_ir() -> pir.PlanIR:
    """7 servers (s0 capacity-3 override), 1 publisher, fanout 2:
    s0 -> {s1,s2,s3}, s1 -> {s4,s5}, s2 -> {s6}."""
    members = [
        {"replica_id": f"s{i}", "address": f"http://s{i}:1",
         "role": "server", "capacity": 3 if i == 0 else 0,
         "version": 4}
        for i in range(7)
    ]
    members.append({"replica_id": "p0", "address": "http://p0:1",
                    "role": "publisher", "version": 5})
    doc = pir.reference_serving_plan(members, fanout=2, epoch=3)
    return pir.serving_ir(doc, payload_nbytes=_PAYLOAD)


def base_reduction_ir() -> pir.PlanIR:
    """hosts:2 over world 6: leaders r0/r2/r4, 3 row-slices."""
    topo = topo_mod.parse_topology("hosts:2", 6)
    assert topo is not None
    return pir.reduction_ir(topo, wire="int8", slice_nbytes=64)


def base_stripe_ir(num_fragments: int = 6, num_leaves: int = 17) -> pir.PlanIR:
    """4 sources (primary + 3 max-step peers) striping the round-robin
    fragment layout."""
    sources = [f"http://src{i}:1" for i in range(4)]
    return pir.stripe_ir(sources, num_fragments, num_leaves, step=7)


# ---------------------------------------------------------------------------
# Seeded plan mutations
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PlanMutation:
    """One seeded plan bug: ``catches`` is the invariant whose FIRST
    violation must name it."""

    name: str
    catches: str
    plane: str
    doc: str


PLAN_MUTATIONS: Tuple[PlanMutation, ...] = (
    PlanMutation(
        "orphan_subtree", "root-reaches-all", "serving",
        "drop an interior relay's inbound edge: its whole subtree "
        "silently stops receiving publishes",
    ),
    PlanMutation(
        "cycle_edge", "acyclic", "serving",
        "reparent a relay under its own descendant: the payload chases "
        "its own tail and never commits",
    ),
    PlanMutation(
        "two_parents", "single-parent", "serving",
        "a relay acquires a second tree parent: double pulls, "
        "non-deterministic version adoption",
    ),
    PlanMutation(
        "fanout_overflow", "fanout-bound", "serving",
        "a child lands on an already-full parent: the relay exceeds its "
        "capacity/fanout budget",
    ),
    PlanMutation(
        "requant_mid_hop", "requant-boundary", "serving",
        "a mid-tree relay changes wire format: serving hops must relay "
        "digest-verified bytes unchanged",
    ),
    PlanMutation(
        "bytes_vanish", "byte-conservation", "serving",
        "a relay forwards fewer bytes than it received without being a "
        "declared boundary",
    ),
    PlanMutation(
        "double_owner", "single-owner", "reduction",
        "a leader is assigned the same row-slice from two peer leaders: "
        "one slice accumulates twice",
    ),
    PlanMutation(
        "dropped_fragment", "full-coverage", "stripe",
        "one fragment's leaf slots vanish from the stripe assignment: "
        "the healer never receives them",
    ),
    PlanMutation(
        "stripe_gap", "full-coverage", "stripe",
        "a stripe range shrinks by one leaf: an off-by-one leaves a "
        "hole in the healed state",
    ),
    PlanMutation(
        "stripe_overlap", "single-owner", "stripe",
        "a stripe range grows into its neighbour: two sources own the "
        "same leaf slot",
    ),
    PlanMutation(
        "rerank_drift", "elastic-stability", "reduction",
        "hosts:K group assignment depends on world size: an elastic "
        "resize silently reshuffles surviving ranks across groups",
    ),
)


def _drop_edge(ir: pir.PlanIR, src: str, dst: str) -> pir.PlanIR:
    kept = tuple(
        e for e in ir.edges if not (e.src == src and e.dst == dst)
    )
    if len(kept) == len(ir.edges):
        raise AssertionError(f"mutation expected edge {src}->{dst}")
    return replace(ir, edges=kept)


def _rewire(ir: pir.PlanIR, src: str, dst: str, **changes: Any) -> pir.PlanIR:
    edges = []
    hit = False
    for e in ir.edges:
        if e.src == src and e.dst == dst:
            e = replace(e, **changes)
            hit = True
        edges.append(e)
    if not hit:
        raise AssertionError(f"mutation expected edge {src}->{dst}")
    return replace(ir, edges=tuple(edges))


def check_plan_mutation(name: str) -> List[PlanViolation]:
    """Apply one seeded plan bug to its base plan and return the
    verifier's (ordered) violations — the gate asserts the first names
    ``catches``."""

    if name == "orphan_subtree":
        return verify_plan(_drop_edge(base_serving_ir(), "s0", "s1"))
    if name == "cycle_edge":
        ir = _drop_edge(base_serving_ir(), "s0", "s1")
        return verify_plan(replace(ir, edges=ir.edges + (
            pir.PlanEdge("s4", "s1", "serving.relay", "frag", tree=True,
                         nbytes=_PAYLOAD),
        )))
    if name == "two_parents":
        ir = base_serving_ir()
        return verify_plan(replace(ir, edges=ir.edges + (
            pir.PlanEdge("s3", "s4", "serving.relay", "frag", tree=True,
                         nbytes=_PAYLOAD),
        )))
    if name == "fanout_overflow":
        ir = _drop_edge(base_serving_ir(), "s2", "s6")
        return verify_plan(replace(ir, edges=ir.edges + (
            pir.PlanEdge("s1", "s6", "serving.relay", "frag", tree=True,
                         nbytes=_PAYLOAD),
        )))
    if name == "requant_mid_hop":
        return verify_plan(
            _rewire(base_serving_ir(), "s1", "s4", wire="fp8")
        )
    if name == "bytes_vanish":
        return verify_plan(
            _rewire(base_serving_ir(), "s2", "s6", nbytes=_PAYLOAD // 2)
        )
    if name == "double_owner":
        ir = base_reduction_ir()
        return verify_plan(replace(ir, coverage=ir.coverage + (
            pir.Ownership("r0", 1, 2, via="r4"),
        )))
    if name == "dropped_fragment":
        ir = base_stripe_ir()
        victim = ir.coverage[0].via  # the primary's nominal fragment 0
        return verify_plan(replace(ir, coverage=tuple(
            o for o in ir.coverage if o.via != victim
        )))
    if name == "stripe_gap":
        ir = base_stripe_ir(num_fragments=1)  # one contiguous run
        o = ir.coverage[0]
        return verify_plan(replace(ir, coverage=(
            replace(o, hi=o.hi - 1),
        ) + ir.coverage[1:]))
    if name == "stripe_overlap":
        ir = base_stripe_ir()
        last = ir.coverage[-1]
        return verify_plan(replace(ir, coverage=ir.coverage[:-1] + (
            replace(last, hi=last.hi + 1),
        )))
    if name == "rerank_drift":
        # a (buggy) assignment that depends on world size: ranks shift
        # by one group on grow — exactly what hosts:K must never do
        return _assignment_stability({
            4: {r: r // 2 for r in range(4)},
            6: {r: (r + 1) // 2 for r in range(6)},
        })
    raise KeyError(f"unknown plan mutation {name!r}")


# ---------------------------------------------------------------------------
# Exhaustive enumeration: small worlds x topologies x churn
# ---------------------------------------------------------------------------


def _serving_members(
    n_servers: int, n_pubs: int, caps: Mapping[int, int]
) -> List[Dict[str, Any]]:
    members: List[Dict[str, Any]] = [
        {"replica_id": f"s{i}", "address": f"http://s{i}:1",
         "role": "server", "capacity": caps.get(i, 0), "version": 3}
        for i in range(n_servers)
    ]
    for j in range(n_pubs):
        members.append({"replica_id": f"p{j}", "address": f"http://p{j}:1",
                        "role": "publisher", "version": 5 + j})
    return members


def explore_plans() -> Dict[str, Any]:
    """Enumerate every small-world plan on all three planes (plus churn
    and failover variants) and verify each.  Returns ``{"plans": N,
    "violations": [...]}`` — the gate requires an empty list."""

    plans = 0
    violations: List[PlanViolation] = []

    def _verify(ir: pir.PlanIR) -> None:
        nonlocal plans
        plans += 1
        violations.extend(verify_plan(ir))

    # -- reduction: hosts:K and explicit groups over worlds 1..8
    for world in range(1, 9):
        for k in range(1, 5):
            topo = topo_mod.parse_topology(f"hosts:{k}", world)
            if topo is not None:
                _verify(pir.reduction_ir(topo, slice_nbytes=64))
    for spec, world in (
        ("0,1;2,3", 4), ("0,2;1,3", 4), ("0;1;2", 3),
        ("1,2,0;3,4", 5), ("0,1,2,3;4,5;6,7", 8),
    ):
        topo = topo_mod.parse_topology(spec, world)
        if topo is not None:
            _verify(pir.reduction_ir(topo, slice_nbytes=64))
    # elastic resize stability of the adaptive grammar
    for k in range(1, 5):
        plans += 1
        violations.extend(elastic_stability(f"hosts:{k}", range(1, 9)))

    # -- serving: membership x fanout x capacity override x publishers,
    # plus drop-one churn resynthesis (sorted order is stable under
    # churn, so the re-plan must verify too)
    for n in range(0, 7):
        cap_patterns: List[Dict[int, int]] = [{}]
        if n >= 1:
            cap_patterns.append({0: 1})
        if n >= 2:
            cap_patterns.append({1: 5})
        for fanout in (1, 2, 3):
            for caps in cap_patterns:
                for n_pubs in (0, 1, 2):
                    members = _serving_members(n, n_pubs, caps)
                    doc = pir.reference_serving_plan(members, fanout)
                    _verify(pir.serving_ir(doc, payload_nbytes=_PAYLOAD))
    for n in (3, 5):
        members = _serving_members(n, 1, {})
        for dropped in range(n):
            churned = [
                m for m in members if m["replica_id"] != f"s{dropped}"
            ]
            doc = pir.reference_serving_plan(churned, 2)
            _verify(pir.serving_ir(doc, payload_nbytes=_PAYLOAD))

    # -- stripe: sources x fragments x leaves, plus per-source failover
    for nsrc in range(1, 6):
        sources = [f"http://src{i}:1" for i in range(nsrc)]
        for nfrag in (1, 2, 3, 5, 8):
            for leaves in (1, 2, 3, 5, 8, 13):
                ir = pir.stripe_ir(sources, nfrag, leaves)
                _verify(ir)
                for dead in sources[1:]:
                    _verify(pir.stripe_reassign(ir, dead))

    return {"plans": plans, "violations": violations}


# ---------------------------------------------------------------------------
# Runtime hook: TORCHFT_PLAN_VERIFY
# ---------------------------------------------------------------------------


def enabled() -> bool:
    """Live-plan validation armed?  Call sites gate IR construction on
    this so the default path pays one env read, nothing else."""
    from torchft_tpu_torch.utils.env import env_bool

    return env_bool("TORCHFT_PLAN_VERIFY", False)


def check_live(ir: pir.PlanIR) -> Optional[PlanViolation]:
    """Validate one live plan at its commit point.  Observe-only: a
    rejection increments ``torchft_plan_verify_total{plane,
    verdict="reject"}``, lands a ``plan.verify`` flight record (the
    ``bad_plan`` diagnose signal), and logs at ERROR — it never raises
    into the committing path (degrade loudly, never wedge).  Returns
    the first violation for callers that want to surface it."""

    from torchft_tpu_torch.utils import flightrecorder as _flightrec
    from torchft_tpu_torch.utils import metrics as _metrics

    try:
        violations = verify_plan(ir)
    except Exception as e:  # noqa: BLE001 - adapter bug must not wedge
        logger.exception("plan verifier errored on %s plan: %s", ir.plane, e)
        _metrics.PLAN_VERIFY_TOTAL.labels(
            plane=ir.plane, verdict="error"
        ).inc()
        return None
    first = violations[0] if violations else None
    verdict = "reject" if first else "accept"
    _metrics.PLAN_VERIFY_TOTAL.labels(plane=ir.plane, verdict=verdict).inc()
    _flightrec.RECORDER.record(
        "plan.verify",
        status="error" if first else "ok",
        step=ir.epoch,
        plane=ir.plane,
        verdict=verdict,
        invariant=first.invariant if first else "",
        detail=first.message if first else "",
    )
    if first:
        logger.error(
            "rejected live %s plan (epoch %s): %s violated — %s",
            ir.plane, ir.epoch, first.invariant, first.message,
        )
    return first
