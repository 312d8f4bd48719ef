"""tft-plan: one IR for every "who talks to whom" decision.

PyTorch port of ``torchft_tpu/analysis/plan_ir.py`` (stdlib only, on the
port's ``ops/topology.py``).

Three live subsystems independently derive peer-communication
structure — reduction plans (:mod:`torchft_tpu_torch.ops.topology`, the
4-hop hierarchy), serving trees (the native lighthouse's BFS in
``native/lighthouse.cc``), and heal stripe assignment (first-K roster
order feeding :func:`torchft_tpu_torch.checkpointing.fragments.striped_fetch`).
None of their outputs were machine-checked, even though a malformed
plan silently drops fragments, orphans subtrees, or double-owns a
slice.  This module is the common *Plan IR* those subsystems adapt
into, and the contract ROADMAP item 4's synthesizer will emit directly:

- :class:`PlanNode` — a participant (host, role, per-node capacity);
- :class:`PlanEdge` — one directed transfer (hop kind, wire format,
  tree membership, payload bytes);
- :class:`Ownership` — one half-open ``[lo, hi)`` unit range a consumer
  receives *via* a named producer ("" = produced locally);
- :class:`PlanIR` — the whole plan: plane name, monotone epoch, the
  unit the coverage ranges count (slices / leaves / payloads), nodes,
  edges, coverage, roots, consumers, requant boundaries, fanout bound.

The three adapters (:func:`reduction_ir`, :func:`serving_ir`,
:func:`stripe_ir`) express each subsystem's live plan as IR;
:mod:`torchft_tpu_torch.analysis.plan_verify` asserts the named invariants
over any IR regardless of which plane produced it.
:func:`reference_serving_plan` is the pure-Python mirror of the native
BFS slot-queue (``rpc_serving_plan``) so C++ and Python can never
drift on tree shape — the cross-language parity test pins them to each
other.  :func:`stripe_roster` / :func:`stripe_source_cohort` are the
one copy of the first-K roster math ``manager.py`` previously inlined
twice.

Everything here is stdlib-only and import-light: the lint/verify tier
and the live runtime hooks both load it, and a plan is validated in
microseconds (worlds are small; the IR is tuples of frozen
dataclasses).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Dict, Iterable, List, Mapping, Sequence, Tuple

from torchft_tpu_torch.ops import topology as topo_mod

__all__ = [
    "PlanNode",
    "PlanEdge",
    "Ownership",
    "PlanIR",
    "reduction_ir",
    "serving_ir",
    "stripe_ir",
    "stripe_reassign",
    "reference_serving_plan",
    "stripe_roster",
    "stripe_source_cohort",
    "LINK_SNAPSHOT_FIELDS",
    "LINK_ROW_KEYS",
]


# ---------------------------------------------------------------------------
# The IR proper
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PlanNode:
    """One plan participant.

    ``capacity`` is the per-node tree fan-out override (0 = use the
    plan-wide :attr:`PlanIR.fanout`; both 0 = unbounded)."""

    id: str
    host: str = ""
    role: str = ""
    capacity: int = 0


@dataclass(frozen=True)
class PlanEdge:
    """One directed transfer ``src -> dst``.

    ``hop`` is the schedule stage (``intra.reduce``, ``serving.relay``,
    ``heal.stripe``, ...); ``wire`` the on-the-wire format crossing this
    edge; ``tree`` marks edges that form the plan's distribution tree
    (single-parent / fanout invariants apply to tree edges only —
    pairwise exchange legs are not tree edges); ``nbytes`` the payload
    size when known (-1 = unknown, byte-conservation skips it)."""

    src: str
    dst: str
    hop: str
    wire: str = ""
    tree: bool = False
    nbytes: int = -1


@dataclass(frozen=True)
class Ownership:
    """Consumer ``consumer`` receives units ``[lo, hi)`` via node
    ``via`` ("" = produced locally, no wire involved)."""

    consumer: str
    lo: int
    hi: int
    via: str = ""


@dataclass(frozen=True)
class PlanIR:
    """A complete, verifiable communication plan.

    ``unit`` names what the coverage ranges count (``slice`` for
    reduction row-slices, ``leaf`` for heal stripe leaf slots,
    ``payload`` for the serving tree's single artifact); ``units`` is
    the total range ``[0, units)`` every consumer must end up owning
    exactly once.  ``roots`` are the nodes data originates from for the
    reachability invariant; ``consumers`` the nodes the coverage map
    must satisfy; ``boundaries`` the nodes allowed to change wire
    format (DynamiQ's requant-at-boundaries); ``fanout`` the plan-wide
    tree fan-out bound (0 = unbounded)."""

    plane: str
    epoch: int
    unit: str
    units: int
    nodes: Tuple[PlanNode, ...]
    edges: Tuple[PlanEdge, ...]
    coverage: Tuple[Ownership, ...]
    roots: Tuple[str, ...] = ()
    consumers: Tuple[str, ...] = ()
    boundaries: Tuple[str, ...] = ()
    fanout: int = 0

    def node(self, node_id: str) -> PlanNode:
        for n in self.nodes:
            if n.id == node_id:
                return n
        raise KeyError(node_id)


# ---------------------------------------------------------------------------
# Adapter 1: reduction plans (ops/topology.synthesize_plan)
# ---------------------------------------------------------------------------


def reduction_ir(
    topo: "topo_mod.Topology",
    *,
    epoch: int = 0,
    wire: str = "int8",
    slice_nbytes: int = -1,
) -> PlanIR:
    """The fleet-wide view of :func:`topology.synthesize_plan`.

    Per-rank plans are rank-local hop schedules; the IR is the union of
    every rank's sends as directed edges, with the coverage map stating
    how each rank ends up holding ALL ``n_groups`` reduced row-slices:
    leaders reduce their own slice locally, gather the others from peer
    leaders, and members receive the whole bundle over the broadcast
    edge.  Only ``intra.bcast`` is a distribution-TREE edge — the
    ``intra.reduce`` leg is a many-to-one gather and the inter-leader
    exchange is pairwise-bidirectional by design, so the tree
    invariants (acyclic / single-parent / fanout) deliberately do not
    apply to them.  Leaders are the requant boundaries (hop-boundary
    requant is theirs by construction; the wire format is fleet-uniform
    today — per-hop wires arrive with the ROADMAP item 5 synthesizer)."""

    n = topo.world
    groups = topo.n_groups
    leaders = topo.leaders()

    def rid(rank: int) -> str:
        return f"r{rank}"

    nodes = tuple(
        PlanNode(
            id=rid(r),
            host=f"g{topo.group_index(r)}",
            role="leader" if r in leaders else "member",
        )
        for r in range(n)
    )

    edges: List[PlanEdge] = []
    total = slice_nbytes * groups if slice_nbytes >= 0 else -1
    for gidx in range(groups):
        lead = topo.leader(gidx)
        for m in topo.members(gidx):
            edges.append(
                PlanEdge(rid(m), rid(lead), "intra.reduce", wire,
                         tree=False, nbytes=total)
            )
        plan = topo_mod.synthesize_plan(topo, lead)
        for hop in plan.hops:
            if hop.name in ("inter.exchange", "inter.gather"):
                for peer in hop.sends:
                    edges.append(
                        PlanEdge(rid(lead), rid(peer), hop.name, wire,
                                 tree=False, nbytes=slice_nbytes)
                    )
        for m in topo.members(gidx):
            edges.append(
                PlanEdge(rid(lead), rid(m), "intra.bcast", wire,
                         tree=True, nbytes=total)
            )

    coverage: List[Ownership] = []
    for gidx in range(groups):
        lead = topo.leader(gidx)
        for h in range(groups):
            coverage.append(
                Ownership(rid(lead), h, h + 1,
                          via="" if h == gidx else rid(topo.leader(h)))
            )
        for m in topo.members(gidx):
            coverage.append(Ownership(rid(m), 0, groups, via=rid(lead)))

    return PlanIR(
        plane="reduction",
        epoch=epoch,
        unit="slice",
        units=groups,
        nodes=nodes,
        edges=tuple(edges),
        coverage=tuple(coverage),
        # rank 0 is always its group's leader (leader = min rank);
        # member -> leader -> all leaders -> their members covers the
        # whole digraph from this single origin.
        roots=(rid(0),),
        consumers=tuple(rid(r) for r in range(n)),
        boundaries=tuple(rid(lv) for lv in leaders),
        fanout=0,
    )


# ---------------------------------------------------------------------------
# Adapter 2: serving trees (native lighthouse rpc_serving_plan)
# ---------------------------------------------------------------------------


def serving_ir(
    doc: Mapping[str, Any],
    *,
    payload_nbytes: int = -1,
    wire: str = "frag",
) -> PlanIR:
    """Express a ``serving_plan`` document (native BFS output, or the
    :func:`reference_serving_plan` mirror) as IR.

    Servers form the relay tree (parent address -> child); publishers
    are the roots, with a ``serving.source`` edge from the max-version
    publisher to the parentless server.  The serving plane never
    requantizes (every hop relays the same digest-verified fragment
    bytes), so ``boundaries`` is empty and ``wire`` is uniform."""

    raw_nodes = list(doc.get("nodes") or [])
    raw_pubs = list(doc.get("publishers") or [])
    fanout = int(doc.get("fanout") or 0)
    root_source = str(doc.get("root_source") or "")

    nodes: List[PlanNode] = []
    by_addr: Dict[str, str] = {}
    for rn in raw_nodes:
        nid = str(rn["replica_id"])
        addr = str(rn.get("address") or "")
        nodes.append(
            PlanNode(id=nid, host=addr, role="server",
                     capacity=int(rn.get("capacity") or 0))
        )
        by_addr[addr] = nid
    pub_ids: Dict[str, str] = {}
    for rp in raw_pubs:
        pid = f"pub:{rp['replica_id']}"
        addr = str(rp.get("address") or "")
        nodes.append(PlanNode(id=pid, host=addr, role="publisher"))
        pub_ids[addr] = pid

    edges: List[PlanEdge] = []
    coverage: List[Ownership] = []
    consumers: List[str] = []
    for rn in raw_nodes:
        nid = str(rn["replica_id"])
        consumers.append(nid)
        parent_addr = str(rn.get("parent") or "")
        if parent_addr:
            edges.append(
                PlanEdge(by_addr[parent_addr], nid, "serving.relay", wire,
                         tree=True, nbytes=payload_nbytes)
            )
            coverage.append(Ownership(nid, 0, 1, via=by_addr[parent_addr]))
        elif root_source and root_source in pub_ids:
            edges.append(
                PlanEdge(pub_ids[root_source], nid, "serving.source", wire,
                         tree=True, nbytes=payload_nbytes)
            )
            coverage.append(Ownership(nid, 0, 1, via=pub_ids[root_source]))
        else:
            # no publisher yet: the root server holds whatever it has
            coverage.append(Ownership(nid, 0, 1, via=""))

    if pub_ids:
        roots: Tuple[str, ...] = tuple(pub_ids[a] for a in sorted(pub_ids))
    else:
        roots = tuple(
            str(rn["replica_id"])
            for rn in raw_nodes
            if not str(rn.get("parent") or "")
        )

    return PlanIR(
        plane="serving",
        epoch=int(doc.get("epoch") or 0),
        unit="payload",
        units=1,
        nodes=tuple(nodes),
        edges=tuple(edges),
        coverage=tuple(coverage),
        roots=roots,
        consumers=tuple(consumers),
        boundaries=(),
        fanout=fanout,
    )


def reference_serving_plan(
    members: Iterable[Mapping[str, Any]],
    fanout: int,
    *,
    epoch: int = 0,
) -> Dict[str, Any]:
    """Pure-Python mirror of the native lighthouse's BFS slot-queue
    (``rpc_serving_plan`` in ``native/lighthouse.cc``).

    ``members`` carry ``replica_id`` / ``address`` / ``role`` and
    optional ``capacity`` / ``version`` / ``version_ms``.  Iteration is
    replica_id order (the native side walks a ``std::map``), node i's
    parent is the earliest node with a free child slot (per-node
    capacity, else ``fanout``), and the root source is the max-version
    publisher with first-in-order winning ties (strict ``>``).  The
    cross-language parity test pins this function to the native output
    — change one side and tier-1 breaks."""

    ordered = sorted(members, key=lambda m: str(m["replica_id"]))
    servers = [m for m in ordered if str(m.get("role") or "") != "publisher"]
    publishers = [m for m in ordered if str(m.get("role") or "") == "publisher"]

    root_source = ""
    root_version = -1
    pubs_out: List[Dict[str, Any]] = []
    for p in publishers:
        version = int(p.get("version") or 0)
        pubs_out.append(
            {
                "replica_id": str(p["replica_id"]),
                "address": str(p.get("address") or ""),
                "version": version,
                "version_ms": int(p.get("version_ms") or 0),
            }
        )
        if version > root_version:
            root_version = version
            root_source = str(p.get("address") or "")

    n = len(servers)
    depth = [0] * n
    children = [0] * n
    parent = [""] * n
    # BFS slot queue: (server index, remaining child slots)
    slots: List[List[int]] = []
    head = 0
    for i in range(n):
        cap = int(servers[i].get("capacity") or 0)
        cap = cap if cap > 0 else fanout
        if i > 0:
            while head < len(slots) and slots[head][1] <= 0:
                head += 1
            if head < len(slots):
                pi = slots[head][0]
                slots[head][1] -= 1
                parent[i] = str(servers[pi].get("address") or "")
                depth[i] = depth[pi] + 1
                children[pi] += 1
        slots.append([i, cap])

    nodes_out: List[Dict[str, Any]] = []
    for i in range(n):
        nodes_out.append(
            {
                "replica_id": str(servers[i]["replica_id"]),
                "address": str(servers[i].get("address") or ""),
                "parent": parent[i],
                "depth": depth[i],
                "children": children[i],
                "capacity": int(servers[i].get("capacity") or 0),
                "version": int(servers[i].get("version") or 0),
            }
        )
    return {
        "epoch": epoch,
        "fanout": fanout,
        "root_source": root_source,
        "publishers": pubs_out,
        "nodes": nodes_out,
        "depth": max(depth) if depth else 0,
    }


# ---------------------------------------------------------------------------
# Adapter 3: heal stripe assignment (checkpointing striped fetch)
# ---------------------------------------------------------------------------


def stripe_roster(
    participants: Sequence[Any],
    max_step: int,
    primary_index: int,
    max_sources: int,
) -> List[str]:
    """The healer's stripe-candidate pick: addresses of the first
    ``max_sources - 1`` max-step roster entries beyond the primary, in
    replica-rank order.  The ONE copy of the math ``manager.py``'s
    ``_resolve_stripe_sources`` and the IR adapter both consume — the
    healer and the verifier can not disagree on who stripes."""

    out: List[str] = []
    for i, p in enumerate(participants):
        if not isinstance(p, dict):
            continue
        if i == primary_index:
            continue
        if p.get("step", -1) != max_step:
            continue
        addr = str(p.get("address") or "")
        if addr:
            out.append(addr)
        if len(out) >= max_sources - 1:
            break
    return out

def stripe_source_cohort(
    participants: Sequence[Any],
    max_step: int,
    max_sources: int,
) -> List[str]:
    """Replica ids of the first ``max_sources`` max-step participants in
    roster order — the superset any healer's :func:`stripe_roster` pick
    can reach, computed identically on every peer (the source side's
    "should I stage fragments?" test)."""

    out: List[str] = []
    for p in participants:
        if not isinstance(p, dict) or p.get("step") != max_step:
            continue
        out.append(str(p.get("replica_id") or ""))
        if len(out) >= max_sources:
            break
    return out


def _fragment_slot_runs(
    frag_index: int, num_leaves: int, num_fragments: int
) -> List[Tuple[int, int]]:
    """Fragment ``frag_index``'s round-robin leaf slots
    (``serialization.split_chunks`` layout: slot s belongs to fragment
    ``s % num_fragments``) as half-open runs."""

    slots = list(range(frag_index, num_leaves, num_fragments))
    runs: List[Tuple[int, int]] = []
    for s in slots:
        if runs and runs[-1][1] == s:
            runs[-1] = (runs[-1][0], s + 1)
        else:
            runs.append((s, s + 1))
    return runs


def stripe_ir(
    sources: Sequence[str],
    num_fragments: int,
    num_leaves: int,
    *,
    step: int = 0,
    healer: str = "healer",
) -> PlanIR:
    """The striped heal receive as IR.

    ``sources[0]`` is the PRIMARY (its manifest defines truth); every
    source holds bitwise-replicated state, so the live fetch runs a
    dynamic work queue.  The IR records the *nominal* static assignment
    the queue starts from — fragment f via ``sources[f % len(sources)]``
    — which is exactly the coverage contract the dynamic schedule must
    preserve under failover (:func:`stripe_reassign` models a source
    death).  Coverage unit is the global leaf slot; fragment f owns the
    round-robin slot set ``range(f, num_leaves, num_fragments)``."""

    if not sources:
        raise ValueError("stripe plan: no sources")
    srcs = [str(s) for s in sources]
    nodes = [
        PlanNode(id=s, host=s, role="primary" if i == 0 else "source")
        for i, s in enumerate(srcs)
    ]
    nodes.append(PlanNode(id=healer, role="healer"))
    edges = tuple(
        PlanEdge(s, healer, "heal.primary" if i == 0 else "heal.stripe",
                 "frag", tree=(i == 0))
        for i, s in enumerate(srcs)
    )
    coverage: List[Ownership] = []
    for f in range(num_fragments):
        via = srcs[f % len(srcs)]
        for lo, hi in _fragment_slot_runs(f, num_leaves, num_fragments):
            coverage.append(Ownership(healer, lo, hi, via=via))
    return PlanIR(
        plane="stripe",
        epoch=step,
        unit="leaf",
        units=num_leaves,
        nodes=tuple(nodes),
        edges=edges,
        coverage=tuple(coverage),
        roots=tuple(srcs),
        consumers=(healer,),
        boundaries=(),
        fanout=0,
    )


def stripe_reassign(ir: PlanIR, dead: str) -> PlanIR:
    """Model per-fragment failover: source ``dead``'s coverage moves to
    the primary (``roots[0]``), its edge drops.  The result must still
    verify — that is the failover property test."""

    primary = ir.roots[0]
    if dead == primary:
        raise ValueError("the primary cannot fail over to itself")
    return replace(
        ir,
        nodes=tuple(n for n in ir.nodes if n.id != dead),
        edges=tuple(e for e in ir.edges if dead not in (e.src, e.dst)),
        coverage=tuple(
            replace(o, via=primary) if o.via == dead else o
            for o in ir.coverage
        ),
        roots=tuple(r for r in ir.roots if r != dead),
    )


# ---------------------------------------------------------------------------
# Frozen synthesizer input contract: LinkMatrix.snapshot()
# ---------------------------------------------------------------------------

#: Field names of ``utils.linkstats.LinkStat`` — the in-process snapshot
#: row the future plan synthesizer (ROADMAP item 4) consumes.  A rename
#: breaks tests/test_linkstats.py's contract gate, not the synthesizer.
LINK_SNAPSHOT_FIELDS: Tuple[str, ...] = (
    "peer",
    "plane",
    "local",
    "goodput_bps",
    "rtt_p50_ms",
    "rtt_p99_ms",
    "samples",
    "bytes_total",
    "age_s",
)

#: Key names of ``LinkStat.to_dict()`` — the `/links.json` wire row the
#: lighthouse aggregates fleet-wide (note the deliberate short names:
#: ``rtt_ms`` carries the p50, ``bytes`` the byte total).
LINK_ROW_KEYS: Tuple[str, ...] = (
    "peer",
    "plane",
    "local",
    "goodput_bps",
    "rtt_ms",
    "rtt_p99_ms",
    "samples",
    "bytes",
    "age_s",
)
