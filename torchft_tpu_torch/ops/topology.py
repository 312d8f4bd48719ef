"""Declarative wire topology + synthesized multi-hop reduction plans.

Multi-region DiLoCo lives at 10-100 ms RTT, where the flat ring's N-1
serialized hops dominate the outer sync (ROADMAP item 3).  DynamiQ
(PAPERS.md) shows the right shape for compressed collectives at WAN
scale — hierarchical intra-host reduce, inter-host exchange among host
leaders, intra-host broadcast, requantizing at hop boundaries — and PCCL
argues the schedule should be a *synthesized plan* over a declarative
topology, not hard-coded.  This module is that layer:

- :class:`Topology` — a partition of the collective's ranks into host
  (or slice/region) groups, parsed from ``TORCHFT_TOPOLOGY``;
- :func:`synthesize_plan` — turns (topology, rank) into a
  :class:`ReductionPlan`: the ordered hop schedule this rank executes,
  with peers resolved per hop.  ``ops/collectives.py`` executes the plan
  per pipeline chunk; ``parallel/process_group.py`` consults the same
  descriptor to charge ``TORCHFT_WIRE_RTT_MS`` only on messages that
  cross a group boundary.

``TORCHFT_TOPOLOGY`` grammar::

    (unset) | "flat"      no hierarchy: today's flat schedule, and every
                          peer counts as inter-group for the RTT model
                          (a flat ring across regions pays RTT per hop)
    "hosts:K"             contiguous groups of K ranks (rank r is in
                          group r // K); adapts to any world size, so it
                          survives elastic shrink/grow re-ranking
    "0,1;2,3"             explicit groups (every rank 0..world-1 exactly
                          once); rejected loudly on a world-size mismatch,
                          so only use it for fixed-world jobs/tests

The hierarchical plan (m groups over w ranks, rows sliced per *group*):

1. ``intra.reduce``  — members quantize their full chunk and send it to
   their group leader; the leader dequant-accumulates members over its
   own raw-f32 contribution (group partial sum, one quantization of
   member data).
2. ``inter.exchange`` — leaders requantize each foreign group's row
   slice of the partial sum (hop-boundary requant) and pairwise-exchange
   with the other leaders; each leader fully reduces its own slice.
3. ``inter.gather``  — leaders exchange their reduced, requantized
   slices so every leader holds all slices.
4. ``intra.bcast``   — leaders ship the reduced slice bundle to members;
   everyone dequantizes the same bytes, so results are bit-identical
   across ALL ranks.

Per inter-host link that is 2 serialized messages per chunk instead of
the flat schedule's 2*(w-1) — the RTT bill shrinks by ~w/m while the
inter-host payload shrinks to one group-reduced copy per host.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from torchft_tpu_torch.utils.env import env_str

__all__ = [
    "Topology",
    "Hop",
    "ReductionPlan",
    "parse_topology",
    "resolve_topology",
    "synthesize_plan",
]


class Topology:
    """A partition of ranks ``0..world-1`` into host/slice groups.

    Group order is schedule-significant (group ``g`` owns row-slice
    ``g``; leaders exchange round-robin by group index), so it is fixed
    at parse time and must agree across ranks — like every other
    cross-rank knob (``TORCHFT_QUANT_WIRE``, chunking), divergence fails
    loudly mid-collective rather than silently corrupting.
    """

    def __init__(self, groups: "Sequence[Sequence[int]]") -> None:
        self.groups: "Tuple[Tuple[int, ...], ...]" = tuple(
            tuple(g) for g in groups
        )
        if not self.groups or not all(self.groups):
            raise ValueError("topology needs at least one non-empty group")
        ranks = [r for g in self.groups for r in g]
        self.world = len(ranks)
        if sorted(ranks) != list(range(self.world)):
            raise ValueError(
                f"topology groups must partition ranks 0..{self.world - 1} "
                f"exactly once, got {self.groups}"
            )
        self._group_of = {r: gi for gi, g in enumerate(self.groups) for r in g}

    @property
    def n_groups(self) -> int:
        return len(self.groups)

    def group_index(self, rank: int) -> int:
        return self._group_of[rank]

    def leader(self, gidx: int) -> int:
        """Group leader = the group's lowest rank (deterministic across
        ranks with no extra coordination)."""
        return min(self.groups[gidx])

    def leaders(self) -> "List[int]":
        return [self.leader(g) for g in range(self.n_groups)]

    def members(self, gidx: int) -> "List[int]":
        """Non-leader ranks of a group, in rank order."""
        lead = self.leader(gidx)
        return sorted(r for r in self.groups[gidx] if r != lead)

    def inter(self, a: int, b: int) -> bool:
        """True when ``a`` and ``b`` sit across a host/slice boundary."""
        return self._group_of[a] != self._group_of[b]

    def describe(self) -> str:
        return ";".join(",".join(str(r) for r in g) for g in self.groups)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"Topology({self.describe()!r})"


def parse_topology(spec: str, world: int) -> "Optional[Topology]":
    """Parse a ``TORCHFT_TOPOLOGY`` spec for a ``world``-rank collective.

    Returns ``None`` for the flat (non-hierarchical) topology.  Raises
    ``ValueError`` on malformed specs or explicit group lists that do not
    match ``world`` — a silently-wrong topology would desync op streams.
    """
    spec = (spec or "").strip()
    if not spec or spec.lower() == "flat":
        return None
    if spec.lower().startswith(("hosts:", "groups:")):
        _, _, raw = spec.partition(":")
        try:
            k = int(raw)
        except ValueError:
            raise ValueError(f"TORCHFT_TOPOLOGY: bad group size in {spec!r}")
        if k < 1:
            raise ValueError(f"TORCHFT_TOPOLOGY: group size must be >= 1, got {k}")
        groups = [
            list(range(start, min(start + k, world)))
            for start in range(0, world, k)
        ]
        topo = Topology(groups)
    else:
        try:
            groups = [
                [int(r) for r in part.split(",") if r.strip() != ""]
                for part in spec.split(";")
                if part.strip()
            ]
        except ValueError:
            raise ValueError(f"TORCHFT_TOPOLOGY: unparseable spec {spec!r}")
        topo = Topology(groups)
        if topo.world != world:
            raise ValueError(
                f"TORCHFT_TOPOLOGY lists {topo.world} ranks but the "
                f"collective world is {world} (explicit group lists do not "
                "adapt to elastic resizing — use hosts:K for that)"
            )
    if topo.n_groups == 1 and topo.world == world and world <= 1:
        return None
    return topo


def resolve_topology(world: int) -> "Optional[Topology]":
    """The env-driven entry point: ``TORCHFT_TOPOLOGY`` for ``world``
    ranks; ``None`` = flat (today's schedule, bit-identical)."""
    return parse_topology(env_str("TORCHFT_TOPOLOGY"), world)


@dataclass(frozen=True)
class Hop:
    """One wire stage of a reduction plan, resolved for one rank.

    ``sends``/``recvs`` are peer ranks in submission order.  When
    ``paired`` is True the two lists zip into simultaneous send+recv
    exchanges (the deadlock-free pairwise form every rank submits in the
    same global order); otherwise sends and recvs are one-directional
    ops (gather/broadcast legs).  ``scope``/``paired`` are descriptive
    plan metadata (tests pin the schedule through them): the executing
    pipeline binds hop semantics by NAME, and the wire model derives
    its boundary map from :meth:`Topology.inter`, not from here.
    """

    name: str
    scope: str
    sends: "Tuple[int, ...]" = ()
    recvs: "Tuple[int, ...]" = ()
    paired: bool = False


@dataclass(frozen=True)
class ReductionPlan:
    """The synthesized multi-hop schedule one rank executes per chunk.

    ``slice_count`` row-slices (one per group) replace the flat plan's
    per-rank slices; ``hops`` run in order, every rank submitting its
    ops in the same global (chunk, hop) interleave so the single-worker
    PG streams stay consistent per socket.
    """

    topology: Topology
    rank: int
    group_index: int
    is_leader: bool
    hops: "Tuple[Hop, ...]"

    @property
    def slice_count(self) -> int:
        return self.topology.n_groups

    def describe(self) -> str:
        return " -> ".join(
            f"{h.name}[s{len(h.sends)}/r{len(h.recvs)}]" for h in self.hops
        )


def _pairwise(leaders: "List[int]", gidx: int) -> "Tuple[Tuple[int, ...], Tuple[int, ...]]":
    """Round-robin pairwise exchange peers among leaders (the alltoall
    offset schedule): at offset o, send to leader (g+o) mod m and receive
    from leader (g-o) mod m — every leader submits the same offset order,
    so no two workers ever block on each other's unposted op."""
    m = len(leaders)
    sends = tuple(leaders[(gidx + o) % m] for o in range(1, m))
    recvs = tuple(leaders[(gidx - o) % m] for o in range(1, m))
    return sends, recvs


def synthesize_plan(topo: Topology, rank: int) -> ReductionPlan:
    """Synthesize this rank's hop schedule from the declarative topology
    (module docstring describes the four hops and their numerics)."""
    gidx = topo.group_index(rank)
    lead = topo.leader(gidx)
    members = topo.members(gidx)
    leaders = topo.leaders()
    is_leader = rank == lead
    hops: "List[Hop]" = []
    if is_leader:
        hops.append(
            Hop("intra.reduce", "intra", recvs=tuple(members))
        )
        ex_sends, ex_recvs = _pairwise(leaders, gidx)
        hops.append(
            Hop("inter.exchange", "inter", ex_sends, ex_recvs, paired=True)
        )
        hops.append(
            Hop("inter.gather", "inter", ex_sends, ex_recvs, paired=True)
        )
        hops.append(Hop("intra.bcast", "intra", sends=tuple(members)))
    else:
        hops.append(Hop("intra.reduce", "intra", sends=(lead,)))
        hops.append(Hop("inter.exchange", "inter"))
        hops.append(Hop("inter.gather", "inter"))
        hops.append(Hop("intra.bcast", "intra", recvs=(lead,)))
    return ReductionPlan(
        topology=topo,
        rank=rank,
        group_index=gidx,
        is_leader=is_leader,
        hops=tuple(hops),
    )
