"""Executable model of the torchft_tpu_torch quorum protocol (tft-verify leg 1).

docs/protocol.md states the protocol's invariants in prose; the soaks
check them empirically on one interleaving per run.  This module is the
same per-step state machine — quorum formation (fast path, min_replicas
floor, majority guard, join timeout, shrink_only), reconfigure, heal,
allreduce, commit with the commit-failure quorum bump, plus crash /
restart / supersession churn — as a **pure-Python transition system**
small enough for :mod:`torchft_tpu_torch.analysis.model_checker` to explore
every bounded interleaving.  No sockets, no threads, no clocks:
nondeterminism (message arrival order, heartbeat expiry, the join
timeout firing, a crash landing mid-phase) is explicit branching.

The spec lives here twice, deliberately:

* **behavior** — the transition functions, which a :class:`Mutation` can
  corrupt (skip the commit-failure quorum bump, heal from a stale
  source, drop the majority guard, ...);
* **invariants** — independent state predicates (`INVARIANTS`), never
  mutated.

The checker proves each mutation is caught by an invariant and that the
unmutated model's bounded state space is clean — the mutation gate in
tests/test_torch_verify.py.  Online parallelism switching added its
states to this model before it added them to the runtime.

Everything is hashable/immutable (NamedTuples) so the checker can
deduplicate visited states.
"""

from __future__ import annotations

from typing import Callable, Dict, FrozenSet, List, NamedTuple, Optional, Tuple

__all__ = [
    "ModelConfig",
    "Mutation",
    "MUTATIONS",
    "INVARIANTS",
    "Violation",
    "State",
    "initial_state",
    "enabled_transitions",
    "apply_transition",
    "check_invariants",
    "is_goal",
    "VoteState",
    "vote_initial",
    "vote_enabled",
    "vote_apply",
    "vote_check",
    "ResizeConfig",
    "ResizeState",
    "resize_initial",
    "resize_enabled",
    "resize_apply",
    "resize_check",
    "resize_is_goal",
    "ElectionConfig",
    "ElectionState",
    "election_initial",
    "election_enabled",
    "election_apply",
    "election_check",
    "election_is_goal",
    "RestoreConfig",
    "RestoreState",
    "restore_initial",
    "restore_enabled",
    "restore_apply",
    "restore_check",
    "restore_is_goal",
    "MODEL_PHASE_OPS",
]

# Replica phases of the per-step state machine (docs/protocol.md 1-5).
IDLE = "idle"
RECONF = "reconfigure"
HEAL = "heal"
READY = "ready"  # reconfigured, waiting for the cohort allreduce
VOTED = "voted"  # allreduce done (or failed), commit vote latched

# Model op -> Manager phase-histogram name (manager.PROTOCOL_PHASES), so
# counterexample traces render in torchft-diagnose with the vocabulary
# operators already know from real flight dumps.
MODEL_PHASE_OPS: "Dict[str, str]" = {
    "join": "quorum_rpc",
    "form": "quorum_rpc",
    "reconf": "pg_configure",
    "heal": "heal_recv",
    "reduce": "ring",
    "reduce_fail": "ring",
    "reduce_abort": "ring",
    "commit": "commit",
    "crash": "crash",
    "wedge": "crash",
    "restart": "quorum_rpc",
    "zombie_join": "quorum_rpc",
    "expire": "quorum_rpc",
    "timeout": "quorum_rpc",
    # resize (online-parallelism-switching) sub-model ops
    "stage": "reshard",
    "stage_fail": "reshard",
    "quorum": "quorum_rpc",
    "plan": "quorum_rpc",
    "commit_layout": "layout_commit",
    # election (coordination-plane HA) sub-model ops
    "e_candidate": "quorum_rpc",
    "e_grant": "quorum_rpc",
    "e_elect": "quorum_rpc",
    "e_form": "quorum_rpc",
    "e_crash": "crash",
    "e_expire": "quorum_rpc",
    # durable-store cold-restore sub-model ops
    "spill": "heal_send",
    "rot": "crash",
    "restore": "heal_recv",
}


class ModelConfig(NamedTuple):
    """One bounded scenario for the checker to explore exhaustively."""

    n_replicas: int = 2
    min_replicas: int = 1
    target_steps: int = 2  # goal: every live replica commits this many steps
    crash_budget: int = 0  # process deaths (heartbeat eventually expires)
    wedge_budget: int = 0  # trainer hangs; manager keeps heartbeating
    restart_budget: int = 0  # new incarnations of dead/wedged replicas
    # Transient collective failures (a transport error with everyone
    # alive): the whole cohort latches an error and votes no — the
    # commit-failure quorum-bump path with UNCHANGED membership.
    abort_budget: int = 0
    # Replicas that only heartbeat, never join (the partitioned side the
    # majority guard must keep from being outvoted by a minority quorum).
    bystanders: "FrozenSet[int]" = frozenset()
    # Replicas whose join requests carry shrink_only=True.
    shrink_only: "FrozenSet[int]" = frozenset()
    # Per-replica committed step at t0 ( () = everyone at step 0 ): lets a
    # scenario start mid-run with stragglers needing a heal.
    initial_steps: "Tuple[int, ...]" = ()
    # Quorum formations allowed per run (0 = unlimited).  The standard
    # context-bounding knob: protocol rounds, not interleavings, drive
    # the state-space depth, so capping formations keeps a scenario
    # exhaustive-within-bound instead of exponential.
    quorum_budget: int = 0


class Rep(NamedTuple):
    inc: int  # incarnation counter; rid = "r{i}:{inc}"
    alive: bool
    wedged: bool  # trainer hung: no protocol progress, heartbeats continue
    step: int
    state: int  # abstract "bitwise state": int evolved deterministically
    phase: str
    # quorum view delivered at formation: (quorum_id, ((rid, step), ...))
    view: "Optional[Tuple[int, Tuple[Tuple[str, int], ...]]]"
    heal_src: "Optional[str]"  # member rid assigned as recovery source
    vote: bool
    next_state: int  # allreduce output staged for commit
    commit_failures: int
    zombie: "Optional[str]"  # superseded-but-alive old incarnation's rid


class LH(NamedTuple):
    quorum_id: int
    # previous quorum membership: ((rid, step-at-formation), ...) sorted
    prev: "Optional[Tuple[Tuple[str, int], ...]]"
    # pending registrations: ((rid, (step, commit_failures, shrink)), ...)
    pending: "Tuple[Tuple[str, Tuple[int, int, bool]], ...]"
    hb: "FrozenSet[str]"  # fresh heartbeats
    evicted: "FrozenSet[str]"  # permanent supersession stamps
    join_fired: bool  # the join-timeout "no that flips to yes by time"


class Ghost(NamedTuple):
    """Spec-side bookkeeping the invariants read; never visible to the
    (mutable) behavior, so a mutation cannot corrupt the judge."""

    # formation record: (prev_qid, new_qid, membership_changed, commit_failure,
    #  n_participants, n_healthy, new_member_admitted_under_shrink, fast)
    last_form: "Optional[Tuple[int, int, bool, bool, int, int, bool, bool]]"
    # heal record: (dst_rid, src_rid, src_snapshot_step, view_max_step)
    last_heal: "Optional[Tuple[str, str, int, int]]"


class State(NamedTuple):
    lh: LH
    reps: "Tuple[Rep, ...]"
    ghost: Ghost
    crashes: int
    wedges: int
    restarts: int
    aborts: int
    forms: int  # quorum formations remaining (-1 = unlimited)


class Violation(NamedTuple):
    invariant: str
    message: str
    replica_id: str  # violating replica ("lighthouse" for formation rules)
    phase: str  # model op active when the violation appeared


class Mutation(NamedTuple):
    name: str
    doc: str
    catches: str  # invariant id expected to flag it


MUTATIONS: "Tuple[Mutation, ...]" = (
    Mutation(
        "skip_commit_failure_bump",
        "quorum formation does not bump quorum_id when a member reports "
        "commit_failures > 0 (docs/protocol.md step 1)",
        "quorum-id-bump",
    ),
    Mutation(
        "reuse_quorum_id",
        "quorum formation reuses an older quorum_id instead of advancing",
        "quorum-id-monotone",
    ),
    Mutation(
        "heal_from_stale",
        "quorum math assigns a recovery source that is NOT at max_step",
        "heal-source-max-step",
    ),
    Mutation(
        "drop_majority_guard",
        "quorum formation skips the majority-of-heartbeaters split-brain "
        "guard",
        "majority-guard",
    ),
    Mutation(
        "commit_despite_error",
        "a replica whose allreduce failed commits the step anyway with "
        "whatever partial state it has",
        "no-divergent-commit",
    ),
    Mutation(
        "zombie_rejoin",
        "the lighthouse forgets the supersession stamp: an evicted "
        "incarnation's retry re-registers it",
        "supersession",
    ),
    Mutation(
        "ignore_shrink_only",
        "a shrink_only quorum admits brand-new members anyway",
        "shrink-only",
    ),
    Mutation(
        "resend_vote",
        "should_commit votes are blindly re-sent after a broken "
        "connection (the idempotent=True path the retry policy forbids for votes)",
        "vote-integrity",
    ),
    Mutation(
        "commit_mixed_epochs",
        "a replica activates its staged layout even when the quorum's "
        "layout-epoch reports disagree (min < max) — a subset of the "
        "fleet switches parallelism while the rest keeps the old layout",
        "all-commit-same-epoch",
    ),
    Mutation(
        "reuse_epoch_after_rollback",
        "layout planning reuses a rolled-back (burned) epoch value "
        "instead of advancing past it — a straggler still holding the "
        "burned stage could later commit stale data under the fresh plan",
        "layout-epoch-monotone",
    ),
    Mutation(
        "two_leaders_same_term",
        "a lighthouse peer grants a leadership lease for a term it has "
        "already promised to a DIFFERENT candidate (the strict "
        "term-monotone grant rule dropped to >=) — two candidates can "
        "each assemble a majority at the same term",
        "at-most-one-leader-per-term",
    ),
    Mutation(
        "reuse_quorum_seq_after_takeover",
        "a freshly elected lighthouse leader mints quorum ids from its "
        "own local counter without the term prefix — its first ids "
        "repeat values the dead leader already served, so quorum_id "
        "regresses across the failover",
        "quorum-id-monotone-across-failover",
    ),
    Mutation(
        "serve_torn_blob",
        "cold restore skips the read-time digest verify: a torn or "
        "bit-rotted blob is served into the restored cut instead of "
        "being treated as a missing fragment that fails over",
        "restore-cut-complete",
    ),
    Mutation(
        "mix_versions_in_cut",
        "cold-restore cut selection takes the newest manifested version "
        "even when incomplete and fills its missing fragments from "
        "older versions' blobs — the restored state splices fragment "
        "versions across an outer sync",
        "restore-cut-consistent",
    ),
)

MUTATION_NAMES = frozenset(m.name for m in MUTATIONS)


def _rid(i: int, inc: int) -> str:
    return f"r{i}:{inc}"


def _owner(rid: str) -> int:
    return int(rid.split(":", 1)[0][1:])


def _logical(rid: str) -> str:
    return rid.split(":", 1)[0]


def initial_state(cfg: ModelConfig) -> State:
    # Canonical committed chain up to the highest initial step: step 0 is
    # state 0 on every replica (init_sync: everyone starts from the
    # primary's identical weights), later steps evolve deterministically.
    steps = cfg.initial_steps or tuple(0 for _ in range(cfg.n_replicas))
    assert len(steps) == cfg.n_replicas
    chain = [0]
    for k in range(1, max(steps) + 1):
        chain.append(_mix(chain[-1], k))
    reps = tuple(
        Rep(
            inc=0,
            alive=True,
            wedged=False,
            step=s,
            state=chain[s],
            phase=IDLE,
            view=None,
            heal_src=None,
            vote=False,
            next_state=0,
            commit_failures=0,
            zombie=None,
        )
        for s in steps
    )
    hb = frozenset(_rid(i, 0) for i in range(cfg.n_replicas))
    lh = LH(
        quorum_id=0,
        prev=None,
        pending=(),
        hb=hb,
        evicted=frozenset(),
        join_fired=False,
    )
    ghost = Ghost(last_form=None, last_heal=None)
    return State(
        lh=lh,
        reps=reps,
        ghost=ghost,
        crashes=cfg.crash_budget,
        wedges=cfg.wedge_budget,
        restarts=cfg.restart_budget,
        aborts=cfg.abort_budget,
        forms=cfg.quorum_budget if cfg.quorum_budget > 0 else -1,
    )


# ---------------------------------------------------------------------------
# transition enumeration
# ---------------------------------------------------------------------------

Transition = Tuple[str, int]  # (op, replica index; -1 for lighthouse ops)

#: ops that only rewrite the acting replica's private planning fields
#: (deterministic, commute with every other actor's transitions, invisible
#: to the invariants) — the checker's DPOR-style persistent-set reduction
#: expands only one of these when any is enabled.
INVISIBLE_OPS = frozenset({"reconf"})


def _pending_ids(lh: LH) -> "FrozenSet[str]":
    return frozenset(rid for rid, _ in lh.pending)


def _participants(lh: LH) -> "List[Tuple[str, Tuple[int, int, bool]]]":
    """Healthy registered participants, replica-id order."""
    return sorted((p for p in lh.pending if p[0] in lh.hb), key=lambda p: p[0])


def _form_guard(
    cfg: ModelConfig, lh: LH, mutations: "FrozenSet[str]"
) -> "Optional[Tuple[List[Tuple[str, Tuple[int, int, bool]]], bool]]":
    """quorum_compute (native/lighthouse.cc): (candidates, fast) when a
    quorum can form now, else None.  The fast path — every previous
    member is back — trusts previous-quorum continuity and precedes the
    min_replicas / majority / join-timeout guards, exactly like the
    implementation."""
    parts = _participants(lh)
    if not parts:
        return None
    candidates = parts
    shrink = any(p[1][2] for p in parts)
    if shrink and lh.prev is not None and "ignore_shrink_only" not in mutations:
        prev_ids = {rid for rid, _ in lh.prev}
        candidates = [p for p in parts if p[0] in prev_ids]
        if not candidates:
            return None
    part_ids = {p[0] for p in parts}
    if lh.prev is not None:
        prev_ids = {rid for rid, _ in lh.prev}
        if prev_ids <= part_ids:
            return candidates, True  # fast quorum: everyone previous is back
    if len(parts) < cfg.min_replicas:
        return None
    if "drop_majority_guard" not in mutations:
        if len(parts) <= len(lh.hb) // 2:
            return None  # split-brain guard
    if part_ids != lh.hb and not lh.join_fired:
        return None  # healthy stragglers: wait for the join timeout
    return candidates, False


def _live_max_step(cfg: ModelConfig, st: State) -> int:
    """Highest committed step held by any live, unwedged replica — the
    step the membership-overlap assumption centers on."""
    return max(
        (
            r.step
            for r in st.reps
            if r.alive and not r.wedged
        ),
        default=0,
    )


def _overlap_ok(cfg: ModelConfig, st: State, mutations: "FrozenSet[str]") -> bool:
    """The membership-overlap assumption (docs/protocol.md,
    'Assumptions'), both halves:

    1. the forming quorum includes a replica at the live max step (else
       a behind cohort would re-derive already-committed steps with
       different members), and
    2. it overlaps the PREVIOUS quorum's max-step cohort — checking (1)
       alone is provably too weak: the checker found a trace where the
       previous max-step member commits step N alone while a new quorum
       (whose own max-step member is only *reaching* step N-1's result)
       re-runs the step with a disjoint cohort, leaving two live
       replicas at step N with divergent state.

    The real deployment gets this from timing (join_timeout_ms + every
    trainer re-joining each step); the model, which explores ALL
    timings, encodes it as an environment constraint: formation waits
    while an admissible max-step replica is alive.  Once every such
    replica is dead or wedged, continuing from a lower step is genuine
    disaster recovery and is allowed."""
    guard = _form_guard(cfg, st.lh, mutations)
    if guard is None:
        return True
    candidates, _ = guard
    if max(m[0] for _, m in candidates) < _live_max_step(cfg, st):
        return False
    if st.lh.prev is not None:
        prev_max = max(s for _, s in st.lh.prev)
        prev_max_rids = {rid for rid, s in st.lh.prev if s == prev_max}
        live_prev_max = {
            rid
            for rid in prev_max_rids
            if st.reps[_owner(rid)].alive
            and not st.reps[_owner(rid)].wedged
            and _rid(_owner(rid), st.reps[_owner(rid)].inc) == rid
        }
        cand_ids = {rid for rid, _ in candidates}
        if live_prev_max and not (cand_ids & live_prev_max):
            return False
    return True


def enabled_transitions(
    cfg: ModelConfig, st: State, mutations: "FrozenSet[str]" = frozenset()
) -> "List[Transition]":
    out: "List[Transition]" = []
    lh = st.lh
    pend = _pending_ids(lh)
    # A replica keeps joining quorums while it is behind the bounded
    # target OR any live admissible peer is (a finished replica still
    # serves as a recovery source, exactly like a real trainer mid-run);
    # once the whole admissible fleet is at the target, joins stop and
    # the space is bounded.
    someone_behind = any(
        r.alive
        and not r.wedged
        and r.step < cfg.target_steps
        and _admissible(cfg, st, i, r)
        for i, r in enumerate(st.reps)
        if i not in cfg.bystanders
    )
    for i, r in enumerate(st.reps):
        rid = _rid(i, r.inc)
        if r.alive and not r.wedged and i not in cfg.bystanders:
            if (
                r.phase == IDLE
                and someone_behind
                and rid not in pend
                and rid not in lh.evicted
            ):
                out.append(("join", i))
            if r.phase == RECONF:
                out.append(("reconf", i))
            if r.phase == HEAL:
                out.append(("heal", i))
            if r.phase == VOTED:
                out.append(("commit", i))
        if r.alive and not r.wedged and st.crashes > 0:
            out.append(("crash", i))
        if r.alive and not r.wedged and st.wedges > 0:
            out.append(("wedge", i))
        if (not r.alive or r.wedged) and st.restarts > 0:
            out.append(("restart", i))
        if _expirable_rids(lh, i, r):
            out.append(("expire", i))
        # A superseded-but-alive zombie retries its join.  Correctly this
        # is a rejected no-op; only the zombie_rejoin mutation makes it a
        # distinct state, so only enumerate it under that mutation.
        if (
            r.zombie is not None
            and "zombie_rejoin" in mutations
            and r.zombie not in pend
        ):
            out.append(("zombie_join", i))
    if lh.pending and not lh.join_fired:
        parts = {p[0] for p in _participants(lh)}
        if parts and parts != lh.hb:
            out.append(("timeout", -1))
    if (
        st.forms != 0
        and _form_guard(cfg, lh, mutations) is not None
        and _overlap_ok(cfg, st, mutations)
    ):
        out.append(("form", -1))
    # allreduce: the cohort is every quorum member at the view's max_step
    # whose current incarnation reached READY; it completes atomically
    # when all of them are there, and fails for the survivors when a
    # cohort member died/wedged mid-collective.
    ready = [
        (i, r)
        for i, r in enumerate(st.reps)
        if r.phase == READY and r.alive and not r.wedged
    ]
    if ready:
        view = ready[0][1].view
        assert view is not None
        cohort = _cohort_of(view)
        live = {
            _rid(i, r.inc)
            for i, r in enumerate(st.reps)
            if r.phase == READY and r.alive and not r.wedged and r.view == view
        }
        if cohort <= live:
            out.append(("reduce", -1))
            if st.aborts > 0:
                out.append(("reduce_abort", -1))
        else:
            dead_member = any(
                not st.reps[_owner(m)].alive
                or st.reps[_owner(m)].wedged
                or _rid(_owner(m), st.reps[_owner(m)].inc) != m
                for m in cohort
            )
            if dead_member:
                out.append(("reduce_fail", -1))
    return sorted(out)


def _cohort_of(
    view: "Tuple[int, Tuple[Tuple[str, int], ...]]",
) -> "FrozenSet[str]":
    _, members = view
    max_step = max(s for _, s in members)
    return frozenset(rid for rid, s in members if s == max_step)


def _admissible(cfg: ModelConfig, st: State, i: int, r: Rep) -> bool:
    """Whether replica ``i`` can still be admitted to a quorum: while a
    live shrink_only requester exists and a previous quorum is on the
    books, only previous members pass the shrink filter — a filtered-out
    replica is a permanent straggler the bounded goal must not wait on."""
    if st.lh.prev is None or not cfg.shrink_only:
        return True
    shrink_active = any(
        st.reps[j].alive and not st.reps[j].wedged
        for j in cfg.shrink_only
        if j not in cfg.bystanders
    )
    if not shrink_active:
        return True
    return _rid(i, r.inc) in {rid for rid, _ in st.lh.prev}


def _expirable_rids(lh: LH, i: int, r: Rep) -> "FrozenSet[str]":
    """Heartbeat entries of replica ``i`` whose freshness window can run
    out: the current incarnation once its process died, and any prior
    incarnation whose process is gone (a wedged-but-alive zombie keeps
    heartbeating, so its entry stays until supersession evicts it)."""
    out = set()
    rid = _rid(i, r.inc)
    if not r.alive and rid in lh.hb:
        out.add(rid)
    if r.inc > 0:
        old = _rid(i, r.inc - 1)
        if old in lh.hb and old != r.zombie:
            out.add(old)
    return frozenset(out)


# ---------------------------------------------------------------------------
# transition application
# ---------------------------------------------------------------------------


def _mix(*parts: int) -> int:
    """Deterministic small-int state evolution (stands in for 'bitwise
    identical tensors': equal inputs -> equal output, any difference
    propagates)."""
    h = 0x811C9DC5
    for p in parts:
        h ^= (p + 0x9E3779B9) & 0xFFFFFFFF
        h = (h * 0x01000193) & 0xFFFFFFFF
    return h


def apply_transition(
    cfg: ModelConfig,
    st: State,
    t: Transition,
    mutations: "FrozenSet[str]" = frozenset(),
) -> State:
    op, i = t
    lh = st.lh
    reps = list(st.reps)
    ghost = st.ghost

    if op == "join":
        r = reps[i]
        rid = _rid(i, r.inc)
        member = (rid, (r.step, r.commit_failures, i in cfg.shrink_only))
        pending = tuple(p for p in lh.pending if p[0] != rid) + (member,)
        hb = lh.hb | {rid}
        evicted = lh.evicted
        # Fast-restart supersession: a new incarnation's join evicts any
        # other incarnation of the same logical replica, permanently.
        stale = {
            x
            for x in hb
            if x != rid and _logical(x) == _logical(rid)
        }
        if stale:
            hb = hb - stale
            pending = tuple(p for p in pending if p[0] not in stale)
            evicted = evicted | stale
        lh = lh._replace(pending=tuple(sorted(pending)), hb=hb, evicted=evicted)
        return st._replace(lh=lh)

    if op == "zombie_join":
        # only reachable under the zombie_rejoin mutation: the lighthouse
        # forgets the stamp and re-registers the superseded incarnation
        r = reps[i]
        assert r.zombie is not None
        member = (r.zombie, (0, 0, False))
        pending = tuple(p for p in lh.pending if p[0] != r.zombie) + (member,)
        lh = lh._replace(
            pending=tuple(sorted(pending)), hb=lh.hb | {r.zombie}
        )
        return st._replace(lh=lh)

    if op == "timeout":
        return st._replace(lh=lh._replace(join_fired=True))

    if op == "form":
        guard = _form_guard(cfg, lh, mutations)
        assert guard is not None
        candidates, fast = guard
        members = tuple((rid, m[0]) for rid, m in candidates)
        prev_ids = (
            None if lh.prev is None else tuple(rid for rid, _ in lh.prev)
        )
        membership_changed = prev_ids is None or prev_ids != tuple(
            rid for rid, _ in members
        )
        commit_failure = any(m[1] > 0 for _, m in candidates)
        new_qid = lh.quorum_id
        if membership_changed or (
            commit_failure and "skip_commit_failure_bump" not in mutations
        ):
            new_qid = lh.quorum_id + 1
        if "reuse_quorum_id" in mutations and lh.quorum_id > 0:
            # hand out an id from a previous configuration instead of a
            # fresh one (only expressible once an id has been minted)
            new_qid = lh.quorum_id - 1
        new_under_shrink = any(p[1][2] for p in candidates) and (
            lh.prev is not None
            and any(
                rid not in {pr for pr, _ in lh.prev} for rid, _ in members
            )
        )
        ghost = ghost._replace(
            last_form=(
                lh.quorum_id,
                new_qid,
                membership_changed,
                commit_failure,
                len(_participants(lh)),
                len(lh.hb),
                new_under_shrink,
                fast,
            )
        )
        view = (new_qid, members)
        for rid, _ in members:
            j = _owner(rid)
            r = reps[j]
            if r.alive and not r.wedged and _rid(j, r.inc) == rid:
                reps[j] = r._replace(
                    phase=RECONF, view=view, heal_src=None, vote=False
                )
        lh = lh._replace(
            quorum_id=new_qid, prev=members, pending=(), join_fired=False
        )
        return st._replace(
            lh=lh,
            reps=tuple(reps),
            ghost=ghost,
            forms=st.forms - 1 if st.forms > 0 else st.forms,
        )

    if op == "reconf":
        r = reps[i]
        assert r.view is not None
        _, members = r.view
        max_step = max(s for _, s in members)
        if r.step < max_step:
            sources = [rid for rid, s in members if s == max_step]
            if "heal_from_stale" in mutations:
                stale = [
                    rid
                    for rid, s in members
                    if s < max_step and _owner(rid) != i
                ]
                if stale:
                    sources = stale
            my_rank = [rid for rid, _ in members].index(_rid(i, r.inc))
            src = sources[my_rank % len(sources)]
            reps[i] = r._replace(phase=HEAL, heal_src=src)
        else:
            reps[i] = r._replace(phase=READY)
        return st._replace(reps=tuple(reps))

    if op == "heal":
        r = reps[i]
        assert r.view is not None and r.heal_src is not None
        _, members = r.view
        max_step = max(s for _, s in members)
        src_snapshot = dict(members)[r.heal_src]
        j = _owner(r.heal_src)
        src = reps[j]
        ghost = ghost._replace(
            last_heal=(_rid(i, r.inc), r.heal_src, src_snapshot, max_step)
        )
        if not src.alive or _rid(j, src.inc) != r.heal_src:
            # source gone: heal fails, go back and re-quorum
            reps[i] = r._replace(phase=IDLE, view=None, heal_src=None)
            return st._replace(reps=tuple(reps), ghost=ghost)
        # copy the source's CURRENT committed (step, state)
        reps[i] = r._replace(
            step=src.step,
            state=src.state,
            phase=IDLE,
            view=None,
            heal_src=None,
        )
        return st._replace(reps=tuple(reps), ghost=ghost)

    if op in ("reduce", "reduce_fail", "reduce_abort"):
        ready = [
            (j, r)
            for j, r in enumerate(reps)
            if r.phase == READY and r.alive and not r.wedged
        ]
        view = ready[0][1].view
        assert view is not None
        qid, members = view
        cohort = sorted(_cohort_of(view))
        step = max(s for _, s in members)
        if op == "reduce_abort":
            # transient wire failure with everyone alive: the whole
            # cohort latches the error and votes no (commit_failures will
            # be reported at the next quorum with UNCHANGED membership)
            for j, r in ready:
                reps[j] = r._replace(
                    phase=VOTED, vote=False, next_state=_mix(r.state, 0xDEAD, j)
                )
            return st._replace(reps=tuple(reps), aborts=st.aborts - 1)
        if op == "reduce":
            # gradient average over the live cohort: identical inputs on
            # every member, so every member stages the identical output
            value = _mix(qid, step, *(hash(m) & 0xFFFF for m in cohort))
            for j, r in ready:
                nxt = _mix(r.state, value)
                reps[j] = r._replace(phase=VOTED, vote=True, next_state=nxt)
        else:
            for j, r in ready:
                # collective failed: latch the error, vote no; the partial
                # buffer (modeled as a garbage value) must never commit
                reps[j] = r._replace(
                    phase=VOTED, vote=False, next_state=_mix(r.state, 0xDEAD, j)
                )
        return st._replace(reps=tuple(reps))

    if op == "commit":
        r = reps[i]
        vote = r.vote or "commit_despite_error" in mutations
        if vote:
            reps[i] = r._replace(
                step=r.step + 1,
                state=r.next_state,
                phase=IDLE,
                view=None,
                vote=False,
                commit_failures=0,
            )
        else:
            reps[i] = r._replace(
                phase=IDLE,
                view=None,
                vote=False,
                commit_failures=r.commit_failures + 1,
            )
        return st._replace(reps=tuple(reps), ghost=ghost)

    if op == "crash":
        r = reps[i]
        reps[i] = r._replace(alive=False, wedged=False)
        return st._replace(reps=tuple(reps), crashes=st.crashes - 1)

    if op == "wedge":
        r = reps[i]
        reps[i] = r._replace(wedged=True)
        return st._replace(reps=tuple(reps), wedges=st.wedges - 1)

    if op == "restart":
        r = reps[i]
        old_rid = _rid(i, r.inc)
        zombie = old_rid if r.wedged else None
        reps[i] = Rep(
            inc=r.inc + 1,
            alive=True,
            wedged=False,
            step=0,
            state=0,
            phase=IDLE,
            view=None,
            heal_src=None,
            vote=False,
            next_state=0,
            commit_failures=0,
            zombie=zombie,
        )
        return st._replace(reps=tuple(reps), restarts=st.restarts - 1)

    if op == "expire":
        stale = _expirable_rids(lh, i, reps[i])
        lh = lh._replace(
            hb=lh.hb - stale,
            pending=tuple(p for p in lh.pending if p[0] not in stale),
        )
        return st._replace(lh=lh)

    raise AssertionError(f"unknown transition {t}")


# ---------------------------------------------------------------------------
# invariants (the spec — never mutated)
# ---------------------------------------------------------------------------


def _inv_quorum_id_monotone(
    cfg: ModelConfig, st: State
) -> "Optional[Violation]":
    f = st.ghost.last_form
    if f is None:
        return None
    prev_qid, new_qid = f[0], f[1]
    if new_qid < prev_qid:
        return Violation(
            "quorum-id-monotone",
            f"quorum_id went backwards: {prev_qid} -> {new_qid}",
            "lighthouse",
            "form",
        )
    return None


def _inv_quorum_id_bump(cfg: ModelConfig, st: State) -> "Optional[Violation]":
    f = st.ghost.last_form
    if f is None:
        return None
    prev_qid, new_qid, membership_changed, commit_failure = f[0], f[1], f[2], f[3]
    if (membership_changed or commit_failure) and new_qid <= prev_qid:
        why = "membership changed" if membership_changed else "commit failure reported"
        return Violation(
            "quorum-id-bump",
            f"{why} but quorum_id did not advance ({prev_qid} -> {new_qid})",
            "lighthouse",
            "form",
        )
    return None


def _inv_majority_guard(cfg: ModelConfig, st: State) -> "Optional[Violation]":
    f = st.ghost.last_form
    if f is None:
        return None
    n_parts, n_healthy, fast = f[4], f[5], f[7]
    if fast:
        # The fast path (every previous member back) trusts membership
        # continuity and legitimately precedes the guard — the documented
        # design (docs/protocol.md step 1, native/lighthouse.cc).
        return None
    if n_parts <= n_healthy // 2:
        return Violation(
            "majority-guard",
            f"quorum formed with {n_parts} participants out of "
            f"{n_healthy} heartbeating replicas (minority side of a "
            f"partition admitted)",
            "lighthouse",
            "form",
        )
    return None


def _inv_shrink_only(cfg: ModelConfig, st: State) -> "Optional[Violation]":
    f = st.ghost.last_form
    if f is None:
        return None
    if f[6]:
        return Violation(
            "shrink-only",
            "shrink_only quorum admitted a member not in the previous "
            "quorum",
            "lighthouse",
            "form",
        )
    return None


def _inv_heal_source(cfg: ModelConfig, st: State) -> "Optional[Violation]":
    h = st.ghost.last_heal
    if h is None:
        return None
    dst, src, src_step, max_step = h
    if src_step < max_step:
        return Violation(
            "heal-source-max-step",
            f"{dst} healed from {src} at step {src_step}, but the quorum's "
            f"max_step is {max_step} (stale recovery source)",
            dst,
            "heal",
        )
    return None


def _inv_no_divergent_commit(
    cfg: ModelConfig, st: State
) -> "Optional[Violation]":
    """docs/protocol.md's single invariant, literally: replicas
    reporting the same step hold bitwise-identical state (live, unwedged
    replicas — a dead replica's unreplicated tail commits are lost by
    design, and its frozen state is not 'reported')."""
    by_step: "Dict[int, Tuple[str, int]]" = {}
    for i, r in enumerate(st.reps):
        if not r.alive or r.wedged:
            continue
        rid = _rid(i, r.inc)
        prior = by_step.get(r.step)
        if prior is not None and prior[1] != r.state:
            return Violation(
                "no-divergent-commit",
                f"{rid} holds state {r.state:#x} at step {r.step} but "
                f"{prior[0]} holds {prior[1]:#x} at the same step "
                f"(replicas at the same step must be bitwise identical)",
                rid,
                "commit",
            )
        by_step.setdefault(r.step, (rid, r.state))
    return None


def _inv_supersession(cfg: ModelConfig, st: State) -> "Optional[Violation]":
    lh = st.lh
    offenders = (lh.hb | _pending_ids(lh)) & lh.evicted
    if offenders:
        rid = sorted(offenders)[0]
        return Violation(
            "supersession",
            f"evicted incarnation {rid} re-registered at the lighthouse "
            f"(a zombie can evict its live successor)",
            rid,
            "join",
        )
    # at most one incarnation of a logical replica may be registered
    seen: "Dict[str, str]" = {}
    for rid in sorted(lh.hb | _pending_ids(lh)):
        log = _logical(rid)
        if log in seen:
            return Violation(
                "supersession",
                f"two incarnations of {log} registered at once: "
                f"{seen[log]} and {rid}",
                rid,
                "join",
            )
        seen[log] = rid
    return None


INVARIANTS: "Dict[str, Callable[[ModelConfig, State], Optional[Violation]]]" = {
    "quorum-id-monotone": _inv_quorum_id_monotone,
    "quorum-id-bump": _inv_quorum_id_bump,
    "majority-guard": _inv_majority_guard,
    "shrink-only": _inv_shrink_only,
    "heal-source-max-step": _inv_heal_source,
    "no-divergent-commit": _inv_no_divergent_commit,
    "supersession": _inv_supersession,
}


def check_invariants(cfg: ModelConfig, st: State) -> "List[Violation]":
    out = []
    for check in INVARIANTS.values():
        v = check(cfg, st)
        if v is not None:
            out.append(v)
    return out


def is_goal(cfg: ModelConfig, st: State) -> bool:
    """Every live, admissible, participating replica committed the
    target steps."""
    live = [
        r
        for i, r in enumerate(st.reps)
        if r.alive
        and not r.wedged
        and i not in cfg.bystanders
        and _admissible(cfg, st, i, r)
    ]
    return bool(live) and all(r.step >= cfg.target_steps for r in live)


# ---------------------------------------------------------------------------
# vote barrier sub-model (should_commit over one group's local ranks)
# ---------------------------------------------------------------------------
#
# The main model treats each replica group as one voter; this sub-model
# zooms into ONE group's Manager server barrier: world_size local ranks
# each send a should_commit vote per step over a pooled connection that
# can die after delivery but before the reply (the exact hazard
# coordination._RpcClient's idempotent=False exists for).


class VoteMsg(NamedTuple):
    rank: int
    step: int
    vote: bool
    resend: bool  # True when this is a blind client re-send


class VoteState(NamedTuple):
    step: int  # barrier's current round (the step being voted on)
    # votes tallied this round: ((rank, (step_voted, vote)), ...)
    tally: "Tuple[Tuple[int, Tuple[int, bool]], ...]"
    channel: "Tuple[VoteMsg, ...]"  # sent but undelivered messages
    # per rank: next step it will vote on (target+1 = done)
    at: "Tuple[int, ...]"
    # per rank: message awaiting a reply that the connection dropped on
    # (None = no outstanding drop)
    dropped: "Tuple[Optional[VoteMsg], ...]"
    decisions: "Tuple[Tuple[int, bool], ...]"  # (step, decision) history
    drops_left: int


def vote_initial(world: int = 2, steps: int = 2, drops: int = 1) -> VoteState:
    return VoteState(
        step=0,
        tally=(),
        channel=(),
        at=tuple(0 for _ in range(world)),
        dropped=tuple(None for _ in range(world)),
        decisions=(),
        drops_left=drops,
    )


VoteTransition = Tuple[str, int]


def vote_enabled(
    st: VoteState, steps: int, mutations: "FrozenSet[str]" = frozenset()
) -> "List[VoteTransition]":
    out: "List[VoteTransition]" = []
    world = len(st.at)
    for rank in range(world):
        if st.dropped[rank] is None and not any(
            m.rank == rank and not m.resend for m in st.channel
        ):
            tallied = any(r == rank for r, _ in st.tally)
            if st.at[rank] == st.step and st.step < steps and not tallied:
                out.append(("send", rank))
        if st.dropped[rank] is not None:
            if "resend_vote" in mutations:
                out.append(("resend", rank))
            out.append(("abstain", rank))
    for idx in range(len(st.channel)):
        out.append(("deliver", idx))
        if st.drops_left > 0 and not st.channel[idx].resend:
            out.append(("drop", idx))
    return sorted(out)


def vote_apply(st: VoteState, t: VoteTransition) -> VoteState:
    op, x = t
    if op == "send":
        msg = VoteMsg(rank=x, step=st.at[x], vote=True, resend=False)
        return st._replace(channel=st.channel + (msg,))
    if op == "resend":
        # mutated client behavior: blind re-send of the dropped vote
        msg = st.dropped[x]
        assert msg is not None
        dropped = list(st.dropped)
        dropped[x] = None
        return st._replace(
            channel=st.channel + (msg._replace(resend=True),),
            dropped=tuple(dropped),
        )
    if op == "abstain":
        # correct client behavior: surface the ConnectionError; the
        # Manager votes no for the NEXT round and moves on
        dropped = list(st.dropped)
        dropped[x] = None
        return st._replace(dropped=tuple(dropped))
    if op == "deliver":
        msg = st.channel[x]
        st = st._replace(channel=st.channel[:x] + st.channel[x + 1 :])
        return _vote_count(st, msg)
    if op == "drop":
        # connection died after the server took the request, before the
        # reply: the vote WAS delivered, the client only knows "broken"
        msg = st.channel[x]
        dropped = list(st.dropped)
        dropped[msg.rank] = msg
        st = st._replace(
            channel=st.channel[:x] + st.channel[x + 1 :],
            dropped=tuple(dropped),
            drops_left=st.drops_left - 1,
        )
        return _vote_count(st, msg)
    raise AssertionError(f"unknown vote transition {t}")


def _vote_count(st: VoteState, msg: VoteMsg) -> VoteState:
    """Server side of one delivered vote: fold it into the open tally and,
    on the world_size'th vote, complete the round (compute the decision,
    advance every rank that was at this step, open the next round)."""
    tally = dict(st.tally)
    tally[msg.rank] = (msg.step, msg.vote)
    st = st._replace(tally=tuple(sorted(tally.items())))
    if len(tally) < len(st.at):
        return st
    decision = all(v for _, (_, v) in sorted(tally.items()))
    at = tuple(a + 1 if a == st.step else a for a in st.at)
    return st._replace(
        step=st.step + 1,
        tally=(),
        at=at,
        decisions=st.decisions + ((st.step, decision),),
    )


# ---------------------------------------------------------------------------
# resize sub-model (online parallelism switching, parallel/layout.py)
# ---------------------------------------------------------------------------
#
# Models the two-phase layout-switch protocol over whole replica groups:
# a quorum whose live world no longer fits the active layout PLANS the
# next layout under a fresh monotone epoch; each group then STAGES the
# reshard transfers (which can fail, or the group can crash mid-stage);
# the next quorum COMMITS the switch iff every participant reports the
# staged epoch (min == max == E at the planned world) — otherwise the
# whole fleet rolls back and the epoch is BURNED, never reused.
#
# Layout identity is abstracted to the (world, generation) pair the plan
# was made for — equal inputs produce equal layouts in the runtime
# planner, so generation inequality stands in for "different (dp, shard,
# pp) / different resharded bytes".


class ResizeConfig(NamedTuple):
    """One bounded resize scenario."""

    n_replicas: int = 3
    target_switches: int = 2  # goal: this many committed layout switches
    crash_budget: int = 1  # group deaths (staged buffers die with them)
    join_budget: int = 1  # dead groups re-admitted fresh (epoch 0)
    stage_fail_budget: int = 1  # reshard transfer failures


class RRep(NamedTuple):
    alive: bool
    epoch: int  # active layout epoch
    gen: int  # active layout identity (0 = the implicit seed layout)
    world: int  # the world the ACTIVE layout was planned for
    # staged switch awaiting its commit round: (epoch, world, gen)
    staged: "Optional[Tuple[int, int, int]]"
    # planned this round, transfer not yet attempted: (epoch, world, gen)
    pending: "Optional[Tuple[int, int, int]]"


class RGhost(NamedTuple):
    """Spec-side bookkeeping; never read by the (mutable) behavior."""

    # epoch value -> generation it was first planned under (epoch reuse
    # across generations is the layout-epoch-monotone violation)
    epoch_gens: "Tuple[Tuple[int, int], ...]"
    # last quorum's (participant_count, activator_count, distinct (epoch,
    # gen) pairs activated) — the switch-atomicity record
    last_round: "Optional[Tuple[int, int, int]]"
    # last activation per replica: (replica, prev_epoch, new_epoch)
    last_activation: "Optional[Tuple[int, int, int]]"


class ResizeState(NamedTuple):
    reps: "Tuple[RRep, ...]"
    highest: int  # highest epoch ever planned (behavior-side)
    burned: "FrozenSet[int]"  # rolled-back epochs (behavior-side)
    gen_seq: int  # plan counter
    switches: int  # committed switch rounds so far
    ghost: RGhost
    crashes: int
    joins: int
    stage_fails: int


def resize_initial(cfg: ResizeConfig) -> ResizeState:
    # seed: every group runs the implicit pure-DP layout at epoch 0,
    # planned (by construction) for the full initial fleet
    reps = tuple(
        RRep(
            alive=True, epoch=0, gen=0, world=cfg.n_replicas,
            staged=None, pending=None,
        )
        for _ in range(cfg.n_replicas)
    )
    return ResizeState(
        reps=reps,
        highest=0,
        burned=frozenset(),
        gen_seq=0,
        switches=0,
        ghost=RGhost(epoch_gens=(), last_round=None, last_activation=None),
        crashes=cfg.crash_budget,
        joins=cfg.join_budget,
        stage_fails=cfg.stage_fail_budget,
    )


def _resize_live(st: ResizeState) -> "List[int]":
    return [i for i, r in enumerate(st.reps) if r.alive]


def resize_enabled(
    cfg: ResizeConfig,
    st: ResizeState,
    mutations: "FrozenSet[str]" = frozenset(),
) -> "List[Transition]":
    del mutations  # the mutated behaviors live in resize_apply
    out: "List[Transition]" = []
    for i, r in enumerate(st.reps):
        if r.alive and r.pending is not None:
            out.append(("stage", i))
            if st.stage_fails > 0:
                out.append(("stage_fail", i))
        if r.alive and st.crashes > 0:
            out.append(("crash", i))
        if not r.alive and st.joins > 0:
            out.append(("join", i))
    live = _resize_live(st)
    # the quorum barrier: everyone alive finished (or skipped) staging
    if live and all(st.reps[i].pending is None for i in live):
        if st.switches < cfg.target_switches:
            out.append(("quorum", -1))
    return sorted(out)


def resize_apply(
    cfg: ResizeConfig,
    st: ResizeState,
    t: Transition,
    mutations: "FrozenSet[str]" = frozenset(),
) -> ResizeState:
    op, i = t
    reps = list(st.reps)
    ghost = st.ghost

    if op == "stage":
        r = reps[i]
        assert r.pending is not None
        reps[i] = r._replace(staged=r.pending, pending=None)
        return st._replace(reps=tuple(reps))

    if op == "stage_fail":
        r = reps[i]
        # transfer failed: nothing staged; the commit round sees this
        # group still reporting its old epoch and rolls the fleet back
        reps[i] = r._replace(pending=None)
        return st._replace(reps=tuple(reps), stage_fails=st.stage_fails - 1)

    if op == "crash":
        reps[i] = reps[i]._replace(alive=False, staged=None, pending=None)
        return st._replace(reps=tuple(reps), crashes=st.crashes - 1)

    if op == "join":
        # a fresh incarnation: no layout history, no sharded data (its
        # world=0 can never equal a live world, forcing a fleet re-plan
        # that fetches its shard — exactly the runtime's joiner path)
        reps[i] = RRep(
            alive=True, epoch=0, gen=0, world=0, staged=None, pending=None
        )
        return st._replace(reps=tuple(reps), joins=st.joins - 1)

    if op == "quorum":
        live = _resize_live(st)
        world = len(live)
        reported = {
            j: (reps[j].staged[0] if reps[j].staged is not None else reps[j].epoch)
            for j in live
        }
        min_e, max_e = min(reported.values()), max(reported.values())
        staged_pairs = {
            reps[j].staged for j in live if reps[j].staged is not None
        }
        switches = st.switches
        burned = st.burned
        activators: "List[int]" = []
        activated_pairs: "set" = set()
        # --- commit / rollback of the previous round's stage ------------
        unanimous = (
            len(staged_pairs) == 1
            and all(reps[j].staged is not None for j in live)
            and min_e == max_e
            and next(iter(staged_pairs))[1] == world
        )
        for j in live:
            r = reps[j]
            if r.staged is None:
                continue
            if unanimous or "commit_mixed_epochs" in mutations:
                e, w, g = r.staged
                ghost = ghost._replace(last_activation=(j, r.epoch, e))
                activators.append(j)
                activated_pairs.add((e, g))
                reps[j] = r._replace(epoch=e, gen=g, world=w, staged=None)
            else:
                burned = burned | {r.staged[0]}
                reps[j] = r._replace(staged=None)
        ghost = ghost._replace(
            last_round=(len(live), len(activators), len(activated_pairs))
        )
        if activators and len(activators) == len(live):
            switches += 1
        # --- plan the next switch if the world no longer fits -----------
        live_reps = [reps[j] for j in live]
        uniform = len({(r.epoch, r.gen, r.world) for r in live_reps}) == 1
        needs_plan = (not uniform) or live_reps[0].world != world
        new_highest = st.highest
        gen_seq = st.gen_seq
        if needs_plan:
            if "reuse_epoch_after_rollback" in mutations and burned:
                epoch = max(burned)
            else:
                epoch = max(new_highest, max_e) + 1
            new_highest = max(new_highest, epoch)
            gen_seq += 1
            ghost = ghost._replace(
                epoch_gens=ghost.epoch_gens + ((epoch, gen_seq),)
            )
            for j in live:
                reps[j] = reps[j]._replace(
                    pending=(epoch, world, gen_seq)
                )
        return st._replace(
            reps=tuple(reps),
            highest=new_highest,
            burned=burned,
            gen_seq=gen_seq,
            switches=switches,
            ghost=ghost,
        )

    raise AssertionError(f"unknown resize transition {t}")


def resize_check(cfg: ResizeConfig, st: ResizeState) -> "List[Violation]":
    out: "List[Violation]" = []
    # layout-epoch-monotone: (a) an epoch value is bound to exactly one
    # generation — burned epochs are never reused; (b) activations
    # strictly advance the replica's epoch.
    seen: "Dict[int, int]" = {}
    for epoch, gen in st.ghost.epoch_gens:
        if epoch in seen and seen[epoch] != gen:
            out.append(
                Violation(
                    "layout-epoch-monotone",
                    f"layout epoch {epoch} planned twice (generations "
                    f"{seen[epoch]} and {gen}) — a rolled-back epoch was "
                    f"reused, so a straggler's stale stage could commit "
                    f"under the fresh plan",
                    "lighthouse",
                    "plan",
                )
            )
        seen.setdefault(epoch, gen)
    la = st.ghost.last_activation
    if la is not None and la[2] <= la[1]:
        out.append(
            Violation(
                "layout-epoch-monotone",
                f"replica r{la[0]} activated epoch {la[2]} over active "
                f"epoch {la[1]} — layout epochs must strictly advance",
                f"r{la[0]}:0",
                "commit_layout",
            )
        )
    # all-commit-same-epoch: a switch is fleet-atomic — either every
    # quorum participant activates (one identical layout) or none does.
    lr = st.ghost.last_round
    if lr is not None:
        participants, activators, distinct = lr
        if 0 < activators < participants or distinct > 1:
            out.append(
                Violation(
                    "all-commit-same-epoch",
                    f"layout commit split the fleet: {activators} of "
                    f"{participants} participants activated "
                    f"({distinct} distinct layouts) — every replica must "
                    f"switch at the same round or not at all",
                    "lighthouse",
                    "commit_layout",
                )
            )
    return out


def resize_is_goal(cfg: ResizeConfig, st: ResizeState) -> bool:
    return st.switches >= cfg.target_switches


def vote_check(st: VoteState) -> "List[Violation]":
    """vote-integrity: every tallied vote was cast for the round it is
    counted in — a duplicate delivery of an old vote must never satisfy a
    later round's barrier."""
    out = []
    for rank, (step_voted, _) in st.tally:
        if step_voted != st.step:
            out.append(
                Violation(
                    "vote-integrity",
                    f"rank {rank}'s should_commit vote for step "
                    f"{step_voted} was counted toward the step {st.step} "
                    f"barrier (double-delivered vote released a stale "
                    f"tally)",
                    f"rank{rank}",
                    "commit",
                )
            )
    return out


# ---------------------------------------------------------------------------
# coordination-plane HA sub-model: leased leader election
# ---------------------------------------------------------------------------
#
# N lighthouse peers over a static endpoint list elect a leader by
# majority lease acknowledgement (native/lighthouse.cc election_loop /
# rpc_lease).  Modeled faithfully where it matters for safety:
#
#   - each peer holds ONE promise (term, candidate) — monotone in term,
#     and a term granted to one candidate is never granted to another
#     (the at-most-one-leader-per-term rule);
#   - a fresh grant to ANOTHER peer shields the holder (the lease); a
#     peer's own failed-candidacy self-promise does not;
#   - promise freshness decays only by an explicit ``e_expire`` event
#     (renewals stopped: the promised leader is dead or deposed), which
#     is how takeover-on-expiry enters the model;
#   - lighthouse state is soft, so a takeover transfers nothing: the new
#     leader mints quorum ids as ``(term << 32) | seq`` with seq reset —
#     the ONLY mechanism keeping quorum_id monotone across failover, and
#     exactly what the reuse_quorum_seq_after_takeover mutation breaks.
#
# Ghost fields record every leadership and every minted quorum id in
# global order; the invariants read only the ghosts, so a mutated
# behavior cannot corrupt the judge.

_E_TERM_SHIFT = 32  # matches native lighthouse.h ha_epoch_id


class ElectionConfig(NamedTuple):
    """One bounded election scenario."""

    n_peers: int = 3
    target_quorums: int = 2  # goal: quorums formed across leaderships
    crash_budget: int = 1  # leader deaths
    expire_budget: int = 3  # promise-expiry (renewals-stopped) events


class EPeer(NamedTuple):
    alive: bool
    promised_term: int
    promised_to: int  # peer index; -1 = never granted
    promise_fresh: bool  # the lease shield (renewed by a live leader)
    leading_term: int  # term this peer leads under (0 = follower)
    # candidacy in flight: (term, frozenset of granting peer indices)
    candidacy: "Optional[Tuple[int, FrozenSet[int]]]"
    quorum_seq: int  # low word of ids minted under this leadership


class EGhost(NamedTuple):
    """Spec-side bookkeeping; never read by the (mutable) behavior."""

    # every leadership ever established, in establishment order
    leaderships: "Tuple[Tuple[int, int], ...]"  # (term, peer)
    # last grant: (peer, old_promised_term, new_promised_term)
    last_grant: "Optional[Tuple[int, int, int]]"
    # every quorum id minted, in formation order
    quorum_ids: "Tuple[int, ...]"


class ElectionState(NamedTuple):
    peers: "Tuple[EPeer, ...]"
    ghost: EGhost
    crashes: int
    expires: int


def election_initial(cfg: ElectionConfig) -> ElectionState:
    peers = tuple(
        EPeer(
            alive=True,
            promised_term=0,
            promised_to=-1,
            promise_fresh=False,
            leading_term=0,
            candidacy=None,
            quorum_seq=0,
        )
        for _ in range(cfg.n_peers)
    )
    return ElectionState(
        peers=peers,
        ghost=EGhost(leaderships=(), last_grant=None, quorum_ids=()),
        crashes=cfg.crash_budget,
        expires=cfg.expire_budget,
    )


def _e_pair(granter: int, candidate: int, n: int) -> int:
    """Encode a (granter, candidate) pair into the Transition int."""
    return granter * n + candidate


def e_unpair(code: int, n: int) -> "Tuple[int, int]":
    return code // n, code % n


def _e_can_campaign(p: EPeer, i: int) -> bool:
    """The elector's candidacy gate: free when never/self-promised or
    the granted promise lapsed (native election_loop 'stale')."""
    return (
        not p.promise_fresh or p.promised_to == i or p.promised_to == -1
    )


def election_enabled(
    cfg: ElectionConfig,
    st: ElectionState,
    mutations: "FrozenSet[str]" = frozenset(),
) -> "List[Transition]":
    del mutations  # mutated behaviors live in election_apply
    n = cfg.n_peers
    out: "List[Transition]" = []
    for i, p in enumerate(st.peers):
        if not p.alive:
            continue
        if (
            p.leading_term == 0
            and p.candidacy is None
            and _e_can_campaign(p, i)
        ):
            out.append(("e_candidate", i))
        if p.candidacy is not None:
            term, granted = p.candidacy
            for j, q in enumerate(st.peers):
                if j != i and q.alive and j not in granted:
                    out.append(("e_grant", _e_pair(j, i, n)))
            # the election post-check (native election_loop): the
            # candidate's own promise must still back THIS candidacy — a
            # higher-term grant it gave away meanwhile aborts the round
            if (
                2 * len(granted) > n
                and p.promised_to == i
                and p.promised_term == term
            ):
                out.append(("e_elect", i))
        if p.leading_term > 0:
            if len(st.ghost.quorum_ids) < cfg.target_quorums:
                out.append(("e_form", i))
            if st.crashes > 0:
                out.append(("e_crash", i))
    if st.expires > 0:
        for j, q in enumerate(st.peers):
            # renewals stop only when the promised leader cannot renew:
            # dead, deposed, or never a leader (a failed candidacy)
            if q.alive and q.promise_fresh and q.promised_to >= 0:
                holder = st.peers[q.promised_to]
                if not holder.alive or holder.leading_term == 0:
                    out.append(("e_expire", j))
    return sorted(out)


def election_apply(
    cfg: ElectionConfig,
    st: ElectionState,
    t: Transition,
    mutations: "FrozenSet[str]" = frozenset(),
) -> ElectionState:
    op, code = t
    n = cfg.n_peers
    peers = list(st.peers)
    ghost = st.ghost

    if op == "e_candidate":
        i = code
        p = peers[i]
        term = max(p.promised_term, p.leading_term) + 1
        # self-grant under the same rule rpc_lease applies locally
        peers[i] = p._replace(
            promised_term=term,
            promised_to=i,
            promise_fresh=True,
            candidacy=(term, frozenset({i})),
        )
        ghost = ghost._replace(last_grant=(i, p.promised_term, term))
        return st._replace(peers=tuple(peers), ghost=ghost)

    if op == "e_grant":
        j, i = e_unpair(code, n)
        granter = peers[j]
        cand = peers[i]
        assert cand.candidacy is not None
        term, granted = cand.candidacy
        # the grant rule (native rpc_lease): strictly higher term, and an
        # unshielded slot.  A fresh grant shields its holder — including
        # the granter's OWN record while it actually leads; only a
        # failed-candidacy self-promise (holder == granter, not leading)
        # does not shield.
        shielded = (
            granter.promise_fresh
            and granter.promised_to != -1
            and not (
                granter.promised_to == j and granter.leading_term == 0
            )
        )
        if "two_leaders_same_term" in mutations:
            ok = term >= granter.promised_term and not shielded
        else:
            ok = term > granter.promised_term and not shielded
        if ok:
            ghost = ghost._replace(
                last_grant=(j, granter.promised_term, term)
            )
            peers[j] = granter._replace(
                promised_term=term, promised_to=i, promise_fresh=True
            )
            peers[i] = cand._replace(candidacy=(term, granted | {j}))
        else:
            # a refusal teaches the candidate nothing in-model (max_seen
            # only accelerates convergence; safety is grant-side)
            peers[i] = cand._replace(candidacy=(term, granted))
        return st._replace(peers=tuple(peers), ghost=ghost)

    if op == "e_elect":
        i = code
        p = peers[i]
        assert p.candidacy is not None
        term, granted = p.candidacy
        assert 2 * len(granted) > n
        # winning refreshes the leader's own promise record (native
        # become_leader_locked): its slot now shields like any lease
        peers[i] = p._replace(
            leading_term=term,
            candidacy=None,
            quorum_seq=0,
            promised_term=term,
            promised_to=i,
            promise_fresh=True,
        )
        ghost = ghost._replace(leaderships=ghost.leaderships + ((term, i),))
        return st._replace(peers=tuple(peers), ghost=ghost)

    if op == "e_form":
        i = code
        p = peers[i]
        assert p.leading_term > 0
        seq = p.quorum_seq + 1
        if "reuse_quorum_seq_after_takeover" in mutations:
            qid = seq  # no term prefix: repeats the dead leader's values
        else:
            qid = (p.leading_term << _E_TERM_SHIFT) | seq
        peers[i] = p._replace(quorum_seq=seq)
        ghost = ghost._replace(quorum_ids=ghost.quorum_ids + (qid,))
        return st._replace(peers=tuple(peers), ghost=ghost)

    if op == "e_crash":
        i = code
        peers[i] = peers[i]._replace(
            alive=False, leading_term=0, candidacy=None
        )
        return st._replace(peers=tuple(peers), crashes=st.crashes - 1)

    if op == "e_expire":
        j = code
        holder = peers[j].promised_to
        peers[j] = peers[j]._replace(promise_fresh=False)
        # A lapsed promise withdraws its grant from any still-open
        # candidacy it backed — including the candidate's own self-grant:
        # the implementation bounds each candidacy round to the lease
        # window precisely so an election can never complete on expired
        # acknowledgements (election_loop's round-deadline check).
        if holder >= 0:
            h = peers[holder]
            if h.candidacy is not None:
                term, granted = h.candidacy
                if j in granted and term == peers[j].promised_term:
                    peers[holder] = h._replace(
                        candidacy=(term, granted - {j})
                    )
        return st._replace(peers=tuple(peers), expires=st.expires - 1)

    raise AssertionError(f"unknown election transition {t}")


def election_check(
    cfg: ElectionConfig, st: ElectionState
) -> "List[Violation]":
    out: "List[Violation]" = []
    # at-most-one-leader-per-term: no term ever establishes two leaders.
    by_term: "Dict[int, int]" = {}
    for term, peer in st.ghost.leaderships:
        if term in by_term and by_term[term] != peer:
            out.append(
                Violation(
                    "at-most-one-leader-per-term",
                    f"term {term} established two leaders (peer "
                    f"{by_term[term]} and peer {peer}) — a granter "
                    f"acknowledged the same term twice",
                    f"peer{peer}",
                    "e_elect",
                )
            )
        by_term.setdefault(term, peer)
    # term-monotone: (a) a grant never lowers a peer's promised term;
    # (b) successive leaderships carry strictly increasing terms.
    lg = st.ghost.last_grant
    if lg is not None and lg[2] < lg[1]:
        out.append(
            Violation(
                "term-monotone",
                f"peer {lg[0]}'s promised term regressed {lg[1]} -> "
                f"{lg[2]}",
                f"peer{lg[0]}",
                "e_grant",
            )
        )
    for k in range(1, len(st.ghost.leaderships)):
        prev_t, _ = st.ghost.leaderships[k - 1]
        cur_t, cur_p = st.ghost.leaderships[k]
        if cur_t < prev_t or (
            cur_t == prev_t and by_term.get(cur_t) == cur_p
        ):
            out.append(
                Violation(
                    "term-monotone",
                    f"leadership terms did not advance: term {prev_t} "
                    f"then term {cur_t}",
                    f"peer{cur_p}",
                    "e_elect",
                )
            )
    # quorum-id-monotone-across-failover: every minted id strictly
    # exceeds all earlier ones, INCLUDING across a leader change.
    ids = st.ghost.quorum_ids
    for k in range(1, len(ids)):
        if ids[k] <= ids[k - 1]:
            out.append(
                Violation(
                    "quorum-id-monotone-across-failover",
                    f"quorum_id regressed across formations: "
                    f"{ids[k - 1]} then {ids[k]} — a takeover minted ids "
                    f"a previous leader already served",
                    "lighthouse",
                    "e_form",
                )
            )
            break
    return out


def election_is_goal(cfg: ElectionConfig, st: ElectionState) -> bool:
    return len(st.ghost.quorum_ids) >= cfg.target_quorums


# ---------------------------------------------------------------------------
# Durable-store cold-restore sub-model (docs/architecture.md
# "Durable fragment store").
#
# Models the whole-fleet cold start: each disk spills versions fragment
# by fragment with the manifest written LAST (its presence asserts every
# referenced blob was durably written first), the fleet crashes at an
# arbitrary point (including mid-spill), blobs may additionally rot, and
# restore must pick the newest *complete, consistent* cut across the
# union of surviving disks — never serving a torn blob, never mixing
# fragment versions across an outer sync, and degrading to an older
# complete version (or a fresh init) instead of wedging.
#
# Blob cells are "ok" (durably written, digest-valid), "torn" (bytes on
# disk that fail digest verify — a torn write or bit rot), or "-"
# (absent).  The ghost records the spec-side answer (which versions were
# GENUINELY complete at restore) so mutated selection logic cannot
# corrupt the judge.
# ---------------------------------------------------------------------------


class RestoreConfig(NamedTuple):
    """One bounded cold-restore scenario."""

    n_disks: int = 2
    n_fragments: int = 2
    n_versions: int = 2
    rot_budget: int = 1  # blobs that may rot/tear before restore


class DiskRep(NamedTuple):
    # blobs[version][fragment] in {"ok", "torn", "-"}
    blobs: "Tuple[Tuple[str, ...], ...]"
    manifests: "Tuple[bool, ...]"  # manifest durably on disk, per version


class RestoreGhost(NamedTuple):
    """Spec-side restore record; never read by the (mutable) behavior."""

    # versions genuinely complete at restore time: some disk holds the
    # manifest and the union of digest-VALID blobs covers every fragment
    completes: "Tuple[int, ...]"
    chosen: int  # version the behavior restored (-1 = fresh init)
    # per-fragment provenance: (fragment, version served from, torn?)
    sources: "Tuple[Tuple[int, int, bool], ...]"


class RestoreState(NamedTuple):
    disks: "Tuple[DiskRep, ...]"
    crashed: bool
    restored: bool
    rot: int  # rot budget remaining
    ghost: "Optional[RestoreGhost]"


def restore_initial(cfg: RestoreConfig) -> RestoreState:
    empty = tuple(
        tuple("-" for _ in range(cfg.n_fragments))
        for _ in range(cfg.n_versions)
    )
    disks = tuple(
        DiskRep(blobs=empty, manifests=(False,) * cfg.n_versions)
        for _ in range(cfg.n_disks)
    )
    return RestoreState(
        disks=disks,
        crashed=False,
        restored=False,
        rot=cfg.rot_budget,
        ghost=None,
    )


def _disk_next_write(
    cfg: RestoreConfig, d: DiskRep
) -> "Optional[Tuple[int, int]]":
    """The disk's next spill write as (version, fragment), fragment == -1
    meaning the manifest: versions spill in order, blobs before the
    manifest (the durability contract store.py enforces)."""
    for v in range(cfg.n_versions):
        if d.manifests[v]:
            continue
        for f in range(cfg.n_fragments):
            if d.blobs[v][f] == "-":
                return (v, f)
        return (v, -1)
    return None


def _rot_target(d: DiskRep) -> "Optional[Tuple[int, int]]":
    """The blob rot flips: the first 'ok' blob of the NEWEST version
    holding any — deterministic, and exactly the blob whose loss makes
    'manifest present but cut torn' reachable."""
    for v in range(len(d.blobs) - 1, -1, -1):
        for f, cell in enumerate(d.blobs[v]):
            if cell == "ok":
                return (v, f)
    return None


def restore_enabled(
    cfg: RestoreConfig,
    st: RestoreState,
    mutations: "FrozenSet[str]" = frozenset(),
) -> "List[Transition]":
    del mutations  # the mutated behaviors live in restore_apply
    out: "List[Transition]" = []
    if st.restored:
        return out
    if not st.crashed:
        out.append(("crash", -1))
        for i, d in enumerate(st.disks):
            if _disk_next_write(cfg, d) is not None:
                out.append(("spill", i))
    else:
        out.append(("restore", -1))
    if st.rot > 0:
        for i, d in enumerate(st.disks):
            if _rot_target(d) is not None:
                out.append(("rot", i))
    return sorted(out)


def restore_apply(
    cfg: RestoreConfig,
    st: RestoreState,
    t: Transition,
    mutations: "FrozenSet[str]" = frozenset(),
) -> RestoreState:
    op, i = t
    disks = list(st.disks)

    if op == "spill":
        d = disks[i]
        nxt = _disk_next_write(cfg, d)
        assert nxt is not None
        v, f = nxt
        if f == -1:
            manifests = list(d.manifests)
            manifests[v] = True
            disks[i] = d._replace(manifests=tuple(manifests))
        else:
            blobs = [list(row) for row in d.blobs]
            blobs[v][f] = "ok"
            disks[i] = d._replace(blobs=tuple(tuple(r) for r in blobs))
        return st._replace(disks=tuple(disks))

    if op == "rot":
        d = disks[i]
        tgt = _rot_target(d)
        assert tgt is not None
        v, f = tgt
        blobs = [list(row) for row in d.blobs]
        blobs[v][f] = "torn"
        disks[i] = d._replace(blobs=tuple(tuple(r) for r in blobs))
        return st._replace(disks=tuple(disks), rot=st.rot - 1)

    if op == "crash":
        return st._replace(crashed=True)

    if op == "restore":
        frags_all = frozenset(range(cfg.n_fragments))

        def union(v: int, count_torn: bool) -> "FrozenSet[int]":
            got = set()
            for d in disks:
                if not d.manifests[v]:
                    continue
                for f in range(cfg.n_fragments):
                    cell = d.blobs[v][f]
                    if cell == "ok" or (count_torn and cell == "torn"):
                        got.add(f)
            return frozenset(got)

        # spec-side truth: genuinely complete versions (torn excluded)
        completes = tuple(
            v for v in range(cfg.n_versions) if union(v, False) == frags_all
        )

        chosen = -1
        sources: "List[Tuple[int, int, bool]]" = []
        if "serve_torn_blob" in mutations:
            # BUG: digest verify skipped — torn blobs count as servable,
            # so a torn cut can be chosen and torn bytes land in state.
            for v in range(cfg.n_versions - 1, -1, -1):
                if union(v, True) == frags_all:
                    chosen = v
                    valid = union(v, False)
                    sources = [
                        (f, v, f not in valid) for f in sorted(frags_all)
                    ]
                    break
        elif "mix_versions_in_cut" in mutations:
            # BUG: the newest manifested version is chosen even when
            # incomplete, its holes filled from OLDER versions' blobs —
            # the restored state splices fragments across outer syncs.
            newest = max(
                (
                    v
                    for v in range(cfg.n_versions)
                    if any(d.manifests[v] for d in disks)
                ),
                default=-1,
            )
            if newest >= 0:
                mixed_srcs: "Optional[List[Tuple[int, int, bool]]]" = []
                for f in sorted(frags_all):
                    src = next(
                        (
                            v
                            for v in range(newest, -1, -1)
                            if f in union(v, False)
                        ),
                        None,
                    )
                    if src is None:
                        # not even an older blob: this (buggy) selector
                        # still degrades to fresh init rather than a cut
                        # with holes — the modeled bug is the splice
                        mixed_srcs = None
                        break
                    mixed_srcs.append((f, src, False))
                if mixed_srcs is not None:
                    chosen = newest
                    sources = mixed_srcs
        else:
            # clean behavior (store.select_cut): newest version whose
            # digest-valid union covers every fragment; nothing -> fresh
            for v in range(cfg.n_versions - 1, -1, -1):
                if union(v, False) == frags_all:
                    chosen = v
                    sources = [(f, v, False) for f in sorted(frags_all)]
                    break

        ghost = RestoreGhost(
            completes=completes, chosen=chosen, sources=tuple(sources)
        )
        return st._replace(restored=True, ghost=ghost)

    raise AssertionError(f"unknown restore transition {t}")


def restore_check(cfg: RestoreConfig, st: RestoreState) -> "List[Violation]":
    out: "List[Violation]" = []
    g = st.ghost
    if not st.restored or g is None:
        return out
    # restore-cut-complete: a restored cut serves every fragment from
    # digest-VALID bytes — a torn blob is a missing fragment, and a cut
    # with holes must never be committed as restored state.
    torn_used = [s for s in g.sources if s[2]]
    if g.chosen >= 0 and (
        torn_used or len(g.sources) < cfg.n_fragments
    ):
        detail = (
            f"fragments {sorted(s[0] for s in torn_used)} served from "
            f"torn blobs"
            if torn_used
            else f"only {len(g.sources)} of {cfg.n_fragments} fragments "
            f"sourced"
        )
        out.append(
            Violation(
                "restore-cut-complete",
                f"cold restore committed v{g.chosen} with an incomplete "
                f"or corrupt cut: {detail} — torn blobs must read as "
                f"missing and incomplete cuts must degrade to an older "
                f"complete version",
                "fleet",
                "restore",
            )
        )
    # restore-cut-consistent: every fragment of the restored state comes
    # from the SAME version — mixing versions splices state across outer
    # syncs into a model that never existed.
    mixed = sorted({s[1] for s in g.sources})
    if g.chosen >= 0 and any(s[1] != g.chosen for s in g.sources):
        out.append(
            Violation(
                "restore-cut-consistent",
                f"cold restore of v{g.chosen} mixed fragment versions "
                f"{mixed} in one cut — fragments must never be filled "
                f"from older versions' blobs",
                "fleet",
                "restore",
            )
        )
    # restore-newest-complete: selection is canonical — the newest
    # genuinely complete version when one exists, fresh init otherwise
    # (degrade-never-wedge, and never a cut the spec says is incomplete).
    want = max(g.completes) if g.completes else -1
    if not out and g.chosen != want:
        out.append(
            Violation(
                "restore-newest-complete",
                f"cold restore chose v{g.chosen} but the newest complete "
                f"version on the surviving disks is "
                f"{'v%d' % want if want >= 0 else 'none (fresh init)'}",
                "fleet",
                "restore",
            )
        )
    return out


def restore_is_goal(cfg: RestoreConfig, st: RestoreState) -> bool:
    return st.restored
