"""Bounded exhaustive checker for the quorum-protocol model (tft-verify).

Explores every interleaving of the transition system in
:mod:`torchft_tpu_torch.analysis.protocol_model` up to the scenario's bounds,
with two sound reductions that keep the clean configs inside the tier-1
time budget:

* **state deduplication** — the full state (including the spec's ghost
  fields) is hashable; a state reached twice is expanded once;
* **DPOR-style persistent sets** — transitions in ``INVISIBLE_OPS`` only
  rewrite the acting replica's private planning fields, are enabled
  deterministically, commute with every other actor's transitions, and
  cannot themselves violate an invariant; when any is enabled, only the
  first is expanded (the other interleavings reach the same states).

A safety violation returns a :class:`CheckResult` carrying the full
transition path; :func:`trace_to_flight_dump` rewrites that path into
the flight-recorder JSONL dialect so ``torchft-diagnose`` renders the
counterexample like any production post-mortem and names the violating
replica and phase.

Liveness is checked separately and *bounded*: :func:`run_schedule`
drives the model with deterministic fair schedules (rotating priority
over enabled transitions) through churn scenarios and requires the
fleet to reach the goal step within a transition budget — a livelock
shows up as budget exhaustion with the looping tail of the schedule in
hand.
"""

from __future__ import annotations

import json
from typing import Any, Dict, FrozenSet, List, NamedTuple, Optional, Tuple

from torchft_tpu_torch.analysis.protocol_model import (
    INVISIBLE_OPS,
    MODEL_PHASE_OPS,
    ElectionConfig,
    ModelConfig,
    ResizeConfig,
    RestoreConfig,
    State,
    Transition,
    Violation,
    apply_transition,
    check_invariants,
    e_unpair,
    election_apply,
    election_check,
    election_enabled,
    election_initial,
    election_is_goal,
    enabled_transitions,
    initial_state,
    is_goal,
    resize_apply,
    resize_check,
    resize_enabled,
    resize_initial,
    resize_is_goal,
    restore_apply,
    restore_check,
    restore_enabled,
    restore_initial,
    restore_is_goal,
    vote_apply,
    vote_check,
    vote_enabled,
    vote_initial,
)

__all__ = [
    "CheckResult",
    "explore",
    "explore_votes",
    "explore_resize",
    "explore_election",
    "explore_restore",
    "run_schedule",
    "SCENARIOS",
    "RESIZE_SCENARIOS",
    "ELECTION_SCENARIOS",
    "RESTORE_SCENARIOS",
    "LIVENESS_SCHEDULES",
    "trace_to_flight_dump",
    "write_flight_dump",
]


class CheckResult(NamedTuple):
    ok: bool
    states: int  # distinct states visited
    transitions: int  # transitions applied
    goal_states: int  # states where every live replica hit the target
    violation: "Optional[Violation]"
    # the counterexample: ((op, actor_index, replica_id, step, quorum_id), ...)
    trace: "Tuple[Tuple[str, int, str, int, int], ...]"


def _trace_entry(
    st: State, t: Transition
) -> "Tuple[str, int, str, int, int]":
    op, i = t
    if i < 0:
        rid = "lighthouse"
        step = max((r.step for r in st.reps), default=0)
    else:
        r = st.reps[i]
        rid = f"r{i}:{r.inc}"
        step = r.step
    return (op, i, rid, step, st.lh.quorum_id)


def explore(
    cfg: ModelConfig,
    mutations: "FrozenSet[str]" = frozenset(),
    max_states: int = 400_000,
    max_depth: int = 250,
) -> CheckResult:
    """Exhaustive DFS over the bounded state space; stops at the first
    invariant violation (safety is per-state, so the first hit carries a
    minimal-enough path to read)."""
    init = initial_state(cfg)
    v0 = check_invariants(cfg, init)
    if v0:
        return CheckResult(False, 1, 0, 0, v0[0], ())
    seen = {init}
    goal_states = 0
    transitions = 0
    # DFS stack: (state, iterator-position over its transitions, path)
    stack: "List[Tuple[State, List[Transition], int]]" = []
    path: "List[Tuple[str, int, str, int, int]]" = []

    def expandable(st: State) -> "List[Transition]":
        ts = enabled_transitions(cfg, st, mutations)
        invisible = [t for t in ts if t[0] in INVISIBLE_OPS]
        if invisible:
            return invisible[:1]
        return ts

    stack.append((init, expandable(init), 0))
    while stack:
        st, ts, idx = stack[-1]
        if idx >= len(ts):
            stack.pop()
            if path:
                path.pop()
            continue
        stack[-1] = (st, ts, idx + 1)
        t = ts[idx]
        nxt = apply_transition(cfg, st, t, mutations)
        transitions += 1
        entry = _trace_entry(st, t)
        if nxt in seen:
            continue
        seen.add(nxt)
        path.append(entry)
        violations = check_invariants(cfg, nxt)
        if violations:
            return CheckResult(
                False,
                len(seen),
                transitions,
                goal_states,
                violations[0],
                tuple(path),
            )
        if is_goal(cfg, nxt):
            goal_states += 1
            path.pop()
            continue  # goal states are terminal for the bounded run
        if len(seen) >= max_states:
            raise RuntimeError(
                f"state-space bound exceeded ({max_states} states) — "
                f"shrink the scenario"
            )
        if len(stack) >= max_depth:
            path.pop()
            continue
        stack.append((nxt, expandable(nxt), 0))
    return CheckResult(True, len(seen), transitions, goal_states, None, ())


def explore_votes(
    world: int = 2,
    steps: int = 2,
    drops: int = 1,
    mutations: "FrozenSet[str]" = frozenset(),
    max_states: int = 200_000,
) -> CheckResult:
    """Exhaustive exploration of the should_commit vote-barrier sub-model
    (delivery orders x connection drops x client recovery behavior)."""
    init = vote_initial(world, steps, drops)
    seen = {init}
    transitions = 0
    goal = 0
    stack = [(init, vote_enabled(init, steps, mutations), 0)]
    path: "List[Tuple[str, int, str, int, int]]" = []
    while stack:
        st, ts, idx = stack[-1]
        if idx >= len(ts):
            stack.pop()
            if path:
                path.pop()
            continue
        stack[-1] = (st, ts, idx + 1)
        t = ts[idx]
        nxt = vote_apply(st, t)
        transitions += 1
        if nxt in seen:
            continue
        seen.add(nxt)
        path.append((t[0], t[1], f"rank{t[1]}", st.step, 0))
        violations = vote_check(nxt)
        if violations:
            return CheckResult(
                False, len(seen), transitions, goal, violations[0], tuple(path)
            )
        if len(nxt.decisions) >= steps:
            goal += 1
            path.pop()
            continue
        if len(seen) >= max_states:
            raise RuntimeError("vote state-space bound exceeded")
        stack.append((nxt, vote_enabled(nxt, steps, mutations), 0))
    return CheckResult(True, len(seen), transitions, goal, None, ())


def explore_resize(
    cfg: "ResizeConfig" = ResizeConfig(),
    mutations: "FrozenSet[str]" = frozenset(),
    max_states: int = 200_000,
) -> CheckResult:
    """Exhaustive exploration of the online-parallelism-switching
    (resize) sub-model: plan at quorum under a monotone layout epoch,
    stage (can fail, groups can crash mid-reshard), commit on unanimous
    epoch reports or roll back and burn the epoch."""
    init = resize_initial(cfg)
    seen = {init}
    transitions = 0
    goal = 0
    stack = [(init, resize_enabled(cfg, init, mutations), 0)]
    path: "List[Tuple[str, int, str, int, int]]" = []
    while stack:
        st, ts, idx = stack[-1]
        if idx >= len(ts):
            stack.pop()
            if path:
                path.pop()
            continue
        stack[-1] = (st, ts, idx + 1)
        t = ts[idx]
        nxt = resize_apply(cfg, st, t, mutations)
        transitions += 1
        if nxt in seen:
            continue
        seen.add(nxt)
        op, i = t
        rid = "lighthouse" if i < 0 else f"r{i}:0"
        epoch = max((r.epoch for r in st.reps), default=0)
        path.append((op, i, rid, st.switches, epoch))
        violations = resize_check(cfg, nxt)
        if violations:
            return CheckResult(
                False, len(seen), transitions, goal, violations[0], tuple(path)
            )
        if resize_is_goal(cfg, nxt):
            goal += 1
            path.pop()
            continue
        if len(seen) >= max_states:
            raise RuntimeError("resize state-space bound exceeded")
        stack.append((nxt, resize_enabled(cfg, nxt, mutations), 0))
    return CheckResult(True, len(seen), transitions, goal, None, ())


def explore_election(
    cfg: "ElectionConfig" = ElectionConfig(),
    mutations: "FrozenSet[str]" = frozenset(),
    max_states: int = 400_000,
) -> CheckResult:
    """Exhaustive exploration of the coordination-plane HA (leased
    leader election) sub-model: candidacies, per-peer lease grants,
    majority elections, leader crashes, promise expiry, and the
    term-prefixed quorum ids a takeover must keep monotone."""
    init = election_initial(cfg)
    seen = {init}
    transitions = 0
    goal = 0
    stack = [(init, election_enabled(cfg, init, mutations), 0)]
    path: "List[Tuple[str, int, str, int, int]]" = []
    while stack:
        st, ts, idx = stack[-1]
        if idx >= len(ts):
            stack.pop()
            if path:
                path.pop()
            continue
        stack[-1] = (st, ts, idx + 1)
        t = ts[idx]
        nxt = election_apply(cfg, st, t, mutations)
        transitions += 1
        if nxt in seen:
            continue
        seen.add(nxt)
        op, code = t
        if op == "e_grant":
            granter, _cand = e_unpair(code, cfg.n_peers)
            rid = f"peer{granter}"
        else:
            rid = f"peer{code}"
        term = max((p.leading_term for p in st.peers), default=0)
        qid = st.ghost.quorum_ids[-1] if st.ghost.quorum_ids else 0
        path.append((op, code, rid, term, qid))
        violations = election_check(cfg, nxt)
        if violations:
            return CheckResult(
                False, len(seen), transitions, goal, violations[0], tuple(path)
            )
        if election_is_goal(cfg, nxt):
            goal += 1
            path.pop()
            continue
        if len(seen) >= max_states:
            raise RuntimeError("election state-space bound exceeded")
        stack.append((nxt, election_enabled(cfg, nxt, mutations), 0))
    return CheckResult(True, len(seen), transitions, goal, None, ())


def explore_restore(
    cfg: "RestoreConfig" = RestoreConfig(),
    mutations: "FrozenSet[str]" = frozenset(),
    max_states: int = 400_000,
) -> CheckResult:
    """Exhaustive exploration of the durable-store cold-restore sub-model:
    per-disk spill orders (blobs before manifest), bounded bit-rot,
    whole-fleet crash, and the fleet-wide cut selection a cold start must
    keep complete, version-consistent, and newest-first."""
    init = restore_initial(cfg)
    seen = {init}
    transitions = 0
    goal = 0
    stack = [(init, restore_enabled(cfg, init, mutations), 0)]
    path: "List[Tuple[str, int, str, int, int]]" = []
    while stack:
        st, ts, idx = stack[-1]
        if idx >= len(ts):
            stack.pop()
            if path:
                path.pop()
            continue
        stack[-1] = (st, ts, idx + 1)
        t = ts[idx]
        nxt = restore_apply(cfg, st, t, mutations)
        transitions += 1
        if nxt in seen:
            continue
        seen.add(nxt)
        op, i = t
        rid = "fleet" if i < 0 else f"disk{i}"
        chosen = nxt.ghost.chosen if nxt.ghost is not None else -1
        path.append((op, i, rid, max(chosen, 0), 0))
        violations = restore_check(cfg, nxt)
        if violations:
            return CheckResult(
                False, len(seen), transitions, goal, violations[0], tuple(path)
            )
        if restore_is_goal(cfg, nxt):
            goal += 1
            path.pop()
            continue
        if len(seen) >= max_states:
            raise RuntimeError("restore state-space bound exceeded")
        stack.append((nxt, restore_enabled(cfg, nxt, mutations), 0))
    return CheckResult(True, len(seen), transitions, goal, None, ())


# ---------------------------------------------------------------------------
# scenarios (the bounded state spaces tier-1 proves clean)
# ---------------------------------------------------------------------------

#: name -> ModelConfig. Sized so the full set explores clean well inside
#: the 30 s tier-1 budget (tests/test_torch_verify.py pins the wall time).
SCENARIOS: "Dict[str, ModelConfig]" = {
    # two replicas, two committed steps, no churn: the steady-state loop
    "steady": ModelConfig(n_replicas=2, min_replicas=1, target_steps=2),
    # a crash and a fresh incarnation rejoining mid-run (heal path,
    # supersession stamps, heartbeat expiry of the dead incarnation)
    "churn": ModelConfig(
        n_replicas=2,
        min_replicas=1,
        target_steps=1,
        crash_budget=1,
        restart_budget=1,
    ),
    # one transient collective abort with everyone alive: the whole
    # cohort votes no and the next quorum — UNCHANGED membership — must
    # bump quorum_id for the reported commit failures
    "abort": ModelConfig(
        n_replicas=2,
        min_replicas=1,
        target_steps=2,
        abort_budget=1,
    ),
    # start mid-run with two stragglers behind one up-to-date replica:
    # the heal-source round-robin with more than one possible source.
    # quorum_budget bounds the protocol rounds (the membership-overlap
    # constraint makes the unbounded space explode in re-join cycles).
    "skewed": ModelConfig(
        n_replicas=3,
        min_replicas=1,
        target_steps=1,
        initial_steps=(1, 0, 0),
        quorum_budget=3,
    ),
    # a wedged trainer whose manager keeps heartbeating, restarted as a
    # new incarnation: the zombie/supersession state space
    "zombie": ModelConfig(
        n_replicas=2,
        min_replicas=1,
        target_steps=1,
        wedge_budget=1,
        restart_budget=1,
    ),
    # one participant vs two partitioned-away heartbeaters: the majority
    # guard must hold the minority side at bay (no quorum ever forms)
    "partition": ModelConfig(
        n_replicas=3,
        min_replicas=1,
        target_steps=1,
        bystanders=frozenset({1, 2}),
    ),
    # a shrink_only joiner must never grow the quorum
    "shrink": ModelConfig(
        n_replicas=3,
        min_replicas=1,
        target_steps=1,
        shrink_only=frozenset({2}),
    ),
}

#: online-parallelism-switching sub-model scenarios (explore_resize):
#: membership churn + reshard-transfer failures around the two-phase
#: layout-epoch commit.
RESIZE_SCENARIOS: "Dict[str, ResizeConfig]" = {
    # a shrink (crash), a grow (rejoin) and one failed reshard transfer
    # around two committed switches — the full plan/stage/commit/rollback
    # space of the layout switch protocol
    "resize": ResizeConfig(
        n_replicas=3,
        target_switches=2,
        crash_budget=1,
        join_budget=1,
        stage_fail_budget=1,
    ),
}

#: coordination-plane HA sub-model scenarios (explore_election): three
#: lighthouse peers, one leader crash, quorums formed across the
#: takeover — the full candidacy/grant/expiry interleaving space of the
#: leased election plus the term-prefixed id discipline.
ELECTION_SCENARIOS: "Dict[str, ElectionConfig]" = {
    "election": ElectionConfig(
        n_peers=3, target_quorums=2, crash_budget=1, expire_budget=3
    ),
}

#: durable-store cold-restore sub-model scenarios (explore_restore): two
#: disks spilling two versions of a two-fragment cut in every order, one
#: bit-rot, whole-fleet crash, then the cold-start cut selection.
RESTORE_SCENARIOS: "Dict[str, RestoreConfig]" = {
    "restore": RestoreConfig(
        n_disks=2, n_fragments=2, n_versions=2, rot_budget=1
    ),
}

#: scenario used to catch each mutation (the smallest space where the
#: mutated behavior is reachable)
MUTATION_SCENARIOS: "Dict[str, str]" = {
    "skip_commit_failure_bump": "abort",
    "reuse_quorum_id": "abort",
    "heal_from_stale": "skewed",
    "drop_majority_guard": "partition",
    "commit_despite_error": "abort",
    "zombie_rejoin": "zombie",
    "ignore_shrink_only": "shrink",
    "resend_vote": "votes",  # vote-barrier sub-model
    "commit_mixed_epochs": "resize",  # parallelism-switching sub-model
    "reuse_epoch_after_rollback": "resize",
    "two_leaders_same_term": "election",  # coordination-plane HA sub-model
    "reuse_quorum_seq_after_takeover": "election",
    "serve_torn_blob": "restore",  # durable-store cold-restore sub-model
    "mix_versions_in_cut": "restore",
}


def check_mutation(name: str) -> CheckResult:
    """Run the mutated model over its scenario; a correct checker returns
    ok=False with the expected invariant in the violation."""
    scenario = MUTATION_SCENARIOS[name]
    if scenario == "votes":
        return explore_votes(mutations=frozenset({name}))
    if scenario in RESIZE_SCENARIOS:
        return explore_resize(
            RESIZE_SCENARIOS[scenario], mutations=frozenset({name})
        )
    if scenario in ELECTION_SCENARIOS:
        return explore_election(
            ELECTION_SCENARIOS[scenario], mutations=frozenset({name})
        )
    if scenario in RESTORE_SCENARIOS:
        return explore_restore(
            RESTORE_SCENARIOS[scenario], mutations=frozenset({name})
        )
    return explore(SCENARIOS[scenario], mutations=frozenset({name}))


# ---------------------------------------------------------------------------
# bounded liveness (no livelock under churn schedules)
# ---------------------------------------------------------------------------

#: deterministic fair schedules: (name, scenario, rotation offset)
LIVENESS_SCHEDULES: "Tuple[Tuple[str, str, int], ...]" = (
    ("steady-rr0", "steady", 0),
    ("steady-rr1", "steady", 1),
    ("churn-rr0", "churn", 0),
    ("churn-rr2", "churn", 2),
    ("abort-rr0", "abort", 0),
    ("zombie-rr0", "zombie", 0),
    ("skewed-rr0", "skewed", 0),
    ("shrink-rr1", "shrink", 1),
)


def run_schedule(
    cfg: ModelConfig,
    rotation: int = 0,
    max_transitions: int = 400,
) -> "Tuple[bool, int, List[Tuple[str, int, str, int, int]]]":
    """Drive the model with a deterministic fair scheduler: at each state
    pick the enabled transition at the rotating priority index.  Returns
    (reached_goal, transitions_used, trace).  Fair because the rotation
    advances every pick, so no persistently-enabled transition is starved
    — a goal miss within the budget is a livelock (or a dead config)."""
    st = initial_state(cfg)
    trace: "List[Tuple[str, int, str, int, int]]" = []
    k = rotation
    for n in range(max_transitions):
        if is_goal(cfg, st):
            return True, n, trace
        ts = enabled_transitions(cfg, st)
        if not ts:
            return is_goal(cfg, st), n, trace
        t = ts[k % len(ts)]
        k += 1
        trace.append(_trace_entry(st, t))
        st = apply_transition(cfg, st, t)
        if check_invariants(cfg, st):
            return False, n, trace
    return is_goal(cfg, st), max_transitions, trace


# ---------------------------------------------------------------------------
# counterexample -> flight-recorder dialect (torchft-diagnose input)
# ---------------------------------------------------------------------------


def trace_to_flight_dump(
    result: CheckResult, t0_ns: int = 1_700_000_000_000_000_000
) -> "List[Dict[str, Any]]":
    """Rewrite a violation trace as flight-recorder JSONL records
    (utils/flightrecorder.py dump dialect) so ``torchft-diagnose`` can
    render the counterexample: the violating replica reports the failed
    phase, and — because its records stop at the violation while every
    other replica gets a later record — the silent-death culprit signal
    names it without bespoke tooling."""
    assert result.violation is not None and result.trace
    v = result.violation
    step_ms = 100_000_000  # 100 ms apart: diagnose's gap thresholds apply
    records: "List[Dict[str, Any]]" = [
        {
            "flight": "meta",
            "reason": f"tft-verify counterexample: {v.invariant}",
            "trigger": "model_checker",
            "ts": t0_ns / 1e9,
            "pid": 0,
            "records": len(result.trace) + 1,
        }
    ]
    t = t0_ns
    seen_rids = set()
    for op, _i, rid, step, qid in result.trace:
        t += step_ms
        seen_rids.add(rid)
        records.append(
            {
                "flight": "rec",
                "op": MODEL_PHASE_OPS.get(op, op),
                "model_op": op,
                "status": "ok",
                "start_ns": t,
                "end_ns": t + step_ms // 2,
                "replica_id": rid,
                "step": step,
                "quorum_id": qid,
                "kind": "phase",
            }
        )
    # the violation itself: an error record from the violating replica
    t += step_ms
    last = result.trace[-1]
    records.append(
        {
            "flight": "rec",
            "op": MODEL_PHASE_OPS.get(v.phase, v.phase),
            "model_op": v.phase,
            "status": "error",
            "start_ns": t,
            "end_ns": t + step_ms // 2,
            "replica_id": v.replica_id,
            "step": last[3],
            "quorum_id": last[4],
            "kind": "phase",
            "reason": f"invariant {v.invariant} violated: {v.message}",
            "invariant": v.invariant,
        }
    )
    # peers produce evidence after the violator stops: the survivors'
    # view diagnose uses to single out the replica whose records end
    for rid in sorted(seen_rids - {v.replica_id}):
        t += step_ms
        records.append(
            {
                "flight": "rec",
                "op": "quorum_rpc",
                "model_op": "post",
                "status": "ok",
                "start_ns": t,
                "end_ns": t + step_ms // 2,
                "replica_id": rid,
                "step": last[3],
                "quorum_id": last[4],
                "kind": "phase",
            }
        )
    return records


def write_flight_dump(result: CheckResult, path: str) -> str:
    with open(path, "w", encoding="utf-8") as fh:
        for rec in trace_to_flight_dump(result):
            fh.write(json.dumps(rec) + "\n")
    return path
