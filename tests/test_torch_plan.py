"""The port's plan IR and plan verifier against the JAX package's.

- Every small-world plan the JAX package's gate enumerates
  (``plan_verify.explore_plans``) is built by both packages' adapters: the
  plans must be equal and draw the same verdict with the same violated
  invariant names.
- Each of the 11 seeded plan mutations is caught by the same invariant in
  both.
- ``stripe_roster`` / ``stripe_source_cohort`` agree on seeded random
  rosters.
- The port's hierarchical quantized allreduce runs the live plan check
  under ``TORCHFT_PLAN_VERIFY=1``: it counts an accepted reduction plan per
  rank and logs no warning.
"""

import dataclasses
import logging
import random
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from torchft_tpu.analysis import plan_ir as jpir
from torchft_tpu.analysis import plan_verify as jpv
from torchft_tpu_torch.analysis import plan_ir as tpir
from torchft_tpu_torch.analysis import plan_verify as tpv
from torchft_tpu_torch.coordination import StoreServer
from torchft_tpu_torch.ops import collectives as tcoll
from torchft_tpu_torch.parallel.process_group import REDUCE_AVG, ProcessGroupTCP
from torchft_tpu_torch.utils import metrics as tmetrics


def _recorded_exploration(pv, monkeypatch):
    """Run ``pv.explore_plans()`` and record, per plan it verifies, the
    plan itself and the names of the invariants it violates."""
    calls = []
    verify = pv.verify_plan

    def recording(ir):
        out = verify(ir)
        calls.append((dataclasses.asdict(ir), [v.invariant for v in out]))
        return out

    monkeypatch.setattr(pv, "verify_plan", recording)
    result = pv.explore_plans()
    return calls, result


def test_every_enumerated_plan_matches_jax(monkeypatch):
    tcalls, tres = _recorded_exploration(tpv, monkeypatch)
    jcalls, jres = _recorded_exploration(jpv, monkeypatch)
    assert len(tcalls) == len(jcalls) > 500
    for i, (t, j) in enumerate(zip(tcalls, jcalls)):
        assert t == j, i
    assert tres["plans"] == jres["plans"]
    assert [v.invariant for v in tres["violations"]] == [
        v.invariant for v in jres["violations"]
    ] == []
    for k in range(1, 6):
        assert tpv.elastic_stability(f"hosts:{k}", range(1, 10)) == []


@pytest.mark.parametrize("name", sorted(m.name for m in jpv.PLAN_MUTATIONS))
def test_seeded_mutation_caught_by_the_same_invariant(name):
    tv = [v.invariant for v in tpv.check_plan_mutation(name)]
    jv = [v.invariant for v in jpv.check_plan_mutation(name)]
    catches = next(m.catches for m in jpv.PLAN_MUTATIONS if m.name == name)
    assert tv == jv
    assert tv and tv[0] == catches


def test_mutation_catalogs_match():
    assert [dataclasses.astuple(m) for m in tpv.PLAN_MUTATIONS] == [
        dataclasses.astuple(m) for m in jpv.PLAN_MUTATIONS
    ]
    assert len(tpv.PLAN_MUTATIONS) == 11
    assert tuple(tpv.INVARIANTS) == tuple(jpv.INVARIANTS)


def _random_participants(rng, n, max_step):
    out = []
    for i in range(n):
        step = max_step if rng.random() < 0.7 else max_step - rng.randint(1, 3)
        p = {
            "replica_id": f"rep{i}",
            "address": f"http://rep{i}:8470" if rng.random() < 0.9 else "",
            "step": step,
        }
        if rng.random() < 0.05:
            p = "corrupt-entry"
        out.append(p)
    return out


def test_stripe_roster_and_cohort_match_jax_on_random_rosters():
    rng = random.Random(19)
    for _ in range(200):
        n = rng.randint(1, 10)
        max_step = rng.randint(5, 50)
        parts = _random_participants(rng, n, max_step)
        max_sources = rng.randint(1, 6)
        primary = rng.randrange(n)
        roster = tpir.stripe_roster(parts, max_step, primary, max_sources)
        assert roster == jpir.stripe_roster(parts, max_step, primary, max_sources)
        assert tpir.stripe_source_cohort(parts, max_step, max_sources) == (
            jpir.stripe_source_cohort(parts, max_step, max_sources)
        )
        sources = ["http://primary:1"] + roster
        nfrag, leaves = rng.randint(1, 9), rng.randint(1, 40)
        tir = tpir.stripe_ir(sources, nfrag, leaves, step=max_step)
        jir = jpir.stripe_ir(sources, nfrag, leaves, step=max_step)
        assert dataclasses.asdict(tir) == dataclasses.asdict(jir)
        assert tpv.verify_plan(tir) == []


def test_hierarchical_allreduce_runs_the_live_plan_check(monkeypatch, caplog):
    monkeypatch.setenv("TORCHFT_PLAN_VERIFY", "1")
    world = 4
    accept = tmetrics.PLAN_VERIFY_TOTAL.labels(plane="reduction", verdict="accept")
    reject = tmetrics.PLAN_VERIFY_TOTAL.labels(plane="reduction", verdict="reject")
    before = (accept.get(), reject.get())
    store = StoreServer()
    pgs = [ProcessGroupTCP(timeout=20.0) for _ in range(world)]
    rng = np.random.default_rng(4)
    data = [rng.standard_normal((8, 256)).astype(np.float32) for _ in range(world)]

    def run(fn):
        with ThreadPoolExecutor(max_workers=world) as ex:
            return [f.result(timeout=60) for f in [ex.submit(fn, r) for r in range(world)]]

    try:
        run(lambda r: pgs[r].configure(f"{store.address()}/plan", f"r{r}", r, world))
        with caplog.at_level(logging.WARNING):
            out = run(lambda r: tcoll.allreduce_quantized(
                [torch.from_numpy(data[r])], REDUCE_AVG, pgs[r], topology="hosts:2",
            ).wait(timeout=30))
    finally:
        for pg in pgs:
            pg.shutdown()
        store.shutdown()
    for r in range(1, world):
        assert torch.equal(out[r][0], out[0][0])
    assert accept.get() - before[0] == world
    assert reject.get() == before[1]
    assert not [r for r in caplog.records if "plan" in r.getMessage().lower()]
