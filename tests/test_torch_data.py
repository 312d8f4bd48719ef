"""The port's elastic data samplers against the JAX package's.

``torchft_tpu_torch/data.py`` keeps numpy's permutation, so every worker
draws the same shard, index for index, as a JAX worker with the same
arguments; the indices are Python ints.  The stateful sampler's state
round-trips and resumes mid-epoch exactly.
"""

import itertools

import pytest

from torchft_tpu import data as jdata
from torchft_tpu_torch import data as tdata

GRID = [
    # (dataset_len, num_replica_groups, num_replicas)
    (1, 1, 1), (7, 2, 1), (10, 3, 1), (17, 2, 2), (64, 4, 2), (101, 3, 3),
]


@pytest.mark.parametrize("shuffle,seed", [(False, 0), (True, 0), (True, 1234)])
@pytest.mark.parametrize("n,groups,replicas", GRID)
def test_indices_equal_the_jax_package_s(n, groups, replicas, shuffle, seed):
    for rg, rank, epoch in itertools.product(
        range(groups), range(replicas), (0, 1, 5)
    ):
        kw = dict(replica_rank=rg, num_replica_groups=groups, rank=rank,
                  num_replicas=replicas, shuffle=shuffle, seed=seed)
        port, ref = tdata.DistributedSampler(n, **kw), jdata.DistributedSampler(n, **kw)
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        got = list(port)
        assert got == list(ref)
        assert all(type(i) is int for i in got)
        assert len(port) == len(ref) == len(got)


def test_a_sized_dataset_and_bad_ranks():
    assert len(tdata.DistributedSampler(list(range(9)), 0, 2)) == 5
    with pytest.raises(ValueError):
        tdata.DistributedSampler(8, replica_rank=2, num_replica_groups=2)
    with pytest.raises(ValueError):
        tdata.DistributedSampler(8, 0, 1, rank=1, num_replicas=1)


@pytest.mark.parametrize("consumed", [0, 3, 9])
def test_stateful_state_dict_and_remaining_round_trip(consumed):
    kw = dict(replica_rank=1, num_replica_groups=2, shuffle=True, seed=7)
    port, ref = (tdata.StatefulDistributedSampler(18, **kw),
                 jdata.StatefulDistributedSampler(18, **kw))
    port.set_epoch(2)
    ref.set_epoch(2)
    it_p, it_r = iter(port), iter(ref)
    head = [next(it_p) for _ in range(consumed)]
    assert head == [next(it_r) for _ in range(consumed)]
    sd = port.state_dict()
    assert sd == ref.state_dict() == {"epoch": 2, "position": consumed}
    assert port.remaining == ref.remaining == 9 - consumed

    # a healed worker resumes where the cohort left off: the port's state
    # loads into either package's sampler and yields the same remainder
    rest = list(it_p)
    assert rest == list(it_r) and len(rest) == 9 - consumed
    for cls in (tdata.StatefulDistributedSampler, jdata.StatefulDistributedSampler):
        fresh = cls(18, **kw)
        fresh.load_state_dict(sd)
        assert fresh.remaining == 9 - consumed
        assert list(fresh) == rest
    # the epoch's end stays distinguishable from a fresh epoch
    assert port.remaining == 0 and port.state_dict()["position"] == 9
    port.set_epoch(3)
    assert port.state_dict() == {"epoch": 3, "position": 0}
