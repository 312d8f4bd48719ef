"""Dataset sharding across elastic replica groups.

PyTorch port of ``torchft_tpu/data.py``, index for index: the permutation
stays numpy's (``default_rng(seed + epoch)``), so a port worker draws the
same shard as a JAX one with the same arguments, as Python ints.  Analog of
the reference sampler (reference: torchft/data.py:24-77): the global
data-parallel world is ``num_replica_groups * num_replicas`` and this worker
owns global shard ``rank + num_replicas * replica_rank``.  Sharding is *lossy
by design* under membership change — when a replica group dies its shard is
simply not consumed that step; exact-once data accounting is delegated to a
stateful loader checkpointed through the Manager state dict.
"""

from __future__ import annotations

from typing import Iterator, Sequence

import numpy as np


class DistributedSampler:
    """Index sampler assigning this worker a fixed global shard.

    Args:
        dataset_len: number of examples (or a Sized dataset).
        replica_rank: which replica group this worker belongs to.
        num_replica_groups: total replica groups in the job.
        rank: this worker's rank within the replica group.
        num_replicas: workers per replica group.
        shuffle: reshuffle each epoch with a deterministic seed.
        seed: base seed shared by all workers.
    """

    def __init__(
        self,
        dataset_len: "int | Sequence",
        replica_rank: int,
        num_replica_groups: int,
        rank: int = 0,
        num_replicas: int = 1,
        shuffle: bool = False,
        seed: int = 0,
    ) -> None:
        if not isinstance(dataset_len, int):
            dataset_len = len(dataset_len)
        if not (0 <= rank < num_replicas):
            raise ValueError(f"invalid rank {rank}, must be in [0, {num_replicas})")
        if not (0 <= replica_rank < num_replica_groups):
            raise ValueError(
                f"invalid replica_rank {replica_rank}, must be in [0, {num_replica_groups})"
            )
        self.dataset_len = dataset_len
        self.global_rank = rank + num_replicas * replica_rank
        self.global_world_size = num_replicas * num_replica_groups
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        # ceil-divide so every rank yields the same number of indices
        self.num_samples = -(-dataset_len // self.global_world_size)
        self.total_size = self.num_samples * self.global_world_size

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return self.num_samples

    def __iter__(self) -> Iterator[int]:
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            indices = rng.permutation(self.dataset_len)
        else:
            indices = np.arange(self.dataset_len)
        # pad to total_size by wrapping, then take a strided shard
        if self.total_size > len(indices):
            pad = np.resize(indices, self.total_size - len(indices))
            indices = np.concatenate([indices, pad])
        shard = indices[self.global_rank : self.total_size : self.global_world_size]
        return iter(shard.tolist())


class StatefulDistributedSampler(DistributedSampler):
    """DistributedSampler with data-position checkpointing.

    The reference defers exact data accounting to torchdata's
    StatefulDataLoader (reference data.py docstring); this sampler carries
    the position natively: ``state_dict()/load_state_dict()`` capture
    (epoch, position) so a healed replica resumes its shard where the
    cohort left off. Register through the Manager::

        manager.register_state_dict_fn(
            "sampler", sampler.load_state_dict, sampler.state_dict)

    Accounting contract: ``position`` counts indices *handed to the
    consumer*, advancing at ``next()``. Resume is exact when each batch is
    drawn and trained within the same committed step; a loader that
    prefetches across step boundaries hands out indices before they are
    trained, so a checkpoint would overcount by the in-flight depth —
    either keep prefetch within the step or checkpoint the loader's
    in-flight count alongside.

    At epoch end the position stays at ``num_samples`` (so an end-of-epoch
    checkpoint is distinguishable from a fresh epoch and resumes to an
    empty remainder); ``set_epoch`` starts the next epoch at 0.
    """

    def __init__(self, *args, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        self._position = 0

    def state_dict(self) -> dict:
        """Checkpointable progress: {epoch, position-within-epoch}."""
        return {"epoch": self.epoch, "position": self._position}

    def load_state_dict(self, sd: dict) -> None:
        self.epoch = int(sd["epoch"])
        self._position = int(sd["position"])

    def set_epoch(self, epoch: int) -> None:
        super().set_epoch(epoch)
        self._position = 0

    @property
    def remaining(self) -> int:
        """Indices left in the current epoch (``__len__`` stays the stable
        per-epoch constant)."""
        return max(self.num_samples - self._position, 0)

    def __iter__(self):
        shard = list(super().__iter__())
        start = self._position

        def gen():
            for i, idx in enumerate(shard[start:], start=start):
                self._position = i + 1
                yield idx

        return gen()
