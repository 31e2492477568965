"""DP-rank-aware pretraining batch samplers (counterpart of
``apex_tpu/transformer/_data/_batchsampler.py``, a copy: numpy only).

Reference: ``apex/transformer/_data/_batchsampler.py:38,102`` — samplers that
(1) resume from ``consumed_samples``, (2) slice the global minibatch so each
data-parallel rank reads only its shard, (3) support changing the local
minibatch size mid-run (batch-size ramp-up). Pure Python index generators;
they plug into any data source (a ``torch.utils.data.DataLoader``'s
``batch_sampler``, numpy arrays indexed per step).
"""

from __future__ import annotations

from typing import Iterator, List

import numpy as np


class MegatronPretrainingSampler:
    """Sequential sampler (ref :38-100): walk ``consumed_samples →
    total_samples`` accumulating a global minibatch of
    ``local_minibatch_size × data_parallel_size`` indices and yield this
    rank's contiguous slice."""

    def __init__(
        self,
        total_samples: int,
        consumed_samples: int,
        local_minibatch_size: int,
        data_parallel_rank: int,
        data_parallel_size: int,
        drop_last: bool = True,
    ):
        if total_samples <= 0:
            raise RuntimeError(
                f"total_samples must be positive, got {total_samples}")
        if consumed_samples >= total_samples:
            raise RuntimeError(
                f"already consumed {consumed_samples} of {total_samples} "
                f"samples — nothing left to iterate")
        if local_minibatch_size <= 0:
            raise RuntimeError(
                f"local_minibatch_size must be positive, got "
                f"{local_minibatch_size}")
        if data_parallel_size <= 0:
            raise RuntimeError(
                f"data_parallel_size must be positive, got "
                f"{data_parallel_size}")
        if data_parallel_rank >= data_parallel_size:
            raise RuntimeError(
                f"data_parallel_rank {data_parallel_rank} out of range for "
                f"data_parallel_size {data_parallel_size}")
        self.total_samples = total_samples
        self.consumed_samples = consumed_samples
        self._local_minibatch_size = local_minibatch_size
        self.data_parallel_rank = data_parallel_rank
        self.data_parallel_size = data_parallel_size
        self.drop_last = drop_last

    def __len__(self) -> int:
        return self.total_samples

    @property
    def local_minibatch_size(self) -> int:
        return self._local_minibatch_size

    @local_minibatch_size.setter
    def local_minibatch_size(self, new_size: int) -> None:
        self._local_minibatch_size = new_size

    def get_start_end_idx(self) -> tuple:
        start = self.data_parallel_rank * self.local_minibatch_size
        return start, start + self.local_minibatch_size

    def __iter__(self) -> Iterator[List[int]]:
        batch: List[int] = []
        for idx in range(self.consumed_samples, self.total_samples):
            batch.append(idx)
            if len(batch) == (self.local_minibatch_size
                              * self.data_parallel_size):
                start, end = self.get_start_end_idx()
                yield batch[start:end]
                batch = []
        if batch and not self.drop_last:
            start, end = self.get_start_end_idx()
            yield batch[start:end]


class MegatronPretrainingRandomSampler:
    """Shuffling sampler (ref :102-177): deterministic per-epoch permutation
    seeded by the epoch index, resumable mid-epoch from ``consumed_samples``;
    each rank permutes only its own bucket of the sample space."""

    def __init__(
        self,
        total_samples: int,
        consumed_samples: int,
        local_minibatch_size: int,
        data_parallel_rank: int,
        data_parallel_size: int,
    ) -> None:
        if total_samples <= 0:
            raise ValueError(
                f"total_samples must be positive, got {total_samples}")
        if local_minibatch_size <= 0:
            raise ValueError(
                f"local_minibatch_size must be positive, got "
                f"{local_minibatch_size}")
        if data_parallel_size <= 0:
            raise ValueError(
                f"data_parallel_size must be positive, got "
                f"{data_parallel_size}")
        if data_parallel_rank >= data_parallel_size:
            raise ValueError(
                f"data_parallel_rank {data_parallel_rank} out of range for "
                f"data_parallel_size {data_parallel_size}")
        self.total_samples = total_samples
        self.consumed_samples = consumed_samples
        self._local_minibatch_size = local_minibatch_size
        self.data_parallel_rank = data_parallel_rank
        self.data_parallel_size = data_parallel_size
        self.last_batch_size = (
            self.total_samples
            % (self._local_minibatch_size * data_parallel_size))

    def __len__(self) -> int:
        return self.total_samples

    @property
    def local_minibatch_size(self) -> int:
        return self._local_minibatch_size

    @local_minibatch_size.setter
    def local_minibatch_size(self, new_size: int) -> None:
        self._local_minibatch_size = new_size

    def __iter__(self) -> Iterator[List[int]]:
        active_total = self.total_samples - self.last_batch_size
        self.epoch = self.consumed_samples // active_total
        current_epoch_samples = self.consumed_samples % active_total
        assert current_epoch_samples % (self.local_minibatch_size
                                        * self.data_parallel_size) == 0

        # per-rank bucket of the (shuffled) sample space
        bucket_size = (active_total // self.data_parallel_size)
        bucket_offset = current_epoch_samples // self.data_parallel_size
        start_idx = self.data_parallel_rank * bucket_size

        rng = np.random.RandomState(seed=self.epoch)
        random_idx = rng.permutation(bucket_size) + start_idx
        idx_range = random_idx[bucket_offset:].tolist()

        batch: List[int] = []
        for idx in idx_range:
            batch.append(int(idx))
            if len(batch) == self.local_minibatch_size:
                self.consumed_samples += (self.local_minibatch_size
                                          * self.data_parallel_size)
                yield batch
                batch = []
