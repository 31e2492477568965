"""Global microbatch calculator — constant and ramp-up schedules
(counterpart of ``apex_tpu/transformer/pipeline_parallel/microbatches.py``,
a copy: pure Python, no framework).

Reference: ``apex/transformer/pipeline_parallel/microbatches.py`` —
``build_num_microbatches_calculator`` (:26), ``ConstantNumMicroBatches``
(:87), ``RampupBatchsizeNumMicroBatches`` (:118). Host-level bookkeeping:
the calculator maps ``consumed_samples`` to (global_batch_size,
num_micro_batches), the number of microbatches the schedules loop over.
"""

from __future__ import annotations

from typing import List, Optional


class NumMicroBatchesCalculator:
    """Base interface (ref microbatches.py:70-85)."""

    def __init__(self) -> None:
        self.num_micro_batches: Optional[int] = None
        self.current_global_batch_size: Optional[int] = None

    def get(self) -> int:
        return self.num_micro_batches

    def get_current_global_batch_size(self) -> int:
        return self.current_global_batch_size

    def update(self, consumed_samples: int, consistency_check: bool) -> None:
        raise NotImplementedError


class ConstantNumMicroBatches(NumMicroBatchesCalculator):
    """Fixed global batch size (ref microbatches.py:87-116)."""

    def __init__(self, global_batch_size: int, micro_batch_size: int,
                 data_parallel_size: int) -> None:
        super().__init__()
        micro_batch_times_data_parallel = micro_batch_size * data_parallel_size
        if global_batch_size % micro_batch_times_data_parallel != 0:
            raise ValueError(
                f"global batch size ({global_batch_size}) is not divisible by "
                f"micro batch size ({micro_batch_size}) times data parallel "
                f"size ({data_parallel_size})"
            )
        self.num_micro_batches = (global_batch_size
                                  // micro_batch_times_data_parallel)
        if self.num_micro_batches < 1:
            raise ValueError("num_micro_batches must be >= 1")
        self.current_global_batch_size = global_batch_size
        self.micro_batch_size = micro_batch_size

    def update(self, consumed_samples: int, consistency_check: bool) -> None:
        pass


class RampupBatchsizeNumMicroBatches(NumMicroBatchesCalculator):
    """Linear global-batch-size ramp-up (ref microbatches.py:118-177):
    batch size grows from ``start_batch_size`` by ``batch_size_increment``
    every ``ramup_samples / steps`` consumed samples until
    ``global_batch_size``."""

    def __init__(self, start_batch_size: int, batch_size_increment: int,
                 ramup_samples: int, global_batch_size: int,
                 micro_batch_size: int, data_parallel_size: int) -> None:
        super().__init__()
        if batch_size_increment <= 0:
            raise ValueError("batch_size_increment must be positive")
        if start_batch_size <= 0 or global_batch_size <= 0:
            raise ValueError("batch sizes must be positive")
        diff_batch_size = global_batch_size - start_batch_size
        if diff_batch_size < 0:
            raise ValueError("global_batch_size must be >= start_batch_size")
        if diff_batch_size % batch_size_increment != 0:
            raise ValueError(
                "expected global batch size interval to be divisible by the "
                "batch size increment"
            )
        self.start_batch_size = start_batch_size
        self.batch_size_increment = batch_size_increment
        self.ramup_samples = ramup_samples
        self.global_batch_size = global_batch_size
        self.micro_batch_size = micro_batch_size
        self.data_parallel_size = data_parallel_size
        self.micro_batch_times_data_parallel_size = (
            micro_batch_size * data_parallel_size
        )

        num_increments = diff_batch_size // batch_size_increment
        # start == global means there is nothing to ramp: jump straight to the
        # final batch size (avoids a 0/0 below).
        self.rampup_samples_per_increment = (
            self.ramup_samples / num_increments if num_increments > 0
            else float("inf")
        )
        self.update(0, False)

    def update(self, consumed_samples: int, consistency_check: bool) -> None:
        if consumed_samples > self.ramup_samples:
            self.current_global_batch_size = self.global_batch_size
        else:
            steps = int(consumed_samples / self.rampup_samples_per_increment)
            self.current_global_batch_size = (
                self.start_batch_size + steps * self.batch_size_increment
            )
            if self.current_global_batch_size > self.global_batch_size:
                self.current_global_batch_size = self.global_batch_size
        if consistency_check and (
            self.current_global_batch_size
            % self.micro_batch_times_data_parallel_size != 0
        ):
            raise ValueError(
                f"current global batch size "
                f"({self.current_global_batch_size}) is not divisible by "
                f"micro-batch-size ({self.micro_batch_size}) times "
                f"data parallel size ({self.data_parallel_size})"
            )
        self.num_micro_batches = (
            self.current_global_batch_size
            // self.micro_batch_times_data_parallel_size
        )


def build_num_microbatches_calculator(
    rank: int,
    rampup_batch_size: Optional[List[int]],
    global_batch_size: int,
    micro_batch_size: int,
    data_parallel_size: int,
) -> NumMicroBatchesCalculator:
    """Ref microbatches.py:26-68."""
    if rampup_batch_size is None:
        return ConstantNumMicroBatches(
            global_batch_size, micro_batch_size, data_parallel_size
        )
    if len(rampup_batch_size) != 3:
        raise ValueError(
            f"rampup_batch_size takes exactly three ints — start size, "
            f"increment, ramp-up samples — got {rampup_batch_size!r}"
        )
    start, increment, samples = (int(v) for v in rampup_batch_size)
    return RampupBatchsizeNumMicroBatches(
        start, increment, samples, global_batch_size,
        micro_batch_size, data_parallel_size,
    )
