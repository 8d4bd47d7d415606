"""Microbatch-count calculators (counterpart of
:mod:`apex_tpu.transformer.microbatches`, a copy of its host-side code).

Rebuild of ``apex/transformer/microbatches.py``:
the reference computes, from (global batch, micro batch, data-parallel
size), how many microbatches each pipeline pass runs — either a constant
or a linear batch-size rampup over consumed samples. The calculator is
process-global (set up once, read by the training loop), matching the
reference's ``setup_microbatch_calculator`` /
``get_num_microbatches()`` singleton surface.

These are host-side Python numbers: the count of microbatches each
pipeline schedule runs (a changed count re-buckets the schedule loop, as
in the reference).
"""

from __future__ import annotations

from typing import List, Optional, Union


class NumMicroBatchesCalculator:
    """Reference ABC surface: ``get()`` and ``update()``."""

    num_micro_batches: int
    current_global_batch_size: int

    def get(self) -> int:
        return self.num_micro_batches

    def get_current_global_batch_size(self) -> int:
        return self.current_global_batch_size

    def update(self, consumed_samples: int, consistency_check: bool):
        raise NotImplementedError


class ConstantNumMicroBatches(NumMicroBatchesCalculator):
    """Reference: ``ConstantNumMicroBatches`` — fixed global batch."""

    def __init__(self, global_batch_size: int, micro_batch_size: int,
                 data_parallel_size: int):
        per_pass = micro_batch_size * data_parallel_size
        if global_batch_size % per_pass != 0:
            raise ValueError(
                f"global batch size ({global_batch_size}) is not divisible "
                f"by micro batch size ({micro_batch_size}) times data "
                f"parallel size ({data_parallel_size})")
        self.num_micro_batches = global_batch_size // per_pass
        if self.num_micro_batches < 1:
            raise ValueError("num_micro_batches must be >= 1")
        self.current_global_batch_size = global_batch_size

    def update(self, consumed_samples: int, consistency_check: bool):
        pass


class RampupBatchsizeNumMicroBatches(NumMicroBatchesCalculator):
    """Reference: ``RampupBatchsizeNumMicroBatches`` — global batch grows
    linearly from ``start_batch_size`` to ``global_batch_size`` in
    ``batch_size_increment`` steps over ``ramup_samples`` samples."""

    def __init__(self, start_batch_size: int, batch_size_increment: int,
                 ramup_samples: int, global_batch_size: int,
                 micro_batch_size: int, data_parallel_size: int):
        self.micro_batch_size = micro_batch_size
        self.data_parallel_size = data_parallel_size
        self.global_batch_size = global_batch_size
        self.start_batch_size = start_batch_size
        self.batch_size_increment = batch_size_increment
        self.ramup_samples = ramup_samples
        self.micro_batch_times_data_parallel = (
            micro_batch_size * data_parallel_size)

        if start_batch_size % self.micro_batch_times_data_parallel != 0:
            raise ValueError(
                "start batch size must be divisible by micro-batch size "
                "times data-parallel size")
        if batch_size_increment <= 0:
            raise ValueError(
                f"batch size increment must be positive, got "
                f"{batch_size_increment}")
        diff = global_batch_size - start_batch_size
        if diff < 0:
            raise ValueError(
                f"global batch size ({global_batch_size}) must be >= start "
                f"batch size ({start_batch_size})")
        if diff % batch_size_increment != 0:
            raise ValueError(
                f"expected global batch size interval ({diff}) to be "
                f"divisible by global batch size increment "
                f"({batch_size_increment})")
        num_increments = diff // batch_size_increment
        self.rampup_samples_per_increment = (
            self.ramup_samples / num_increments if num_increments else 0)
        self.update(0, False)

    def update(self, consumed_samples: int, consistency_check: bool):
        if consumed_samples > self.ramup_samples or \
                self.rampup_samples_per_increment == 0:
            self.current_global_batch_size = self.global_batch_size
        else:
            steps = int(consumed_samples /
                        self.rampup_samples_per_increment)
            self.current_global_batch_size = (
                self.start_batch_size + steps * self.batch_size_increment)
            self.current_global_batch_size = min(
                self.current_global_batch_size, self.global_batch_size)
        if consistency_check and (
                self.current_global_batch_size %
                self.micro_batch_times_data_parallel != 0):
            raise ValueError(
                f"current global batch size "
                f"({self.current_global_batch_size}) is not divisible by "
                "micro-batch-size * data-parallel-size")
        # round down to a runnable microbatch count (reference behavior:
        # the rampup sizes are expected to be divisible; without the
        # check we floor)
        self.num_micro_batches = max(
            self.current_global_batch_size //
            self.micro_batch_times_data_parallel, 1)


_GLOBAL_NUM_MICROBATCHES_CALCULATOR: Optional[NumMicroBatchesCalculator] = None


def build_num_microbatches_calculator(
    rank: int,
    rampup_batch_size: Optional[List[int]],
    global_batch_size: int,
    micro_batch_size: int,
    data_parallel_size: int,
) -> NumMicroBatchesCalculator:
    """Reference factory: ``rampup_batch_size`` is None (constant) or
    ``[start, increment, ramup_samples]``."""
    if rampup_batch_size is None:
        calc = ConstantNumMicroBatches(
            global_batch_size, micro_batch_size, data_parallel_size)
        if rank == 0:
            from apex_tpu_torch.amp._amp_state import maybe_print

            maybe_print(
                f"setting number of micro-batches to constant {calc.get()}")
    else:
        if len(rampup_batch_size) != 3:
            raise ValueError(
                "expected the following format: --rampup-batch-size "
                "<start batch size> <batch size increment> "
                "<ramp-up samples>")
        calc = RampupBatchsizeNumMicroBatches(
            int(rampup_batch_size[0]), int(rampup_batch_size[1]),
            int(rampup_batch_size[2]), global_batch_size,
            micro_batch_size, data_parallel_size)
    return calc


def setup_microbatch_calculator(rank, rampup_batch_size, global_batch_size,
                                micro_batch_size, data_parallel_size):
    """Reference: installs the process-global calculator."""
    global _GLOBAL_NUM_MICROBATCHES_CALCULATOR
    _GLOBAL_NUM_MICROBATCHES_CALCULATOR = build_num_microbatches_calculator(
        rank, rampup_batch_size, global_batch_size, micro_batch_size,
        data_parallel_size)
    return _GLOBAL_NUM_MICROBATCHES_CALCULATOR


def _get_calculator() -> NumMicroBatchesCalculator:
    if _GLOBAL_NUM_MICROBATCHES_CALCULATOR is None:
        raise RuntimeError(
            "microbatch calculator is not set up; call "
            "setup_microbatch_calculator() first")
    return _GLOBAL_NUM_MICROBATCHES_CALCULATOR


def get_num_microbatches() -> int:
    return _get_calculator().get()


def get_current_global_batch_size() -> int:
    return _get_calculator().get_current_global_batch_size()


def update_num_microbatches(consumed_samples: int,
                            consistency_check: bool = True):
    _get_calculator().update(consumed_samples, consistency_check)


def destroy_microbatch_calculator():
    global _GLOBAL_NUM_MICROBATCHES_CALCULATOR
    _GLOBAL_NUM_MICROBATCHES_CALCULATOR = None
