"""Shared pieces of the port's optimizers (counterpart of
``apex_tpu/optimizers/_common.py``): the learning-rate schedule type."""

from __future__ import annotations

from typing import Callable, Union

# a constant learning rate, or a function of the 1-based step count
Schedule = Union[float, Callable[[int], float]]


def value_at(lr: Schedule, count: int) -> float:
    """The learning rate at step ``count`` (1 for the first update)."""
    return float(lr(count)) if callable(lr) else float(lr)
