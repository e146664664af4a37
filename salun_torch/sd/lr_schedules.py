"""LDM learning-rate schedules (counterpart of ``salun/sd/lr_schedules.py``;
reference SD/ldm/lr_scheduler.py:4-135: LambdaWarmUpCosineScheduler,
LambdaWarmUpCosineScheduler2, LambdaLinearScheduler).

Each schedule is a function of the step count returning the factor that
multiplies a base LR of 1.0. The arithmetic is the JAX package's fp32
arithmetic, operation for operation: Python-float constants folded in
double and rounded to fp32 where JAX's weak typing rounds them, every
array operation in fp32. The cosine is computed in double and rounded to
fp32; XLA's fp32 cosine differs from it by at most 1 ulp.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

_f32 = np.float32


def _cos(x: np.float32) -> np.float32:
    return _f32(np.cos(np.float64(x)))


def warmup_cosine(warm_up_steps: int, lr_min: float, lr_max: float,
                  lr_start: float, max_decay_steps: int):
    """LambdaWarmUpCosineScheduler (lr_scheduler.py:4-48)."""
    slope = _f32((lr_max - lr_start) / warm_up_steps)
    half = _f32(0.5 * (lr_max - lr_min))
    span = _f32(max_decay_steps - warm_up_steps)

    def schedule(n) -> np.float32:
        n = _f32(n)
        if n < _f32(warm_up_steps):
            return slope * n + _f32(lr_start)
        t = min((n - _f32(warm_up_steps)) / span, _f32(1.0))
        return _f32(lr_min) + half * (_f32(1) + _cos(t * _f32(np.pi)))

    return schedule


def _multi_cycle(warm_up_steps, f_min, f_max, f_start, cycle_lengths,
                 tail_fn):
    warm_up_steps = np.asarray(warm_up_steps, np.float32)
    f_min = np.asarray(f_min, np.float32)
    f_max = np.asarray(f_max, np.float32)
    f_start = np.asarray(f_start, np.float32)
    cycle_lengths = np.asarray(cycle_lengths, np.float32)
    if not (len(warm_up_steps) == len(f_min) == len(f_max) == len(f_start)
            == len(cycle_lengths)):
        raise ValueError("every per-cycle list needs one entry a cycle")
    cum = np.cumsum(np.concatenate([[0.0], cycle_lengths])).astype(np.float32)

    def schedule(n) -> np.float32:
        n = _f32(n)
        # the reference's interval: the first c with n <= cum[c + 1]
        c = min(int(np.searchsorted(cum[1:], n, side="left")),
                len(cycle_lengths) - 1)
        nn = n - cum[c]
        wu, cl = warm_up_steps[c], cycle_lengths[c]
        if nn < wu:
            return (f_max[c] - f_start[c]) / wu * nn + f_start[c]
        return tail_fn(nn, wu, f_min[c], f_max[c], cl)

    return schedule


def warmup_cosine2(warm_up_steps: Sequence[float], f_min, f_max, f_start,
                   cycle_lengths):
    """LambdaWarmUpCosineScheduler2 (lr_scheduler.py:51-111)."""

    def tail(nn, wu, fmin, fmax, cl):
        t = min((nn - wu) / (cl - wu), _f32(1.0))
        return fmin + _f32(0.5) * (fmax - fmin) * (
            _f32(1) + _cos(t * _f32(np.pi)))

    return _multi_cycle(warm_up_steps, f_min, f_max, f_start, cycle_lengths,
                        tail)


def lambda_linear(warm_up_steps: Sequence[float], f_min, f_max, f_start,
                  cycle_lengths):
    """LambdaLinearScheduler (lr_scheduler.py:114-135), the scheduler the
    LDM training configs instantiate."""

    def tail(nn, wu, fmin, fmax, cl):
        return fmin + (fmax - fmin) * (cl - nn) / cl

    return _multi_cycle(warm_up_steps, f_min, f_max, f_start, cycle_lengths,
                        tail)
