"""Device timing helpers.

``measure`` times a call end to end, ended by ``jax.block_until_ready``.
``measure_chained`` times one operation by difference: the operation runs
chained k_big and k_small times inside one jitted call (each iteration
consuming the previous result, so XLA cannot drop iterations), and the
time difference is divided by (k_big - k_small). Per-call dispatch and
launch costs cancel.
"""

from __future__ import annotations

import time
from typing import Callable

import jax


def measure(fn: Callable[[], object], reps: int = 3, warmup: int = 1) -> float:
    """Wall-time fn() end to end (dispatch + compute until ready).

    Reports the minimum over reps, after `warmup` untimed calls.
    """
    for _ in range(warmup):
        jax.block_until_ready(fn())
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return best


def measure_chained(chain_fn: Callable[[int], Callable], k_small: int,
                    k_big: int, reps: int = 2) -> float:
    """Differential timing: seconds per single op, fixed overhead cancelled.

    Args:
      chain_fn: k -> zero-arg callable running the op k times *chained*
        (each iteration must consume the previous result, or XLA dedups).
      k_small, k_big: chain lengths; per-op = (t_big - t_small)/(k_big-k_small).
    """
    assert k_big > k_small >= 1
    f_small, f_big = chain_fn(k_small), chain_fn(k_big)
    t_small = measure(f_small, reps=reps)
    t_big = measure(f_big, reps=reps)
    return max((t_big - t_small) / (k_big - k_small), 0.0)
