"""Wall-clock timing of jitted calls, each call waited for on the device."""
from __future__ import annotations

import time

import jax
import numpy as np


def timed_ms(f, *args, iters: int = 10, warmup: int = 1) -> list[float]:
    """Wall ms of each of `iters` calls f(*args), every call run to
    completion with `block_until_ready` (after `warmup` untimed calls)."""
    for _ in range(warmup):
        jax.block_until_ready(f(*args))
    out = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(f(*args))
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def median_ms(f, *args, iters: int = 10, warmup: int = 1) -> float:
    """Median of `timed_ms`."""
    return float(np.median(timed_ms(f, *args, iters=iters, warmup=warmup)))
