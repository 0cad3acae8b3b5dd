"""Profiling and timing utilities.

The reference relies on ``jax.profiler.trace`` + a block-until-ready timing
harness documented in its performance-tips notebook and used by its
CodSpeed benchmarks (SURVEY.md section 5). This module packages both.
"""

import contextlib
import time
from collections.abc import Callable, Iterator
from typing import Any

import jax


def synchronize(tree: Any) -> Any:
    """Wait until every array in ``tree`` is computed (``block_until_ready``)."""
    return jax.block_until_ready(tree)


def timeit(
    fn: Callable[[], Any],
    *,
    repeats: int = 5,
    warmup: int = 1,
) -> dict[str, float]:
    """Time a nullary device function with warm-up and sync barriers.

    Returns min/mean/max wall-clock seconds over ``repeats`` runs.

    Examples:
        >>> import jax.numpy as jnp
        >>> from differt_tpu.profiling import timeit
        >>> stats = timeit(lambda: jnp.ones(8).sum(), repeats=2)
        >>> sorted(stats)
        ['max', 'mean', 'min', 'repeats']
    """
    for _ in range(warmup):
        synchronize(fn())
    times = []
    for _ in range(repeats):
        start = time.perf_counter()
        synchronize(fn())
        times.append(time.perf_counter() - start)
    return {
        "min": min(times),
        "mean": sum(times) / len(times),
        "max": max(times),
        "repeats": float(repeats),
    }


@contextlib.contextmanager
def trace(log_dir: str = "profile") -> Iterator[None]:
    """Record a ``jax.profiler`` trace (view with TensorBoard / Perfetto)."""
    with jax.profiler.trace(log_dir):
        yield


annotate = jax.profiler.TraceAnnotation
"""Re-export: annotate a named region inside a profiler trace."""
