"""Profiling and observability (the reference has none — SURVEY.md §5).

Provides a wall-clock timing harness reporting the SURVEY.md §3.2 cost model
(intersection queries per second), structured per-run metric JSON, and a
``jax.profiler`` trace context for Perfetto dumps.
"""
from __future__ import annotations

import contextlib
import json
import logging
import time
from dataclasses import asdict, dataclass
from typing import Callable, Optional

import jax

logger = logging.getLogger("hermespy_rt_tpu")

__all__ = ["TraceStats", "time_trace", "profile_trace", "log_metrics"]


@dataclass
class TraceStats:
    wall_s: float
    queries: int
    queries_per_s: float
    num_paths: int
    num_bounces: int
    num_rx: int
    num_tx: int
    iters: int

    def json(self) -> str:
        return json.dumps(asdict(self))


def time_trace(fn: Callable, *args, num_paths: int, num_bounces: int,
               num_rx: int = 1, num_tx: int = 1, iters: int = 5,
               warmup: int = 1) -> TraceStats:
    """Time a jitted trace callable; reports intersection queries/s
    (= num_bounces * num_tx * num_paths * (1 + num_rx) per call, the
    SURVEY.md §3.2 cost model of /root/reference/src/compute_paths.c)."""
    for _ in range(warmup):
        out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    outs = [fn(*args) for _ in range(iters)]
    jax.block_until_ready(outs[-1])
    wall = (time.perf_counter() - t0) / iters
    queries = num_bounces * num_tx * num_paths * (1 + num_rx)
    return TraceStats(wall_s=wall, queries=queries,
                      queries_per_s=queries / wall, num_paths=num_paths,
                      num_bounces=num_bounces, num_rx=num_rx, num_tx=num_tx,
                      iters=iters)


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """``jax.profiler`` trace context (TensorBoard/Perfetto readable)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def log_metrics(stats: TraceStats, extra: Optional[dict] = None,
                path: Optional[str] = None):
    """Emit one structured metrics line (stdout logger and optionally a
    JSONL file)."""
    record = asdict(stats)
    if extra:
        record.update(extra)
    line = json.dumps(record)
    logger.info("metrics %s", line)
    if path:
        with open(path, "a") as f:
            f.write(line + "\n")
    return record
