"""Kernel-level tracing — the observability upgrade SURVEY.md §5.1 calls
for (the reference only logs comm CSV rows; no compute profiling).

``profile_trace`` wraps jax.profiler for XLA device traces viewable in
TensorBoard/Perfetto; ``timed`` is a lightweight wall-clock context that
feeds the same structured logger as the orchestrator.
"""

from __future__ import annotations

import contextlib
import time
from datetime import datetime


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Capture an XLA profiler trace for the enclosed block."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def timed(step: str, role: str = "perf", sink=print):
    t0 = time.time()
    try:
        yield
    finally:
        dt = (time.time() - t0) * 1e3
        sink(f"[{datetime.now().isoformat(timespec='seconds')}] [{role}] [{step}] "
             f"{dt:.1f} ms")
