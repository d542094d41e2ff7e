"""Tracing/profiling utilities (SURVEY §5: the reference's only tooling is
`ffmpeg -benchmark` utime printing + ad-hoc START_TIMER rdtsc macros in
libavutil/common.h; regression.sh:124,137-138 logs per-test utime).

Equivalents here:
* `stage_timer` — per-stage wall-clock accumulation for pipelines (the
  structured analog of the utime log);
* `trace` — wraps `jax.profiler.trace` so a run can emit a TensorBoard-
  loadable device trace (`python -m amv_tpu ... --benchmark` prints stage
  times; set AMV_TRACE_DIR=/path to also capture a profiler trace).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import OrderedDict


class StageTimes(OrderedDict):
    """name -> accumulated seconds; prints like the reference's bench line."""

    def report(self) -> str:
        total = sum(self.values())
        parts = " ".join(f"{k}={v:.3f}s" for k, v in self.items())
        return f"bench stages: {parts} total={total:.3f}s"


@contextlib.contextmanager
def stage_timer(times: StageTimes, name: str):
    """Accumulate wall-clock of a pipeline stage into `times[name]`.

    Callers must block on device results inside the region (the project
    convention: force a scalar readback) — jitted dispatch is async.
    """
    t0 = time.perf_counter()
    try:
        yield
    finally:
        times[name] = times.get(name, 0.0) + time.perf_counter() - t0


@contextlib.contextmanager
def trace(label: str = "amv_tpu"):
    """Emit a jax.profiler trace to $AMV_TRACE_DIR when set, else no-op.

    The trace contains per-HLO device timelines (the device analog of the
    reference's rdtsc START_TIMER blocks) and loads in TensorBoard or
    xprof.
    """
    trace_dir = os.environ.get("AMV_TRACE_DIR")
    if not trace_dir:
        yield
        return
    import jax
    with jax.profiler.trace(os.path.join(trace_dir, label)):
        yield
