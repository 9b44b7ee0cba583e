"""Profiling / observability.

The reference instruments itself with malloc interposition (per-phase peak
heap via malloc_count, bfq_int.cpp:976-1001) and wall-clock timers around
every step (BFQzip.py:98-145).  The equivalents here:

  * phase timers (host wall clock),
  * device memory statistics per phase (jax device memory_stats — the analog
    of malloc_count_peak_curr),
  * optional jax.profiler traces for kernel-level inspection.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional


def device_memory_stats() -> Dict[str, int]:
    """Bytes in use / peak on the default device (empty dict off-accelerator)."""
    import jax

    dev = jax.devices()[0]
    stats = getattr(dev, "memory_stats", lambda: None)()
    if not stats:
        return {}
    keep = ("bytes_in_use", "peak_bytes_in_use", "bytes_limit")
    return {k: int(v) for k, v in stats.items() if k in keep}


class PhaseProfiler:
    """Collects (phase, wall seconds, device-memory snapshot) tuples."""

    def __init__(self, trace_dir: Optional[str] = None):
        self.records: List[dict] = []
        self.trace_dir = trace_dir

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            rec = {"phase": name, "seconds": time.time() - t0}
            rec.update(device_memory_stats())
            self.records.append(rec)

    @contextlib.contextmanager
    def trace(self):
        """Wrap a region in a jax.profiler trace when trace_dir is set."""
        if not self.trace_dir:
            yield
            return
        import jax

        with jax.profiler.trace(self.trace_dir):
            yield

    def report(self) -> str:
        lines = []
        for r in self.records:
            mem = ""
            if "peak_bytes_in_use" in r:
                mem = f"  peak_dev_mem={r['peak_bytes_in_use']/2**20:.1f}MB"
            lines.append(f"{r['phase']}: {r['seconds']:.3f}s{mem}")
        return "\n".join(lines)
