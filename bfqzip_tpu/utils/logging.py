"""Per-run logging: step timers + subprocess capture + per-phase memory.

The reference writes a BASENAME.log capturing every subprocess's stdout plus
the exact command lines and wall-clock per step (BFQzip.py:52-57,98-145,
328-342), and the cores print the peak heap after every phase via
malloc_count_peak_curr (bfq_int.cpp:976-1001).  StepLogger is the same
contract for library-call stages: each step records wall seconds, the host
RSS high-water delta across the step (the malloc_count analog) and the
device bytes in use / peak (the HBM analog), both into the .log and into
`phases` for PipelineResult.report.
"""

from __future__ import annotations

import contextlib
import resource
import subprocess
import sys
import time
from typing import List


def _rss_kb() -> int:
    # ru_maxrss is KB on Linux; a high-water mark, so per-step deltas show
    # which phase pushed the peak (0 for phases under an earlier peak)
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss


class StepLogger:
    def __init__(self, path: str):
        self.path = path
        self.f = open(path, "a")
        self.phases: List[dict] = []

    def info(self, msg: str) -> None:
        print(msg)
        print(msg, file=self.f)
        self.f.flush()

    def command_line(self) -> None:
        print("command line: " + " ".join(sys.argv), file=self.f)
        self.f.flush()

    def devices(self) -> None:
        """Name the devices the run uses, so a CPU fallback shows in the log."""
        import jax

        devs = jax.devices()
        self.info(
            f"device: platform={devs[0].platform} kind={devs[0].device_kind} "
            f"count={len(devs)}"
        )

    @contextlib.contextmanager
    def step(self, name: str):
        t0 = time.time()
        rss0 = _rss_kb()
        self.info(f"--- {name} ---")
        try:
            yield
        finally:
            rec = {
                "phase": name,
                "seconds": time.time() - t0,
                "host_rss_delta_mb": round((_rss_kb() - rss0) / 1024.0, 2),
                "host_rss_peak_mb": round(_rss_kb() / 1024.0, 2),
            }
            try:
                from bfqzip_tpu.utils.profiling import device_memory_stats

                rec.update(device_memory_stats())
            except Exception:
                pass
            self.phases.append(rec)
            mem = f"  host_rss_delta={rec['host_rss_delta_mb']:.1f}MB"
            if "peak_bytes_in_use" in rec:
                mem += (
                    f"  dev_in_use={rec.get('bytes_in_use', 0)/2**20:.1f}MB"
                    f"  dev_peak={rec['peak_bytes_in_use']/2**20:.1f}MB"
                )
            self.info(f"    elapsed: {rec['seconds']:.4f}s{mem}")

    def run(self, cmd) -> None:
        """Run a subprocess with output captured into the log (the reference's
        execute_command, BFQzip.py:328-336)."""
        print("$ " + " ".join(cmd), file=self.f)
        self.f.flush()
        subprocess.check_call(cmd, stdout=self.f, stderr=self.f)

    def close(self) -> None:
        self.f.close()
