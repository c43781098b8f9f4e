"""Metrics/observability subsystem (SURVEY.md §5.5).

The reference printed loss to stdout; here: structured JSONL metric streams
(one object per logged step) consumable by any dashboard, plus rolling
aggregates and the BASELINE-mandated throughput counters
(audio-seconds/s per device, samples/s).  Kept dependency-free (no TF summaries);
the jax profiler covers traces (utils/profiling.py).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class MetricsLogger:
    """Append-only JSONL metrics writer with wall-clock stamps."""

    def __init__(self, path: Optional[str] = None, also_print: bool = True):
        self.path = path
        self.also_print = also_print
        self._f = None
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._f = open(path, "a", buffering=1)
        self._t0 = time.time()

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        rec = {"step": step, "time": round(time.time() - self._t0, 3)}
        rec.update({k: (round(float(v), 6) if isinstance(v, (int, float))
                        else v) for k, v in metrics.items()})
        if self._f:
            self._f.write(json.dumps(rec) + "\n")
        if self.also_print:
            print(" ".join(f"{k}={v}" for k, v in rec.items()), flush=True)

    def close(self):
        if self._f:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class ThroughputMeter:
    """Rolling audio-seconds/s and samples/s, compile-step excluded."""

    def __init__(self, audio_seconds_per_batch: float, samples_per_batch: int):
        self.aspb = audio_seconds_per_batch
        self.spb = samples_per_batch
        self.t0 = None
        self.n = 0

    def tick(self):
        if self.t0 is None:
            self.t0 = time.perf_counter()
        else:
            self.n += 1

    def rates(self) -> Dict[str, float]:
        if not self.n:
            return {}
        dt = time.perf_counter() - self.t0
        return {"steps_per_sec": self.n / dt,
                "audio_seconds_per_sec": self.n * self.aspb / dt,
                "samples_per_sec": self.n * self.spb / dt}
