"""Wall-clock timing utilities (the port of ``dmlc_core_tpu/utils/timer.py``;
reference: include/dmlc/timer.h:27-46)."""

from __future__ import annotations

import time


def get_time() -> float:
    """Seconds since an arbitrary epoch, monotonic, as double.

    Reference GetTime() prefers clock_gettime(CLOCK_REALTIME)
    (timer.h:27-46); this is the monotonic clock, which is what every
    caller wants (elapsed-time measurement).
    """
    return time.monotonic()


class Timer:
    """Context-manager stopwatch used by throughput logging and benches."""

    def __init__(self) -> None:
        self.start = 0.0
        self.elapsed = 0.0

    def __enter__(self) -> "Timer":
        self.start = get_time()
        return self

    def __exit__(self, *exc) -> None:
        self.elapsed = get_time() - self.start
