"""The timed training loop: the port's normal path, as a user's loop
drives it. Each epoch opens the cell's producer on the file
(``ell_batches`` / ``dense_batches``), stages it with
``StagingPipeline`` and closes both at the epoch's end; every batch goes
to the model's ``sgd_step``. No step waits for the device: the losses
stay on it and are read after the window.

The benchmark's own spans sit around its calls into each layer:
``next`` (the wait for a staged batch, an epoch's reopen included),
``sgd_step`` (the host's time in the step) and ``reopen`` (the epoch's
producer and pipeline opened); their clocks are always read, and under
a profiler they are also ``record_function`` ranges.
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import Callable, Dict, Iterator, List, Tuple

from dmlc_core_tpu_torch.staging.pipeline import StagingPipeline, drain_close


class RowLog:
    """A producer passed through, noting each batch's valid rows in order
    (the pipeline keeps the order, so the consumer pops one a step)."""

    def __init__(self, source) -> None:
        self.source = source
        self.rows: collections.deque = collections.deque()
        self.ring_slots = getattr(source, "ring_slots", None)
        self.spec = getattr(source, "spec", None)

    def __iter__(self):
        for batch in self.source:
            self.rows.append(batch.n_valid)
            yield batch


class Feed:
    """Epochs of staged batches for one model. ``epoch(e)`` yields
    ``(device batch, valid rows, its place in the epoch)`` and closes its
    producer and pipeline when it ends or is closed; ``epoch_rows`` keeps
    the rows each whole epoch staged."""

    def __init__(self, make_source: Callable[[int], object], device) -> None:
        self.make_source = make_source
        self.device = device
        self.span: Callable = lambda name: contextlib.nullcontext()
        self.epoch_rows: List[int] = []  # rows staged by each whole epoch
        # the transfer thread's pack-and-enqueue seconds and the batches
        # staged, summed over the closed pipelines
        self.stage_dispatch_s = 0.0
        self.staged_batches = 0
        self.pipe = None
        self.parts = None  # the producer threads of the last epoch opened

    def epoch(self, e: int) -> Iterator[Tuple[Dict, int, int]]:
        with self.span("perfbench:reopen"):
            src = self.make_source(e)
            # a source fanned out over threads (``ShardedFusedBatches``)
            # holds one producer a part of the file
            self.parts = len(getattr(src, "_producers", None) or [src])
            log = RowLog(src)
            pipe = StagingPipeline(log, device=self.device)
        self.pipe = pipe
        whole = False
        try:
            for pos, batch in enumerate(pipe):
                yield batch, log.rows.popleft(), pos
            whole = True
        finally:
            if whole:
                self.epoch_rows.append(pipe.rows_staged)
            thr = pipe.throughput()
            self.stage_dispatch_s += thr["secs_stage_dispatch"]
            self.staged_batches += int(thr["batches"])
            self.pipe = None
            if not drain_close(pipe, src):
                raise RuntimeError("the staging pipeline did not close")


class Stepper:
    """The loop's state: steps taken, rows trained, the losses (on the
    device) and the host clocks of each part."""

    def __init__(self, model, lr: float, feed: Feed) -> None:
        self.model, self.lr, self.feed = model, lr, feed
        self.losses: List = []
        self.reset_clocks()

    def reset_clocks(self) -> None:
        self.steps = 0
        self.rows = 0
        self.wait_s = 0.0
        self.step_s = 0.0
        self.starts: List[float] = []

    def run(self, it: Iterator, until: Callable[[], bool], on_batch=None) -> bool:
        """Steps from ``it`` until ``until()`` or the epoch ends; returns
        False when the epoch ended. ``on_batch(batch, place)`` sees each
        batch before its step."""
        span = self.feed.span
        while not until():
            t0 = time.perf_counter()
            with span("perfbench:next"):
                item = next(it, None)
            t1 = time.perf_counter()
            self.wait_s += t1 - t0
            if item is None:
                return False
            batch, n, pos = item
            if on_batch is not None:
                on_batch(batch, pos)
                t1 = time.perf_counter()  # the check's reading is no step's
            with span("perfbench:sgd_step"):
                self.losses.append(self.model.sgd_step(batch, self.lr))
            self.starts.append(t1)
            self.step_s += time.perf_counter() - t1
            self.steps += 1
            self.rows += n
        return True
