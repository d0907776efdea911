"""Host-side batch prefetching: the PyTorch counterpart of
``ivlnce_tpu/utils/prefetch.py``.

The reference hides LMDB decode latency behind 3-4 DataLoader workers
(dagger_trainer.py:568-576, iterative_dagger_trainer.py:210-216). The
TPU-side equivalent: one producer thread decodes/collates the next
batches into a bounded queue while the current train step runs on the
accelerator, so store reads, msgpack decode, and padding never serialize
with device compute. A thread (not a process) suffices — the decode work
is numpy/C and releases the GIL, and batches stay in shared memory.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, TypeVar

T = TypeVar("T")

_SENTINEL = object()


class PrefetchIterator:
    """Wrap an iterator with a depth-bounded background producer."""

    def __init__(self, iterable: Iterable[T], depth: int = 3):
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._err = None
        self._done = threading.Event()
        self._thread = threading.Thread(
            target=self._produce, args=(iter(iterable),), daemon=True
        )
        self._thread.start()

    def _put_unless_closed(self, item) -> bool:
        """Timed put that gives up when the consumer closed: an abandoned
        consumer (break/exception mid-epoch) leaves the queue full
        forever, so re-check _done between attempts instead of blocking —
        the producer exits rather than leaking a thread that pins the
        underlying batch iterator (ADVICE r2)."""
        while not self._done.is_set():
            try:
                self._q.put(item, timeout=0.25)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self, it: Iterator[T]) -> None:
        try:
            for item in it:
                if not self._put_unless_closed(item):
                    return
        except BaseException as e:  # propagate into the consumer
            self._err = e
        finally:
            self._put_unless_closed(_SENTINEL)

    def __iter__(self):
        return self

    def __next__(self) -> T:
        item = self._q.get()
        if item is _SENTINEL:
            self._done.set()
            self._thread.join(timeout=5)
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self) -> None:
        """Stop the producer early (e.g. on epoch break)."""
        self._done.set()
        # drain so a blocked put() can observe the flag
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass

    def __del__(self):  # last-resort cleanup for abandoned iterators
        self._done.set()


def prefetch(iterable: Iterable[T], depth: int = 3) -> Iterator[T]:
    """Background-prefetch ``iterable`` with a queue of ``depth``."""
    return PrefetchIterator(iterable, depth=depth)


# -- multi-process decode ------------------------------------------------------
# The thread producer above hides store READ latency, but msgpack decode
# and collate padding are pure-python enough to contend for the GIL at
# production scale; the reference parallelizes them across 3-4 DataLoader
# worker PROCESSES (dagger_trainer.py:568-576). process_windows is the
# equivalent: tasks (decode windows) are statically sharded worker w <-
# tasks[w::workers], each worker streams its task's items into a bounded
# queue, and the parent reads queues in task round-robin — so the global
# item order is DETERMINISTIC (identical to processing tasks in order),
# unlike a single shared queue.

def _window_worker(fn, tasks, wid, num_workers, q):
    try:
        for ti in range(wid, len(tasks), num_workers):
            for item in fn(tasks[ti]):
                q.put(("item", ti, item))
            q.put(("end", ti, None))
        q.put(("done", None, None))
    except BaseException as e:  # surface in the parent
        # mp.Queue serializes in a background FEEDER thread, so an
        # unpicklable exception would be dropped silently AFTER put()
        # returned — probe picklability synchronously first
        import pickle

        try:
            pickle.dumps(e)
        except Exception:
            e = RuntimeError(f"{type(e).__name__}: {e}")
        q.put(("error", None, e))


class ProcessWindowIterator:
    """Yield fn(task) items for every task, flattened in task order, with
    fn evaluated across ``workers`` processes. fn and tasks must be
    picklable (fn a module-level callable)."""

    def __init__(self, fn, tasks, workers: int = 2, depth: int = 4):
        import multiprocessing as mp

        ctx = mp.get_context("forkserver")
        self._tasks = list(tasks)
        self._n = max(1, min(workers, len(self._tasks)))
        self._qs = [ctx.Queue(maxsize=max(1, depth)) for _ in range(self._n)]
        self._procs = [
            ctx.Process(
                target=_window_worker,
                args=(fn, self._tasks, w, self._n, self._qs[w]),
                daemon=True,
            )
            for w in range(self._n)
        ]
        for p in self._procs:
            p.start()
        self._ti = 0
        self._closed = False

    def __iter__(self):
        return self

    def __next__(self):
        import queue as queue_mod

        while True:
            if self._ti >= len(self._tasks):
                self.close()
                raise StopIteration
            w = self._ti % self._n
            try:
                kind, ti, item = self._qs[w].get(timeout=10)
            except queue_mod.Empty:
                # a worker killed without a message (OOM, segfault in
                # the decode C layer) would otherwise hang the consumer
                # forever
                if not self._procs[w].is_alive():
                    code = self._procs[w].exitcode
                    self.close()
                    raise RuntimeError(
                        f"decode worker {w} died (exit {code}) without "
                        "delivering its window"
                    )
                continue
            if kind == "error":
                self.close()
                raise item
            if kind == "end":
                assert ti == self._ti, (ti, self._ti)
                self._ti += 1
                continue
            if kind == "done":
                self.close()
                raise StopIteration
            return item

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for p in self._procs:
            p.terminate()
        for p in self._procs:
            p.join(timeout=5)
        for q in self._qs:
            q.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
