"""Host-side batch prefetching for the stage-1 training loops (port of the
JAX package's ``data/prefetch.py``).

Worker threads assemble whole fixed-shape batches into bounded queues, one
a worker, while the card runs the previous step; the loop takes them in
turn, worker 0 first, so that the stream of batches depends only on the
workers' seeds. The ranks of one host run the same stream and keep their
rows of each batch (:func:`unmore_tpu_torch.parallel.distributed.local_rows`),
as the JAX package's one process splits each batch over its chips. The
synthesis hot spots (image decode, the distance transform and resizes of
``csrc/labels.cpp``) release the interpreter lock, so threads overlap them
with the training thread without pickling datasets across processes.

``starved_s`` is the wall time the training loop spent blocked in
``__next__``; ``starved_fraction`` is its share of the loop's time from the
first batch on, the waits included. (The JAX package's copy divides by the
time between calls only, so its "fraction" can exceed 1.)
"""

from __future__ import annotations

import queue
import threading
import time


class PrefetchIterator:
    """N worker threads calling ``make_batch()`` (or one ``worker_fns``
    callable each, for workers that own a dataset and RNG), each into its
    own queue of ``depth // N`` batches (at least one), taken in turn."""

    def __init__(self, make_batch=None, num_workers: int = 4, depth: int = 8, worker_fns=None):
        if worker_fns is None:
            if make_batch is None:
                raise ValueError("need make_batch or worker_fns")
            worker_fns = [make_batch] * num_workers
        self._qs = [queue.Queue(maxsize=max(depth // len(worker_fns), 1)) for _ in worker_fns]
        self._turn = 0
        self._stop = threading.Event()
        self._errors: queue.Queue = queue.Queue()
        self.starved_s = 0.0
        self.total_s = 0.0
        self._t_last = None
        self._threads = [threading.Thread(target=self._run, args=(fn, q), daemon=True)
                         for fn, q in zip(worker_fns, self._qs)]
        for t in self._threads:
            t.start()

    def _run(self, fn, q):
        while not self._stop.is_set():
            try:
                batch = fn()
            except Exception as e:  # surfaced to the consumer by __next__
                self._errors.put(e)
                return
            while not self._stop.is_set():
                try:
                    q.put(batch, timeout=0.2)
                    break
                except queue.Full:
                    continue

    def __iter__(self):
        return self

    def __next__(self):
        t0 = time.perf_counter()
        while True:
            if not self._errors.empty():
                self.close()
                raise self._errors.get()
            try:
                batch = self._qs[self._turn].get(timeout=0.5)
                break
            except queue.Empty:
                continue
        self._turn = (self._turn + 1) % len(self._qs)
        t1 = time.perf_counter()
        if self._t_last is not None:  # the loop's time since the previous batch, this wait included
            self.starved_s += t1 - t0
            self.total_s += t1 - self._t_last
        self._t_last = t1
        return batch

    @property
    def starved_fraction(self) -> float:
        return self.starved_s / self.total_s if self.total_s > 0 else 0.0

    def close(self):
        """Stop and join the workers (draining the queues so that a producer
        blocked in ``put`` sees the stop flag), within about 10 s."""
        self._stop.set()
        deadline = time.perf_counter() + 10.0
        while any(t.is_alive() for t in self._threads):
            for q in self._qs:
                try:
                    while True:
                        q.get_nowait()
                except queue.Empty:
                    pass
            for t in self._threads:
                t.join(timeout=0.1)
            if time.perf_counter() > deadline:
                break
