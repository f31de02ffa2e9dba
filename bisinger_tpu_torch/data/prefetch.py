"""Background-thread batch prefetch (the port's copy of
`bisinger_tpu/data/prefetch.py`).

`DataLoader` produces batches inline on the calling thread, which
serializes record fetch + collate with the device step. `Prefetcher` moves
that work onto a daemon thread with a bounded queue (depth 2 by default)
so the next batch is staged while the card runs the current step.

Ordering is preserved (single worker thread); exceptions raised while
producing are re-raised on the consuming thread at the point of `next()`.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterable, Iterator, Optional


class _Stop:
    pass


_STOP = _Stop()


class Prefetcher:
    """Iterator pulling from `iterable` on a background thread.

    transform: applied to each item ON THE WORKER THREAD — put the
    expensive host work here (collate already happened inside the
    loader's iterator).
    depth: max batches staged ahead (queue bound).
    """

    def __init__(
        self,
        iterable: Iterable[Any],
        depth: int = 2,
        transform: Optional[Callable[[Any], Any]] = None,
        name: str = "batch-prefetch",
    ):
        self._src = iterable
        self._transform = transform
        self._q: queue.Queue = queue.Queue(maxsize=max(1, int(depth)))
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._worker, daemon=True, name=name
        )
        self._thread.start()

    def _put(self, item: Any) -> bool:
        """Bounded put that aborts promptly once close() is called."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self):
        try:
            for item in self._src:
                if self._transform is not None:
                    item = self._transform(item)
                if not self._put(item):
                    return
            self._put(_STOP)
        except BaseException as e:  # re-raised on the consumer thread
            self._put(e)

    def __iter__(self) -> Iterator[Any]:
        return self

    def __next__(self) -> Any:
        if self._stop.is_set():
            raise StopIteration
        item = self._q.get()
        if item is _STOP:
            # latch exhaustion: the sentinel is consumed exactly once,
            # so without the flag a second next() would block forever on
            # the empty queue (the iterator protocol requires repeated
            # StopIteration after exhaustion)
            self._stop.set()
            raise StopIteration
        if isinstance(item, BaseException):
            self._stop.set()
            raise item
        return item

    def close(self):
        """Stop the worker (endless loaders would otherwise keep the
        thread parked on the queue for the process lifetime)."""
        self._stop.set()
        # unblock a worker waiting on a full queue
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
