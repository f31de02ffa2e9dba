"""Background-thread batch prefetch (the port's copy of
`bisinger_tpu/data/prefetch.py`).

`DataLoader` produces batches inline on the calling thread, which
serializes record fetch + collate with the device step. `Prefetcher` moves
that work onto a daemon thread with a bounded queue (depth 2 by default)
so the next batch is staged while the card runs the current step.

Ordering is preserved (single worker thread); exceptions raised while
producing are re-raised on the consuming thread at the point of `next()`.

`DevicePut` is the trainer's `dataloader_prefetch_put: worker` (JAX's
`trainer.py:230-239`): the copy of each batch to the device runs in the
prefetcher's transform, on its thread. On the card the batch goes through
pinned host memory on a side stream, and an event recorded after the
copies is what the consuming step waits on (`take`); the tensors are then
marked as used on the consuming stream, so that the allocator does not
hand their memory out again while the step still reads it. The batches are
the ones `batch_to_device` makes on the main thread, bit for bit.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict, Iterable, Iterator, Optional, Tuple

import torch


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


class DevicePut:
    """`stage` (the prefetcher's transform, on its thread): a collated batch
    -> (its tensors on `device`, the event that ends their copy, or None off
    the card); `take` (on the consuming thread): the tensors, once the
    current stream waits on that event."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

    def stage(self, batch) -> Tuple[Dict[str, torch.Tensor], Optional["torch.cuda.Event"]]:
        from bisinger_tpu_torch.data.dataset import batch_to_device

        if self.stream is None:
            return batch_to_device(batch, self.device), None
        host = batch_to_device(batch, "cpu")
        with torch.cuda.stream(self.stream):
            out = {k: v.pin_memory().to(self.device, non_blocking=True) for k, v in host.items()}
            done = torch.cuda.Event()
            done.record(self.stream)
        return out, done

    def take(self, staged) -> Dict[str, torch.Tensor]:
        out, done = staged
        if done is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(done)
            for v in out.values():
                v.record_stream(cur)
        return out
