"""Background batch prefetching.

The port's own copy of ``livespeechportraits_tpu/train/prefetch.py``: a
thread assembles the next batches on the host (and moves them to the card,
when the trainer passes that as ``transform``) while the current step runs.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterator, Optional


def prefetch(iterator: Iterator[Any], size: int = 2,
             transform: Optional[Callable[[Any], Any]] = None) -> Iterator[Any]:
    """Wrap an iterator with a ``size``-deep background queue.

    ``transform`` runs in the worker thread.  An exception in the worker is
    raised in the consumer.  A consumer that abandons the generator (a step
    raised, an interrupt) releases the worker: it stops at its next put
    instead of blocking forever on a full queue holding batches."""
    if size < 1:
        raise ValueError("prefetch size must be >= 1 (0 would make the queue unbounded; "
                         "callers wanting synchronous iteration should not wrap at all)")
    q: "queue.Queue" = queue.Queue(maxsize=size)
    end = object()
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def worker() -> None:
        try:
            for item in iterator:
                if stop.is_set():
                    return
                if not put(transform(item) if transform is not None else item):
                    return
            put(end)
        except BaseException as e:  # handed to the consuming thread, which raises it
            put(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()  # releases a worker blocked on a full queue
