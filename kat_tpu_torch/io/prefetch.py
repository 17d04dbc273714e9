"""Background prefetching for host input pipelines.

The reference overlaps parsing with counting via its cooperative MPMC pool
(deps/jellyfish-2.2.0/include/jellyfish/cooperative_pool2.hpp:28-50 —
consumers become producers).  The TPU analogue is simpler: device compute
is asynchronous anyway, so ONE background thread running the native reader
a few batches ahead keeps the chip fed while the host parses/decompresses.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, TypeVar

T = TypeVar("T")

_SENTINEL = object()


class _Raised:
    def __init__(self, exc: BaseException):
        self.exc = exc


def prefetch(iterable: Iterable[T], depth: int = 4) -> Iterator[T]:
    """Iterate `iterable` on a daemon thread, staying `depth` items ahead.

    Exceptions raised by the producer re-raise at the consumer's next
    read, preserving the original traceback.
    """
    q: queue.Queue = queue.Queue(maxsize=depth)

    def worker() -> None:
        try:
            for item in iterable:
                q.put(item)
        except BaseException as e:  # noqa: BLE001 — re-raised at consumer
            q.put(_Raised(e))
        finally:
            q.put(_SENTINEL)

    t = threading.Thread(target=worker, daemon=True,
                         name="kat-tpu-prefetch")
    t.start()
    while True:
        item = q.get()
        if item is _SENTINEL:
            break
        if isinstance(item, _Raised):
            raise item.exc
        yield item
