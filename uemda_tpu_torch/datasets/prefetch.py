"""Background-thread batch prefetching.

The port's copy of ``uemda_tpu/datasets/prefetch.py``: one daemon thread
assembles the next batches (RAM-cached decode + stack) while the device runs
the current step, behind a queue of ``depth`` batches. The trainer chains
two of them: the decode stage here (``train/loop.py``'s
``make_source_iter``/``make_target_iter``) and the upload stage
(``train/loop.py``'s ``device_batches``), whose worker is this stage's only
consumer.

Unlike the JAX package's copy, closing the returned generator stops the
worker at its next batch, so its owner can read the wrapped iterator again
afterwards (the trainer closes its upload stage when the loop ends).
"""

import queue
import threading
from typing import Iterator

_POLL_S = 0.1  # how often a worker blocked on a full queue looks for a stop


def prefetch(iterator: Iterator, depth: int = 2) -> Iterator:
    """Wrap any batch iterator with a depth-bounded background thread.

    Worker exceptions (decode/IO failures) re-raise in the consumer: a
    corrupt tile must fail the run, not silently truncate the dataset."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = object()
    closed = threading.Event()

    def put(item) -> bool:
        while not closed.is_set():
            try:
                q.put(item, timeout=_POLL_S)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in iterator:
                if not put(item):
                    break
            else:
                put(stop)
        except BaseException as e:  # noqa: BLE001 - forwarded to consumer
            put((stop, e))

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is stop:
                return
            if isinstance(item, tuple) and len(item) == 2 and item[0] is stop:
                raise item[1]
            yield item
    finally:
        closed.set()
        t.join()
