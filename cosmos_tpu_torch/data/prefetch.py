"""Input prefetch onto the device on a CUDA stream of its own (counterpart of
``cosmos_tpu/data/prefetch.py`` ``DevicePrefetcher`` together with the JAX
trainer's ``shard_batch``).

A daemon thread takes numpy batches from the loader, copies each array into
pinned host memory and issues its host-to-device copy with
``non_blocking=True`` on the prefetcher's own ``torch.cuda.Stream``, then
records an event there.  The consumer makes its current stream wait on that
event and marks each tensor with ``record_stream`` before use, so the copy
of batch i+1 overlaps step i and the allocator does not reuse a batch's
memory while the step still reads it.

On the CPU (``device="cpu"``, because the caller asked for it) the batches
come back as CPU tensors.  On a CUDA device no host tensor is ever handed
back.

Ordering is the loader's: one producer thread takes the iterator in order,
and an exception the loader raises re-raises in the consumer where it
happened.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Dict, Iterable, Iterator, Optional, Union

import numpy as np
import torch

__all__ = ["DevicePrefetcher", "to_device"]

_DONE = object()


def to_device(batch: Dict[str, np.ndarray], device: torch.device,
              stream: Optional[torch.cuda.Stream] = None
              ) -> Dict[str, torch.Tensor]:
    """numpy batch -> tensors on ``device``.  For a CUDA device each array
    goes through pinned memory and a non-blocking copy on ``stream`` (the
    current stream when None)."""
    host = {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}
    if device.type != "cuda":
        return {k: v.to(device) for k, v in host.items()}
    with torch.cuda.device(device), torch.cuda.stream(stream):
        return {k: v.pin_memory().to(device, non_blocking=True)
                for k, v in host.items()}


class DevicePrefetcher:
    """Iterate ``src`` (numpy batches) on a daemon thread, ``depth`` batches
    ahead, handing back tensors on ``device``."""

    def __init__(self, src: Iterable, device: Union[str, torch.device],
                 depth: int = 2):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self.device = torch.device(device)
        self._stream = (torch.cuda.Stream(device=self.device)
                        if self.device.type == "cuda" else None)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._src = iter(src)
        self._exc: Optional[BaseException] = None
        self._finished = False
        self._stop = False
        self._thread = threading.Thread(
            target=self._produce, name="device-prefetch", daemon=True
        )
        self._thread.start()

    def _put(self, item) -> bool:
        """Bounded put that watches the stop flag, so close() can always
        unblock a parked producer."""
        while not self._stop:
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self) -> None:
        try:
            for batch in self._src:
                tensors = to_device(batch, self.device, self._stream)
                event = None
                if self._stream is not None:
                    event = torch.cuda.Event()
                    event.record(self._stream)
                if not self._put((tensors, event)):
                    return
        except BaseException as e:  # re-raised in the consumer
            self._exc = e
        finally:
            self._put(_DONE)

    def close(self, timeout: float = 2.0) -> None:
        """Stop the producer and drop the batches still queued (they hold
        device memory).  Safe to call repeatedly; iteration afterwards
        raises StopIteration.  A producer blocked inside the wrapped
        iterator cannot be interrupted: past ``timeout`` the daemon thread
        is left to exit at its next stop-flag check."""
        self._stop = True
        self._finished = True
        deadline = time.monotonic() + timeout
        while self._thread.is_alive() and time.monotonic() < deadline:
            try:  # unblock a producer parked on a full queue
                self._q.get(timeout=0.05)
            except queue.Empty:
                pass
            self._thread.join(timeout=0.05)
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break

    def __enter__(self) -> "DevicePrefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __iter__(self) -> Iterator:
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        if self._finished:
            raise StopIteration
        item = self._q.get()
        if item is _DONE:
            self._finished = True
            self._thread.join()
            if self._exc is not None:
                raise self._exc
            raise StopIteration
        batch, event = item
        if event is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(event)
            for t in batch.values():
                t.record_stream(current)
        return batch
