"""The batch container (``veto_tpu/engine/batch.py`` ``SGGBatch``) and the
device feeder.

Fixed-shape, mask-carrying arrays, padded by the loader to static budgets.
Host side it holds numpy arrays; :meth:`SGGBatch.to` makes the torch
tensors a step runs on.  :class:`DeviceFeeder` is PyTorch's form of the JAX
loader's prefetch and asynchronous ``device_put``: it moves the next batch
to the card while the current one runs.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Tuple

import numpy as np
import torch


@dataclass
class SGGBatch:
    images: Any      # (B, H, W, 3) float32, normalized
    depth: Any       # (B, H, W, 1) float32
    boxes: Any       # (B, N, 4) xyxy in padded-image pixel coords
    box_mask: Any    # (B, N) bool
    labels: Any      # (B, N) int32 object classes (0 = bg/pad)
    obj_logits: Any  # (B, N, num_obj) detector logits (PredCls: one-hot)
    rel_matrix: Any  # (B, N, N) int32 GT predicate matrix (0 = none)
    sizes: Any       # (B, 2) int32 (width, height) before padding
    attributes: Any = None  # (B, N, 10) int32 attribute ids (0 = none)
    masks: Any = None       # (B, N, H, W) uint8 0/1 instance masks, or None
    keypoints: Any = None   # (B, N, K, 3) float32 [x, y, visibility], or None

    def fields(self) -> Dict[str, Any]:
        """The fields that hold an array (masks and keypoints only when the
        batch carries them)."""
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)
                if getattr(self, f.name) is not None}

    def to(self, device) -> "SGGBatch":
        """The same batch as torch tensors on ``device`` (a pageable copy)."""
        return SGGBatch(**{k: torch.as_tensor(v).to(device)
                           for k, v in self.fields().items()})


_END = object()


class DeviceFeeder:
    """Iterate ``(host SGGBatch, records)`` pairs as ``(device SGGBatch,
    records)``, one batch ahead.

    On a card a background thread takes the next host batch, copies it into
    pinned host buffers (one set per batch shape, reused), and issues
    non-blocking copies to the card on a side stream; the consumer's stream
    waits on that copy's event before the batch is handed out, and each
    tensor is recorded on the consumer's stream so that the allocator does
    not reuse its memory early.  So the copy of batch ``i + 1`` (and the
    loader's work for it) overlaps step ``i``.  On the CPU the batches pass
    through ``SGGBatch.to`` in the caller's thread.

    ``waits`` holds, per batch handed out, the seconds the consumer waited
    for it (the loader not keeping up).  The host iterator is drained in
    order on one thread, so the batches and every RNG draw behind them are
    those of a plain loop.  Closing the iteration early stops the thread."""

    def __init__(self, batches: Iterable[Tuple[Any, list]], device):
        self.batches = batches
        self.device = torch.device(device)
        self.waits: List[float] = []

    def __iter__(self):
        if self.device.type == "cuda":
            yield from self._cuda_iter()
            return
        it = iter(self.batches)
        while True:
            t0 = time.perf_counter()
            item = next(it, _END)
            if item is _END:
                return
            self.waits.append(time.perf_counter() - t0)
            host, recs = item
            yield host.to(self.device), recs

    def _cuda_iter(self):
        ready: "queue.Queue" = queue.Queue(maxsize=1)
        stop = threading.Event()
        thread = threading.Thread(target=self._produce, args=(ready, stop),
                                  daemon=True)
        thread.start()
        consumer = torch.cuda.current_stream(self.device)
        try:
            while True:
                t0 = time.perf_counter()
                item = ready.get()
                wait = time.perf_counter() - t0
                if item is _END:
                    return
                if isinstance(item, BaseException):
                    raise item
                batch, recs, event = item
                consumer.wait_event(event)
                for t in batch.fields().values():
                    t.record_stream(consumer)
                self.waits.append(wait)
                yield batch, recs
        finally:
            stop.set()
            while thread.is_alive():  # unblock a producer stuck on put
                try:
                    ready.get(timeout=0.05)
                except queue.Empty:
                    pass
            thread.join()

    def _produce(self, ready: "queue.Queue", stop: threading.Event) -> None:
        pinned: Dict[tuple, torch.Tensor] = {}
        it = iter(self.batches)

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    ready.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    pass
            return False

        try:
            with torch.cuda.device(self.device):
                side = torch.cuda.Stream(self.device)
                for host, recs in it:
                    if stop.is_set():
                        return
                    fields = {}
                    with torch.cuda.stream(side):
                        for name, arr in host.fields().items():
                            arr = np.ascontiguousarray(arr)
                            key = (name, arr.shape, arr.dtype.str)
                            buf = pinned.get(key)
                            if buf is None:
                                buf = pinned[key] = torch.from_numpy(arr).pin_memory()
                            else:
                                buf.copy_(torch.from_numpy(arr))
                            fields[name] = buf.to(self.device, non_blocking=True)
                    event = torch.cuda.Event()
                    event.record(side)
                    # the pinned buffers are reused for the next batch of
                    # this shape: its copy must be done first
                    event.synchronize()
                    if not put((SGGBatch(**fields), recs, event)):
                        return
            put(_END)
        except BaseException as err:  # handed to the consumer, raised there
            put(err)
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()
