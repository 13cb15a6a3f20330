"""Bucketed, iteration-based loading (``veto_tpu/data/loader.py``).

The port's copy of the JAX loader, with the port's own collate
(:func:`veto_tpu_torch.data.batching.make_sgg_batch`):

  * epoch shuffling seeded by ``(seed, epoch).__hash__() % 2**31`` (a tuple
    of ints hashes the same in every process);
  * aspect-ratio grouping into a landscape and a portrait bucket (800 x 1344
    and 1344 x 800 at the Visual Genome sizes) so a train batch has one
    shape; an eval batch that mixes aspects (its last batch wraps around
    to the first images) pads to the envelope of both, 1344 x 1344;
  * ground truth is drawn on the calling thread in index order (the
    dataset's sequential ``RandomState``); only pixel work runs on the
    worker threads, so batches do not depend on the worker count;
  * the fused path: when the port's host ops are built and the dataset
    serves raw u8 images and their sizes, a worker decodes, resizes,
    normalizes and pads each image straight into its batch slot;
  * ``iterations(max_iter, start_iter)`` yields ``max_iter - start_iter``
    batches.  As in the JAX loader, the index stream restarts at epoch 0
    whatever ``start_iter`` is: a resumed run does not continue the
    interrupted run's data stream.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np

from ..engine.batch import SGGBatch
from .batching import make_sgg_batch
from .transforms import (
    bucket_shape,
    normalize_depth,
    normalize_image,
    pad_to,
    resize_image,
    resize_shape,
)

# Batches' worth of records the worker pool decodes ahead of the consumer.
PREFETCH_BATCHES = 2


def load_pixels(dataset, inner: int, min_size: int, max_size: int, pixel_mean,
                pixel_std, to_bgr255: bool = True, use_depth: bool = True):
    """Decode, resize and normalize one image (no shared RNG: thread-safe)."""
    image = dataset.load_image(inner)
    h0, w0 = image.shape[:2]
    oh, ow = resize_shape(w0, h0, min_size, max_size)
    image = resize_image(image, oh, ow)
    image = normalize_image(image, pixel_mean, pixel_std, to_bgr255)

    depth = None
    if use_depth:
        raw = dataset.load_depth(inner)
        if raw is not None:
            depth = normalize_depth(resize_image(raw, oh, ow))
        else:
            depth = np.zeros((oh, ow, 1), np.float32)
    return image, depth, (h0, w0), (oh, ow)


def finish_record(rec: Dict, pixels) -> Dict:
    image, depth, (h0, w0), (oh, ow) = pixels
    # boxes scale with the resize
    sy, sx = oh / h0, ow / w0
    boxes = rec["boxes"] * np.array([sx, sy, sx, sy], np.float32)
    out = dict(rec)
    out.update(image=image, depth=depth, boxes=boxes,
               size=np.array([ow, oh], np.int32))
    return out


def _inner(dataset, index: int) -> int:
    return dataset.idx_list[index] if hasattr(dataset, "idx_list") else index


def prepare_record(dataset, index: int, min_size: int, max_size: int,
                   pixel_mean, pixel_std, to_bgr255: bool = True,
                   use_depth: bool = True) -> Dict:
    """Load and transform one image into a batch-ready record."""
    rec = dataset.get_groundtruth(index, inner_idx=False)
    return finish_record(rec, load_pixels(
        dataset, _inner(dataset, index), min_size, max_size, pixel_mean,
        pixel_std, to_bgr255, use_depth))


class SGGLoader:
    """Deterministic bucketed loader over a VG/GQA-style dataset."""

    def __init__(self, dataset, batch_size: int, max_boxes: int = 80,
                 num_obj_classes: int = 151, min_size: int = 800,
                 max_size: int = 1333,
                 pixel_mean=(102.9801, 115.9465, 122.7717),
                 pixel_std=(1.0, 1.0, 1.0), use_depth: bool = True,
                 shuffle: bool = True, seed: int = 1,
                 size_divisibility: int = 32, num_workers: int = 4):
        self.dataset = dataset
        self.batch_size = batch_size
        self.max_boxes = max_boxes
        self.num_obj_classes = num_obj_classes
        self.min_size = min_size
        self.max_size = max_size
        self.pixel_mean = pixel_mean
        self.pixel_std = pixel_std
        self.use_depth = use_depth
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = num_workers
        self.pad_shapes = {
            "landscape": bucket_shape(min_size, max_size, size_divisibility),
            "portrait": bucket_shape(max_size, min_size, size_divisibility),
        }

    def _indices(self, epoch: int) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.RandomState((self.seed, epoch).__hash__() % (2**31))
            rng.shuffle(idx)
        return idx

    def _record(self, index: int) -> Dict:
        return prepare_record(self.dataset, index, self.min_size, self.max_size,
                              self.pixel_mean, self.pixel_std,
                              use_depth=self.use_depth)

    def _stream_records(self, idx_iter) -> Iterator[Dict]:
        """Records in index order, the pixel work on a thread pool (PIL and
        the host ops release the GIL); ground truth stays on this thread,
        so record order and every RNG draw match ``num_workers=0``."""
        if self.num_workers <= 0:
            for i in idx_iter:
                yield self._record(int(i))
            return
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        ds = self.dataset
        depth = self.num_workers + self.batch_size * PREFETCH_BATCHES

        def pixels(inner):
            return load_pixels(ds, inner, self.min_size, self.max_size,
                               self.pixel_mean, self.pixel_std,
                               use_depth=self.use_depth)

        with ThreadPoolExecutor(self.num_workers) as ex:
            pending = deque()
            for i in idx_iter:
                i = int(i)
                rec = ds.get_groundtruth(i, inner_idx=False)
                pending.append((rec, ex.submit(pixels, _inner(ds, i))))
                if len(pending) >= depth:
                    rec, fut = pending.popleft()
                    yield finish_record(rec, fut.result())
            while pending:
                rec, fut = pending.popleft()
                yield finish_record(rec, fut.result())

    def fast_capable(self) -> bool:
        """Whether :meth:`iterations` takes the fused path."""
        from .. import native

        return (self.num_workers > 0 and native.available()
                and hasattr(self.dataset, "load_image_raw")
                and hasattr(self.dataset, "image_size"))

    def _fast_batches(self, idx_iter) -> Iterator[Tuple[SGGBatch, list]]:
        """The fused path: aspect routing from the dataset's size metadata
        (no decode on this thread), ground truth here in index order, and
        one host-op call a worker per image into preallocated batch arrays.
        Its pixels match the NumPy path's to float rounding."""
        from concurrent.futures import ThreadPoolExecutor

        from .. import native

        ds = self.dataset
        mean, std = self.pixel_mean, self.pixel_std
        use_depth = self.use_depth
        bsz = self.batch_size

        def task(inner, oh, ow, img_slot, depth_slot):
            raw = ds.load_image_raw(inner)
            native.resize_normalize_u8_into(raw, oh, ow, img_slot, mean, std)
            d = ds.load_depth(inner) if use_depth else None
            if d is None:
                depth_slot[:] = 0.0
            else:
                native.resize_standardize_into(d, oh, ow, depth_slot)

        open_bufs: Dict[bool, dict] = {}
        with ThreadPoolExecutor(self.num_workers) as ex:
            for i in idx_iter:
                i = int(i)
                inner = _inner(ds, i)
                w0, h0 = ds.image_size(inner)
                oh, ow = resize_shape(w0, h0, self.min_size, self.max_size)
                key = oh > ow
                buf = open_bufs.get(key)
                if buf is None:
                    ph, pw = self.pad_shapes["portrait" if key else "landscape"]
                    buf = open_bufs[key] = dict(
                        images=np.empty((bsz, ph, pw, 3), np.float32),
                        depth=np.empty((bsz, ph, pw, 1), np.float32),
                        recs=[], futs=[])
                slot = len(buf["recs"])
                rec = dict(ds.get_groundtruth(i, inner_idx=False))
                sy, sx = oh / h0, ow / w0
                rec["boxes"] = rec["boxes"] * np.array([sx, sy, sx, sy],
                                                       np.float32)
                rec["size"] = np.array([ow, oh], np.int32)
                buf["recs"].append(rec)
                buf["futs"].append(ex.submit(task, inner, oh, ow,
                                             buf["images"][slot],
                                             buf["depth"][slot]))
                if len(buf["recs"]) == bsz:
                    del open_bufs[key]
                    for f in buf["futs"]:
                        f.result()
                    yield make_sgg_batch(
                        buf["recs"], buf["images"].shape[1:3], self.max_boxes,
                        self.num_obj_classes,
                        pixel_arrays=(buf["images"], buf["depth"])), buf["recs"]

    def _assemble(self, records) -> SGGBatch:
        aspects = {r["image"].shape[0] > r["image"].shape[1] for r in records}
        if len(aspects) == 1:
            shape = self.pad_shapes["portrait" if aspects.pop() else "landscape"]
        else:  # a mixed eval batch pads to the envelope of both buckets
            a, b = self.pad_shapes["portrait"], self.pad_shapes["landscape"]
            shape = (max(a[0], b[0]), max(a[1], b[1]))
        for r in records:
            r["image"] = pad_to(r["image"], *shape)
            if r["depth"] is not None:
                r["depth"] = pad_to(r["depth"], *shape)
        return make_sgg_batch(records, shape, self.max_boxes, self.num_obj_classes)

    def epochs(self) -> Iterator[Tuple[SGGBatch, list]]:
        """One pass over the dataset (eval); the last batch is padded
        by wrapping around to the first indices."""
        idx = self._indices(epoch=0)
        chunks = []
        for start in range(0, len(idx), self.batch_size):
            chunk = idx[start: start + self.batch_size]
            if len(chunk) < self.batch_size:
                chunk = np.concatenate([chunk, idx[: self.batch_size - len(chunk)]])
            chunks.append(chunk)
        stream = self._stream_records(int(i) for chunk in chunks for i in chunk)
        for chunk in chunks:
            recs = [next(stream) for _ in chunk]
            yield self._assemble(recs), recs

    def iterations(self, max_iter: int,
                   start_iter: int = 0) -> Iterator[Tuple[SGGBatch, list]]:
        """The training stream: ``max_iter - start_iter`` batches, each of
        one bucket (IterationBasedBatchSampler semantics)."""
        it = start_iter
        buffers: Dict[bool, list] = {True: [], False: []}

        def index_stream():
            epoch = 0
            while True:
                for index in self._indices(epoch):
                    yield int(index)
                epoch += 1

        if it >= max_iter:
            return
        if self.fast_capable():
            for batch, recs in self._fast_batches(index_stream()):
                yield batch, recs
                it += 1
                if it >= max_iter:
                    return
            return
        for rec in self._stream_records(index_stream()):
            key = rec["image"].shape[0] > rec["image"].shape[1]
            buffers[key].append(rec)
            if len(buffers[key]) == self.batch_size:
                yield self._assemble(buffers[key]), buffers[key]
                buffers[key] = []
                it += 1
                if it >= max_iter:
                    return
