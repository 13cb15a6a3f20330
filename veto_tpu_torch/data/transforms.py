"""Host-side image transforms (NumPy/PIL), ``veto_tpu/data/transforms.py``.

The shipped pipeline is Resize(short 800 / long cap 1333) → BGR*255
Normalize (PIXEL_MEAN [102.98, 115.95, 122.77], std 1); depth gets Resize →
per-image zero-mean/unit-std with a 1/sqrt(HW) floor.  Resized images land
in aspect-ratio buckets padded to a fixed shape, so a step sees two batch
shapes (and their envelope when an eval batch mixes aspects).  PIL is
imported only where the resize falls back to it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def resize_shape(
    w: int, h: int, min_size: int, max_size: Optional[int]
) -> Tuple[int, int]:
    """Target (h, w): short side → min_size, long side capped at max_size
    (Resize.get_size, transforms.py:35-55)."""
    size = min_size
    if max_size is not None:
        mn, mx = float(min(w, h)), float(max(w, h))
        if mx / mn * size > max_size:
            size = int(round(max_size * mn / mx))
    if (w <= h and w == size) or (h <= w and h == size):
        return h, w
    if w < h:
        ow = size
        oh = int(size * h / w)
    else:
        oh = size
        ow = int(size * w / h)
    return oh, ow


def resize_image(image: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """Bilinear resize (H, W, C) uint8/float → (oh, ow, C) float32.

    Fast path: the port's C++ host op (``veto_tpu_torch/native``) — the
    same PIL triangle-filter resampling, OpenMP-parallel.  Falls back to
    PIL, then to pure NumPy, keeping the pipeline dependency-free.
    """
    from .. import native

    out = native.resize_bilinear(np.asarray(image, np.float32), oh, ow)
    if out is not None:
        return out
    try:
        from PIL import Image

        chans = []
        for c in range(image.shape[2]):
            im = Image.fromarray(np.asarray(image[..., c], np.float32), mode="F")
            chans.append(np.asarray(im.resize((ow, oh), Image.BILINEAR)))
        return np.stack(chans, axis=-1).astype(np.float32)
    except ImportError:  # pragma: no cover
        ys = np.linspace(0, image.shape[0] - 1, oh)
        xs = np.linspace(0, image.shape[1] - 1, ow)
        y0, x0 = np.floor(ys).astype(int), np.floor(xs).astype(int)
        y1 = np.minimum(y0 + 1, image.shape[0] - 1)
        x1 = np.minimum(x0 + 1, image.shape[1] - 1)
        wy, wx = (ys - y0)[:, None, None], (xs - x0)[None, :, None]
        img = image.astype(np.float32)
        top = img[y0][:, x0] * (1 - wx) + img[y0][:, x1] * wx
        bot = img[y1][:, x0] * (1 - wx) + img[y1][:, x1] * wx
        return top * (1 - wy) + bot * wy


def normalize_image(
    image: np.ndarray,
    pixel_mean=(102.9801, 115.9465, 122.7717),
    pixel_std=(1.0, 1.0, 1.0),
    to_bgr255: bool = True,
) -> np.ndarray:
    """RGB float [0,1] (H, W, 3) → normalized BGR*255 (Normalize :112-124)."""
    img = image.astype(np.float32)
    if to_bgr255:
        img = img[..., ::-1] * 255.0
    return (img - np.asarray(pixel_mean, np.float32)) / np.asarray(
        pixel_std, np.float32
    )


def normalize_depth(depth: np.ndarray) -> np.ndarray:
    """Per-image standardization with 1/sqrt(HW) std floor
    (DepthNormalize :127-149)."""
    d = depth.astype(np.float32)
    h, w = d.shape[:2]
    floor = 1.0 / np.sqrt(h * w)
    d = d - d.mean()
    return d / max(float(d.std()), floor)


def pad_to(image: np.ndarray, h: int, w: int) -> np.ndarray:
    """Zero-pad bottom/right to (h, w, C) — ImageList semantics
    (image_list.py:29-72)."""
    out = np.zeros((h, w) + image.shape[2:], dtype=image.dtype)
    out[: image.shape[0], : image.shape[1]] = image
    return out


def bucket_shape(
    oh: int, ow: int, divisibility: int = 32, buckets=None
) -> Tuple[int, int]:
    """Choose the padded shape: smallest bucket that fits, else round up to
    ``divisibility`` (SIZE_DIVISIBILITY, image_list.py:54-61).

    Buckets bound the number of distinct batch shapes a step sees.
    """

    def round_up(x):
        return ((x + divisibility - 1) // divisibility) * divisibility

    if buckets:
        fitting = [b for b in buckets if b[0] >= oh and b[1] >= ow]
        if fitting:
            return min(fitting, key=lambda b: b[0] * b[1])
    return round_up(oh), round_up(ow)
