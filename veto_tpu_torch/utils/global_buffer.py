"""The global debug buffer (``veto_tpu/utils/global_buffer.py``, the
reference's ``pysgg/utils/global_buffer.py``).

The reference keeps a process-wide buffer that any module fills mid-forward
(``store_data``), all-gathering each tensor, and pickles it at the end of
the run (``inter_data_buffer.pkl``).  Its one producer is the relation
proposal network's relness diagnostics.  As in the JAX package, the
train step returns those diagnostics (``engine/train.py``,
``collect_diagnostics``) and the tool stores them here.  Under data
parallelism (``enable(dp=)``) each value is gathered over the ranks
(``engine/gather.py`` ``pad_allgather``) and only rank 0 keeps it.
"""

from __future__ import annotations

import os
import pickle
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np
import torch

from ..engine.gather import pad_allgather

_BUFFER: Optional["_GlobalBuffer"] = None


class _GlobalBuffer:
    def __init__(self):
        self.data: Dict[str, List[np.ndarray]] = defaultdict(list)
        self.enabled = False
        self.dp = None  # the ranks whose values are gathered

    def __str__(self) -> str:
        lines = ["Buffer contains data: (key, entries, total rows)"]
        for k, v in self.data.items():
            lines.append(f"    {k}, {len(v)}, {sum(len(a) for a in v)}")
        return "\n".join(lines)


def _buffer() -> _GlobalBuffer:
    global _BUFFER
    if _BUFFER is None:
        _BUFFER = _GlobalBuffer()
    return _BUFFER


def _main(buf) -> bool:
    return buf.dp is None or buf.dp.rank == 0


def enable(on: bool = True, dp=None) -> None:
    """Turn collection on or off (``global_buffer_on``); ``dp`` (a
    ``distributed.DataParallel``) gathers the values of its ranks."""
    buf = _buffer()
    buf.enabled, buf.dp = on, dp


def reset() -> None:
    global _BUFFER
    _BUFFER = None


def store_data(key: str, val, mask=None) -> None:
    """Append ``val`` (an array or tensor) under ``key``, one row per entry
    of its leading axes; ``mask`` drops rows first.  With several ranks the
    rows of every rank are gathered in rank order and only rank 0 keeps
    them."""
    buf = _buffer()
    if not buf.enabled:
        return
    if torch.is_tensor(val):
        val = val.detach().cpu().numpy()
    arr = np.asarray(val)
    if mask is not None:
        if torch.is_tensor(mask):
            mask = mask.cpu().numpy()
        arr = arr[np.asarray(mask).astype(bool)]
    arr = (arr.reshape(len(arr), int(np.prod(arr.shape[1:]))) if arr.ndim
           else arr.reshape(1, 1))
    if buf.dp is not None and buf.dp.world > 1:
        cols = arr.shape[1]
        parts = pad_allgather(arr.astype(np.float64), buf.dp.host_group)
        if buf.dp.rank != 0:
            return
        arr = np.concatenate(parts).reshape(-1, cols).astype(arr.dtype)
    buf.data[key].append(arr)


def save_buffer(output_dir: str) -> Optional[str]:
    """Pickle the buffer to ``output_dir/inter_data_buffer.pkl`` on rank 0;
    returns the path written, or None (off, empty, or another rank)."""
    buf = _buffer()
    if not buf.enabled or not buf.data or not _main(buf):
        return None
    path = os.path.join(output_dir, "inter_data_buffer.pkl")
    with open(path, "wb") as f:
        pickle.dump({k: list(v) for k, v in buf.data.items()}, f)
    return path
