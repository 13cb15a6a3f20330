"""The evaluation gather across processes (``veto_tpu/engine/gather.py``).

The reference gathers every rank's predictions to rank 0 through a pickled
all-gather (``SYNC_GATHER``).  The JAX package gathers the evaluator's
state instead, and the port keeps that design: every rank feeds its own
shard of the images into a local :class:`SGGEvaluator`, whose accumulated
per-image statistics are flat float lists; these are padded with NaN to
the longest rank's length, all-gathered and merged into one evaluator on
every rank.  Each metric is a mean over per-image values (mR: the
per-class lists concatenate before the class mean), so the merge equals
one evaluator fed every image, and every rank then holds the global
metrics (the reference leaves them on rank 0 only).

Host arrays ride CPU tensors, so the group must be a gloo one (NCCL gathers
only device tensors): ``DataParallel.host_group``.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.distributed as dist


def _world(group) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def pad_allgather(arr, group=None) -> List[np.ndarray]:
    """All-gather a 1-D float array whose length differs between ranks:
    the lengths are exchanged first, each payload padded with NaN to the
    longest, then gathered (``group``: a gloo group, CPU tensors).  Returns
    every rank's array, trimmed, in rank order; a single process gets
    ``[arr]`` back without a collective."""
    arr = np.asarray(arr, np.float64).reshape(-1)
    world = _world(group)
    if world == 1:
        return [arr]
    lengths = [torch.zeros(1, dtype=torch.int64) for _ in range(world)]
    dist.all_gather(lengths, torch.tensor([len(arr)], dtype=torch.int64), group=group)
    lengths = [int(n) for n in lengths]
    padded = torch.full((max(lengths),), float("nan"), dtype=torch.float64)
    padded[: len(arr)] = torch.from_numpy(arr)
    parts = [torch.empty_like(padded) for _ in range(world)]
    dist.all_gather(parts, padded, group=group)
    return [p[:n].numpy() for p, n in zip(parts, lengths)]


def _evaluator_blob(ev) -> Dict[str, np.ndarray]:
    """An SGGEvaluator's accumulated lists as named 1-D arrays."""
    blob: Dict[str, np.ndarray] = {"num_images": np.asarray([ev.num_images])}
    for k in ev.ks:
        blob[f"recall/{k}"] = np.asarray(ev.recall[k])
        blob[f"ng/{k}"] = np.asarray(ev.recall_nogc[k])
        blob[f"zs/{k}"] = np.asarray(ev.zeroshot_recall[k])
        blob[f"acc_hit/{k}"] = np.asarray(ev.accuracy_hit[k])
        blob[f"acc_cnt/{k}"] = np.asarray(ev.accuracy_count[k])
        blob[f"ar_hit/{k}"] = np.asarray(ev.acc_recall_hit[k])
        blob[f"ar_cnt/{k}"] = np.asarray(ev.acc_recall_count[k])
        for c in range(ev.num_rel):
            blob[f"mr/{k}/{c}"] = np.asarray(ev.mean_recall_collect[k][c])
            blob[f"ngmr/{k}/{c}"] = np.asarray(ev.ng_mean_recall_collect[k][c])
    return blob


def _load_blobs(ev, blobs: List[Dict[str, np.ndarray]]) -> None:
    """Replace ``ev``'s state with the concatenation of the blobs."""
    ev.reset()
    ev.num_images = int(sum(b["num_images"][0] for b in blobs))

    def cat(key):
        return list(np.concatenate([b[key] for b in blobs]))

    for k in ev.ks:
        ev.recall[k] = cat(f"recall/{k}")
        ev.recall_nogc[k] = cat(f"ng/{k}")
        ev.zeroshot_recall[k] = cat(f"zs/{k}")
        ev.accuracy_hit[k] = cat(f"acc_hit/{k}")
        ev.accuracy_count[k] = cat(f"acc_cnt/{k}")
        ev.acc_recall_hit[k] = cat(f"ar_hit/{k}")
        ev.acc_recall_count[k] = cat(f"ar_cnt/{k}")
        for c in range(ev.num_rel):
            ev.mean_recall_collect[k][c] = cat(f"mr/{k}/{c}")
            ev.ng_mean_recall_collect[k][c] = cat(f"ngmr/{k}/{c}")


def merge_evaluators(target, sources) -> None:
    """Merge the evaluators ``sources`` into ``target``, in place (the
    gather's merge within one process)."""
    _load_blobs(target, [_evaluator_blob(e) for e in sources])


def sync_gather_evaluator(ev, group=None) -> None:
    """Merge every rank's evaluator state into ``ev``, in place, on every
    rank of ``group`` (a gloo group); a no-op in a single process."""
    world = _world(group)
    if world == 1:
        return
    local = _evaluator_blob(ev)
    gathered: List[Dict[str, np.ndarray]] = [{} for _ in range(world)]
    for key in sorted(local):
        for r, part in enumerate(pad_allgather(local[key], group)):
            gathered[r][key] = part
    _load_blobs(ev, gathered)
