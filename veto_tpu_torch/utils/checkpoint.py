"""Checkpoints with resume (``veto_tpu/utils/checkpoint.py``), saved with
``torch.save``.

A checkpoint is one file, ``<dir>/model_<step>.pth``, holding everything a
resumed run needs to continue bit-exactly: the model's ``state_dict`` (the
trainable depth ResNet-18's and ``pos_bn``'s BatchNorm running statistics
included), the optimizer's state (Adam's moments and step, or SGD's
momentum buffers), the iteration, the state of the samplers'
``torch.Generator`` with its device type, the loss variant's state (the
balanced norm's running labeling probability, ``TrainState.loss_state``)
and the host-side extras (the ``LRController`` fields).  A file is written under a
temporary name and moved into place, then the ``last_checkpoint`` pointer
names it (as the reference's Checkpointer keeps it); the newest ``keep``
files stay.  A checkpoint restores on any device: tensors are copied to the
model's device; a generator state saved on another device type is left
out (the sampler then restarts from its seed, with a log line).

Under data parallelism (``CheckpointManager(dp=)``) only rank 0 writes;
the other ranks wait at a barrier until the file is in place, so that
every rank can then restore it.  The ranks' states are equal (the summed
gradients, the global BatchNorm statistics, the generator kept in step),
so a checkpoint of a run of W ranks restores into a run of any other W.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional

import torch


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 5, dp=None):
        self.directory = os.path.abspath(directory)
        self.keep = keep
        self.dp = dp

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"model_{step:07d}.pth")

    def steps(self):
        """The steps saved in the directory, oldest first."""
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(m.group(1)) for m in (
            re.fullmatch(r"model_(\d+)\.pth", f) for f in os.listdir(self.directory))
            if m)

    def save(self, step: int, state, extra: Optional[Dict[str, Any]] = None) -> str:
        """Persist a :class:`TrainState` at ``step`` (plus host-side extras);
        under ``dp`` rank 0 writes and every rank returns once it has."""
        if self.dp is not None and self.dp.rank != 0:
            self.dp.barrier()
            return self.path(step)
        os.makedirs(self.directory, exist_ok=True)
        gen = state.generator
        payload = {
            "step": int(step),
            "model": state.model.state_dict(),
            "optimizer": state.optimizer.inner.state_dict(),
            "generator": None if gen is None else {
                "device": gen.device.type, "state": gen.get_state()},
            "loss_state": getattr(state, "loss_state", None),
            "extra": extra,
        }
        path = self.path(step)
        atomic_write(path, lambda tmp: torch.save(payload, tmp))

        def pointer(tmp):
            with open(tmp, "w") as f:
                f.write(str(step))

        atomic_write(os.path.join(self.directory, "last_checkpoint"), pointer)
        for old in self.steps()[:-self.keep]:
            os.remove(self.path(old))
        if self.dp is not None:
            self.dp.barrier()
        return path

    def latest_step(self) -> Optional[int]:
        pointer = os.path.join(self.directory, "last_checkpoint")
        if os.path.exists(pointer):
            with open(pointer) as f:
                return int(f.read().strip())
        steps = self.steps()
        return steps[-1] if steps else None

    def load(self, step: Optional[int] = None, map_location=None):
        """The payload of ``step`` (default the latest), or None when the
        directory is absent or empty.  A directory that holds files but no
        checkpoint of this format (the JAX package's orbax steps, say)
        raises rather than pass for an empty one."""
        step = self.latest_step() if step is None else step
        if step is None or not os.path.exists(self.path(step)):
            entries = (sorted(os.listdir(self.directory))
                       if os.path.isdir(self.directory) else [])
            if not entries:
                return None
            raise FileNotFoundError(
                f"{self.directory} holds {entries[:5]} but no checkpoint "
                f"model_<step>.pth of the port to restore"
                + (f" (last_checkpoint names step {step})" if step is not None else ""))
        return torch.load(self.path(step), map_location=map_location,
                          weights_only=True)

    def restore(self, state, step: Optional[int] = None, log=None):
        """Restore ``state`` in place from ``step`` (default the latest);
        returns the saved extras, or None when there is nothing to restore
        (``state`` is then untouched).  The file is read to the host: the
        model's tensors and the optimizer's state are copied to their
        parameters' device (Adam's step counts stay on the host, as a fresh
        Adam keeps them).  A checkpoint of another optimizer (Adam's into
        SGD's state, say) raises ``ValueError``."""
        payload = self.load(step, map_location="cpu")
        if payload is None:
            return None
        inner = state.optimizer.inner
        if _groups(payload["optimizer"]["param_groups"]) != _groups(inner.param_groups):
            raise ValueError(
                f"{self.path(payload['step'])} holds the state of another "
                f"optimizer than {type(inner).__name__}'s (or other groups)")
        state.model.load_state_dict(payload["model"])
        inner.load_state_dict(payload["optimizer"])
        state.step = payload["step"]
        if (payload.get("loss_state") is not None
                and getattr(state, "loss_state", None) is not None):
            state.loss_state = payload["loss_state"].to(state.loss_state.device)
        saved, gen = payload["generator"], state.generator
        if saved is not None and gen is not None:
            if saved["device"] == gen.device.type:
                gen.set_state(saved["state"])
            elif log is not None:
                log(f"the sampler's generator was saved on {saved['device']}; "
                    f"on {gen.device.type} it restarts from its seed")
        return payload["extra"]


def _groups(param_groups):
    """A torch optimizer's groups by label and kind (Adam's have ``betas``)."""
    return [(g.get("label"), "betas" in g) for g in param_groups]


def atomic_write(path: str, write) -> None:
    """``write(tmp)`` to a temporary name beside ``path``, then rename it
    into place: a reader sees the old file or the whole new one."""
    tmp = f"{path}.{os.getpid()}.tmp"
    write(tmp)
    os.replace(tmp, path)


def load_params_partially(model, loaded, log=print):
    """Copy the entries of the state dict ``loaded`` whose name and shape
    match ``model``'s into it; every other tensor of the model keeps its
    value, with a log line (the reference's ``load_weight_partially``, the
    JAX package's ``load_params_partially``).  Returns the names copied."""
    copied = []
    with torch.no_grad():
        for name, tensor in model.state_dict().items():
            src = loaded.get(name)
            if src is not None and tuple(src.shape) == tuple(tensor.shape):
                tensor.copy_(src)
                copied.append(name)
            else:
                log(f"checkpoint: no match for {name}, keeping init")
    return copied
