"""Logging and smoothed training meters (``veto_tpu/utils/logger.py``): a
console + ``log.txt`` logger, a window-smoothed metric aggregator with an
ETA, and the ``metrics.jsonl`` writer the JAX tool writes (one JSON object
a line: ``{"step": ..., <metric>: <float>, ...}``)."""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from collections import defaultdict, deque
from typing import Dict, Optional


def setup_logger(name: str, output_dir: Optional[str] = None,
                 rank: int = 0) -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    if logger.handlers:
        return logger
    if rank == 0:
        fmt = logging.Formatter("%(asctime)s %(name)s %(levelname)s: %(message)s")
        ch = logging.StreamHandler(stream=sys.stdout)
        ch.setLevel(logging.DEBUG)
        ch.setFormatter(fmt)
        logger.addHandler(ch)
        if output_dir:
            os.makedirs(output_dir, exist_ok=True)
            fh = logging.FileHandler(os.path.join(output_dir, "log.txt"))
            fh.setFormatter(fmt)
            logger.addHandler(fh)
    return logger


class SmoothedValue:
    """Window median/average of a scalar stream."""

    def __init__(self, window_size: int = 20):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0

    def update(self, value: float):
        self.deque.append(value)
        self.count += 1
        self.total += value

    @property
    def median(self) -> float:
        d = sorted(self.deque)
        return d[len(d) // 2] if d else 0.0

    @property
    def avg(self) -> float:
        return sum(self.deque) / len(self.deque) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)


class MetricLogger:
    def __init__(self, delimiter: str = "  ", window_size: int = 20):
        self.meters: Dict[str, SmoothedValue] = defaultdict(
            lambda: SmoothedValue(window_size))
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def __str__(self):
        return self.delimiter.join(
            f"{name}: {m.median:.4f} ({m.global_avg:.4f})"
            for name, m in self.meters.items())

    def eta_string(self, iteration: int, max_iter: int) -> str:
        if "time" not in self.meters:
            return "?"
        secs = self.meters["time"].global_avg * (max_iter - iteration)
        return time.strftime("%H:%M:%S", time.gmtime(secs)) if secs < 86400 else (
            f"{secs / 86400:.1f}d")


class JSONLWriter:
    """Append-only ``<output_dir>/metrics.jsonl``.  ``tensorboard=True``
    (``tensorboard_on``) raises: the TensorBoard writer comes with the rest
    of the zoo, slice A14."""

    def __init__(self, output_dir: str, filename: str = "metrics.jsonl",
                 tensorboard: bool = False):
        if tensorboard:
            raise NotImplementedError(
                "tensorboard_on: the TensorBoard event writer comes with slice "
                "A14; metrics.jsonl holds the same scalars")
        os.makedirs(output_dir, exist_ok=True)
        self.path = os.path.join(output_dir, filename)

    def write(self, step: int, metrics: Dict[str, float]):
        rec = {"step": int(step)}
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v  # non-scalar entries pass through verbatim
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
