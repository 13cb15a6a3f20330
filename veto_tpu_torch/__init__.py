"""veto_tpu_torch — the PyTorch/CUDA port of veto_tpu.

A second package beside ``veto_tpu/`` that computes the same scene-graph
model in PyTorch, with hand-written CUDA kernels (``csrc/*.cu``) where the
JAX package has Pallas TPU kernels.  It imports ``torch`` and ``numpy`` and
never the JAX package: what it needs from there (the config tree, the
synthetic corpus, the evaluator) it keeps as its own copy.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a GPU they raise instead of falling back to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless asked otherwise.

    Raises when CUDA is requested (explicitly or by default) and no GPU is
    present — the port never falls back to the CPU on its own.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    return dev
