"""Optimizer and LR scheduling (``veto_tpu/solver/optim.py``).

:func:`make_optimizer` builds the JAX package's optax chain in PyTorch:

    clip_by_global_norm(grad_clip_norm)
    → per group: add_decayed_weights(wd) → scale_by_adam → scale(-lr)
    → scale(lr_scale)

that is, ``torch.optim.Adam`` with L2 decay added to the (clipped)
gradient, not AdamW, at ``lr = base_lr * ims_per_batch * lr_scale``.
Groups follow the flax leaf name (``_label_params``): a leaf literally
named ``bias`` — the ``.bias`` of a Dense, conv or BN — is in the bias group
(``bias_lr_factor``, ``weight_decay_bias``); every other leaf, the flat
encoder biases (``attn{i}_out_bias``, ``ffn{i}_fc{1,2}_bias``), the
``*_proj_bias`` vectors, LN ``*_scale`` and BN scales included, is in the
weight group (``weight_decay``).  Parameters under a frozen prefix (the
detector body) get no updates.

:class:`LRController` is the host-side warmup + ReduceLROnPlateau state
machine, a copy of the JAX package's.
"""

from __future__ import annotations

from typing import Iterable

import torch

FROZEN_DETECTOR = ("backbone", "rpn", "box_extractor", "box_predictor")


def param_label(name: str) -> str:
    """'frozen' | 'bias' | 'weight' for a torch parameter name, by the rule
    of the JAX ``_label_params`` on the equivalent flax path."""
    if any(name.split(".", 1)[0].startswith(p) for p in FROZEN_DETECTOR):
        return "frozen"
    return "bias" if name.rsplit(".", 1)[-1] == "bias" else "weight"


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of all entries (``optax.global_norm``)."""
    return torch.stack([t.float().square().sum() for t in tensors]).sum().sqrt()


class Optimizer:
    """Clip by global norm, then Adam per group with its learning rate and
    L2 decay, scaled by the step's ``lr_scale``."""

    def __init__(self, cfg, model: torch.nn.Module):
        if cfg.optimizer != "adam":
            raise NotImplementedError(
                f"optimizer {cfg.optimizer!r}: the port trains the relation "
                "head with Adam; SGD (detector pretraining) is a later slice")
        rl = float(cfg.ims_per_batch) if cfg.scale_lr_by_batch else 1.0
        self.clip = cfg.grad_clip_norm
        self.base_lr = {"weight": cfg.base_lr * rl,
                        "bias": cfg.base_lr * cfg.bias_lr_factor * rl}
        decay = {"weight": cfg.weight_decay, "bias": cfg.weight_decay_bias}
        groups = {"weight": [], "bias": []}
        for name, p in model.named_parameters():
            label = param_label(name)
            if label != "frozen":
                groups[label].append(p)
        self.params = groups["weight"] + groups["bias"]
        self.adam = torch.optim.Adam(
            [dict(params=ps, lr=self.base_lr[k], weight_decay=decay[k], label=k)
             for k, ps in groups.items() if ps],
            betas=(0.9, 0.999), eps=1e-8)

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def step(self, lr_scale: float) -> torch.Tensor:
        """One update from the parameters' ``.grad``; returns the global norm
        of the gradients before clipping.  A trainable parameter without a
        gradient takes a zero one, as every leaf does in optax."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        norm = global_norm(grads)
        with torch.no_grad():
            for g in grads:  # optax: where(norm < max, g, g / norm * max)
                g.copy_(torch.where(norm < self.clip, g, g / norm * self.clip))
        for group in self.adam.param_groups:
            group["lr"] = self.base_lr[group["label"]] * float(lr_scale)
        self.adam.step()
        return norm


def make_optimizer(cfg, model: torch.nn.Module) -> Optimizer:
    """The training optimizer over ``model``'s trainable parameters."""
    return Optimizer(cfg, model)


class LRController:
    """Host-side warmup + plateau state machine → lr multiplier.

    Port of the JAX package's controller (itself an exact port of the
    reference ``WarmupReduceLROnPlateau``): linear warmup from
    ``warmup_factor`` to 1 over ``warmup_iters``; on each validation report,
    decay by ``plateau_factor`` once the metric has not beaten ``best +
    threshold`` for ``patience`` reports, then ``cooldown`` reports of
    grace; ``should_stop`` after ``max_decay_step`` decays.  The reference's
    quirks are kept: the constructor reports a metric of 0.0 once, the
    cooldown counter ticks on every report, and decay triggers at
    ``bad_epochs >= patience``.
    """

    def __init__(self, cfg):
        self.cfg = cfg
        self.best: float = -1e12
        self.bad_epochs = 0
        self.cooldown_counter = cfg.plateau_cooldown
        self.num_decays = 0
        self.report_validation(0.0)

    @property
    def decay_scale(self) -> float:
        return self.cfg.plateau_factor ** self.num_decays

    def scale(self, step: int) -> float:
        """LR multiplier for 0-based train step ``step``:
        ``warmup(max(step, 1))`` times the decays so far."""
        e = max(step, 1)
        if e < self.cfg.warmup_iters and self.cfg.warmup_method == "linear":
            alpha = e / max(self.cfg.warmup_iters, 1)
            warm = self.cfg.warmup_factor * (1 - alpha) + alpha
        elif e < self.cfg.warmup_iters and self.cfg.warmup_method == "constant":
            warm = self.cfg.warmup_factor
        else:
            warm = 1.0
        return warm * self.decay_scale

    def report_validation(self, metric: float) -> None:
        # order matters: improvement check, then cooldown (which also zeroes
        # the bad counter), then the decay test
        if float(metric) > self.best + self.cfg.plateau_threshold:
            self.best = float(metric)
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.bad_epochs = 0
        if self.bad_epochs >= self.cfg.plateau_patience:
            self.num_decays += 1
            self.cooldown_counter = self.cfg.plateau_cooldown
            self.bad_epochs = 0

    @property
    def should_stop(self) -> bool:
        return self.num_decays >= self.cfg.max_decay_step
