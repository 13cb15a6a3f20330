"""Data-parallel relation training over ``torch.distributed``: the port's
counterpart of the JAX package's ``make_mesh`` / ``batch_sharding`` /
``shard_train_step`` (``veto_tpu/engine/train.py``).

W processes, one a card, each run the step on ``ims_per_batch // W`` images
of the global batch; together they compute what one process computes on
the whole global batch (what the JAX step computes over a ``make_mesh(W,
1)`` mesh, whose jit sees one global batch):

  * every BatchNorm in training takes the global batch's statistics: its
    f32 sums are all-reduced (the gradient flows back through the
    reduction, :func:`all_reduce_sum`) and flax's arithmetic is applied
    to the global sums (``models/layers.py``, ``MaskedBatchNorm``);
  * every masked mean takes the global denominator: each rank divides its
    own numerator by the all-reduced denominator, and the gradients are
    then summed across ranks (not averaged, as DDP would: the ranks'
    denominators are not their share of the global one);
  * every random draw is one global draw at the global batch's size, of
    which each rank keeps its own rows (:meth:`DataParallel.rand`), so the
    samples are the one-process step's, bit for bit, and every rank's
    generator stays in the same state;
  * the host's decisions (the preemption flag, the plateau decay and the
    early stop) are taken alike on every rank (:meth:`DataParallel.agree`,
    the gathered validation metrics).

The pair axis of the JAX mesh (``make_mesh(data, pair)``) is not split: W
must divide ``ims_per_batch``.

Launch with ``torchrun --nproc_per_node=W -m veto_tpu_torch.tools.
relation_train_net ...``; :func:`init_from_env` joins the default group
from the variables ``torchrun`` sets (NCCL for a CUDA device, gloo for the
CPU).  A process with none of them and no group is the plain single
process: no :class:`DataParallel`, nothing reduced.
"""

from __future__ import annotations

import os
from typing import Iterable, Optional, Sequence

import torch
import torch.distributed as dist

# configurations that run with W > 1 (each held by a two-rank test); any
# other raises naming ROADMAP queue A12b
SCOPE = ("VETOPredictor (veto.encoder_impl auto, fused or xla) in PredCls, "
         "SGCls and SGDet; its MEET heads in PredCls; BGNNPredictor with "
         "relation.rel_aware in PredCls; the weighted cross-entropy only")


class DataParallel:
    """The ranks of one data-parallel step: the process group, this rank
    and the world size.  ``host_group`` carries host values (CPU tensors):
    the default group when it is gloo, else a gloo group over the same
    ranks, since NCCL reduces only device tensors."""

    def __init__(self, group=None, host_group=None):
        self.group = group
        self.host_group = host_group
        self.rank = dist.get_rank(group)
        self.world = dist.get_world_size(group)

    def __deepcopy__(self, memo):  # modules that hold it may be copied
        return self

    @property
    def backend(self) -> str:
        return dist.get_backend(self.group)

    # ----------------------------------------------------------- reductions
    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the ranks; its gradient is the sum of the
        ranks' gradients (BatchNorm's statistics)."""
        return all_reduce_sum(x, self.group)

    def agree(self, flag: bool) -> bool:
        """True on every rank when ``flag`` is true on any."""
        return agree(flag, self.host_group)

    def barrier(self) -> None:
        dist.barrier(group=self.host_group)


# ---------------------------------------------------------------- draws
def _global(shape: Sequence[int], batch_dim: int, dp: DataParallel) -> list:
    shape = list(shape)
    shape[batch_dim] *= dp.world
    return shape


def _rows(x: torch.Tensor, batch_dim: int, dp: DataParallel) -> torch.Tensor:
    b = x.shape[batch_dim] // dp.world
    return x.narrow(batch_dim, dp.rank * b, b)


def rand(dp: Optional[DataParallel], shape, generator, device, batch_dim=0):
    """A uniform draw of ``shape`` from ``generator``.  Under ``dp`` (where
    ``shape[batch_dim]`` is the local batch's size) one draw at the global
    batch's size, of which this rank keeps its own rows; else ``torch.rand``
    itself."""
    if dp is None:
        return torch.rand(shape, generator=generator, device=device)
    u = torch.rand(_global(shape, batch_dim, dp), generator=generator, device=device)
    return _rows(u, batch_dim, dp)


def randint(dp: Optional[DataParallel], low, high, shape, generator, device,
            batch_dim=0):
    """:func:`rand`'s rule for ``torch.randint``."""
    if dp is None:
        return torch.randint(low, high, shape, generator=generator, device=device)
    u = torch.randint(low, high, _global(shape, batch_dim, dp), generator=generator,
                      device=device)
    return _rows(u, batch_dim, dp)


def total(dp: Optional[DataParallel], x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks under ``dp``, outside autograd (a loss's
    denominator, a count); else ``x`` itself."""
    if dp is None:
        return x
    y = x.detach().clone()
    dist.all_reduce(y, group=dp.group)
    return y


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group``, differentiable: the
    backward all-reduces the gradient, so that each rank's inputs get the
    gradient of every rank's use of the sum."""
    return _AllReduceSum.apply(x, group)


def all_reduce_grads(params: Iterable[torch.Tensor], group=None,
                     extra: Sequence[torch.Tensor] = ()) -> list:
    """Sum the ``.grad`` of ``params`` over the ranks, in place, in one
    flattened f32 all-reduce (a parameter without a gradient takes a zero
    one, as ``Optimizer.step`` gives it); ``extra`` 0-d tensors (the
    losses) ride the same reduction and come back summed."""
    params = list(params)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    flat = torch.cat([p.grad.reshape(-1).float() for p in params]
                     + [e.detach().reshape(1).float() for e in extra])
    dist.all_reduce(flat, group=group)
    offset = 0
    with torch.no_grad():
        for p in params:
            n = p.numel()
            p.grad.copy_(flat[offset: offset + n].view_as(p.grad))
            offset += n
    return list(flat[offset:].unbind())


def agree(flag: bool, group=None) -> bool:
    """True on every rank of ``group`` (a gloo group: a CPU tensor) when
    ``flag`` is true on any: the host decisions every rank must take alike."""
    t = torch.tensor([int(bool(flag))], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return bool(t.item())


def broadcast_value(value: float, dp: DataParallel, src: int = 0) -> float:
    """Rank ``src``'s ``value`` on every rank (a host float)."""
    t = torch.tensor([float(value)], dtype=torch.float64)
    dist.broadcast(t, src=src, group=dp.host_group)
    return float(t.item())


# -------------------------------------------------------------- the process
def rank() -> int:
    """This process's rank in the default group (0 without one)."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def world() -> int:
    """The default group's size (1 without one)."""
    return (dist.get_world_size() if dist.is_available() and dist.is_initialized()
            else 1)


def is_main() -> bool:
    return rank() == 0


def rank_device(local_rank: int, device=None) -> torch.device:
    """A rank's device: ``device`` when the caller names one, else
    ``cuda:LOCAL_RANK``; a local rank past the card count raises (no
    wrap-around onto a card another rank holds)."""
    if device is not None:
        return torch.device(device)
    from .. import resolve_device

    resolve_device("cuda")  # raises without a card
    count = torch.cuda.device_count()
    if local_rank >= count:
        raise RuntimeError(f"LOCAL_RANK={local_rank} but this machine has "
                           f"{count} CUDA device(s): one rank a card")
    return torch.device("cuda", local_rank)


def init_from_env(device=None) -> tuple:
    """Join the default process group as ``torchrun`` describes it (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), or
    take the group the caller already started.  Returns ``(dp, device)``:
    a :class:`DataParallel` over the default group and this rank's device
    (:func:`rank_device`), or ``(None, device)`` for the plain single
    process (no group and no ``WORLD_SIZE`` in the environment).  The
    backend is NCCL for a CUDA device and gloo for the CPU; a group that
    fails to form raises."""
    local_rank = int(os.environ.get("LOCAL_RANK", 0))
    if not dist.is_initialized():
        if "WORLD_SIZE" not in os.environ:
            return None, (None if device is None else torch.device(device))
        dev = rank_device(local_rank, device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method="env://",
                                rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]))
    else:
        dev = rank_device(local_rank, device)
    host = None if dist.get_backend() == "gloo" else dist.new_group(backend="gloo")
    return DataParallel(None, host), dev


def shutdown() -> None:
    """Leave the default group (the end of a ``torchrun`` entry point)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def local_batch(ims_per_batch: int, world_size: int) -> int:
    """Each rank's share of the global batch ``ims_per_batch``; a world
    size that does not divide it raises."""
    if ims_per_batch % world_size:
        raise ValueError(
            f"{world_size} ranks do not divide solver.ims_per_batch="
            f"{ims_per_batch}: the port splits the global batch over the "
            "ranks only (the JAX tool would put the rest on its mesh's pair "
            "axis, which the port does not split)")
    return ims_per_batch // world_size


def _refuse(why: str, world_size: int) -> None:
    raise NotImplementedError(
        f"{why} with {world_size} ranks: data-parallel training runs "
        f"{SCOPE}; the rest comes with ROADMAP queue A12b")


def refuse_ranks(what: str) -> None:
    """Raise ``NotImplementedError`` naming ROADMAP queue A12b when this
    process is one of several ranks (the default group's, else
    ``WORLD_SIZE`` as ``torchrun`` sets it): ``what`` has no data-parallel
    step."""
    w = world() if dist.is_initialized() else int(os.environ.get("WORLD_SIZE", 1))
    if w > 1:
        _refuse(what, w)


def check_scope(cfg, world_size: int) -> None:
    """Raise ``NotImplementedError`` naming ROADMAP queue A12b for a
    configuration that has no two-rank test yet, when ``world_size`` > 1."""
    if world_size <= 1:
        return
    from ..models.sgg import resolve_predictor

    pred = resolve_predictor(cfg.relation.predictor)
    mode = cfg.relation.mode
    if cfg.model.attribute_on:
        _refuse("model.attribute_on", world_size)
    # their denominators and the balanced norm's running state have no
    # two-rank test
    if cfg.relation.loss_variant != "weighted_ce":
        _refuse(f"relation.loss_variant={cfg.relation.loss_variant}", world_size)
    if cfg.relation.label_smoothing:
        _refuse("relation.label_smoothing=True", world_size)
    if pred == "VETOPredictor":
        if cfg.veto.encoder_impl not in ("auto", "fused", "xla"):
            _refuse(f"veto.encoder_impl={cfg.veto.encoder_impl}", world_size)
        if cfg.ensemble.enabled and mode != "predcls":
            _refuse(f"MEET in {mode}", world_size)
    elif not (pred == "BGNNPredictor" and cfg.relation.rel_aware
              and mode == "predcls"):
        _refuse(f"relation.predictor={cfg.relation.predictor} in {mode}" + (
            "" if cfg.relation.rel_aware else " without relation.rel_aware"),
            world_size)


def attach(model: torch.nn.Module, dp: Optional[DataParallel]) -> None:
    """Give every module of ``model`` that reduces over the batch in
    training (the BatchNorms: they declare a ``dp`` attribute) the ranks
    ``dp`` to reduce over; None makes them single-process again."""
    for m in model.modules():
        if hasattr(m, "dp"):
            m.dp = dp
