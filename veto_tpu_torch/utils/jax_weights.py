"""Weight bridge: a flax variables tree → the port's ``state_dict``.

Takes ``{"params": ..., "batch_stats": ...}`` as the JAX package's
``SGGModel.init`` produces it, with numpy (or array-like) leaves, and needs
no JAX to run.  The port names its modules after the flax tree, so a leaf's
path is its torch name, with these conversions:

  * conv kernels HWIO → OIHW (grouped ``(3, 3, C/G, C)`` → ``(C, C/G, 3, 3)``);
  * the two transposed-convolution kernels (the mask head's ``conv5_mask``
    and the keypoint head's ``kps_score_lowres``): flax's ``ConvTranspose``
    does not flip its kernel, torch's ``ConvTranspose2d`` is the true
    transpose of a convolution, so (kh, kw, I, O) → (I, O, kh, kw) with
    both spatial axes reversed;
  * Dense kernels ``(in, out)`` → Linear weights ``(out, in)``;
  * norm ``scale`` → ``weight``; ``embedding`` → ``weight``;
  * ``batch_stats`` ``mean``/``var`` → ``running_mean``/``running_var``;
    the causal predictor's untreated averages (``untreated_*``,
    ``avg_post_ctx``) keep their names (the port's buffers);
  * the encoder's flat per-layer parameters (``attn{i}_qkv``, ``ffn{i}_fc1``,
    ...) keep their names and their ``(in, out)`` layout — the CUDA layer
    kernel reads them so.

The SGDet model's frozen heads map by the same rules: the ``rpn`` subtree
(``conv``, ``cls_logits``, ``bbox_pred``: HWIO kernels → OIHW) and the box
predictor's ``bbox_pred`` Dense.  So do MEET's: ``relation/trunk`` and
each head ``relation/rel_out_e{e}_g{k}`` (a Dense) keep their names.

The legacy heads' leaves map by the same rules (``nn.Embed`` tables,
1-D BatchNorm statistics, the rect convs' HWIO kernels, the union fc6,
whose rows are already in the (h, w, c) order the port flattens in);
their explicit parameters (the decoders' and TreeLSTMs' ``*_w`` / ``*_b``,
``bi_freq_prior``, ``obj_baseline``) keep their names and layout.  One
conversion is structural: a flax ``OptimizedLSTMCell`` (the keys ``ii``,
``if``, ``ig``, ``io`` without bias, ``hi``, ``hf``, ``hg``, ``ho`` with
bias) becomes the port's stacked ``weight_ih`` (4H, D), ``weight_hh``
(4H, H) and ``bias`` (4H), gate rows in (i, f, g, o) order; a flax
``GRUCell`` (``ir``, ``iz``, ``in`` with bias, ``hr``, ``hz`` without,
``hn`` with) becomes ``torch.nn.GRUCell``'s ``weight_ih`` (3H, D),
``weight_hh`` (3H, H) and ``bias_ih`` (3H), rows in (r, z, n) order, and
``bias_hn`` (H), the n third of torch's ``bias_hh`` (the port's
``legacy.predictors.GRUCell`` fixes its r and z thirds at 0).

The VGG-16 body's ``conv{idx}`` kernels (HWIO → OIHW) keep their names,
as do BGNN's ``relness_alpha`` and the LayerNorms and BatchNorm of the
message-passing heads, and the rest of the zoo's leaves: the causal
predictor's spatial gate (flax's ``Dense_0`` / ``Dense_1``), KERN's GGNN,
AGRCNN's collect units, the attribute decoder's ``att_embed`` /
``att_out_w`` / ``att_out_b``.

A detector body in the unfolded layout (conv + ``FrozenBatchNorm``) loads
into an unfolded port model as is, or is folded here (``kernel * scale``,
``bias = bn.bias``) for a folded one.
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

from ..models.relation.legacy.causal import UNTREATED

_FOLD_PAIRS = {"stem_conv": "stem_bn", "conv1": "bn1", "conv2": "bn2",
               "conv3": "bn3", "downsample_conv": "downsample_bn"}
_STATS = {"mean": "running_mean", "var": "running_var"}
# flax ``nn.ConvTranspose`` modules (by their last path key)
CONV_TRANSPOSE = ("conv5_mask", "kps_score_lowres")


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.array(v, dtype=np.float32)  # a copy


_LSTM_GATES = ("i", "f", "g", "o")
_LSTM_KEYS = {f"{side}{g}" for side in "ih" for g in _LSTM_GATES}


_GRU_GATES = ("r", "z", "n")
_GRU_KEYS = {f"{side}{g}" for side in "ih" for g in _GRU_GATES}


def gru_cell_params(tree: Mapping) -> Dict[str, np.ndarray]:
    """A flax ``GRUCell`` subtree → the port's ``GRUCell`` parameters."""
    k = {n: np.asarray(v["kernel"], np.float32) for n, v in tree.items()}
    return {"weight_ih": np.concatenate([k[f"i{g}"] for g in _GRU_GATES], 1).T,
            "weight_hh": np.concatenate([k[f"h{g}"] for g in _GRU_GATES], 1).T,
            "bias_ih": np.concatenate([np.asarray(tree[f"i{g}"]["bias"], np.float32)
                                       for g in _GRU_GATES]),
            "bias_hn": np.asarray(tree["hn"]["bias"], np.float32)}


def stack_lstm_cells(tree: Mapping) -> Dict:
    """``tree`` with every flax ``OptimizedLSTMCell`` subtree replaced by
    the stacked ``weight_ih`` / ``weight_hh`` / ``bias`` of the port's
    ``LSTMDirection``, and every flax ``GRUCell`` subtree by the port's
    ``GRUCell`` parameters (:func:`gru_cell_params`)."""
    if set(tree) == _GRU_KEYS:
        return gru_cell_params(tree)
    if set(tree) == _LSTM_KEYS:
        k = {n: np.asarray(v["kernel"], np.float32) for n, v in tree.items()}
        return {"weight_ih": np.concatenate([k[f"i{g}"] for g in _LSTM_GATES], 1).T,
                "weight_hh": np.concatenate([k[f"h{g}"] for g in _LSTM_GATES], 1).T,
                "bias": np.concatenate([np.asarray(tree[f"h{g}"]["bias"], np.float32)
                                        for g in _LSTM_GATES])}
    return {k: stack_lstm_cells(v) if isinstance(v, Mapping) else v
            for k, v in tree.items()}


def fold_frozen_bn(body: Mapping) -> Dict:
    """An unfolded detector-body tree in the folded layout: each (conv,
    FrozenBatchNorm) pair becomes a conv with ``kernel * scale`` (output
    channels last in HWIO) and ``bias = bn.bias``.  Exact: the detector is
    frozen."""
    out = {}
    for k, v in body.items():
        if k in _FOLD_PAIRS.values():
            continue
        bn = body.get(_FOLD_PAIRS.get(k, ""))
        if bn is not None:
            out[k] = {"kernel": np.asarray(v["kernel"]) * np.asarray(bn["scale"]),
                      "bias": np.asarray(bn["bias"])}
        elif isinstance(v, Mapping):
            out[k] = fold_frozen_bn(v)
        else:
            out[k] = v
    return out


def flax_to_state_dict(variables: Mapping,
                       fold_bn: bool = False) -> Dict[str, torch.Tensor]:
    """Convert a flax variables tree; ``fold_bn`` folds an unfolded detector
    body (``params/backbone/body``) into the folded layout first."""
    params = stack_lstm_cells(variables["params"])
    body = params.get("backbone", {}).get("body", {})
    if fold_bn and "stem_bn" in body:
        params = {**params, "backbone": {**params["backbone"],
                                         "body": fold_frozen_bn(body)}}
    sd = {}
    for path, arr in _leaves(params):
        *mod, leaf = path
        if leaf == "kernel":
            leaf = "weight"
            if mod[-1] in CONV_TRANSPOSE:
                arr = arr[::-1, ::-1].transpose(2, 3, 0, 1)
            else:
                arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
        elif leaf in ("scale", "embedding"):
            leaf = "weight"
        sd[".".join(mod + [leaf])] = torch.from_numpy(np.ascontiguousarray(arr))
    for path, arr in _leaves(variables.get("batch_stats", {})):
        *mod, leaf = path
        if leaf not in _STATS and leaf not in UNTREATED:
            raise KeyError(f"unknown batch_stats leaf {'/'.join(path)}")
        sd[".".join(mod + [_STATS.get(leaf, leaf)])] = torch.from_numpy(arr)
    return sd


def load_flax_variables(model: torch.nn.Module, variables: Mapping) -> None:
    """Load a flax variables tree into ``model`` (strict, apart from torch's
    ``num_batches_tracked`` counters, which flax does not keep)."""
    fold = getattr(getattr(model.backbone, "body", None), "fold_bn", False)
    sd = flax_to_state_dict(variables, fold_bn=fold)
    missing, unexpected = model.load_state_dict(sd, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise KeyError(f"flax tree does not match the model: missing {missing}, "
                       f"unexpected {unexpected}")
