"""Import reference (maskrcnn-benchmark / Scene-Graph-Benchmark) checkpoints
into the port's models (``veto_tpu/utils/torch_import.py``).

The reference's tensors are already in torch layouts, and the port names
its modules after the flax tree (``utils/jax_weights.py``), so an import is
mostly renaming: a reference name becomes the port's ``state_dict`` name,
with no HWIO round trip.  What changes values:

  * the detector body's ``FrozenBatchNorm`` buffers fold into an affine,
    ``scale = weight / sqrt(running_var)``, ``bias = bias - running_mean *
    scale`` (the reference's fold, ``layers/batch_norm.py:28-30``: no eps);
    with ``fold_bn`` that affine folds further into the conv, ``weight *
    scale`` per output channel and ``bias`` as the conv's bias;
  * the VETO encoder's flat per-layer matrices keep the flax ``(in, out)``
    layout (the CUDA layer reads them so): their torch weights transpose;
  * the reference projects ``concat(subject, object)``; the port's trunk
    factorizes it into subject and object projections, so those weights
    split by columns (:func:`_split_pair_columns`,
    :func:`_split_patch_columns`).
  * the box head's fc6 eats the flattened pooled map: the reference
    flattens NCHW (C, P, P), the port NHWC (P, P, C), so fc6's input axis
    is permuted (:func:`_fc6_to_nhwc`).

Entry points: :func:`import_detector_weights` (a ``.pth``, a Detectron
``.pkl`` or a ``catalog://`` name from the local cache, which never
downloads); :func:`depth_backbone_state_updates` and
:func:`veto_relation_state_updates` for a reference relation checkpoint;
:func:`apply_updates` writes any of them into a model and reports what it
skipped (a PredCls model has no RPN and no box head, an SGCls model no
RPN, so those tensors are reported as missing; an SGDet model loads the
RPN head and the whole box head, ``bbox_pred`` included).  The motifs/LSTM/attribute converters come with the rest of
the zoo (A14).
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

import numpy as np

Updates = Dict[str, np.ndarray]


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A torch checkpoint as {name: numpy array}: its ``model`` (or
    ``state_dict``) entry, ``module.`` prefixes dropped."""
    import torch

    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("model", ckpt.get("state_dict", ckpt))
    out = {}
    for k, v in sd.items():
        if k.startswith("module."):
            k = k[len("module."):]
        if hasattr(v, "numpy"):
            out[k] = v.detach().cpu().numpy()
    return out


def _f32(a) -> np.ndarray:
    return np.asarray(a, np.float32)


def _fold_bn(sd: Updates, prefix: str) -> Tuple[np.ndarray, np.ndarray]:
    w = sd[f"{prefix}.weight"]
    b = sd[f"{prefix}.bias"]
    mean = sd[f"{prefix}.running_mean"]
    var = sd[f"{prefix}.running_var"]
    scale = w / np.sqrt(var)
    return scale.astype(np.float32), (b - mean * scale).astype(np.float32)


def _fc6_to_nhwc(w: np.ndarray, channels: int) -> np.ndarray:
    """fc6's (out, C * P * P) weight, whose input is the reference's NCHW
    flatten of the pooled map (``x.view(x.size(0), -1)``,
    roi_box_feature_extractors.py:46), as (out, P * P * C) for the port's
    NHWC flatten; a weight whose input is not ``P * P * channels`` for a
    whole P is returned as it is (the JAX import's rule)."""
    p = int(round(max(w.shape[1] // channels, 1) ** 0.5))
    if p * p * channels != w.shape[1]:
        return w
    return np.ascontiguousarray(
        w.reshape(w.shape[0], channels, p, p).transpose(0, 2, 3, 1)
        .reshape(w.shape[0], -1))


def detector_state_updates(sd: Updates, fpn_channels: int) -> Updates:
    """A maskrcnn-benchmark detector state dict in the port's names, in the
    unfolded layout (convs without bias, each followed by a
    ``FrozenBatchNorm`` with the folded affine); fc6 permuted for the NHWC
    pool of ``fpn_channels`` channels."""
    out: Updates = {}

    def put_bn(src: str, dst: str) -> None:
        out[f"{dst}.weight"], out[f"{dst}.bias"] = _fold_bn(sd, src)

    body = "backbone.body"
    if f"{body}.stem.conv1.weight" in sd:
        out[f"{body}.stem_conv.weight"] = _f32(sd[f"{body}.stem.conv1.weight"])
        put_bn(f"{body}.stem.bn1", f"{body}.stem_bn")
    pat = re.compile(r"^backbone\.body\.layer(\d)\.(\d+)\.(conv\d|downsample\.0)\.weight$")
    for k in list(sd):
        m = pat.match(k)
        if not m:
            continue
        layer, block, conv = m.groups()
        base = f"{body}.layer{layer}_block{block}"
        src = f"{body}.layer{layer}.{block}"
        if conv == "downsample.0":
            out[f"{base}.downsample_conv.weight"] = _f32(sd[k])
            put_bn(f"{src}.downsample.1", f"{base}.downsample_bn")
        else:
            bn = conv.replace("conv", "bn")
            out[f"{base}.{conv}.weight"] = _f32(sd[k])
            put_bn(f"{src}.{bn}", f"{base}.{bn}")
    # the FPN: the same 1-indexed names on both sides
    pat_fpn = re.compile(r"^backbone\.fpn\.fpn_(inner|layer)\d\.(weight|bias)$")
    for k in sd:
        if pat_fpn.match(k):
            out[k] = _f32(sd[k])
    # the VGG-16 body of the legacy single-scale detectors
    pat_vgg = re.compile(r"^(?:backbone\.conv_body|features)\.(\d+)\.weight$")
    for k in list(sd):
        m = pat_vgg.match(k)
        if m:
            out[f"backbone.conv{m.group(1)}.weight"] = _f32(sd[k])
            out[f"backbone.conv{m.group(1)}.bias"] = _f32(sd[k[:-len("weight")] + "bias"])
    # the RPN head and the box head
    heads = [(f"rpn.head.{n}", f"rpn.{n}") for n in ("conv", "cls_logits", "bbox_pred")]
    heads += [("roi_heads.box.feature_extractor.fc6", "box_extractor.fc6"),
              ("roi_heads.box.feature_extractor.fc7", "box_extractor.fc7"),
              ("roi_heads.box.predictor.cls_score", "box_predictor.cls_score"),
              ("roi_heads.box.predictor.bbox_pred", "box_predictor.bbox_pred"),
              ("roi_heads.attribute.predictor.att_score",
               "attribute_predictor.att_score")]
    for src, dst in heads:
        if f"{src}.weight" in sd:
            w = _f32(sd[f"{src}.weight"])
            if dst == "box_extractor.fc6":
                w = _fc6_to_nhwc(w, fpn_channels)
            out[f"{dst}.weight"] = w
            out[f"{dst}.bias"] = _f32(sd[f"{src}.bias"])
    return out


_BN_FOR_CONV = {"conv1": "bn1", "conv2": "bn2", "conv3": "bn3",
                "downsample_conv": "downsample_bn", "stem_conv": "stem_bn"}


def fold_detector_updates(updates: Updates) -> Updates:
    """The body's updates in the folded layout (``model.fold_bn``): each
    conv weight times its BN scale per output channel, the BN bias as the
    conv's bias, the BN entries gone."""
    out: Updates = {}
    for name, arr in updates.items():
        parts = name.split(".")
        if name.startswith("backbone.body.") and len(parts) >= 2:
            mod, leaf = parts[-2], parts[-1]
            if mod in _BN_FOR_CONV.values():
                continue  # absorbed into its conv
            if mod in _BN_FOR_CONV and leaf == "weight":
                bn = ".".join(parts[:-2] + [_BN_FOR_CONV[mod]])
                scale = updates.get(f"{bn}.weight")
                if scale is not None:
                    out[name] = arr * scale[:, None, None, None]
                    out[".".join(parts[:-1] + ["bias"])] = updates[f"{bn}.bias"]
                    continue
        out[name] = arr
    return out


def apply_updates(model, updates: Updates,
                  log=None) -> Tuple[List[str], List[Tuple[str, str]]]:
    """Copy ``updates`` into ``model``'s parameters and buffers by name.

    Returns (loaded, skipped): a name the model does not have, or whose
    shape differs, is skipped with its reason, as the reference's
    ``load_weight_partially`` logs it."""
    import torch

    state = model.state_dict()
    loaded, skipped = [], []
    with torch.no_grad():
        for name, arr in updates.items():
            if name not in state:
                skipped.append(("missing", name))
            elif tuple(state[name].shape) != tuple(arr.shape):
                skipped.append((f"shape {tuple(state[name].shape)} vs "
                                f"{tuple(arr.shape)}", name))
            else:
                state[name].copy_(torch.from_numpy(np.ascontiguousarray(arr)))
                loaded.append(name)
    if log is not None:
        log(f"torch import: {len(loaded)} tensors loaded, {len(skipped)} skipped")
        for why, name in skipped:
            log(f"  SKIP [{why}] {name}")
    return loaded, skipped


def import_detector_weights(model, ckpt_path: str, log=None,
                            fold_bn: bool = False):
    """Checkpoint file → the model's detector.  ``catalog://...`` resolves
    to a file of the local cache; ``*.pkl`` is a caffe2/Detectron pickle;
    anything else a torch checkpoint.  ``fold_bn`` targets a model built
    with ``model.fold_bn``.  fc6 is permuted for the width of the model's
    FPN (VGG-16's map: 512).  Returns :func:`apply_updates`' (loaded, skipped)."""
    if ckpt_path.startswith("catalog://"):
        ckpt_path = resolve_catalog(ckpt_path)
    if ckpt_path.endswith(".pkl"):
        sd = load_c2_state_dict(ckpt_path)
    else:
        sd = load_torch_state_dict(ckpt_path)
    fpn = getattr(model.backbone, "fpn", None)  # VGG-16 has one 512-channel map
    updates = detector_state_updates(
        sd, fpn.fpn_layer1.out_channels if fpn is not None else 512)
    if fold_bn:
        updates = fold_detector_updates(updates)
    return apply_updates(model, updates, log)


# ---------------------------------------------------------------------------
# caffe2 / Detectron pickles (reference utils/c2_model_loading.py:1-206 and
# config/paths_catalog.py:251-282): raw float arrays under 'blobs'
# ---------------------------------------------------------------------------

# the ordered replacement chain of _rename_basic_resnet_weights
# (c2_model_loading.py:12-63), its '.b' → '.bias' quirk and repair included
_C2_BASIC_RENAMES = (
    (".w", ".weight"),
    (".bn", "_bn"),
    (".b", ".bias"),
    ("_bn.s", "_bn.scale"),
    (".biasranch", ".branch"),
    ("bbox.pred", "bbox_pred"),
    ("cls.score", "cls_score"),
    ("res.conv1_", "conv1_"),
    (".biasbox", ".bbox"),
    ("conv.rpn", "rpn.conv"),
    ("rpn.bbox.pred", "rpn.bbox_pred"),
    ("rpn.cls.logits", "rpn.cls_logits"),
    ("_bn.scale", "_bn.weight"),   # AffineChannel scale → BN weight
    ("conv1_bn.", "bn1."),
    ("res2.", "layer1."),
    ("res3.", "layer2."),
    ("res4.", "layer3."),
    ("res5.", "layer4."),
    (".branch2a.", ".conv1."),
    (".branch2a_bn.", ".bn1."),
    (".branch2b.", ".conv2."),
    (".branch2b_bn.", ".bn2."),
    (".branch2c.", ".conv3."),
    (".branch2c_bn.", ".bn3."),
    (".branch1.", ".downsample.0."),
    (".branch1_bn.", ".downsample.1."),
    # GroupNorm variants (R-50-GN et al.)
    ("conv1.gn.s", "bn1.weight"),
    ("conv1.gn.bias", "bn1.bias"),
    ("conv2.gn.s", "bn2.weight"),
    ("conv2.gn.bias", "bn2.bias"),
    ("conv3.gn.s", "bn3.weight"),
    ("conv3.gn.bias", "bn3.bias"),
    ("downsample.0.gn.s", "downsample.1.weight"),
    ("downsample.0.gn.bias", "downsample.1.bias"),
)


def c2_rename_key(key: str) -> str:
    """A caffe2 blob name → its fully prefixed maskrcnn-benchmark name
    (c2_model_loading.py:12-116 plus the module prefixes the reference's
    suffix matcher resolves)."""
    k = "fc1000_b" if key == "pred_b" else ("fc1000_w" if key == "pred_w"
                                            else key)
    k = k.replace("_", ".")
    for old, new in _C2_BASIC_RENAMES:
        k = k.replace(old, new)
    k = re.sub(r"fpn\.inner\.layer(\d)\.\d+\.sum(\.lateral)?", r"fpn_inner\1", k)
    k = re.sub(r"fpn\.layer(\d)\.\d+\.sum", r"fpn_layer\1", k)
    k = k.replace("rpn.conv.fpn2", "rpn.conv")
    k = k.replace("rpn.bbox_pred.fpn2", "rpn.bbox_pred")
    k = k.replace("rpn.cls_logits.fpn2", "rpn.cls_logits")
    k = k.replace("mask.fcn.logits", "mask_fcn_logits")
    k = k.replace(".[mask].fcn", "mask_fcn")
    k = k.replace("conv5.mask", "conv5_mask")
    k = k.replace("kps.score.lowres", "kps_score_lowres")
    k = k.replace("kps.score", "kps_score")
    k = k.replace("conv.fcn", "conv_fcn")
    if k.startswith("rpn."):
        k = "rpn.head." + k[len("rpn."):]
    if re.match(r"^layer\d\.", k):
        return "backbone.body." + k
    if k.startswith("conv1.") or k.startswith("bn1."):
        return "backbone.body.stem." + k
    if k.startswith("fpn_inner") or k.startswith("fpn_layer"):
        return "backbone.fpn." + k
    if k.startswith("fc6.") or k.startswith("fc7."):
        return "roi_heads.box.feature_extractor." + k
    if k.startswith("cls_score.") or k.startswith("bbox_pred."):
        return "roi_heads.box.predictor." + k
    return k


def load_c2_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A Detectron/caffe2 ``.pkl`` in maskrcnn-benchmark names.  caffe2's
    AffineChannel has no running statistics, so every BN affine gets
    ``running_mean`` 0 and ``running_var`` 1: the fold then keeps its scale
    and bias exactly."""
    import pickle

    with open(path, "rb") as f:
        data = pickle.load(f, encoding="latin1")
    blobs = data.get("blobs", data)
    out: Dict[str, np.ndarray] = {}
    for k, v in blobs.items():
        if "_momentum" in k or not isinstance(v, np.ndarray):
            continue
        out[c2_rename_key(k)] = np.asarray(v, np.float32)
    for k in list(out):
        m = re.match(r"^(.*(?:\bbn\d|downsample\.1|stem\.bn1))\.weight$", k)
        if m and f"{m.group(1)}.bias" in out:
            out[f"{m.group(1)}.running_mean"] = np.zeros_like(out[k])
            out[f"{m.group(1)}.running_var"] = np.ones_like(out[k])
    return out


_C2_DETECTRON_URL = "https://dl.fbaipublicfiles.com/detectron"
_C2_IMAGENET_MODELS = {
    "MSRA/R-50": "ImageNetPretrained/MSRA/R-50.pkl",
    "MSRA/R-50-GN": "ImageNetPretrained/47261647/R-50-GN.pkl",
    "MSRA/R-101": "ImageNetPretrained/MSRA/R-101.pkl",
    "MSRA/R-101-GN": "ImageNetPretrained/47592356/R-101-GN.pkl",
    "FAIR/20171220/X-101-32x8d": "ImageNetPretrained/20171220/X-101-32x8d.pkl",
}
_C2_DETECTRON_MODELS = {
    "35857197/e2e_faster_rcnn_R-50-C4_1x": "01_33_49.iAX0mXvW",
    "35857345/e2e_faster_rcnn_R-50-FPN_1x": "01_36_30.cUF7QR7I",
    "35857890/e2e_faster_rcnn_R-101-FPN_1x": "01_38_50.sNxI7sX7",
    "36761737/e2e_faster_rcnn_X-101-32x8d-FPN_1x": "06_31_39.5MIHi1fZ",
    "35858791/e2e_mask_rcnn_R-50-C4_1x": "01_45_57.ZgkA7hPB",
    "35858933/e2e_mask_rcnn_R-50-FPN_1x": "01_48_14.DzEQe4wC",
    "35861795/e2e_mask_rcnn_R-101-FPN_1x": "02_31_37.KqyEK4tT",
    "36761843/e2e_mask_rcnn_X-101-32x8d-FPN_1x": "06_35_59.RZotkLKI",
    "37129812/e2e_mask_rcnn_X-152-32x8d-FPN-IN5k_1.44x": "09_35_36.8pzTQKYK",
    "37697547/e2e_keypoint_rcnn_R-50-FPN_1x": "08_42_54.kdzV35ao",
}


def catalog_url(name: str) -> str:
    """``catalog://...`` → the Detectron URL it names (the file's name in
    the cache; nothing is fetched)."""
    name = name[len("catalog://"):] if name.startswith("catalog://") else name
    if name.startswith("ImageNetPretrained/"):
        short = name[len("ImageNetPretrained/"):]
        return f"{_C2_DETECTRON_URL}/{_C2_IMAGENET_MODELS[short]}"
    if name.startswith("Caffe2Detectron/COCO/"):
        rest = name[len("Caffe2Detectron/COCO/"):]
        tag = "keypoints_" if "keypoint" in rest else ""
        signature = _C2_DETECTRON_MODELS[rest]
        model_id, model_name = rest.split("/", 1)
        suffix = (f"output/train/{tag}coco_2014_train%3A{tag}"
                  "coco_2014_valminusminival/generalized_rcnn/model_final.pkl")
        return (f"{_C2_DETECTRON_URL}/{model_id}/12_2017_baselines/"
                f"{model_name}.yaml.{signature}/{suffix}")
    raise KeyError(f"model not present in the catalog: {name}")


def resolve_catalog(name: str, cache_dir: str = None) -> str:
    """``catalog://...`` → a file of the local weight cache
    (``$VETO_WEIGHTS_CACHE``, default ``~/.cache/veto_tpu/models``, the
    JAX package's), named by the URL's basename.  Never downloads: a
    missing file raises ``FileNotFoundError`` naming where to put it."""
    import os
    from urllib.parse import urlparse

    url = catalog_url(name)
    cache_dir = cache_dir or os.environ.get(
        "VETO_WEIGHTS_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache", "veto_tpu", "models"))
    path = os.path.join(cache_dir, os.path.basename(urlparse(url).path))
    if not os.path.exists(path):
        raise FileNotFoundError(f"{name} resolves to {url}; place the file at "
                                f"{path} (nothing is downloaded)")
    return path


# ---------------------------------------------------------------------------
# a reference relation checkpoint: the depth ResNet-18 and VETOPredictor
# ---------------------------------------------------------------------------

def depth_backbone_state_updates(sd: Updates,
                                 src_prefix: str = "depth_backbone.body") -> Updates:
    """The reference depth backbone (torchvision ResNet-18 truncated after
    layer3) in the port's names.  It trains, so its BatchNorms stay live:
    weight, bias and running statistics as stored."""
    p = src_prefix + "."
    sd = {k[len(p):]: v for k, v in sd.items() if k.startswith(p)}
    out: Updates = {}
    root = "depth_backbone"

    def put_bn(src: str, dst: str) -> None:
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            out[f"{dst}.{leaf}"] = _f32(sd[f"{src}.{leaf}"])

    out[f"{root}.conv1.weight"] = _f32(sd["conv1.weight"])
    put_bn("bn1", f"{root}.bn1")
    pat = re.compile(r"^layer(\d)\.(\d+)\.conv(\d)\.weight$")
    for k in list(sd):
        m = pat.match(k)
        if not m:
            continue
        layer, block, conv = m.groups()
        base = f"{root}.layer{layer}_block{block}"
        out[f"{base}.conv{conv}.weight"] = _f32(sd[k])
        put_bn(f"layer{layer}.{block}.bn{conv}", f"{base}.bn{conv}")
        ds = f"layer{layer}.{block}.downsample"
        if conv == "1" and f"{ds}.0.weight" in sd:
            out[f"{base}.downsample_conv.weight"] = _f32(sd[f"{ds}.0.weight"])
            put_bn(f"{ds}.1", f"{base}.downsample_bn")
    return out


def _split_pair_columns(w: np.ndarray, half: int) -> Tuple[np.ndarray, np.ndarray]:
    """A torch (out, 2 half) projection of concat(subj, obj) as its subject
    and object (out, half) weights: ``W [s; o] = W[:, :half] s +
    W[:, half:] o``."""
    return _f32(w[:, :half]), _f32(w[:, half:])


def _split_patch_columns(w: np.ndarray, channels: int,
                         patch_area: int) -> Tuple[np.ndarray, np.ndarray]:
    """A torch patch projection over the channel-concatenated subject and
    object maps, patchified ``(p1 p2 c)``, as its subject and object
    (out, area * channels) weights: each patch position holds ``2
    channels`` adjacent columns, the subject's first."""
    out_dim = w.shape[0]
    w = w.reshape(out_dim, patch_area, 2 * channels)
    return (_f32(w[:, :, :channels].reshape(out_dim, patch_area * channels)),
            _f32(w[:, :, channels:].reshape(out_dim, patch_area * channels)))


def veto_encoder_updates(sd: Updates, src: str, dst: str, layers: int = 6) -> Updates:
    """The reference Transformer stack (model_veto.py:28-64) as the port's
    flat ``VetoEncoder`` parameters under ``dst``: norms as stored,
    matrices transposed to ``(in, out)``."""
    out: Updates = {f"{dst}.cls_token": _f32(sd[f"{src}.cls_token"]),
                    f"{dst}.pos_embedding": _f32(sd[f"{src}.pos_embedding"])}
    for i in range(layers):
        lp = f"{src}.layers.{i}"
        out[f"{dst}.attn_norm{i}_scale"] = _f32(sd[f"{lp}.0.norm.weight"])
        out[f"{dst}.attn_norm{i}_bias"] = _f32(sd[f"{lp}.0.norm.bias"])
        out[f"{dst}.attn{i}_qkv"] = _f32(sd[f"{lp}.0.fn.to_qkv.weight"].T)
        out[f"{dst}.attn{i}_out"] = _f32(sd[f"{lp}.0.fn.to_out.0.weight"].T)
        out[f"{dst}.attn{i}_out_bias"] = _f32(sd[f"{lp}.0.fn.to_out.0.bias"])
        out[f"{dst}.ffn_norm{i}_scale"] = _f32(sd[f"{lp}.1.norm.weight"])
        out[f"{dst}.ffn_norm{i}_bias"] = _f32(sd[f"{lp}.1.norm.bias"])
        out[f"{dst}.ffn{i}_fc1"] = _f32(sd[f"{lp}.1.fn.net.0.weight"].T)
        out[f"{dst}.ffn{i}_fc1_bias"] = _f32(sd[f"{lp}.1.fn.net.0.bias"])
        out[f"{dst}.ffn{i}_fc2"] = _f32(sd[f"{lp}.1.fn.net.3.weight"].T)
        out[f"{dst}.ffn{i}_fc2_bias"] = _f32(sd[f"{lp}.1.fn.net.3.bias"])
    return out


def veto_relation_state_updates(sd: Updates,
                                src_prefix: str = "roi_heads.relation.predictor",
                                layers: int = 6, in_channels: int = 256,
                                patch_size: int = 2,
                                dst_prefix: str = "relation") -> Updates:
    """A reference VETOPredictor (roi_relation_predictors.py:3997-4070) in
    the port's names under ``dst_prefix`` (the ``SGGModel``'s ``relation``;
    empty for a ``VetoPredictor`` alone): the concat projections split
    into the trunk's subject and object weights, ``pos_embed``'s
    BatchNorm1d with its running statistics."""
    p = (src_prefix + ".") if src_prefix else ""
    sd = {k[len(p):]: v for k, v in sd.items() if k.startswith(p)}
    pre = f"{dst_prefix}." if dst_prefix else ""
    t = f"{pre}trunk"
    out: Updates = {f"{t}.obj_embed.weight": _f32(sd["obj_embed.weight"])}
    # pos_embed: BatchNorm1d(4) + Linear(4, 128)
    for leaf in ("weight", "bias", "running_mean", "running_var"):
        out[f"{t}.pos_bn.{leaf}"] = _f32(sd[f"pos_embed.0.{leaf}"])
    out[f"{t}.pos_fc.weight"] = _f32(sd["pos_embed.1.weight"])
    out[f"{t}.pos_fc.bias"] = _f32(sd["pos_embed.1.bias"])
    for name, src, half in (("loc_proj", "location_projection", 128),
                            ("class_proj", "class_projection", 200)):
        ws, wo = _split_pair_columns(sd[f"{src}.0.weight"], half)
        out[f"{t}.{name}_subj.weight"], out[f"{t}.{name}_obj.weight"] = ws, wo
        out[f"{t}.{name}_bias"] = _f32(sd[f"{src}.0.bias"])
    pe = "fusion_transformer.transformer.patch_embed"
    for kind in ("d", "v"):
        ws, wo = _split_patch_columns(sd[f"{pe}.proj_{kind}.weight"],
                                      in_channels, patch_size * patch_size)
        out[f"{t}.proj_{kind}_subj.weight"] = ws
        out[f"{t}.proj_{kind}_obj.weight"] = wo
        out[f"{t}.proj_{kind}_bias"] = _f32(sd[f"{pe}.proj_{kind}.bias"])
    out.update(veto_encoder_updates(sd, "fusion_transformer.transformer",
                                    f"{t}.fusion_transformer", layers))
    if "rel_out.weight" in sd:
        out[f"{pre}rel_out.weight"] = _f32(sd["rel_out.weight"])
        out[f"{pre}rel_out.bias"] = _f32(sd["rel_out.bias"])
    return out
