"""Port parity for the reference checkpoint import (``utils/torch_import.py``):
reference-format state dicts written into ``tmp_path`` go through the JAX
package's import followed by the weight bridge (``flax_to_state_dict``) and
through the port's import; every imported tensor is exactly equal, and
the models that hold them give equal outputs."""

import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from veto_tpu.models.backbone.depth_resnet import DepthResNet18 as JDepth
from veto_tpu.models.backbone.resnet import ResNetFPNBackbone as JBackbone
from veto_tpu.models.relation.predictor_veto import VetoPredictor as JPredictor
from veto_tpu.utils import torch_import as jti

from veto_tpu_torch.models.backbone.depth_resnet import DepthResNet18
from veto_tpu_torch.models.backbone.resnet import ResNetFPNBackbone
from veto_tpu_torch.models.relation.predictor_veto import VetoPredictor
from veto_tpu_torch.utils import torch_import as tti
from veto_tpu_torch.utils.jax_weights import flax_to_state_dict

BODY = dict(stage_blocks=(1, 1, 1, 1), groups=4, width_per_group=4,
            fpn_channels=32)


def _t_conv(k):
    return np.transpose(np.asarray(k), (3, 2, 0, 1))


def _jax_backbone(fold_bn):
    jb = JBackbone(**BODY, fold_bn=fold_bn, dtype=jnp.float32)
    return jb, jb.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))["params"]


def _reference_detector_sd(rng):
    """maskrcnn-benchmark names at the shapes of the small body (from the
    unfolded JAX tree), with RPN and box-head tensors the PredCls model
    does not hold."""
    body = _jax_backbone(False)[1]
    sd = {}

    def bn(prefix, n):
        for leaf in ("weight", "bias", "running_mean"):
            sd[f"{prefix}.{leaf}"] = rng.randn(n).astype(np.float32)
        sd[f"{prefix}.running_var"] = rng.uniform(0.5, 2.0, n).astype(np.float32)

    b = body["body"]
    sd["backbone.body.stem.conv1.weight"] = rng.randn(
        *_t_conv(b["stem_conv"]["kernel"]).shape).astype(np.float32)
    bn("backbone.body.stem.bn1", 64)
    for name, mod in b.items():
        if not name.startswith("layer"):
            continue
        layer, block = name[len("layer"):].split("_block")
        pre = f"backbone.body.layer{layer}.{block}"
        for conv in ("conv1", "conv2", "conv3"):
            k = _t_conv(mod[conv]["kernel"])
            sd[f"{pre}.{conv}.weight"] = rng.randn(*k.shape).astype(np.float32)
            bn(f"{pre}.{conv.replace('conv', 'bn')}", k.shape[0])
        if "downsample_conv" in mod:
            k = _t_conv(mod["downsample_conv"]["kernel"])
            sd[f"{pre}.downsample.0.weight"] = rng.randn(*k.shape).astype(np.float32)
            bn(f"{pre}.downsample.1", k.shape[0])
    for i in range(1, 5):
        for kind in ("inner", "layer"):
            k = body["fpn"][f"fpn_{kind}{i}"]
            sd[f"backbone.fpn.fpn_{kind}{i}.weight"] = rng.randn(
                *_t_conv(k["kernel"]).shape).astype(np.float32)
            sd[f"backbone.fpn.fpn_{kind}{i}.bias"] = rng.randn(
                *k["bias"].shape).astype(np.float32)
    for name, shape in (("rpn.head.conv", (32, 32, 3, 3)),
                        ("roi_heads.box.feature_extractor.fc7", (64, 64))):
        sd[f"{name}.weight"] = rng.randn(*shape).astype(np.float32)
        sd[f"{name}.bias"] = rng.randn(shape[0]).astype(np.float32)
    return sd


def _both_imports(path, fold_bn):
    """(port model, port loaded, port skipped, JAX tree as port names, JAX
    loaded, JAX skipped) after importing ``path``."""
    jb, params = _jax_backbone(fold_bn)
    new, j_loaded, j_skipped = jti.import_detector_weights(
        {"backbone": params}, path, fold_bn=fold_bn)
    ref = flax_to_state_dict({"params": new})
    model = torch.nn.ModuleDict({"backbone": ResNetFPNBackbone(
        **BODY, fold_bn=fold_bn, dtype=torch.float32)}).eval()
    loaded, skipped = tti.import_detector_weights(model, path, fold_bn=fold_bn)
    return model, loaded, skipped, ref, j_loaded, j_skipped


@pytest.mark.parametrize("fold_bn", (False, True))
def test_detector_import_matches_jax(tmp_path, fold_bn):
    rng = np.random.RandomState(0)
    sd = _reference_detector_sd(rng)
    path = str(tmp_path / "model_final.pth")
    torch.save({"model": {f"module.{k}": torch.from_numpy(v)
                          for k, v in sd.items()}}, path)
    model, loaded, skipped, ref, j_loaded, j_skipped = _both_imports(path, fold_bn)
    state = model.state_dict()
    assert len(loaded) == len(j_loaded) == len(state)
    assert sorted(n for _, n in skipped) == [
        "box_extractor.fc7.bias", "box_extractor.fc7.weight",
        "rpn.conv.bias", "rpn.conv.weight"]
    assert len(j_skipped) == len(skipped)
    for name, value in state.items():
        np.testing.assert_array_equal(value.numpy(), ref[name].numpy(), err_msg=name)
    if fold_bn:
        return
    # the folded import computes what the unfolded one does, to rounding
    folded = _both_imports(path, True)[0]
    x = torch.from_numpy(rng.randn(1, 64, 96, 3).astype(np.float32))
    with torch.no_grad():
        for a, b in zip(model["backbone"](x), folded["backbone"](x)):
            scale = float(b.abs().max())
            np.testing.assert_allclose(a.numpy() / scale, b.numpy() / scale,
                                       atol=1e-5, rtol=0)


def _c2_blobs(rng):
    """A Detectron pickle's blobs for the stem, the first block and the
    FPN of the small body."""
    blobs = {"conv1_w": rng.randn(64, 3, 7, 7), "res_conv1_bn_s": rng.rand(64) + .5,
             "res_conv1_bn_b": rng.randn(64)}
    shapes = {"branch2a": (16, 64, 1, 1), "branch2b": (16, 4, 3, 3),
              "branch2c": (256, 16, 1, 1), "branch1": (256, 64, 1, 1)}
    for br, shape in shapes.items():
        blobs[f"res2_0_{br}_w"] = rng.randn(*shape)
        blobs[f"res2_0_{br}_bn_s"] = rng.rand(shape[0]) + .5
        blobs[f"res2_0_{br}_bn_b"] = rng.randn(shape[0])
    for lvl, c in ((2, 256), (3, 512), (4, 1024), (5, 2048)):
        blobs[f"fpn_inner_res{lvl}_0_sum_lateral_w"] = rng.randn(32, c, 1, 1)
        blobs[f"fpn_inner_res{lvl}_0_sum_lateral_b"] = rng.randn(32)
        blobs[f"fpn_res{lvl}_0_sum_w"] = rng.randn(32, 32, 3, 3)
        blobs[f"fpn_res{lvl}_0_sum_b"] = rng.randn(32)
    blobs["conv1_w_momentum"] = rng.randn(64, 3, 7, 7)
    return {k: v.astype(np.float32) for k, v in blobs.items()}


@pytest.mark.parametrize("fold_bn", (False, True))
def test_c2_pickle_and_catalog_match_jax(tmp_path, monkeypatch, fold_bn):
    """A Detectron ``.pkl`` reads to the JAX package's names and imports to
    its tensors; ``catalog://`` finds the same file in the local cache and
    never downloads."""
    path = str(tmp_path / "R-50.pkl")
    with open(path, "wb") as f:
        pickle.dump({"blobs": _c2_blobs(np.random.RandomState(1))}, f)
    ours, ref = tti.load_c2_state_dict(path), jti.load_c2_state_dict(path)
    assert sorted(ours) == sorted(ref) and "backbone.fpn.fpn_inner4.weight" in ours
    for k in ours:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    model, loaded, _, ref_sd, j_loaded, _ = _both_imports(path, fold_bn)
    assert len(loaded) == len(j_loaded) > 20
    for name in loaded:
        np.testing.assert_array_equal(model.state_dict()[name].numpy(),
                                      ref_sd[name].numpy(), err_msg=name)

    name = "catalog://ImageNetPretrained/MSRA/R-50"
    for table in (tti._C2_IMAGENET_MODELS, tti._C2_DETECTRON_MODELS):
        pre = ("ImageNetPretrained/" if table is tti._C2_IMAGENET_MODELS
               else "Caffe2Detectron/COCO/")
        for k in table:
            assert tti.catalog_url(pre + k) == jti.catalog_url(pre + k)
    with pytest.raises(FileNotFoundError, match="nothing is downloaded"):
        tti.resolve_catalog(name, cache_dir=str(tmp_path / "empty"))
    monkeypatch.setenv("VETO_WEIGHTS_CACHE", str(tmp_path))
    assert tti.resolve_catalog(name) == path
    again = torch.nn.ModuleDict({"backbone": ResNetFPNBackbone(
        **BODY, fold_bn=fold_bn, dtype=torch.float32)})
    assert tti.import_detector_weights(again, name, fold_bn=fold_bn)[0] == loaded
    for k in loaded:
        assert torch.equal(again.state_dict()[k], model.state_dict()[k])


def _reference_relation_sd(shapes, rng, num_layers, area=4, c_in=256):
    """VETOPredictor and depth ResNet-18 names, at the shapes of the small
    predictor (``shapes``: the port's names → shapes) and of ResNet-18."""
    t = "trunk"
    dim = shapes[f"{t}.loc_proj_subj.weight"][0]
    ffn = shapes[f"{t}.fusion_transformer.ffn0_fc1"][1]
    r = {"obj_embed.weight": shapes[f"{t}.obj_embed.weight"],
         "pos_embed.0.weight": (4,), "pos_embed.0.bias": (4,),
         "pos_embed.0.running_mean": (4,), "pos_embed.1.weight": (128, 4),
         "pos_embed.1.bias": (128,), "location_projection.0.weight": (dim, 256),
         "location_projection.0.bias": (dim,),
         "class_projection.0.weight": (dim, 400),
         "class_projection.0.bias": (dim,), "rel_out.weight": shapes["rel_out.weight"],
         "rel_out.bias": shapes["rel_out.bias"]}
    pe = "fusion_transformer.transformer"
    for kind in ("d", "v"):
        out = shapes[f"{t}.proj_{kind}_subj.weight"][0]
        r[f"{pe}.patch_embed.proj_{kind}.weight"] = (out, area * 2 * c_in)
        r[f"{pe}.patch_embed.proj_{kind}.bias"] = (out,)
    r[f"{pe}.cls_token"] = shapes[f"{t}.fusion_transformer.cls_token"]
    r[f"{pe}.pos_embedding"] = shapes[f"{t}.fusion_transformer.pos_embedding"]
    for i in range(num_layers):
        lp = f"{pe}.layers.{i}"
        r.update({f"{lp}.0.norm.weight": (dim,), f"{lp}.0.norm.bias": (dim,),
                  f"{lp}.0.fn.to_qkv.weight": (3 * dim, dim),
                  f"{lp}.0.fn.to_out.0.weight": (dim, dim),
                  f"{lp}.0.fn.to_out.0.bias": (dim,),
                  f"{lp}.1.norm.weight": (dim,), f"{lp}.1.norm.bias": (dim,),
                  f"{lp}.1.fn.net.0.weight": (ffn, dim),
                  f"{lp}.1.fn.net.0.bias": (ffn,),
                  f"{lp}.1.fn.net.3.weight": (dim, ffn),
                  f"{lp}.1.fn.net.3.bias": (dim,)})
    sd = {k: (rng.randn(*s) * 0.2).astype(np.float32) for k, s in r.items()}
    sd["pos_embed.0.running_var"] = rng.uniform(0.5, 2.0, 4).astype(np.float32)
    d = "depth_backbone.body"

    def conv_bn(conv, bn, o, i, k):
        sd[f"{d}.{conv}.weight"] = (rng.randn(o, i, k, k) * 0.1).astype(np.float32)
        for leaf in ("weight", "bias", "running_mean"):
            sd[f"{d}.{bn}.{leaf}"] = (rng.randn(o) * 0.1 + (leaf == "weight")
                                      ).astype(np.float32)
        sd[f"{d}.{bn}.running_var"] = rng.uniform(0.5, 2.0, o).astype(np.float32)

    conv_bn("conv1", "bn1", 64, 1, 7)
    cin = 64
    for layer, c in ((1, 64), (2, 128), (3, 256)):
        for block in (0, 1):
            p = f"layer{layer}.{block}"
            conv_bn(f"{p}.conv1", f"{p}.bn1", c, cin, 3)
            conv_bn(f"{p}.conv2", f"{p}.bn2", c, c, 3)
            if block == 0 and layer > 1:
                conv_bn(f"{p}.downsample.0", f"{p}.downsample.1", c, cin, 1)
            cin = c
    return sd


def test_relation_and_depth_converters_match_jax():
    """A reference VETOPredictor and depth ResNet-18: the port's converters
    give the JAX converters' tensors exactly, and the two packages' models
    holding them give equal outputs (f32)."""
    rng = np.random.RandomState(2)
    num_obj, num_rel = 11, 7
    kw = dict(embed_dim=200, dim=48, layers=2, heads=6, patch_size=2,
              depth_proj_dim=32, visual_proj_dim=16)
    b, n, p = 2, 5, 9
    x1y1 = rng.uniform(0, 40, (b, n, 2))
    boxes = np.concatenate([x1y1, x1y1 + rng.uniform(2, 30, (b, n, 2))],
                           -1).astype(np.float32)
    box_mask = np.array([[1] * 5, [1] * 3 + [0] * 2], bool)
    labels = (rng.randint(1, num_obj, (b, n)) * box_mask).astype(np.int32)
    pair_idx = rng.randint(0, n, (b, p, 2)).astype(np.int32)
    roi = rng.randn(b, n, 8, 8, 256).astype(np.float32)
    dep = rng.randn(b, n, 8, 8, 256).astype(np.float32)
    jp = JPredictor(num_obj_classes=num_obj, num_rel_classes=num_rel, **kw,
                    dtype=jnp.float32, remat=False, encoder_impl="xla")
    args = [jnp.asarray(a) for a in (boxes, box_mask, labels,
                                     np.zeros((b, n, num_obj), np.float32),
                                     pair_idx, np.ones((b, p), bool), roi, dep)]
    variables = jax.tree.map(np.asarray, jp.init(jax.random.PRNGKey(0), *args))
    shapes = {k: tuple(v.shape) for k, v in flax_to_state_dict(variables).items()}
    sd = _reference_relation_sd(shapes, rng, kw["layers"])

    updates, stats = jti.veto_relation_param_updates(sd, src_prefix="", layers=2)
    params, _, skipped = jti.apply_updates(variables["params"], updates)
    bstats, _, s_skipped = jti.apply_updates(variables["batch_stats"], stats)
    assert not skipped and not s_skipped
    jvars = {"params": params, "batch_stats": bstats}
    ref = np.asarray(jp.apply(jvars, *args).rel_logits)

    tp = VetoPredictor(num_obj, num_rel, **kw, rgb_channels=256,
                       depth_channels=256, dtype=torch.float32).eval()
    ours = tti.veto_relation_state_updates(sd, src_prefix="", layers=2,
                                           dst_prefix="")
    loaded, skipped = tti.apply_updates(tp, ours)
    assert not skipped and len(loaded) == len(tp.state_dict())
    want = flax_to_state_dict(jvars)
    for name, value in tp.state_dict().items():
        if name in want:
            np.testing.assert_array_equal(value.numpy(), want[name].numpy(), name)
    with torch.no_grad():
        got = tp(*[torch.from_numpy(a) for a in (boxes, box_mask, labels,
                                                   pair_idx, roi, dep)]).rel_logits
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=1e-5)

    jd = JDepth(dtype=jnp.float32)
    depth = rng.randn(1, 64, 96, 1).astype(np.float32)
    dvars = jax.tree.map(np.asarray, jd.init(jax.random.PRNGKey(1), jnp.asarray(depth)))
    dup, dstats = jti.depth_backbone_param_updates(sd)
    dparams, _, sk1 = jti.apply_updates({"depth_backbone": dvars["params"]}, dup)
    dbs, _, sk2 = jti.apply_updates({"depth_backbone": dvars["batch_stats"]}, dstats)
    assert not sk1 and not sk2
    dref = np.asarray(jd.apply({"params": dparams["depth_backbone"],
                                "batch_stats": dbs["depth_backbone"]},
                               jnp.asarray(depth)))
    td = torch.nn.ModuleDict({"depth_backbone": DepthResNet18(torch.float32)}).eval()
    loaded, skipped = tti.apply_updates(td, tti.depth_backbone_state_updates(sd))
    assert not skipped and len(loaded) == sum(
        not k.endswith("num_batches_tracked") for k in td.state_dict())
    want = flax_to_state_dict({"params": dparams, "batch_stats": dbs})
    for name, value in td.state_dict().items():
        if not name.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(value.numpy(), want[name].numpy(), name)
    with torch.no_grad():
        dmap = td["depth_backbone"](torch.from_numpy(depth)).numpy()
    scale = max(1.0, float(np.abs(dref).max()))
    np.testing.assert_allclose(dmap / scale, dref / scale, atol=2e-5, rtol=0)
