"""Port parity for the detector backbone (ResNeXt body + FPN, P2-P6) and the
depth ResNet-18, f32, in the folded and unfolded frozen-BN layouts, with
parameters from the JAX modules' ``init`` through the weight bridge."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from veto_tpu.models.backbone.depth_resnet import DepthResNet18 as JDepth
from veto_tpu.models.backbone.resnet import ResNetFPNBackbone as JBackbone

from torch_port_threads import one_torch_thread_per_worker  # noqa: F401

from veto_tpu_torch.models.backbone.depth_resnet import DepthResNet18
from veto_tpu_torch.models.backbone.resnet import ResNetFPNBackbone
from veto_tpu_torch.utils.jax_weights import flax_to_state_dict

SMALL = dict(stage_blocks=(1, 1, 1, 1), groups=4, width_per_group=4,
             fpn_channels=32)


def _perturb(tree, rng):
    """Random norm affines and statistics, so BN arithmetic is exercised
    (init leaves scale=1, bias=0, mean=0, var=1)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb(v, rng)
        elif k in ("scale", "var"):
            out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k in ("bias", "mean"):
            out[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


def _load(module, sd, prefix):
    sub = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    missing, unexpected = module.load_state_dict(sub, strict=False)
    assert not unexpected and all(k.endswith("num_batches_tracked")
                                  for k in missing), (missing, unexpected)


@pytest.mark.parametrize("jax_fold,port_fold", [
    (True, True),     # folded tree → folded port
    (False, False),   # unfolded tree → conv + FrozenBatchNorm in the port
    (False, True),    # unfolded tree folded by the bridge
])
def test_backbone_and_depth_match_jax_f32(jax_fold, port_fold):
    rng = np.random.RandomState(0)
    images = rng.randn(2, 64, 96, 3).astype(np.float32)
    depth = rng.randn(2, 64, 96, 1).astype(np.float32)

    jb = JBackbone(**SMALL, fold_bn=jax_fold, dtype=jnp.float32)
    jd = JDepth(dtype=jnp.float32)
    bvars = _perturb(jb.init(jax.random.PRNGKey(0), jnp.asarray(images)), rng)
    dvars = _perturb(jd.init(jax.random.PRNGKey(1), jnp.asarray(depth)), rng)
    ref_feats = jb.apply(bvars, jnp.asarray(images))
    ref_depth = jd.apply(dvars, jnp.asarray(depth))

    sd = flax_to_state_dict({
        "params": {"backbone": bvars["params"], "depth_backbone": dvars["params"]},
        "batch_stats": {"depth_backbone": dvars["batch_stats"]}},
        fold_bn=port_fold)
    tb = ResNetFPNBackbone(**SMALL, fold_bn=port_fold, dtype=torch.float32).eval()
    td = DepthResNet18(dtype=torch.float32).eval()
    _load(tb, sd, "backbone.")
    _load(td, sd, "depth_backbone.")
    with torch.no_grad():
        feats = tb(torch.from_numpy(images))
        dmap = td(torch.from_numpy(depth))

    assert len(feats) == 5
    for lvl, (got, ref) in enumerate(zip(feats, ref_feats)):
        ref = np.asarray(ref)
        assert tuple(got.shape) == ref.shape, lvl
        scale = max(1.0, float(np.abs(ref).max()))
        # f32 convolutions in another summation order through 7 conv layers
        np.testing.assert_allclose(got.numpy() / scale, ref / scale, atol=2e-5,
                                   rtol=0, err_msg=f"P{lvl + 2}")
    ref_depth = np.asarray(ref_depth)
    assert tuple(dmap.shape) == ref_depth.shape == (2, 4, 6, 256)
    scale = max(1.0, float(np.abs(ref_depth).max()))
    np.testing.assert_allclose(dmap.numpy() / scale, ref_depth / scale,
                               atol=2e-5, rtol=0)
