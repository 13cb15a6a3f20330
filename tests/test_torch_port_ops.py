"""Port parity for the two kernel modules (ROIAlign, encoder layer), the
no-JAX import rule, and the port's device default.

The JAX side reaches its Pallas kernels through the interpreter
(``interpret=True`` / ``fused_encoder.INTERPRET``); the port runs its
plain versions, which is what its wrappers do for CPU tensors.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import veto_tpu.ops.fused_encoder as jfe
from veto_tpu.ops.roi_align import roi_align as j_roi_align
from veto_tpu.ops.roi_align_windowed import (
    multilevel_roi_align_batched as j_multilevel,
)

from torch_port_threads import one_torch_thread_per_worker  # noqa: F401

from veto_tpu_torch.ops import fused_encoder as tfe
from veto_tpu_torch.ops.roi_align import multilevel_roi_align
from veto_tpu_torch.ops.roi_align import roi_align as t_roi_align
from veto_tpu_torch.ops.roi_align_windowed import (
    multilevel_roi_align_batched, reference_multilevel_roi_align_batched,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCALES = (0.25, 0.125, 0.0625, 0.03125)


@pytest.fixture
def interpret():
    jfe.INTERPRET = True
    yield
    jfe.INTERPRET = False


# ---------------------------------------------------------------- ROIAlign
def _pyramid(rng, b=2, img=512, c=8):
    return [rng.randn(b, img // s, img // s, c).astype(np.float32)
            for s in (4, 8, 16, 32)]


def _rois(rng, b=2):
    """Rois on all four levels (sqrt-area ~50/150/300/480 px), partly off
    the map, degenerate (< 1 px), and one 1:6 roi 60 rows tall on P2 —
    taller than the TPU kernel's 32-row window."""
    base = np.array([
        [10, 20, 60, 70],        # P2
        [100, 80, 250, 230],     # P3
        [50, 40, 350, 340],      # P4
        [10, 5, 500, 495],       # P5
        [-30, -20, 40, 60],      # off the top-left corner
        [470, 480, 560, 590],    # off the bottom-right corner
        [200.2, 100.7, 200.5, 100.9],  # degenerate
        [300, 10, 340, 250],     # 1:6, 60 rows on P2
    ], np.float32)
    out = np.stack([base + rng.uniform(-3, 3, base.shape).astype(np.float32)
                    for _ in range(b)])
    return out


@pytest.mark.parametrize("impl", ["windowed", "separable"])
def test_multilevel_roi_align_matches_jax_f32(impl):
    rng = np.random.RandomState(0)
    feats, rois = _pyramid(rng), _rois(rng)
    ref = np.asarray(j_multilevel([jnp.asarray(f) for f in feats],
                                  jnp.asarray(rois), SCALES, 8, 2, impl=impl,
                                  interpret=True))
    got = multilevel_roi_align_batched([torch.from_numpy(f) for f in feats],
                                       torch.from_numpy(rois), SCALES, 8, 2)
    # f32 sums of four weighted taps in another order: 1e-5 absolute
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)
    assert np.abs(ref).max() > 0.1  # the rois really pool something
    one = multilevel_roi_align([torch.from_numpy(f[1]) for f in feats],
                               torch.from_numpy(rois[1]), SCALES, 8, 2)
    np.testing.assert_allclose(one.numpy(), ref[1], atol=1e-5, rtol=0)


def test_roi_align_single_level_matches_jax_f32():
    """The depth path: one 1/16 level, no level assignment."""
    rng = np.random.RandomState(1)
    feat = rng.randn(2, 32, 32, 8).astype(np.float32)
    rois = _rois(rng)
    ref = np.stack([np.asarray(j_roi_align(jnp.asarray(feat[i]),
                                           jnp.asarray(rois[i]), 0.0625, 8, 2))
                    for i in range(2)])
    got = multilevel_roi_align_batched([torch.from_numpy(feat)],
                                       torch.from_numpy(rois), (0.0625,), 8, 2)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)
    one = t_roi_align(torch.from_numpy(feat[0]), torch.from_numpy(rois[0]),
                      0.0625, 8, 2)
    np.testing.assert_allclose(one.numpy(), ref[0], atol=1e-5, rtol=0)


def test_multilevel_roi_align_bf16_matches_jax():
    """bf16 maps: the JAX kernel rounds its bilinear weights and stage-1
    temp to bf16, the port keeps f32 weights and sums — bf16 tolerance."""
    rng = np.random.RandomState(2)
    feats, rois = _pyramid(rng), _rois(rng)
    ref = np.asarray(j_multilevel(
        [jnp.asarray(f, jnp.bfloat16) for f in feats], jnp.asarray(rois),
        SCALES, 8, 2, impl="windowed", interpret=True))
    got = reference_multilevel_roi_align_batched(
        [torch.from_numpy(f).bfloat16() for f in feats], torch.from_numpy(rois),
        SCALES, 8, 2)
    np.testing.assert_allclose(got.numpy(), ref, atol=3e-2, rtol=2e-2)


# ------------------------------------------------------------- encoder layer
def _enc_params(rng, d, f):
    mk = lambda *s: (rng.randn(*s) * 0.1).astype(np.float32)  # noqa: E731
    return dict(ln1_scale=mk(d) + 1, ln1_bias=mk(d), w_qkv=mk(d, 3 * d),
                w_out=mk(d, d), b_out=mk(d), ln2_scale=mk(d) + 1,
                ln2_bias=mk(d), w1=mk(d, f), b1=mk(f), w2=mk(f, d), b2=mk(d))


@pytest.mark.parametrize("t_pad", [24, 19])
def test_encoder_layer_matches_jax_fused_f32(interpret, t_pad):
    P, T, D, F, H = 8, 19, 96, 192, 6
    rng = np.random.RandomState(3)
    p = _enc_params(rng, D, F)
    x = rng.randn(P * t_pad, D).astype(np.float32)
    ref = np.asarray(jfe.fused_encoder_layer(
        jnp.asarray(x), jfe.EncoderLayerParams(**{k: jnp.asarray(v)
                                                  for k, v in p.items()}),
        H, t_pad, T, 4))
    got = tfe.fused_encoder_layer(
        torch.from_numpy(x),
        tfe.EncoderLayerParams(**{k: torch.from_numpy(v) for k, v in p.items()}),
        H, t_pad, T)
    # the JAX kernel test's own tolerance (tests/test_fused_encoder.py)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=0)


def test_encoder_layer_matches_jax_fused_bf16(interpret):
    P, T, TP, D, F, H = 8, 19, 24, 96, 192, 6
    rng = np.random.RandomState(4)
    p = _enc_params(rng, D, F)
    x = rng.randn(P * TP, D).astype(np.float32)
    jp = jfe.EncoderLayerParams(**{
        k: jnp.asarray(v, jnp.bfloat16 if v.ndim == 2 else jnp.float32)
        for k, v in p.items()})
    ref = np.asarray(jfe.fused_encoder_layer(
        jnp.asarray(x, jnp.bfloat16), jp, H, TP, T, 4).astype(jnp.float32))
    tp = tfe.EncoderLayerParams(**{
        k: torch.from_numpy(v).to(torch.bfloat16 if v.ndim == 2 else torch.float32)
        for k, v in p.items()})
    got = tfe.fused_encoder_layer(torch.from_numpy(x).bfloat16(), tp, H, TP, T)
    assert got.dtype == torch.bfloat16
    # same rounding points; f32 sums in another order can flip a bf16
    # rounding, which then moves a value by one or two bf16 ulps (~1e-2 at |y|~2)
    np.testing.assert_allclose(got.float().numpy(), ref, atol=6e-2, rtol=2e-2)
    assert np.mean(np.abs(got.float().numpy() - ref)) < 5e-3


def test_encoder_gelu_is_the_rational_erf():
    z = torch.linspace(-6, 6, 1001)
    ref = np.asarray(jfe._gelu_exact(jnp.asarray(z.numpy())))
    # the same formula; XLA may fuse a multiply-add, so allow two f32 ulps
    np.testing.assert_allclose(tfe._gelu_exact(z).numpy(), ref, atol=1e-7,
                               rtol=2.5e-7)


# ------------------------------------------------------ isolation & devices
def test_port_imports_no_jax():
    """Every module of the port imports with JAX, flax, the JAX package and
    OpenCV blocked, and with PIL and h5py blocked too: the port reads image
    and HDF5 files only inside the functions that read them, and needs no
    OpenCV anywhere."""
    code = (
        "import sys\n"
        "for m in ('jax', 'flax', 'veto_tpu', 'cv2', 'PIL', 'h5py'):\n"
        "    sys.modules[m] = None\n"
        "import importlib, pkgutil, veto_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(veto_tpu_torch.__path__,"
        " 'veto_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "assert len(mods) > 20, mods\n"
        "new = {'veto_tpu_torch.data.coco', 'veto_tpu_torch.data.voc',\n"
        "       'veto_tpu_torch.data.compound', 'veto_tpu_torch.evaluation.voc_eval',\n"
        "       'veto_tpu_torch.structures.masks', 'veto_tpu_torch.structures.keypoints',\n"
        "       'veto_tpu_torch.models.detector.mask_head',\n"
        "       'veto_tpu_torch.models.detector.keypoint_head',\n"
        "       'veto_tpu_torch.models.detector.attribute_head'}\n"
        "assert new <= set(mods), new - set(mods)\n"
        "from veto_tpu_torch.models.detector.keypoint_head import heatmaps_to_keypoints\n"
        "import numpy as np\n"
        "heatmaps_to_keypoints(np.zeros((1, 2, 8, 8), np.float32),\n"
        "                      np.array([[0, 0, 20, 12]], np.float32))\n"
        "print('imported', len(mods))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "imported" in out.stdout


def test_build_model_defaults_to_cuda_and_never_falls_back():
    from veto_tpu_torch.config import load_config
    from veto_tpu_torch.models.sgg import build_model

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    cfg = load_config(os.path.join(REPO, "configs", "veto_vg_predcls.yaml"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg)


def test_chip_smoke_refuses_without_gpu(tmp_path):
    """Without a card, and alone in a directory, chip_smoke.py fails and
    prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    script = os.path.join(REPO, "chip_smoke.py")
    for cwd, path in ((REPO, script), (tmp_path, str(tmp_path / "chip_smoke.py"))):
        if cwd == tmp_path:
            (tmp_path / "chip_smoke.py").write_text(open(script).read())
        out = subprocess.run([sys.executable, path], cwd=cwd,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
