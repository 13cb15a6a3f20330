"""The port's host ops (``veto_tpu_torch/native``) against the JAX package's
library (built privately by :mod:`torch_port_jax_native`) and against the
NumPy transforms of both packages, and the atomic build: six processes that
start at once all load a whole library."""

import os
import subprocess
import sys

import numpy as np
import pytest

from veto_tpu import native as jnative
from veto_tpu.data import transforms as jt

import torch_port_jax_native
from torch_port_threads import one_torch_thread_per_worker  # noqa: F401

from veto_tpu_torch import native
from veto_tpu_torch.data import transforms as tt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MEAN, STD = (102.9801, 115.9465, 122.7717), (1.0, 1.0, 1.0)


@pytest.fixture(scope="module")
def jax_lib(tmp_path_factory):
    return torch_port_jax_native.build(tmp_path_factory.mktemp("jax_native"))


@pytest.fixture
def libs(monkeypatch, jax_lib):
    """Both libraries loaded: the JAX one from this module's own build."""
    torch_port_jax_native.use(monkeypatch, jax_lib)
    assert native.available()
    assert native.PATH_TAKEN in ("built", "loaded")


def _inputs(h=37, w=53):
    rng = np.random.RandomState(0)
    return (rng.randint(0, 256, (h, w, 3)).astype(np.uint8),
            rng.rand(h, w, 1).astype(np.float32) * 1000)


@pytest.mark.parametrize("oh,ow", [(24, 40), (61, 83), (37, 53)])
def test_host_ops_match_the_jax_library(libs, oh, ow):
    """Downscale, upscale and identity; every op bit-equal."""
    u8, depth = _inputs()
    img = u8.astype(np.float32) / 255.0
    np.testing.assert_array_equal(native.resize_bilinear(img, oh, ow),
                                  jnative.resize_bilinear(img, oh, ow))
    np.testing.assert_array_equal(  # pads the (37, 53) input as it is
        native.normalize_bgr255_pad(img, 45, 61, MEAN, STD),
        jnative.normalize_bgr255_pad(img, 45, 61, MEAN, STD))
    np.testing.assert_array_equal(native.standardize_pad(depth, 40, 56),
                                  jnative.standardize_pad(depth, 40, 56))
    for lib in (native, jnative):
        slot = np.full((oh + 3, ow + 5, 3), 7.0, np.float32)
        dslot = np.full((oh + 3, ow + 5, 1), 7.0, np.float32)
        assert lib.resize_normalize_u8_into(u8, oh, ow, slot, MEAN, STD)
        assert lib.resize_standardize_into(depth, oh, ow, dslot)
        if lib is native:
            got = slot, dslot
    np.testing.assert_array_equal(got[0], slot)
    np.testing.assert_array_equal(got[1], dslot)


def test_host_ops_match_the_numpy_transforms(libs):
    """The fused u8 path against the NumPy pipeline of both packages: the
    port's NumPy transforms equal the JAX package's exactly, the fused
    path matches them to float rounding."""
    u8, depth = _inputs()
    oh, ow = tt.resize_shape(53, 37, 24, 40)
    assert (oh, ow) == jt.resize_shape(53, 37, 24, 40)
    assert tt.bucket_shape(oh, ow, 8) == jt.bucket_shape(oh, ow, 8)
    img = u8.astype(np.float32) / 255.0
    ref = jt.pad_to(jt.normalize_image(jt.resize_image(img, oh, ow), MEAN, STD),
                    oh + 3, ow + 5)
    ours = tt.pad_to(tt.normalize_image(tt.resize_image(img, oh, ow), MEAN, STD),
                     oh + 3, ow + 5)
    np.testing.assert_array_equal(ours, ref)
    dref = jt.normalize_depth(jt.resize_image(depth, oh, ow))
    np.testing.assert_array_equal(tt.normalize_depth(tt.resize_image(depth, oh, ow)),
                                  dref)
    slot = np.empty((oh + 3, ow + 5, 3), np.float32)
    dslot = np.empty((oh + 3, ow + 5, 1), np.float32)
    native.resize_normalize_u8_into(u8, oh, ow, slot, MEAN, STD)
    native.resize_standardize_into(depth, oh, ow, dslot)
    np.testing.assert_allclose(slot, ref, atol=2e-3)
    np.testing.assert_allclose(dslot[:oh, :ow], dref, atol=1e-4)
    assert not dslot[oh:].any() and not dslot[:, ow:].any()


def test_six_processes_building_at_once_all_load_a_whole_library(tmp_path):
    """Six processes start together on an empty build directory: one builds
    (under the lock, to a temporary name, then ``os.replace``), the others
    wait and load the finished file; all compute the same resize."""
    code = (
        "import sys, hashlib, numpy as np\n"
        "from pathlib import Path\n"
        "from veto_tpu_torch import native\n"
        "native.BUILD_DIR = Path(sys.argv[1])\n"
        "img = np.random.RandomState(0).rand(31, 45, 3).astype(np.float32)\n"
        "out = native.resize_bilinear(img, 20, 28)\n"
        "print(native.PATH_TAKEN, hashlib.sha1(out.tobytes()).hexdigest())\n")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(6)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e for _, e in outs]
    taken = sorted(o.split()[0] for o, _ in outs)
    assert taken == ["built"] + ["loaded"] * 5, outs
    assert len({o.split()[1] for o, _ in outs}) == 1
    libs = [f for f in os.listdir(tmp_path) if f.endswith(".so")]
    assert len(libs) == 1 and not [f for f in os.listdir(tmp_path)
                                   if f.endswith(".tmp")]


def test_a_failed_build_takes_the_numpy_path(tmp_path, monkeypatch):
    """A compiler that fails leaves no library: every op answers None /
    False and the loader keeps to its NumPy path."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "CXX_FLAGS", ("--no-such-flag",))
    monkeypatch.setattr(native, "PATH_TAKEN", None)
    monkeypatch.setattr(native, "_lib", None)
    u8, depth = _inputs()
    assert not native.available() and native.PATH_TAKEN == "numpy"
    assert native.resize_bilinear(u8.astype(np.float32), 8, 8) is None
    assert not native.resize_normalize_u8_into(
        u8, 8, 8, np.empty((8, 8, 3), np.float32), MEAN, STD)
    assert not os.listdir(tmp_path) or os.listdir(tmp_path) == ["libveto_host.lock"]
