"""Port parity for the Visual Genome and GQA readers, the bucketed loader
and the zero-shot triplets, on VG/GQA-format files written into
``tmp_path``: every record, batch and triplet equals the JAX package's
exactly.

The JAX loader takes its fused path when its own host-ops library loads.
Every test here runs with ``veto_tpu.native`` pinned to a build of that
library private to this module (:mod:`torch_port_jax_native`, the autouse
:func:`_jax_native`), so both packages run their native host ops whatever
another test of the process did to ``veto_tpu.native`` (a build of its
in-package library that lost a race leaves it on NumPy for the rest of the
process), and no test here reads or writes the JAX package's own
``libveto_host.so``."""

import os

import numpy as np
import pytest

pytest.importorskip("h5py")
pytest.importorskip("PIL")

from veto_tpu.data.gqa import GQADataset as JGQA
from veto_tpu.data.loader import SGGLoader as JLoader
from veto_tpu.data.visual_genome import VGDataset as JVG
from veto_tpu.evaluation.sgg_eval import compute_zeroshot_triplets as j_zs
from veto_tpu.evaluation.sgg_eval import load_zeroshot_triplets_file as j_zs_file

from veto_tpu import native as jnative

import torch_port_jax_native
from torch_port_vg_files import write_fake_gqa, write_fake_vg
from torch_port_threads import one_torch_thread_per_worker  # noqa: F401
from veto_tpu_torch import native
from veto_tpu_torch.data.gqa import GQADataset
from veto_tpu_torch.data.loader import SGGLoader
from veto_tpu_torch.data.visual_genome import VGDataset
from veto_tpu_torch.evaluation.sgg_eval import (
    compute_zeroshot_triplets, load_zeroshot_triplets_file,
)

FIELDS = ("images", "depth", "boxes", "box_mask", "labels", "obj_logits",
          "rel_matrix", "sizes", "attributes")


@pytest.fixture(scope="module")
def vg_dir(tmp_path_factory):
    return write_fake_vg(str(tmp_path_factory.mktemp("vg")))


@pytest.fixture(scope="module")
def gqa_dir(tmp_path_factory):
    return write_fake_gqa(str(tmp_path_factory.mktemp("gqa")))


@pytest.fixture(scope="module")
def _jax_lib(tmp_path_factory):
    return torch_port_jax_native.build(tmp_path_factory.mktemp("jax_native"))


@pytest.fixture(autouse=True)
def _jax_native(monkeypatch, _jax_lib):
    torch_port_jax_native.use(monkeypatch, _jax_lib)
    assert native.available()


def _vg(cls, root, split, **kw):
    return cls(split, roidb_file=os.path.join(root, "VG-SGG-with-attri.h5"),
               dict_file=os.path.join(root, "VG-SGG-dicts-with-attri.json"),
               image_file=os.path.join(root, "image_data.json"),
               img_dir=os.path.join(root, "VG_100K"),
               depth_img_dir=os.path.join(root, "VG_100K_depth"),
               num_val_im=5, **kw)


def _gqa(cls, root, split, **kw):
    return cls(split, dict_file=os.path.join(root, "GQA_200_ID_Info.json"),
               train_file=os.path.join(root, "GQA_200_Train.json"),
               test_file=os.path.join(root, "GQA_200_Test.json"),
               img_dir=os.path.join(root, "images"),
               depth_img_dir=os.path.join(root, "depth"), num_val_im=3, **kw)


def _same_record(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], np.ndarray) or isinstance(b[k], np.ndarray):
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                          err_msg=k)
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        else:
            assert a[k] == b[k], k


def _same_batches(got, ref):
    assert len(got) == len(ref) > 0
    for (gb, grecs), (rb, rrecs) in zip(got, ref):
        for f in FIELDS:
            g, r = getattr(gb, f), np.asarray(getattr(rb, f))
            assert g.shape == r.shape and g.dtype == r.dtype, f
            np.testing.assert_array_equal(g, r, err_msg=f)
        assert len(grecs) == len(rrecs)
        for g, r in zip(grecs, rrecs):
            _same_record(g, r)


@pytest.mark.parametrize("split,resampling", [
    ("train", None), ("train", {"repeat_factor": 0.13,
                                "instance_drop_rate": 1.6}),
    ("val", None), ("test", None)])
def test_vg_records_match_jax(vg_dir, split, resampling):
    ours = _vg(VGDataset, vg_dir, split, resampling=resampling, seed=3)
    ref = _vg(JVG, vg_dir, split, resampling=resampling, seed=3)
    np.testing.assert_array_equal(ours.image_index, ref.image_index)
    assert ours.idx_list == ref.idx_list and len(ours) > 0
    assert ours.img_info == ref.img_info
    assert ours.ind_to_predicates == ref.ind_to_predicates
    for i in range(len(ours)):  # the sequential RandomState, drawn in order
        _same_record(ours.get_groundtruth(i, inner_idx=False),
                     ref.get_groundtruth(i, inner_idx=False))
    inner = ours.idx_list[0]
    np.testing.assert_array_equal(ours.load_image(inner), ref.load_image(inner))
    np.testing.assert_array_equal(ours.load_image_raw(inner),
                                  ref.load_image_raw(inner))
    np.testing.assert_array_equal(ours.load_depth(inner), ref.load_depth(inner))
    assert ours.image_size(inner) == ref.image_size(inner)


@pytest.mark.parametrize("split", ("train", "val", "test"))
def test_gqa_records_match_jax(gqa_dir, split):
    ours, ref = _gqa(GQADataset, gqa_dir, split), _gqa(JGQA, gqa_dir, split)
    assert ours.filenames == ref.filenames and len(ours) > 0
    assert ours.ind_to_classes == ref.ind_to_classes
    assert ours.ind_to_predicates == ref.ind_to_predicates
    for i in range(len(ours)):
        _same_record(ours.get_groundtruth(i), ref.get_groundtruth(i))
    np.testing.assert_array_equal(ours.load_image(0), ref.load_image(0))
    np.testing.assert_array_equal(ours.load_depth(0), ref.load_depth(0))


def _loader(cls, ds, workers, batch_size=3):
    return cls(ds, batch_size=batch_size, max_boxes=8, num_obj_classes=151,
               min_size=32, max_size=56, shuffle=True, seed=5,
               size_divisibility=8, num_workers=workers)


class _NoRaw:
    """A dataset without the raw-image protocol: the loader's slow path."""

    def __init__(self, ds):
        self._ds = ds

    def __getattr__(self, name):
        if name in ("load_image_raw", "image_size"):
            raise AttributeError(name)
        return getattr(self._ds, name)

    def __len__(self):
        return len(self._ds)


@pytest.mark.parametrize("start_iter", (0, 4))
@pytest.mark.parametrize("workers", (0, 2))
def test_loader_iterations_match_jax_slow_path(vg_dir, workers, start_iter):
    """Both buckets, the slow path, with and without worker threads (the JAX
    loader sequential), resumed at ``start_iter``: the stream restarts."""
    got = list(_loader(SGGLoader, _NoRaw(_vg(VGDataset, vg_dir, "train")),
                       workers).iterations(7, start_iter))
    ref = list(_loader(JLoader, _NoRaw(_vg(JVG, vg_dir, "train")),
                       0).iterations(7, start_iter))
    assert len(got) == 7 - start_iter
    assert {b.images.shape[1:3] for b, _ in got} == {(32, 56), (56, 32)}
    _same_batches(got, ref)


def test_loader_fused_path_matches_jax(vg_dir):
    """The fused path (host ops into the batch slots) against the JAX
    loader's fused path exactly, and against the slow path to float
    rounding."""
    port = _loader(SGGLoader, _vg(VGDataset, vg_dir, "train"), 2)
    assert port.fast_capable()
    got = list(port.iterations(6, 1))
    ref = list(_loader(JLoader, _vg(JVG, vg_dir, "train"), 2).iterations(6, 1))
    assert {b.images.shape[1:3] for b, _ in got} == {(32, 56), (56, 32)}
    _same_batches(got, ref)
    slow = list(_loader(SGGLoader, _NoRaw(_vg(VGDataset, vg_dir, "train")),
                        0).iterations(6, 1))
    for (f, _), (s, _) in zip(got, slow):
        np.testing.assert_allclose(f.images, s.images, atol=2e-3)
        np.testing.assert_allclose(f.depth, s.depth, atol=1e-4)
        for field in FIELDS[2:]:
            np.testing.assert_array_equal(getattr(f, field), getattr(s, field))


# the states another test of the process can leave ``veto_tpu.native`` in
_JAX_NATIVE_STATES = {
    "lost_build": dict(_tried=True, _lib=None),  # its in-package build failed
    "untried": dict(_tried=False, _lib=None),
    "missing_file": dict(_tried=False, _lib=None,
                         _LIB_PATH=os.path.join(os.sep, "nonexistent",
                                                "libveto_host.so")),
}


@pytest.mark.parametrize("before", sorted(_JAX_NATIVE_STATES))
def test_slow_path_matches_jax_whatever_the_jax_library_state(
        vg_dir, monkeypatch, _jax_lib, before):
    """The slow-path comparison (2 worker threads, resumed at 4) after
    ``veto_tpu.native`` was left in ``before``'s state and then pinned to
    the private build, as the autouse fixture pins it: the JAX side loads
    that build and both sides stay equal."""
    for name, value in _JAX_NATIVE_STATES[before].items():
        monkeypatch.setattr(jnative, name, value)
    torch_port_jax_native.use(monkeypatch, _jax_lib)
    got = list(_loader(SGGLoader, _NoRaw(_vg(VGDataset, vg_dir, "train")),
                       2).iterations(7, 4))
    ref = list(_loader(JLoader, _NoRaw(_vg(JVG, vg_dir, "train")),
                       0).iterations(7, 4))
    assert jnative._LIB_PATH == _jax_lib and jnative._lib is not None
    _same_batches(got, ref)


@pytest.mark.parametrize("workers", (0, 3))
def test_loader_epochs_match_jax(vg_dir, workers):
    """One eval pass: the last batch wraps around, and a batch that mixes
    aspects pads to the envelope of both buckets."""
    got = list(_loader(SGGLoader, _vg(VGDataset, vg_dir, "test"), workers,
                       batch_size=4).epochs())
    ref = list(_loader(JLoader, _vg(JVG, vg_dir, "test"), 0,
                       batch_size=4).epochs())
    assert (56, 56) in {b.images.shape[1:3] for b, _ in got}
    _same_batches(got, ref)


def test_zeroshot_triplets_match_jax(vg_dir, tmp_path):
    import torch

    train, test = (_vg(VGDataset, vg_dir, s) for s in ("train", "test"))
    jtrain, jtest = (_vg(JVG, vg_dir, s) for s in ("train", "test"))
    got = compute_zeroshot_triplets(train, test)
    ref = j_zs(jtrain, jtest)
    assert got.shape[0] > 0 and got.dtype == np.int64
    np.testing.assert_array_equal(got, ref)
    path = str(tmp_path / "zeroshot_triplet.pytorch")
    torch.save(torch.from_numpy(got[:, ::-1].copy()), path)
    np.testing.assert_array_equal(load_zeroshot_triplets_file(path),
                                  j_zs_file(path))
