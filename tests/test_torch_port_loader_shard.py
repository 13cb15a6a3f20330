"""Each rank's shard of the port's loader against the JAX loader's per-host
shard: ``SGGLoader(rank=r, world=W)`` against ``SGGLoader(host_id=r,
num_hosts=W)`` (the indices ``[r::W]`` of each epoch's order), W in
{2, 3}, at the same local batch, bit-equal, for the training stream
(``iterations``, both buckets, through the host ops) and one eval pass
(``epochs``).  The JAX side's host ops are pinned to a private build
(``tests/torch_port_jax_native.py``), as in ``test_torch_port_vg_loader.py``.
The synthetic corpus shards the same way (``batches_for``)."""

import os

import numpy as np
import pytest

from veto_tpu.data.loader import SGGLoader as JLoader
from veto_tpu.data.visual_genome import VGDataset as JVG

import torch_port_jax_native
from torch_port_vg_files import write_fake_vg
from torch_port_threads import one_torch_thread_per_worker  # noqa: F401
from veto_tpu_torch import native
from veto_tpu_torch.data.loader import SGGLoader
from veto_tpu_torch.data.visual_genome import VGDataset

FIELDS = ("images", "depth", "boxes", "box_mask", "labels", "obj_logits",
          "rel_matrix", "sizes", "attributes")
SHARDS = [(2, 0), (2, 1), (3, 0), (3, 1), (3, 2)]


@pytest.fixture(scope="module")
def vg_dir(tmp_path_factory):
    return write_fake_vg(str(tmp_path_factory.mktemp("vg")))


@pytest.fixture(scope="module")
def _jax_lib(tmp_path_factory):
    return torch_port_jax_native.build(tmp_path_factory.mktemp("jax_native"))


@pytest.fixture(autouse=True)
def _jax_native(monkeypatch, _jax_lib):
    torch_port_jax_native.use(monkeypatch, _jax_lib)
    assert native.available()


def _vg(cls, root, split):
    return cls(split, roidb_file=os.path.join(root, "VG-SGG-with-attri.h5"),
               dict_file=os.path.join(root, "VG-SGG-dicts-with-attri.json"),
               image_file=os.path.join(root, "image_data.json"),
               img_dir=os.path.join(root, "VG_100K"),
               depth_img_dir=os.path.join(root, "VG_100K_depth"), num_val_im=5)


def _loaders(root, split, world, rank, batch_size):
    kw = dict(batch_size=batch_size, max_boxes=8, num_obj_classes=151, min_size=32,
              max_size=56, shuffle=split == "train", seed=5, size_divisibility=8,
              num_workers=2)
    return (SGGLoader(_vg(VGDataset, root, split), rank=rank, world=world, **kw),
            JLoader(_vg(JVG, root, split), host_id=rank, num_hosts=world, **kw))


def _same_batches(got, ref):
    assert len(got) == len(ref) > 0
    for (gb, grecs), (rb, rrecs) in zip(got, ref):
        for f in FIELDS:
            g, r = getattr(gb, f), np.asarray(getattr(rb, f))
            assert g.shape == r.shape and g.dtype == r.dtype, f
            np.testing.assert_array_equal(g, r, err_msg=f)
        assert [r["image_id"] if "image_id" in r else None for r in grecs] == [
            r["image_id"] if "image_id" in r else None for r in rrecs]


@pytest.mark.parametrize("world,rank", SHARDS)
def test_train_shard_matches_jax(vg_dir, world, rank):
    port, ref = _loaders(vg_dir, "train", world, rank, batch_size=2)
    assert port._indices(1).tolist() == ref._indices(1).tolist()
    _same_batches(list(port.iterations(5, 1)), list(ref.iterations(5, 1)))


@pytest.mark.parametrize("world,rank", SHARDS)
def test_eval_shard_matches_jax(vg_dir, world, rank):
    port, ref = _loaders(vg_dir, "test", world, rank, batch_size=2)
    _same_batches(list(port.epochs()), list(ref.epochs()))


def test_shards_partition_each_epoch(vg_dir):
    """The ranks' shards of an epoch are disjoint and cover its order."""
    for world in (2, 3):
        whole = SGGLoader(_vg(VGDataset, vg_dir, "train"), batch_size=1, seed=5)
        shards = [SGGLoader(_vg(VGDataset, vg_dir, "train"), batch_size=1, seed=5,
                            rank=r, world=world)._indices(2) for r in range(world)]
        order = whole._indices(2)
        assert sorted(np.concatenate(shards).tolist()) == sorted(order.tolist())
        for r, s in enumerate(shards):
            assert s.tolist() == order[r::world].tolist()


def test_synthetic_corpus_shards_alike():
    """``batches_for`` on the synthetic corpus: rank r of W reads the
    images ``[r::W]`` at ``ims_per_batch // W`` a batch; one rank reads
    what it always read."""
    import torch_port_ddp_worker as worker

    from veto_tpu_torch.tools.relation_train_net import (
        batches_for, synthetic_train_dataset,
    )

    cfg = worker.toy_config("veto_vg_predcls.yaml")
    ds = synthetic_train_dataset(cfg, 8)
    one = [b for b, _ in batches_for(cfg, ds, "train")(2)]
    ranks = [[b for b, _ in batches_for(cfg, ds, "train", r, 2)(2)] for r in range(2)]
    assert one[0].images.shape[0] == 4 and ranks[0][0].images.shape[0] == 2
    for step in range(2):
        got = np.concatenate([ranks[r][step].images for r in range(2)])
        want = np.stack([ds[i]["image"] for i in range(8)])[
            [4 * step, 4 * step + 2, 4 * step + 1, 4 * step + 3]]
        np.testing.assert_array_equal(got, want)
    legacy = [b for b, _ in ds.batches(4, cfg.data.max_boxes)][:2]
    for a, b in zip(one, legacy):
        np.testing.assert_array_equal(a.images, b.images)
