"""Port parity for detector pretraining's other data: the COCO and Pascal
VOC readers (with and without difficult objects), the concatenated and
list datasets, ``build_dataset``'s routing by name, the VOC evaluator in
both AP modes, and the synthetic corpus's masks and keypoints, against the
JAX package on files this test writes itself; and the loader carrying a
record's masks and keypoints through its resize."""

import json
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

from veto_tpu.config.defaults import load_config as j_load_config
from veto_tpu.data import compound as jcompound
from veto_tpu.data.batching import make_sgg_batch as j_make_sgg_batch
from veto_tpu.data.coco import COCODetDataset as JCOCO
from veto_tpu.data.synthetic import SyntheticSGGDataset as JSynthetic
from veto_tpu.data.voc import VOCDataset as JVOC
from veto_tpu.evaluation.voc_eval import VOCEvaluator as JVOCEvaluator

from torch_port_threads import one_torch_thread_per_worker  # noqa: F401

from veto_tpu_torch.config import load_config
from veto_tpu_torch.data import compound
from veto_tpu_torch.data.batching import make_sgg_batch
from veto_tpu_torch.data.coco import COCODetDataset
from veto_tpu_torch.data.loader import resize_instances
from veto_tpu_torch.data.synthetic import SyntheticSGGDataset
from veto_tpu_torch.data.voc import VOCDataset
from veto_tpu_torch.evaluation.voc_eval import VOCEvaluator
from veto_tpu_torch.tools.relation_train_net import build_dataset

VOC_NAMES = ("aeroplane", "bicycle", "bird", "dog", "person", "sofa")


def _coco_json(rng, n_images):
    """Unsorted image ids, non-contiguous category ids, crowd annotations,
    boxes past the image, boxes of a pixel or less, one image without
    annotations, one with only tiny boxes, one whose only box clips away."""
    cats = [{"id": i, "name": f"cat{i}"} for i in (18, 1, 7, 3)]
    ids = rng.permutation(np.arange(100, 100 + n_images)).tolist()
    images, anns = [], []
    for j, i in enumerate(ids):
        w, h = int(rng.randint(30, 60)), int(rng.randint(20, 50))
        images.append({"id": i, "width": w, "height": h, "file_name": f"{i}.png"})
        if j == 0:
            continue  # no annotation
        boxes = ([[2.0, 2.0, 1.0, 0.5]] if j == 1 else          # only tiny
                 [[w + 5.0, 3.0, 4.0, 4.0]] if j == 2 else       # clips away
                 [[*rng.uniform(-5, w - 5, 1), *rng.uniform(-5, h - 5, 1),
                   *rng.uniform(0.5, 25, 2)] for _ in range(rng.randint(1, 6))])
        for b in boxes:
            anns.append({"id": len(anns), "image_id": i, "bbox": [float(v) for v in b],
                         "category_id": int(rng.choice([1, 3, 7, 18])),
                         "iscrowd": int(rng.rand() < 0.15)})
    return {"images": images, "annotations": anns, "categories": cats}


def _voc_xml(rng, w, h):
    objs = []
    for _ in range(rng.randint(1, 5)):
        x1, y1 = rng.randint(1, w - 5), rng.randint(1, h - 5)
        name = str(rng.choice(VOC_NAMES))
        objs.append(
            f"<object><name>{' ' + name.upper() if rng.rand() < 0.3 else name}</name>"
            f"<difficult>{int(rng.rand() < 0.3)}</difficult><bndbox>"
            f"<xmin>{x1}</xmin><ymin>{y1}</ymin><xmax>{rng.randint(x1 + 1, w + 1)}</xmax>"
            f"<ymax>{rng.randint(y1 + 1, h + 1)}</ymax></bndbox></object>")
    return (f"<annotation><size><width>{w}</width><height>{h}</height></size>"
            + "".join(objs) + "</annotation>")


@pytest.fixture(scope="module")
def det_dir(tmp_path_factory):
    """COCO 2014 and 2017 instances (train, val) and VOC2007 / VOC2012
    devkits (train, val, test) with their images."""
    from PIL import Image

    root = tmp_path_factory.mktemp("det")
    rng = np.random.RandomState(0)
    (root / "annotations").mkdir()
    for year in ("2014", "2017"):
        for split, n in (("train", 9), ("val", 5)):
            coco = _coco_json(rng, n)
            (root / "annotations" / f"instances_{split}{year}.json").write_text(
                json.dumps(coco))
            (root / f"{split}{year}").mkdir()
            for im in coco["images"]:
                Image.fromarray(rng.randint(0, 256, (im["height"], im["width"], 3),
                                            dtype=np.uint8)).save(
                    root / f"{split}{year}" / im["file_name"])
    for year in ("2007", "2012"):
        voc = root / f"VOC{year}"
        for d in ("Annotations", "JPEGImages", "ImageSets/Main"):
            (voc / d).mkdir(parents=True)
        for split, n in (("train", 5), ("val", 3), ("test", 2)):
            names = [f"{year}_{split}_{i}" for i in range(n)]
            (voc / "ImageSets" / "Main" / f"{split}.txt").write_text("\n".join(names) + "\n")
            for nm in names:
                w, h = int(rng.randint(30, 60)), int(rng.randint(20, 50))
                (voc / "Annotations" / f"{nm}.xml").write_text(_voc_xml(rng, w, h))
                Image.fromarray(rng.randint(0, 256, (h, w, 3), dtype=np.uint8)).save(
                    voc / "JPEGImages" / f"{nm}.jpg")
    return root


def _same_record(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            assert a[k].dtype == np.asarray(b[k]).dtype, k
        else:
            assert a[k] == b[k], k


def _same_dataset(got, ref, images=True):
    assert type(got).__name__ == type(ref).__name__ and len(got) == len(ref) > 0
    for i in range(len(got)):
        _same_record(got.get_groundtruth(i, inner_idx=False),
                     ref.get_groundtruth(i, inner_idx=False))
    if images:
        for i in (0, len(got) - 1):
            inner = got.idx_list[i] if hasattr(got, "idx_list") else i
            np.testing.assert_array_equal(got.load_image(inner), ref.load_image(inner))


def test_coco_matches_jax(det_dir):
    """Sorted ids, images without a valid annotation dropped, crowd
    annotations dropped, contiguous labels, xywh → xyxy with TO_REMOVE and
    the clip: every record, the image info and the vocabulary equal."""
    args = (str(det_dir / "annotations" / "instances_train2017.json"),
            str(det_dir / "train2017"))
    got, ref = COCODetDataset(*args), JCOCO(*args)
    _same_dataset(got, ref)
    assert got.img_info == ref.img_info and got.filenames == ref.filenames
    assert got.ind_to_classes == ref.ind_to_classes
    assert got.json_to_contiguous == ref.json_to_contiguous == {1: 1, 3: 2, 7: 3, 18: 4}
    assert len(got) < 9  # images were dropped
    assert COCODetDataset(*args, num_im=2).img_info == JCOCO(*args, num_im=2).img_info


@pytest.mark.parametrize("use_difficult", [False, True])
def test_voc_matches_jax(det_dir, use_difficult):
    """0-based pixel boxes, names lowered and stripped, difficult objects
    kept or dropped: every record (``difficult`` included) equal."""
    args = (str(det_dir / "VOC2007"), "train", use_difficult)
    got, ref = VOCDataset(*args), JVOC(*args)
    _same_dataset(got, ref)
    assert got.img_info == ref.img_info
    diff = np.concatenate([got.get_groundtruth(i)["difficult"] for i in range(len(got))])
    assert diff.any() == use_difficult


def test_concat_and_list_datasets_match_jax(det_dir):
    """The bisect routing of global indices, records, image info and pixels
    through ``ConcatDataset``; ``ListDataset``'s dummy boxes and pixels."""
    parts = [(str(det_dir / "VOC2007"), "train"), (str(det_dir / "VOC2012"), "val")]
    got = compound.ConcatDataset([VOCDataset(*p) for p in parts])
    ref = jcompound.ConcatDataset([JVOC(*p) for p in parts])
    assert len(got) == len(ref) == 8 and got.ind_to_classes == ref.ind_to_classes
    for i in range(len(got)):
        assert got.get_idxs(i) == ref.get_idxs(i)
        assert got.get_img_info(i) == ref.get_img_info(i)
        _same_record(got.get_groundtruth(i), ref.get_groundtruth(i))
    assert got.get_idxs(5) == (1, 0) and got.load_depth(5) is None
    np.testing.assert_array_equal(got.load_image(6), ref.load_image(6))
    paths = [str(det_dir / "train2017" / f) for f in sorted(os.listdir(det_dir / "train2017"))[:3]]
    _same_dataset(compound.ListDataset(paths), jcompound.ListDataset(paths))


@pytest.mark.parametrize("name,split,kind,where", [
    ("coco_2017_train", "train", "COCODetDataset", "train2017"),
    ("coco_2014_val", "val", "COCODetDataset", "val2014"),
    ("COCO", "test", "COCODetDataset", "val2017"),
    ("VOC2012", "test", "VOCDataset", "VOC2012"),
    ("VOC2007+VOC2012", "train", "ConcatDataset", None),
    ("VOC2007+VOC2012", "val", "VOCDataset", "VOC2007"),
])
def test_build_dataset_routes_like_the_jax_tool(det_dir, name, split, kind, where):
    """``data.dataset`` to a reader as the JAX tool routes it: the COCO
    year rule (2017 unless the name holds another 201x), the
    ``VOC{year}`` subdirectories, ``A+B`` concatenated for train only (val
    and test take the first-named part); the same records as the JAX
    tool's ``build_dataset``.  Open Images still raises."""
    from relation_train_net import build_dataset as j_build_dataset

    opts = [f"data.data_dir={det_dir}", f"data.dataset={name}"]
    got = build_dataset(load_config(None, opts), split)
    ref = j_build_dataset(j_load_config(None, opts), split)
    assert type(got).__name__ == kind
    if kind == "COCODetDataset":
        assert got.img_dir == str(det_dir / where)
    elif kind == "VOCDataset":
        assert got.root == str(det_dir / where)
    else:
        assert [type(d).__name__ for d in got.datasets] == ["VOCDataset"] * 2
    _same_dataset(got, ref, images=False)
    with pytest.raises(NotImplementedError, match="A14"):
        build_dataset(load_config(None, [f"data.data_dir={det_dir}",
                                         "data.dataset=OI_V6"]), "train")


@pytest.mark.parametrize("use_07", [True, False])
def test_voc_evaluator_matches_jax(use_07):
    """Seeded detections over 12 images and 5 classes, difficult GT boxes,
    duplicates of one GT box and a class with no GT: the AP of every class
    (nan where the JAX evaluator has nan) and the mAP to 1e-12, in the
    07 11-point and the area mode."""
    rng = np.random.RandomState(1)
    got, ref = VOCEvaluator(use_07_metric=use_07), JVOCEvaluator(use_07_metric=use_07)
    for _ in range(12):
        g = int(rng.randint(1, 6))
        gt = np.round(rng.uniform(0, 200, (g, 2)))
        gt = np.concatenate([gt, gt + np.round(rng.uniform(5, 80, (g, 2)))], 1)
        gl = rng.randint(1, 5, g)
        gd = rng.rand(g) < 0.2
        d = int(rng.randint(0, 12))
        src = rng.randint(0, g, d)
        pb = gt[src] + rng.uniform(-8, 8, (d, 4))
        pl = np.where(rng.rand(d) < 0.8, gl[src], rng.randint(1, 6, d))
        ps = rng.rand(d)
        for ev in (got, ref):
            ev.add_image(pb, pl, ps, gt, gl, gd)
    a, b = got.aggregate(), ref.aggregate()
    np.testing.assert_allclose(a["ap"], b["ap"], rtol=0, atol=1e-12)
    assert np.isnan(a["ap"]).tolist() == np.isnan(b["ap"]).tolist()
    np.testing.assert_allclose(a["map"], b["map"], rtol=0, atol=1e-12)
    assert 0 < a["map"] < 1


def test_synthetic_masks_and_keypoints_match_jax():
    """The synthetic corpus's instance masks (the ellipse in each box;
    uint8 here, f32 there) and 17 keypoints a box, record by record, and
    the batch's masks, keypoints and attributes, equal."""
    kw = dict(num_images=3, image_size=(40, 56), num_obj_classes=11, max_objects=5,
              seed=4, with_masks=True, with_keypoints=17)
    got, ref = SyntheticSGGDataset(**kw), JSynthetic(**kw)
    for i in range(3):
        a, b = got[i], ref[i]
        assert a["masks"].dtype == np.uint8 and a["masks"].any()
        for k in ("boxes", "labels", "rel_matrix", "image", "masks", "keypoints"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    recs = [got[i] for i in range(3)]
    n = len(recs[1]["boxes"])
    recs[1] = {**recs[1], "attributes": np.arange(10 * n).reshape(n, 10) % 7}
    tb = make_sgg_batch(recs, (48, 64), 6, 11)
    jb = j_make_sgg_batch(recs, (48, 64), 6, 11)
    assert tb.masks.dtype == np.uint8 and tb.masks.shape == (3, 6, 48, 64)
    for k in ("masks", "keypoints", "attributes"):
        np.testing.assert_array_equal(getattr(tb, k), getattr(jb, k), err_msg=k)
    assert tb.attributes[1].any() and not tb.attributes[0].any()


def test_loader_resizes_masks_and_keypoints_with_the_image():
    """A record's keypoints scale with its boxes; its masks resample to the
    nearest source pixel and stay 0/1 (a box filled in the source covers
    the scaled box, to a pixel)."""
    h0, w0, oh, ow = 30, 40, 75, 60
    masks = np.zeros((1, h0, w0), np.uint8)
    masks[0, 6:18, 10:30] = 1  # rows 6..17, columns 10..29
    kps = np.array([[[10.0, 6.0, 2.0], [29.5, 17.5, 1.0]]], np.float32)
    rec = {"boxes": np.array([[10.0, 6.0, 30.0, 18.0]], np.float32), "masks": masks,
           "keypoints": kps, "labels": np.ones(1, np.int32)}
    out = resize_instances(rec, h0, w0, oh, ow)
    sy, sx = oh / h0, ow / w0
    np.testing.assert_allclose(out["boxes"], [[10 * sx, 6 * sy, 30 * sx, 18 * sy]], rtol=1e-6)
    np.testing.assert_allclose(out["keypoints"][..., :2], kps[..., :2] * [sx, sy], rtol=1e-6)
    np.testing.assert_array_equal(out["keypoints"][..., 2], kps[..., 2])
    m = out["masks"][0]
    assert m.shape == (oh, ow) and m.dtype == np.uint8 and set(np.unique(m)) == {0, 1}
    rows, cols = np.nonzero(m.any(1))[0], np.nonzero(m.any(0))[0]
    assert abs(rows[0] - 6 * sy) <= 1 and abs(rows[-1] + 1 - 18 * sy) <= 1
    assert abs(cols[0] - 10 * sx) <= 1 and abs(cols[-1] + 1 - 30 * sx) <= 1
    assert rec["masks"] is masks and rec["keypoints"] is kps  # the record untouched
