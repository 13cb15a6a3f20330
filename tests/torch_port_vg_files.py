"""Small Visual-Genome- and GQA-format file trees for the port's CPU tests,
written into a directory a test owns (the layout the train tools read
under ``data.data_dir``):

  VG-SGG-with-attri.h5, VG-SGG-dicts-with-attri.json, image_data.json,
  VG_100K/<id>.jpg, VG_100K_depth/<id>-depth_raw.png  (VG)
  GQA_200_ID_Info.json, GQA_200_Train.json, GQA_200_Test.json,
  images/<name>.jpg, depth/<name>-depth_raw.png        (GQA)

Images mix landscape and portrait aspects; relations include duplicate
(subject, object) pairs and an image without relations, so the readers'
filters and their sequential RandomState draws are exercised.
"""

import json
import os

import numpy as np


def _write_pixels(path_img, path_depth, w, h, rng):
    from PIL import Image

    Image.fromarray(rng.randint(0, 256, (h, w, 3)).astype(np.uint8)).save(
        path_img, quality=95)
    Image.fromarray(rng.randint(0, 60000, (h, w)).astype(np.uint16)).save(path_depth)


def _shape(i):
    """Alternating aspects, a few sizes: (w, h)."""
    return [(60, 40), (40, 60), (64, 48), (44, 62)][i % 4]


def write_fake_vg(root, num_train=18, num_test=6, seed=0):
    """A VG tree of ``num_train`` train (split 0) and ``num_test`` test
    (split 2) images; image 3 has no relations (filtered out)."""
    import h5py

    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "VG_100K"), exist_ok=True)
    os.makedirs(os.path.join(root, "VG_100K_depth"), exist_ok=True)
    boxes, labels, attrs, split, meta = [], [], [], [], []
    first_box, last_box, first_rel, last_rel = [], [], [], []
    rel_pairs, rel_preds = [], []
    for i in range(num_train + num_test):
        w, h = _shape(i)
        split.append(0 if i < num_train else 2)
        n = rng.randint(3, 7)
        first_box.append(len(labels))
        for _ in range(n):  # cx cy w h at BOX_SCALE 1024, overlapping
            cx, cy = rng.uniform(300, 700, 2)
            bw, bh = rng.uniform(200, 500, 2)
            boxes.append([cx, cy, bw, bh])
            labels.append(rng.randint(1, 151))
            attrs.append(rng.randint(0, 5, 10))
        last_box.append(len(labels) - 1)
        base = first_box[-1]
        if i == 3:
            first_rel.append(-1)
            last_rel.append(-1)
        else:
            first_rel.append(len(rel_preds))
            for _ in range(rng.randint(2, 6)):
                s, o = rng.choice(n, 2, replace=False)
                rel_pairs.append([base + s, base + o])
                rel_preds.append(rng.randint(1, 51))
            # a duplicate pair with another predicate
            rel_pairs.append(list(rel_pairs[-1]))
            rel_preds.append(rng.randint(1, 51))
            last_rel.append(len(rel_preds) - 1)
        meta.append({"image_id": 2000 + i, "width": w, "height": h})
        _write_pixels(os.path.join(root, "VG_100K", f"{2000 + i}.jpg"),
                      os.path.join(root, "VG_100K_depth", f"{2000 + i}-depth_raw.png"),
                      w, h, rng)
    with h5py.File(os.path.join(root, "VG-SGG-with-attri.h5"), "w") as f:
        f["split"] = np.array(split)
        f["img_to_first_box"] = np.array(first_box)
        f["img_to_last_box"] = np.array(last_box)
        f["img_to_first_rel"] = np.array(first_rel)
        f["img_to_last_rel"] = np.array(last_rel)
        f["boxes_1024"] = np.array(boxes, np.float32)
        f["labels"] = np.array(labels)[:, None]
        f["attributes"] = np.stack(attrs)
        f["relationships"] = np.array(rel_pairs)
        f["predicates"] = np.array(rel_preds)[:, None]
    with open(os.path.join(root, "VG-SGG-dicts-with-attri.json"), "w") as f:
        json.dump({"label_to_idx": {f"obj{i}": i for i in range(1, 151)},
                   "predicate_to_idx": {f"rel{i}": i for i in range(1, 51)},
                   "attribute_to_idx": {f"att{i}": i for i in range(1, 201)}}, f)
    with open(os.path.join(root, "image_data.json"), "w") as f:
        json.dump(meta, f)
    return str(root)


def write_fake_gqa(root, num_train=10, num_test=8, seed=1):
    """A GQA-200 tree; boxes are in image coordinates."""
    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    os.makedirs(os.path.join(root, "depth"), exist_ok=True)
    with open(os.path.join(root, "GQA_200_ID_Info.json"), "w") as f:
        json.dump({"label_to_idx": {f"obj{i}": i for i in range(1, 201)},
                   "predicate_to_idx": {f"rel{i}": i for i in range(1, 101)}}, f)
    for name, count, off in (("Train", num_train, 0), ("Test", num_test, 500)):
        data = {k: [] for k in ("filenames_all", "img_info_all", "gt_boxes_all",
                                "gt_classes_all", "relationships_all")}
        for i in range(count):
            w, h = _shape(i)
            n = rng.randint(2, 6)
            x1 = rng.uniform(0, w / 2, n)
            y1 = rng.uniform(0, h / 2, n)
            b = np.stack([x1, y1, x1 + rng.uniform(4, w / 2, n),
                          y1 + rng.uniform(4, h / 2, n)], 1)
            rels = [[int(s), int(o), int(rng.randint(1, 101))]
                    for s, o in (rng.choice(n, 2, replace=False)
                                 for _ in range(rng.randint(0 if i == 2 else 1, 4)))]
            if rels:
                rels.append(rels[-1][:2] + [int(rng.randint(1, 101))])
            fn = f"{off + i}.jpg"
            data["filenames_all"].append(fn)
            data["img_info_all"].append({"image_id": off + i, "width": w,
                                         "height": h})
            data["gt_boxes_all"].append(b.tolist())
            data["gt_classes_all"].append(rng.randint(1, 201, n).tolist())
            data["relationships_all"].append(rels)
            _write_pixels(os.path.join(root, "images", fn),
                          os.path.join(root, "depth", f"{off + i}-depth_raw.png"),
                          w, h, rng)
        with open(os.path.join(root, f"GQA_200_{name}.json"), "w") as f:
            json.dump(data, f)
    return str(root)
