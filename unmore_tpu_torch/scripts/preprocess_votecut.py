"""VoteCut preprocessing without OpenCV (the port of ``utils/preprocess_votecut.py``):
the top-1 mask PNGs that the stage-1 CLI's ``--votecut_mask_dir`` reads,
and the full instance-id maps that the existence sampler reads.

    python -m unmore_tpu_torch.scripts.preprocess_votecut \\
        --annotation_file imagenet_train_votecut_kmax_3_tuam_0.2.json --dest_folder OUT [--mode top1|full]

* ``--mode top1`` (default): for each image, the annotation of the highest
  ``weight`` (the first of equals), RLE-decoded; of a mask that is not
  empty, its largest connected component; written to
  ``OUT/masks_top1_single_component/<class>/<name>.png`` (255 =
  foreground).
* ``--mode full``: every annotation drawn into one id map (where masks
  overlap, the larger annotation id), the ids made dense 1..N in ascending
  order; written to ``OUT/masks/<class>/<name>.png`` as uint8, so that ids
  above 255 wrap.

The files equal the JAX script's pixel for pixel. That script asks OpenCV
for 4-connectivity, but passes the 4 where ``connectedComponentsWithStats``
takes its output array, so OpenCV labels with its default 8-connectivity;
the port labels 8-connected components too (``scipy.ndimage.label``) and
breaks a tie of largest areas as OpenCV's numbering does (see
:func:`largest_component`). RLE goes through ``utils/rle.py``, PNGs through
PIL.
"""

from __future__ import annotations

import argparse
import json
import os
from collections import defaultdict

import numpy as np


def largest_component(mask: np.ndarray) -> np.ndarray:
    """The largest 8-connected component of ``mask`` as uint8 0/1.

    OpenCV scans the image in 2x2 blocks, two rows at a time, and numbers a
    component by the first block that holds one of its pixels; of components
    of equal area it keeps the lower number. Here: the component whose first
    block in that order comes first.
    """
    from scipy import ndimage

    labels, n = ndimage.label(mask, structure=np.ones((3, 3), bool))
    if n <= 1:
        return (labels > 0).astype(np.uint8)
    ys, xs = np.nonzero(labels)
    lab = labels[ys, xs]
    first_block = np.full(n + 1, np.iinfo(np.int64).max, np.int64)
    np.minimum.at(first_block, lab, (ys // 2).astype(np.int64) * ((mask.shape[1] + 1) // 2) + xs // 2)
    areas = np.bincount(lab, minlength=n + 1)
    best = max(range(1, n + 1), key=lambda k: (areas[k], -first_block[k]))
    return (labels == best).astype(np.uint8)


def dense_id_map(masks_and_ids, hw) -> np.ndarray:
    """Each mask drawn with its id (the larger id where masks overlap), then
    the ids renumbered 1..N in ascending order; int32 [H, W]."""
    canvas = np.zeros(hw, np.int32)
    for m, ann_id in masks_and_ids:
        canvas = np.maximum(canvas, m.astype(np.int32) * ann_id)
    ids, inverse = np.unique(canvas, return_inverse=True)
    dense = np.arange(len(ids), dtype=np.int32) + int(ids[0] != 0)  # background stays 0
    return dense[inverse.reshape(hw)]


def write_png(path: str, img: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(np.ascontiguousarray(img, np.uint8)).save(path)


def main(argv=None):
    from unmore_tpu_torch.utils import rle

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--annotation_file", required=True,
                   help="VoteCut annotation JSON (imagenet_train_votecut_kmax_3_tuam_0.2.json)")
    p.add_argument("--dest_folder", required=True)
    p.add_argument("--mode", choices=["top1", "full"], default="top1")
    args = p.parse_args(argv)

    with open(args.annotation_file) as f:
        data = json.load(f)
    id_to_fname = {im["id"]: im["file_name"] for im in data["images"]}
    id_to_hw = {im["id"]: (im.get("height"), im.get("width")) for im in data["images"]}
    anns_by_image = defaultdict(list)
    for ann in data["annotations"]:
        anns_by_image[ann["image_id"]].append(ann)

    sub = "masks_top1_single_component" if args.mode == "top1" else "masks"
    os.makedirs(os.path.join(args.dest_folder, sub), exist_ok=True)
    for n, image_id in enumerate(sorted(anns_by_image)):
        fname = id_to_fname[image_id]
        anns = anns_by_image[image_id]
        os.makedirs(os.path.join(args.dest_folder, sub, os.path.dirname(fname)), exist_ok=True)
        out_path = os.path.join(args.dest_folder, sub, fname).rsplit(".", 1)[0] + ".png"
        if args.mode == "top1":
            best = max(anns, key=lambda a: a.get("weight", 0.0))
            mask = rle.decode(best["segmentation"])
            if mask.sum() > 0:
                mask = largest_component(mask)
            write_png(out_path, mask * 255)
        else:
            ids = dense_id_map([(rle.decode(a["segmentation"]), a["id"]) for a in anns], id_to_hw[image_id])
            write_png(out_path, ids.astype(np.uint8))  # ids above 255 wrap, as the JAX script writes them
        if (n + 1) % 1000 == 0:
            print(f"{n + 1}/{len(anns_by_image)}", flush=True)
    print("done:", len(anns_by_image), "images")


if __name__ == "__main__":
    main()
