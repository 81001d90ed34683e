"""Instance maps, hue images and the object-count histogram of a VoteCut
annotation JSON, without OpenCV (the port of ``utils/vis_votecut.py``).

    python -m unmore_tpu_torch.scripts.vis_votecut --votecut_json VOTECUT.json --out_dir OUT \\
        [--limit N] [--no_vis]

For each image (in id order, the first ``--limit``): the annotations drawn
in id order into one map with ids 1..N (a later one over an earlier one),
written as uint8 to ``OUT/masks/<class>/<name>.png``, and its hue image
(``utils/vis.vis_label_map``) to ``OUT/masks_vis/<class>/<name>.png``; then
the histogram of annotations an image. The PNGs equal the JAX script's
pixel for pixel (PIL in place of ``cv2.imwrite``).
"""

from __future__ import annotations

import argparse
import json
import os
from collections import Counter, defaultdict

import numpy as np


def label_map(anns: list, hw) -> np.ndarray:
    """The image's annotations drawn in id order with ids 1..N; int32 [H, W]."""
    from unmore_tpu_torch.utils import rle

    out = np.zeros(hw, np.int32)
    for new_id, ann in enumerate(sorted(anns, key=lambda a: a["id"]), start=1):
        out[rle.decode(ann["segmentation"]).astype(bool)] = new_id
    return out


def main(argv=None):
    from unmore_tpu_torch.scripts.preprocess_votecut import write_png
    from unmore_tpu_torch.utils.vis import vis_label_map

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--votecut_json", required=True)
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--limit", type=int, default=0, help="0 = all images")
    ap.add_argument("--no_vis", action="store_true", help="write only the id-map PNGs, not the hue images")
    args = ap.parse_args(argv)

    with open(args.votecut_json) as f:
        data = json.load(f)
    anns_by_img = defaultdict(list)
    for ann in data["annotations"]:
        anns_by_img[ann["image_id"]].append(ann)
    images = sorted(data["images"], key=lambda im: im["id"])
    if args.limit:
        images = images[: args.limit]
    os.makedirs(os.path.join(args.out_dir, "masks"), exist_ok=True)
    if not args.no_vis:
        os.makedirs(os.path.join(args.out_dir, "masks_vis"), exist_ok=True)

    obj_count: Counter = Counter()
    for info in images:
        anns = anns_by_img.get(info["id"], [])
        labels = label_map(anns, (info["height"], info["width"]))
        obj_count[len(anns)] += 1
        cls_dir = os.path.dirname(info["file_name"])
        base = os.path.basename(info["file_name"]).replace("JPEG", "png").replace("jpg", "png")
        mdir = os.path.join(args.out_dir, "masks", cls_dir)
        os.makedirs(mdir, exist_ok=True)
        write_png(os.path.join(mdir, base), labels.astype(np.uint8))
        if not args.no_vis:
            vdir = os.path.join(args.out_dir, "masks_vis", cls_dir)
            os.makedirs(vdir, exist_ok=True)
            write_png(os.path.join(vdir, base), vis_label_map(labels))

    print("object-count histogram:", dict(sorted(obj_count.items())))
    print(f"wrote {len(images)} mask PNGs to {args.out_dir}")


if __name__ == "__main__":
    main()
