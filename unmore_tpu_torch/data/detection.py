"""CAD detector training data on the host (port of the JAX package's
``data/detection.py``), without OpenCV.

Loads the merged training JSON (COCO pseudo-labels and ImageNet VoteCut,
``merge_coco_and_imagenet.py``'s output) and makes fixed-shape batches:

* multi-scale resize into a square canvas: the shorter side drawn from
  MIN_SIZE_TRAIN, capped so that the longer side fits;
* copy-paste across the batch's reversed pairs (reference
  ``cad/engine/train_loop.py:90-248``): a random subset of one image's
  instances, resized by a random ratio and shifted, composited onto the
  other; occluded instances lose the pasted area, copies covering half of
  an instance (IoY >= 0.5) are dropped, boxes are recomputed from masks;
* the fixed GT lattice: [max_gt] boxes (xyxy, canvas coordinates), scores,
  validity and box-frame masks, with images and masks as uint8 (the wire
  format; the detector divides by 255 on the card).

``is_single_object`` is 1 for ``imagenet_`` image ids (exempt from DropLoss).
The numpy ``Generator`` calls are the JAX package's, in its order, so one
seed gives its batches. OpenCV's calls become: ``imread`` -> PIL with the
EXIF orientation applied (imported only where a file is read), float
``INTER_LINEAR`` -> :func:`~unmore_tpu_torch.ops.labels.resize_linear`,
``INTER_NEAREST`` -> :func:`~unmore_tpu_torch.ops.labels.resize_nearest`.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict

import numpy as np

from unmore_tpu_torch.ops.labels import resize_linear, resize_nearest
from unmore_tpu_torch.utils import rle as rle_codec

MIN_SIZE_TRAIN = (240, 320, 480, 640, 672, 704, 736, 768, 800, 1024)


class Instance:
    __slots__ = ("box", "mask", "score")

    def __init__(self, box, mask, score):
        self.box = np.asarray(box, np.float32)  # xyxy
        self.mask = mask  # [H, W] bool (canvas resolution)
        self.score = float(score)


def _ann_mask(ann, h, w):
    seg = ann.get("segmentation")
    if seg:
        m = rle_codec.decode(seg).astype(bool)
        if m.shape != (h, w):
            m = resize_nearest(m.astype(np.uint8), (h, w)).astype(bool)
        return m
    x, y, bw, bh = ann["bbox"]
    m = np.zeros((h, w), bool)
    m[int(y) : int(y + bh), int(x) : int(x + bw)] = True
    return m


def read_rgb(path: str) -> np.ndarray | None:
    """uint8 RGB [H, W, 3] of an image file, EXIF orientation applied (as
    OpenCV's ``imread`` applies it); None when it cannot be read."""
    try:
        from PIL import Image, ImageOps
    except ImportError as exc:
        raise ImportError("reading training images needs the Pillow package (PIL)") from exc
    if not os.path.isfile(path):
        return None
    try:
        with Image.open(path) as img:
            return np.asarray(ImageOps.exif_transpose(img).convert("RGB"), np.uint8)
    except OSError:  # not an image PIL can decode: OpenCV's imread gives None too
        return None


class DetectionDataset:
    """Training JSON + image roots -> per-sample (image, instances, flags).

    ``training_json`` is a path or the loaded dict; ``read_image(path)``
    (default :func:`read_rgb`) returns uint8 RGB or None, so that images may
    come from memory."""

    def __init__(self, training_json, image_roots: dict, canvas_size: int = 1024, min_sizes=MIN_SIZE_TRAIN,
                 seed: int = 0, read_image=read_rgb):
        """image_roots: {'coco': dir, 'imagenet': dir, '': fallback_dir}."""
        if isinstance(training_json, dict):
            data = training_json
        else:
            with open(training_json) as f:
                data = json.load(f)
        self.images = data["images"]
        self.anns_by_image = defaultdict(list)
        for ann in data["annotations"]:
            self.anns_by_image[str(ann["image_id"])].append(ann)
        self.image_roots = image_roots
        self.canvas = canvas_size
        self.min_sizes = tuple(min_sizes)
        self.rng = np.random.default_rng(seed)
        self.read_image = read_image

    def __len__(self):
        return len(self.images)

    def _resolve_path(self, info):
        img_id = str(info["id"])
        for prefix, root in self.image_roots.items():
            if prefix and img_id.startswith(prefix + "_"):
                return os.path.join(root, info["file_name"])
        return os.path.join(self.image_roots.get("", "."), info["file_name"])

    def load(self, idx: int):
        """-> dict(image [S, S, 3] float32 in [0, 1], hw (the resized h, w),
        instances, is_single_object), or None when the image cannot be read."""
        info = self.images[idx]
        rgb = self.read_image(self._resolve_path(info))
        if rgb is None:
            return None
        image = rgb.astype(np.float32) / 255.0
        h0, w0 = image.shape[:2]

        short = int(self.rng.choice(self.min_sizes))
        scale = short / min(h0, w0)
        scale = min(scale, self.canvas / max(h0, w0))
        nh, nw = int(round(h0 * scale)), int(round(w0 * scale))
        image = resize_linear(image, (nh, nw))
        canvas = np.zeros((self.canvas, self.canvas, 3), np.float32)
        canvas[:nh, :nw] = image

        instances = []
        for ann in self.anns_by_image.get(str(info["id"]), []):
            x, y, bw, bh = ann["bbox"]
            box = np.array([x, y, x + bw, y + bh], np.float32) * scale
            mask = resize_nearest(_ann_mask(ann, h0, w0).astype(np.uint8), (nh, nw))
            cmask = np.zeros((self.canvas, self.canvas), bool)
            cmask[:nh, :nw] = mask.astype(bool)
            if cmask.sum() == 0:
                continue
            instances.append(Instance(box, cmask, ann.get("score", 1.0)))
        return {
            "image": canvas,
            "hw": (nh, nw),
            "instances": instances,
            "is_single_object": 1.0 if str(info["id"]).startswith("imagenet_") else 0.0,
        }


def copy_and_paste(donor: dict, recipient: dict, rng: np.random.Generator, rate: float = 1.0,
                   min_ratio: float = 0.3, max_ratio: float = 1.0, random_num: bool = True) -> dict:
    """Paste a random subset of the donor's instances into the recipient
    (reference ``train_loop.py:125-248``, at canvas resolution)."""
    n = len(donor["instances"])
    if rng.random() > rate or n == 0:
        return recipient
    num_copy = 1 if n == 1 else int(rng.integers(1, max(1, n))) if random_num else n
    choice = rng.choice(n, num_copy, replace=False)
    S = recipient["image"].shape[0]

    ratio = rng.uniform(min_ratio, max_ratio)
    new_size = max(int(ratio * S), 8)
    sx = int(rng.integers(0, S - new_size + 1))
    sy = int(rng.integers(0, S - new_size + 1))

    pasted_img = np.zeros_like(recipient["image"])
    pasted_img[sy : sy + new_size, sx : sx + new_size] = resize_linear(donor["image"], (new_size, new_size))

    copied = []
    for i in choice:
        inst = donor["instances"][i]
        m = resize_nearest(inst.mask.astype(np.uint8), (new_size, new_size))
        full = np.zeros((S, S), bool)
        full[sy : sy + new_size, sx : sx + new_size] = m.astype(bool)
        if full.sum() == 0:
            continue
        copied.append(Instance(inst.box, full, inst.score))
    if not copied:
        return recipient

    rec_insts = recipient["instances"]
    if rec_insts:
        # drop copies that mostly cover an existing instance (IoY >= 0.5)
        kept = []
        for c in copied:
            ioy = max((np.logical_and(c.mask, r.mask).sum() / max(r.mask.sum(), 1) for r in rec_insts), default=0.0)
            if ioy < 0.5:
                kept.append(c)
        copied = kept
        if not copied:
            return recipient

    alpha = np.zeros((S, S), bool)
    for c in copied:
        alpha |= c.mask
    out_img = np.where(alpha[..., None], pasted_img, recipient["image"])

    out_insts = []
    for r in rec_insts:
        new_mask = r.mask & ~alpha
        if new_mask.sum() > 0:
            out_insts.append(Instance(r.box, new_mask, r.score))
    out_insts.extend(copied)
    for inst in out_insts:  # boxes from the masks (reference :236-241)
        ys, xs = np.nonzero(inst.mask)
        inst.box = np.array([xs.min(), ys.min(), xs.max() + 1, ys.max() + 1], np.float32)

    return {"image": out_img, "hw": recipient["hw"], "instances": out_insts,
            "is_single_object": recipient["is_single_object"]}


def to_lattice(sample: dict, max_gt: int, mask_res: int) -> dict:
    """A sample -> the fixed GT lattice the detector takes, images and masks
    quantized to uint8 (``n_gt_dropped``: instances beyond ``max_gt``)."""
    S = sample["image"].shape[0]
    boxes = np.zeros((max_gt, 4), np.float32)
    scores = np.zeros((max_gt,), np.float32)
    valid = np.zeros((max_gt,), bool)
    masks = np.zeros((max_gt, mask_res, mask_res), np.float32)
    for g, inst in enumerate(sample["instances"][:max_gt]):
        x1, y1, x2, y2 = np.clip(inst.box, 0, S)
        if x2 - x1 < 1 or y2 - y1 < 1:
            continue
        boxes[g] = [x1, y1, x2, y2]
        scores[g] = inst.score
        valid[g] = True
        crop = inst.mask[int(y1) : int(np.ceil(y2)), int(x1) : int(np.ceil(x2))]
        masks[g] = resize_linear(crop.astype(np.float32), (mask_res, mask_res))
    image = sample["image"]
    if image.dtype != np.uint8:
        image = np.clip(image * 255.0 + 0.5, 0, 255).astype(np.uint8)
    masks = np.clip(masks * 255.0 + 0.5, 0, 255).astype(np.uint8)
    return {
        "image": image,
        "image_hw": np.asarray(sample["hw"], np.float32),
        "gt_boxes": boxes,
        "gt_scores": scores,
        "gt_valid": valid,
        "gt_masks": masks,
        "is_single_object": np.float32(sample["is_single_object"]),
        "n_gt_dropped": max(len(sample["instances"]) - max_gt, 0),
    }


def detection_batch_iterator(dataset: DetectionDataset, batch_size: int, max_gt: int, mask_res: int,
                             rng: np.random.Generator, copy_paste: bool = True, **cp_kwargs):
    """Infinite fixed-shape batches, each image pasted into from the batch's
    reversed order (reference :125)."""
    n = len(dataset)
    while True:
        samples = []
        while len(samples) < batch_size:
            s = dataset.load(int(rng.integers(0, n)))
            if s is not None:
                samples.append(s)
        if copy_paste:
            samples = [copy_and_paste(d, r, rng, **cp_kwargs) for d, r in zip(samples[::-1], samples)]
        lattices = [to_lattice(s, max_gt, mask_res) for s in samples]
        batch = {k: np.stack([lat[k] for lat in lattices])
                 for k in ("image", "image_hw", "gt_boxes", "gt_scores", "gt_valid", "gt_masks", "is_single_object")}
        batch["images"] = batch.pop("image")
        batch["n_gt_dropped"] = sum(lat["n_gt_dropped"] for lat in lattices)
        yield batch
