"""Detector inference -> COCO predictions (port of ``detector/evaluation.py``).

Images are resized into the square canvas as the JAX package resizes them
(``cv2.resize(INTER_LINEAR)``, here the host library ``csrc/labels.cpp``:
OpenCV's fixed-point path for uint8, bit for bit), a batch runs through
:func:`~unmore_tpu_torch.detector.cascade_rcnn.detector_forward_inference`
on the device, and the detections go back to image coordinates; each
28x28 mask's probabilities are pasted into the full image, thresholded at
0.5 and RLE-encoded by the host library ``csrc/paste.cpp``. Metrics come
from :mod:`unmore_tpu_torch.evaluation.coco_eval`.
"""

from __future__ import annotations

import numpy as np
import torch

from unmore_tpu_torch import resolve_device
from unmore_tpu_torch.detector.cascade_rcnn import no_stage, detector_forward_inference
from unmore_tpu_torch.ops.labels import resize_linear, resize_linear_u8
from unmore_tpu_torch.ops.paste import paste_prob_rle


def prepare_eval_image(image: np.ndarray, canvas_size: int, min_size: int = 800):
    """Resize the shorter side to ``min_size`` (capped by the canvas), pad to
    a square uint8 canvas. Returns (canvas [S, S, 3] uint8, scale, (nh, nw))."""
    h0, w0 = image.shape[:2]
    scale = min_size / min(h0, w0)
    scale = min(scale, canvas_size / max(h0, w0))
    nh, nw = int(round(h0 * scale)), int(round(w0 * scale))
    if image.dtype == np.uint8:
        resized = resize_linear_u8(image, (nh, nw))
    else:
        resized = resize_linear(np.asarray(image, np.float32), (nh, nw))
        resized = np.clip(resized * 255.0 + 0.5, 0, 255).astype(np.uint8)
    canvas = np.zeros((canvas_size, canvas_size, 3), np.uint8)
    canvas[:nh, :nw] = resized
    return canvas, scale, (nh, nw)


def detections_to_coco(dets: dict, image_id, scale: float, orig_hw: tuple[int, int], batch_index: int = 0,
                       with_masks: bool = True, mask_thresh: float = 0.5) -> list[dict]:
    """One image's fixed-lattice detections (numpy) -> COCO annotation dicts."""
    boxes = np.asarray(dets["boxes"][batch_index])
    scores = np.asarray(dets["scores"][batch_index])
    valid = np.asarray(dets["valid"][batch_index])
    masks = np.asarray(dets["masks"][batch_index]) if with_masks and "masks" in dets else None
    h0, w0 = orig_hw
    anns = []
    for i in np.nonzero(valid)[0]:
        x1, y1, x2, y2 = boxes[i] / scale
        x1, x2 = np.clip([x1, x2], 0, w0)
        y1, y2 = np.clip([y1, y2], 0, h0)
        if x2 - x1 < 1e-3 or y2 - y1 < 1e-3:
            continue
        ann = {
            "image_id": image_id,
            "category_id": 1,
            "score": float(scores[i]),
            "bbox": [float(x1), float(y1), float(x2 - x1), float(y2 - y1)],
        }
        if masks is not None:
            ann["segmentation"] = paste_prob_rle(masks[i].astype(np.float32), np.array([x1, y1, x2, y2]), h0, w0,
                                                 mask_thresh)
        anns.append(ann)
    return anns


class DetectorEvaluator:
    """Batched inference over images -> COCO predictions, on one device.

    ``model`` is a :class:`~unmore_tpu_torch.detector.cascade_rcnn.CascadeMaskRCNN`
    in eval mode on ``device`` (None = cuda) holding its weights."""

    def __init__(self, model, cfg, min_size_test: int = 800, device=None):
        self.model = model
        self.cfg = cfg
        self.min_size_test = min_size_test
        self.device = resolve_device(device)

    def predict_image(self, image: np.ndarray, image_id) -> list[dict]:
        return self.predict_batch([image], [image_id])

    def predict_batch(self, images: list, image_ids: list, stage=no_stage) -> list[dict]:
        """One inference call over a stack of canvases; returns the
        concatenated COCO annotation dicts. ``stage(name)`` wraps each part
        ("backbone", "rpn", "cascade", "mask", "paste"), for timing."""
        S = self.cfg.image_size
        B = len(images)
        canvases = np.zeros((B, S, S, 3), np.uint8)
        hw = np.ones((B, 2), np.float32)
        scales = []
        for i, image in enumerate(images):
            canvases[i], scale, (nh, nw) = prepare_eval_image(image, S, self.min_size_test)
            hw[i] = (nh, nw)
            scales.append(scale)
        out = detector_forward_inference(
            self.model, self.cfg, torch.from_numpy(canvases).to(self.device), torch.from_numpy(hw).to(self.device),
            stage=stage,
        )
        with stage("paste"):
            dets = {k: v.cpu().numpy() for k, v in out.items()}
            anns = []
            for i, image_id in enumerate(image_ids):
                anns.extend(detections_to_coco(dets, image_id, scales[i], images[i].shape[:2], batch_index=i,
                                               with_masks=self.cfg.mask_on))
        return anns
