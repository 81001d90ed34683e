"""COCO image dataset reader (pure JSON + PIL; no pycocotools needed).

Reproduces reference ``datasets.py:385-464``: filename<->image_id maps
built from the instances JSON, images listed from the directory and
sorted by filename, optional [start_idx, end_idx) sharding for manual
job splitting (kept for CLI compatibility).

PIL is imported only by the functions that decode an image, so the rest of
the package runs where PIL is missing.
"""

from __future__ import annotations

import json
import os

import numpy as np


class COCOImages:
    def __init__(self, image_dir: str, annotations_path: str, start_idx: int = -1, end_idx: int = -1):
        self.image_dir = image_dir
        with open(annotations_path) as f:
            gt = json.load(f)
        self.gt = gt
        self.fname_to_id = {im["file_name"]: im["id"] for im in gt["images"]}
        self.id_to_fname = {im["id"]: im["file_name"] for im in gt["images"]}
        self.id_to_info = {im["id"]: im for im in gt["images"]}
        # the JSON is the source of truth (reference datasets.py:404-426
        # builds its maps from the instances JSON): ignore directory
        # files absent from it, so a subset annotations file over a full
        # image directory evaluates the subset instead of KeyError-ing.
        # Bit-identical when the JSON covers every file in the dir.
        names = sorted(set(os.listdir(image_dir)) & set(self.fname_to_id))
        if start_idx != -1 and end_idx != -1:
            names = names[start_idx:end_idx]
        self.filenames = names

    def __len__(self):
        return len(self.filenames)

    def get(self, idx: int, dtype=np.float32):
        """-> (image [H, W, 3] float32 in [0,1] — or uint8 0-255 with
        ``dtype=np.uint8``, the low-bandwidth wire format the engines
        decode on device — and image_id)."""
        from PIL import Image

        fname = self.filenames[idx]
        img = Image.open(os.path.join(self.image_dir, fname)).convert("RGB")
        arr = np.asarray(img, np.uint8)
        if dtype != np.uint8:
            arr = arr.astype(np.float32) / 255.0
        return arr, self.fname_to_id[fname]

    def image_id(self, idx: int) -> int:
        """image_id for index ``idx`` without decoding the image."""
        return self.fname_to_id[self.filenames[idx]]

    def get_by_id(self, image_id: int):
        from PIL import Image

        fname = self.id_to_fname[image_id]
        img = Image.open(os.path.join(self.image_dir, fname)).convert("RGB")
        return np.asarray(img, np.float32) / 255.0, image_id
