"""Evaluation dataset registry (a copy of ``data/registry.py``).

The reference registers class-agnostic splits in a detectron2 catalog
(``cad/data/datasets/builtin.py:28-65``). Here the same names map to
(image_dir, annotation_json) templates under a single ``--data-root``;
the CAD eval CLI resolves ``--test-dataset cls_agnostic_coco*_val_17``
etc. through this table, matching the reference's zero-shot eval matrix
(COCO / COCO* / COCO20K / LVIS / VOC / KITTI / Objects365 / OpenImages).
"""

from __future__ import annotations

import os

# name -> (relative image dir, relative cls-agnostic annotation json)
EVAL_DATASETS = {
    # pseudo-label scoring on train2017 (reference builtin.py:37)
    "cls_agnostic_coco_train_17": ("coco/train2017", "coco/annotations/coco_cls_agnostic_instances_train2017.json"),
    "cls_agnostic_coco_val_17": ("coco/val2017", "coco/annotations/coco_cls_agnostic_instances_val2017.json"),
    "cls_agnostic_coco*_val_17": ("coco/val2017", "coco/annotations/coco_star_cls_agnostic_instances_val2017.json"),
    "cls_agnostic_coco20k": ("coco/train2014", "coco/annotations/coco20k_trainval_gt.json"),
    "cls_agnostic_lvis": ("coco", "coco/annotations/lvis1.0_cocofied_val_cls_agnostic.json"),
    "cls_agnostic_voc": ("voc/JPEGImages", "voc/annotations/trainvaltest_2007_cls_agnostic.json"),
    "cls_agnostic_kitti": ("kitti/image_2", "kitti/annotations/trainval_cls_agnostic.json"),
    "cls_agnostic_objects365": ("objects365/val", "objects365/annotations/zhiyuan_objv2_val_cls_agnostic.json"),
    "cls_agnostic_openimages": ("openimages/validation", "openimages/annotations/openimages_val_cls_agnostic.json"),
    # training split (stage-3 input)
    "coco_train_with_imagenet_train": ("", "cad_training_data/COCO_merged_IN_training_format.json"),
}


def resolve_dataset(name: str, data_root: str) -> tuple[str, str]:
    """-> (image_dir, annotation_json) absolute paths."""
    if name not in EVAL_DATASETS:
        raise KeyError(f"unknown dataset '{name}'; known: {sorted(EVAL_DATASETS)}")
    img_rel, ann_rel = EVAL_DATASETS[name]
    return os.path.join(data_root, img_rel), os.path.join(data_root, ann_rel)
