"""Stage-2 object scoring CLI on one CUDA device.

    python -m unmore_tpu_torch.cli.object_scoring --coco_image_dir DIR \\
        --coco_annotations instances.json --sdf_activation tanh --use_bg_sdf \\
        --raw_annotations_path results_reasoning/<run>/discovery_results.json \\
        --objectness_resume objectness.ckpt --binary_classifier_resume classifier.ckpt \\
        [--max_restarts 3]

Same flags and files as the JAX package's ``object_scoring.py``: it reads
the discovery JSON (image_id -> [N, 4] xyxy boxes), scores the boxes of
every image named there, and writes into the folder that holds that JSON
``configs_object_scoring.json``, a per-group ``scoring_partial_p0.jsonl``
stamped with an input fingerprint (a rerun skips the images it holds) and
``object_discovery_with_scores.json``, a COCO annotation list with the
existence, center, boundary and area sub-scores. Checkpoints are the JAX
trainers' msgpack files or torch ``.ckpt`` / state_dict files; without one
the models get seeded random weights. ``--max_restarts N`` runs the CLI as
a supervised child that is relaunched after a crash or a hang and resumes
from the partial file (``cli/supervisor.py``). Flags of the TPU build that
have no meaning here are accepted and ignored (see ``--help``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from unmore_tpu_torch.cli import supervisor
from unmore_tpu_torch.cli.object_reasoning import IGNORED


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--gpu_index", type=int, default=0, help="CUDA card to run on (with the default --device)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default cuda:<gpu_index>; 'cpu' runs the models on the CPU")
    p.add_argument("--seed", type=int, default=0, help="seed of the random weights used without checkpoints")
    p.add_argument("--run_name", type=str, default=None)
    p.add_argument("--image_size", type=int, default=128)
    p.add_argument("--backbone_type", type=str, default="dpt_large",
                   choices=["dpt_large", "dpt_base", "dpt_hybrid"])
    p.add_argument("--sdf_activation", type=str, default=None)
    p.add_argument("--use_bg_sdf", action="store_true")
    p.add_argument("--objectness_resume", type=str, default=None)
    p.add_argument("--binary_classifier_resume", type=str, default=None)
    p.add_argument("--start_idx", type=int, default=-1)
    p.add_argument("--end_idx", type=int, default=-1)
    p.add_argument("--dataset_split", type=str, default="test")
    p.add_argument("--dataset", type=str, default="COCO")
    p.add_argument("--raw_annotations_path", type=str, default=None,
                   help="discovery_results.json; the outputs go to its folder")
    p.add_argument("--coco_image_dir", type=str, required=True)
    p.add_argument("--coco_annotations", type=str, required=True)
    p.add_argument("--dtype", type=str, default="bfloat16", choices=["float32", "bfloat16"])
    p.add_argument("--canvas_size", type=int, default=640)
    p.add_argument("--crop_chunk", type=int, default=128, help="model microbatch")
    p.add_argument("--vit_pack", type=int, default=1, help=IGNORED)
    p.add_argument("--image_batch", type=int, default=4, help="images scored per shared proposal lattice")
    p.add_argument("--devices", type=int, default=-1, help=IGNORED + " (one device)")
    supervisor.add_flags(p, IGNORED)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.max_restarts > 0:
        # the result folder derives from --raw_annotations_path, so every
        # restart finds the partial file with no name to pin
        raw = list(argv) if argv is not None else sys.argv[1:]
        sys.exit(supervisor.run_supervised(__spec__.name, raw, args.max_restarts, args.hang_timeout_min))

    import torch

    from unmore_tpu_torch import resolve_device
    from unmore_tpu_torch.cli.common import (
        NpEncoder, build_classifier, build_objectness, device_name, init_random_variables, load_classifier_weights,
        load_objectness_weights, load_partial_jsonl, make_apply_fns, partial_fingerprint,
    )
    from unmore_tpu_torch.data.coco import COCOImages
    from unmore_tpu_torch.reasoning.scoring import ObjectScoringEngine, ScoringConfig

    device = resolve_device(device_name(args))
    # f32 means f32: no TF32 in cuDNN convolutions or cuBLAS matmuls
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    result_folder = "/".join(args.raw_annotations_path.split("/")[0:-1])
    with open(os.path.join(result_folder, "configs_object_scoring.json"), "w") as f:
        json.dump(vars(args), f, indent=2)
    print("result_folder", result_folder)
    with open(args.raw_annotations_path) as f:
        raw_annotations = json.load(f)
    print("# of loaded images", len(raw_annotations))

    objectness = build_objectness(args, args.dtype, device)
    classifier = build_classifier(args.dtype, device)
    init_random_variables(objectness, classifier, seed=args.seed)
    if args.objectness_resume:
        load_objectness_weights(objectness, args.objectness_resume)
    if args.binary_classifier_resume:
        load_classifier_weights(classifier, args.binary_classifier_resume)
    engine = ObjectScoringEngine(
        *make_apply_fns(objectness, classifier),
        ScoringConfig(crop_size=args.image_size, canvas_size=args.canvas_size,
                      crop_chunk=args.crop_chunk, image_batch=args.image_batch),
        device=device,
    )
    print(f"device {device} (images per dispatch: {engine.image_slots})")

    dataset = COCOImages(args.coco_image_dir, args.coco_annotations, args.start_idx, args.end_idx)
    # only images present in the discovery JSON are scored
    todo = [i for i in range(len(dataset)) if str(dataset.image_id(i)) in raw_annotations]
    part_path = os.path.join(result_folder, "scoring_partial_p0.jsonl")
    fp = partial_fingerprint(
        args, [args.objectness_resume, args.binary_classifier_resume, args.raw_annotations_path]
    )
    done_ids, kept = load_partial_jsonl(part_path, "anns", fingerprint=fp)
    out_annotations = [a for anns in kept.values() for a in anns]
    if done_ids:
        print(f"resuming: {len(done_ids)} images already scored in {part_path}; skipping them", flush=True)
        todo = [i for i in todo if int(dataset.image_id(i)) not in done_ids]

    t0 = time.time()
    t_device = t_host = 0.0
    B = engine.image_slots
    for base in range(0, len(todo), B):
        group = [dataset.get(i, dtype=np.uint8) for i in todo[base : base + B]]
        images = [g[0] for g in group]
        ids = [int(g[1]) for g in group]
        boxes_list = [np.asarray(raw_annotations[str(i)], np.float32).reshape(-1, 4) for i in ids]
        part_lines = []
        for image_id, anns in zip(ids, engine.score_batch(images, boxes_list, ids)):
            out_annotations.extend(anns)
            part_lines.append(json.dumps({"image_id": image_id, "anns": anns}, cls=NpEncoder))
        with open(part_path, "a") as f:
            f.write("".join(line + "\n" for line in part_lines))
        t_device += engine.last_timings.get("device_s", 0.0)
        t_host += engine.last_timings.get("host_s", 0.0)
        done = min(base + B, len(todo))
        print(f"[{done}/{len(todo)}] images {ids}: ({done / (time.time() - t0):.3f} img/s)", flush=True)
    if t_device:
        print(f"timing split: device {t_device:.1f}s, host tail {t_host:.1f}s "
              f"(host/device {t_host / t_device:.3f})", flush=True)

    print("# of final annotations", len(out_annotations))
    out_path = os.path.join(result_folder, "object_discovery_with_scores.json")
    with open(out_path, "w") as f:
        json.dump(out_annotations, f, indent=2, cls=NpEncoder)
    print("wrote", out_path)


if __name__ == "__main__":
    main()
