"""Stage-2 object discovery CLI on one or several CUDA cards.

    python -m unmore_tpu_torch.cli.object_reasoning --coco_image_dir DIR \\
        --coco_annotations instances.json --sdf_activation tanh --use_bg_sdf \\
        --objectness_resume objectness.ckpt --binary_classifier_resume classifier.ckpt \\
        [--max_restarts 3]

Same flags and files as the JAX package's ``object_reasoning.py``:
``results_reasoning/<run_name>/configs_object_reasoning.json``, a
per-group ``partial_results_p<rank>.jsonl`` stamped with an input
fingerprint (a rerun skips the images it holds), ``discovery_results.json``
(image_id -> [N, 4] xyxy boxes) and ``stage_timings.json``. ``--devices N``
runs N ranks, one a card (-1, the default: every visible card; with
``--device cpu``, N ranks on the CPU), spawned here unless a launcher
(torchrun, or the JAX package's ``JAX_*`` variables) started them; each
rank discovers its strided shard of the images and rank 0 writes the
merged files. Checkpoints are the JAX
trainers' msgpack files or torch ``.ckpt`` / state_dict files; without one
the model gets seeded random weights. ``--max_restarts N`` runs the CLI as
a supervised child that is relaunched after a crash or a hang and resumes
from the partial file (``cli/supervisor.py``). Flags of the TPU build that
have no meaning here are accepted and ignored (see ``--help``).
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import sys
import time

import numpy as np

from unmore_tpu_torch.cli import supervisor

IGNORED = "accepted for compatibility and ignored by this build"


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--gpu_index", type=int, default=0,
                   help="CUDA card of a one-rank run (--devices 1, with the default --device)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device of every rank; default: the rank's card (cuda:<gpu_index> on one rank); "
                        "'cpu' runs the plain versions of the kernels")
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
    p.add_argument("--class_score_thres", type=float, default=0.1)
    p.add_argument("--center_score_max_thres", type=float, default=0.009)
    p.add_argument("--analyze_cc", action="store_true")
    p.add_argument("--max_sdf_thres", type=float, default=0.5)
    p.add_argument("--max_shrink_threshold", type=float, default=16)
    p.add_argument("--delta_ratio", type=float, default=0.5)
    p.add_argument("--n_round", type=int, default=50)
    p.add_argument("--proposal_area_thres", type=int, default=50)
    p.add_argument("--coco_image_dir", type=str, required=True)
    p.add_argument("--coco_annotations", type=str, required=True)
    p.add_argument("--dtype", type=str, default="bfloat16", choices=["float32", "bfloat16"])
    p.add_argument("--canvas_size", type=int, default=640)
    p.add_argument("--max_proposals", type=int, default=2048)
    p.add_argument("--max_active", type=int, default=1024)
    p.add_argument("--max_splits", type=int, default=2048,
                   help="per-image split/CC lattice capacity; raise when the stats "
                        "lines show split_overflow > 0 on dense scenes")
    p.add_argument("--image_batch", type=int, default=1, help="images discovered per shared proposal lattice")
    p.add_argument("--crop_chunk", type=int, default=256, help="model microbatch while enough proposals are live")
    p.add_argument("--crop_chunk_tail", type=int, default=32, help="model microbatch for the live remainder")
    p.add_argument("--exist_chunk", type=int, default=1024, help="classifier microbatch")
    p.add_argument("--reference_rounds", action="store_true",
                   help="reference boundary semantics: re-predict converged boxes every "
                        "round instead of the sticky-convergence default")
    p.add_argument("--pallas_decode", choices=["auto", "on", "off"], default="auto",
                   help=IGNORED + " (the CUDA decode kernel runs for CUDA tensors)")
    p.add_argument("--boundary_segment", type=int, default=0, help=IGNORED)
    p.add_argument("--vit_pack", type=int, default=1,
                   help=IGNORED + " (ViT sequence packing: every crop runs its own encoder sequence)")
    p.add_argument("--devices", type=int, default=-1,
                   help="cards to run on, one rank each (-1: every visible card); ranks on the CPU with --device cpu")
    supervisor.add_flags(p, IGNORED)
    return p.parse_args(argv)


def default_run_name(args) -> str:
    return datetime.datetime.now().strftime("%y%m%d_%H%M%S") + "_" + args.dataset + "_" + args.dataset_split


def main(argv=None):
    args = parse_args(argv)
    raw = list(argv) if argv is not None else sys.argv[1:]

    from unmore_tpu_torch.cli.common import launch_local_ranks, pin_run_name
    from unmore_tpu_torch.parallel import mesh

    n_local = 1 if mesh.launched() else mesh.local_ranks(args.devices, args.device)
    if n_local > 1 or args.max_restarts > 0 or mesh.launched():
        # pin the run name, so that every rank and every restart finds its
        # partial file in one result folder, not a new timestamped one
        raw = pin_run_name(args, raw, default_run_name(args))
    launch_local_ranks(main, raw, n_local)
    if args.max_restarts > 0:  # each rank supervises its own child
        sys.exit(supervisor.run_supervised(__spec__.name, raw, args.max_restarts, args.hang_timeout_min))

    from unmore_tpu_torch.cli.common import (
        STAGE2_GATHER_TIMEOUT, NpEncoder, build_classifier, build_objectness, init_random_variables,
        load_classifier_weights, load_objectness_weights, load_partial_jsonl, make_apply_fns,
        partial_fingerprint, setup_device,
    )
    from unmore_tpu_torch.data.coco import COCOImages
    from unmore_tpu_torch.parallel import distributed as dist
    from unmore_tpu_torch.reasoning.engine import ObjectDiscoveryEngine, ReasoningConfig
    from unmore_tpu_torch.utils import tracing

    # the ranks' group is made at the gather after their shards, so that a
    # restarted rank still joins it
    dist.initialize(timeout=STAGE2_GATHER_TIMEOUT)
    device = setup_device(args)

    if args.run_name is None:
        args.run_name = default_run_name(args)
    if args.start_idx != -1 and args.end_idx != -1:
        args.run_name += f"_{args.start_idx}_{args.end_idx}"
    result_folder = os.path.join("results_reasoning", args.run_name)
    os.makedirs(result_folder, exist_ok=True)
    if dist.is_main():
        with open(os.path.join(result_folder, "configs_object_reasoning.json"), "w") as f:
            json.dump(vars(args), f, indent=2)
    print("result_folder", result_folder)

    objectness = build_objectness(args, args.dtype, device)
    classifier = build_classifier(args.dtype, device)
    init_random_variables(objectness, classifier, seed=args.seed)
    if args.objectness_resume:
        load_objectness_weights(objectness, args.objectness_resume)
    if args.binary_classifier_resume:
        load_classifier_weights(classifier, args.binary_classifier_resume)
    objectness_fn, classifier_fn = make_apply_fns(objectness, classifier)

    cfg = ReasoningConfig(
        crop_size=args.image_size,
        canvas_size=args.canvas_size,
        image_batch=args.image_batch,
        max_proposals=args.max_proposals,
        max_active=args.max_active,
        max_splits=args.max_splits,
        crop_chunk=args.crop_chunk,
        crop_chunk_tail=args.crop_chunk_tail,
        exist_chunk=args.exist_chunk,
        class_score_thres=args.class_score_thres,
        center_score_max_thres=args.center_score_max_thres,
        analyze_cc=args.analyze_cc,
        max_sdf_thres=args.max_sdf_thres,
        max_shrink_threshold=args.max_shrink_threshold,
        delta_ratio=args.delta_ratio,
        n_round=args.n_round,
        proposal_area_thres=args.proposal_area_thres,
        sticky_convergence=not args.reference_rounds,
    )
    engine = ObjectDiscoveryEngine(objectness_fn, classifier_fn, cfg, device=device)
    print(f"rank {dist.process_index()}/{dist.process_count()} on {device} "
          f"(images per dispatch: {engine.image_slots})")

    dataset = COCOImages(args.coco_image_dir, args.coco_annotations, args.start_idx, args.end_idx)
    indices = dist.host_shard_indices(len(dataset))
    part_path = os.path.join(result_folder, f"partial_results_p{dist.process_index()}.jsonl")
    fp = partial_fingerprint(args, [args.objectness_resume, args.binary_classifier_resume])
    done_ids, results = load_partial_jsonl(part_path, "boxes", fingerprint=fp)
    if done_ids:
        print(f"resuming: {len(done_ids)} images already discovered in {part_path}; skipping them", flush=True)
        indices = np.asarray([i for i in indices if int(dataset.image_id(int(i))) not in done_ids], dtype=np.int64)

    # spans and counters on (utils/tracing.py): stage_timings.json gets the
    # engine's phases on the device's clock beside load and discover
    tracing.enable()
    try:
        t0 = time.time()
        B = engine.image_slots
        for base in range(0, len(indices), B):
            with tracing.span("load"):
                group = [dataset.get(int(i), dtype=np.uint8) for i in indices[base : base + B]]
            with tracing.span("discover"):
                outs = engine.discover_batch([g[0] for g in group])
            part_lines = []
            for (_, image_id), out in zip(group, outs):
                boxes = np.asarray(out["boxes"]).tolist() if len(out["boxes"]) else []
                if boxes:
                    results[int(image_id)] = boxes
                part_lines.append(json.dumps({"image_id": int(image_id), "boxes": boxes}, cls=NpEncoder))
                # the log line keeps the JAX package's format (scripts/parse_discovery_stats.py)
                log_stats = {k: v for k, v in out["stats"].items() if k != "trace"}
                print(
                    f"[{base + len(group)}/{len(indices)}] image {image_id}: {log_stats} "
                    f"({(base + len(group)) / (time.time() - t0):.3f} img/s)",
                    flush=True,
                )
            with open(part_path, "a") as f:
                f.write("".join(line + "\n" for line in part_lines))

        # rank 0 writes the one contract JSON, filled in rank order
        merged = {}
        for part in dist.all_gather_objects(results):
            merged.update(part)
        if dist.is_main():
            out_path = os.path.join(result_folder, "discovery_results.json")
            with open(out_path, "w") as f:
                json.dump(merged, f, indent=2, cls=NpEncoder)
            tracing.dump(os.path.join(result_folder, "stage_timings.json"))
            print("wrote", out_path)
    finally:
        tracing.disable()


if __name__ == "__main__":
    main()
