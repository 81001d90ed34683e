"""Rank bodies of the port's two-rank CPU worlds (``tests/test_torch_parallel*.py``).

Each function runs in a rank spawned by ``unmore_tpu_torch.parallel.mesh.launch``
and imports torch and the port only: the test process writes the inputs
(weights, batches) into ``folder`` with numpy and torch and reads back what
each rank writes there, ``rank<r>.pt``.
"""

import os

import numpy as np
import torch

from unmore_tpu_torch.parallel import distributed as dist

GROUP_TIMEOUT_S = 120  # a collective that waits longer fails the world, and its test


def _init():
    import datetime

    torch.set_num_threads(2)
    dist.initialize(backend="gloo", timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))


def _rows(batch: dict) -> dict:
    """This rank's rows of a global batch of numpy arrays, as tensors."""
    n, r = dist.process_count(), dist.process_index()
    b = len(next(iter(batch.values()))) // n
    return {k: torch.from_numpy(np.ascontiguousarray(v[r * b:(r + 1) * b])) for k, v in batch.items()}


def _digest(*tensors) -> str:
    """sha1 of the tensors' bytes: equal on two ranks only when every bit is."""
    import hashlib

    h = hashlib.sha1()
    for t in tensors:
        h.update(t.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def _weights(out: dict, key: str, model):
    """Every rank writes the digest of ``model``'s state; rank 0 the state too."""
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    out[f"{key}_digest"] = _digest(*state.values())
    if dist.is_main():
        out[key] = state


def steps(folder: str):
    """Object gather, barrier and a main-only write; then two steps each of
    the classifier (SGD, f32), the objectness trainer (SGD, f32) and the CAD
    (f64, weights from ``init_like_flax``: one finite step drawing the global
    batch's draws, one whose loss is NaN on rank 1 only). Rank 0 writes the
    states, both ranks their digests."""
    from unmore_tpu_torch.config import OptimConfig, TrainObjectnessConfig
    from unmore_tpu_torch.detector.cascade_rcnn import CascadeMaskRCNN, DetectorConfig
    from unmore_tpu_torch.models.objectness import ObjectnessNet
    from unmore_tpu_torch.models.resnet import BinaryClassifier
    from unmore_tpu_torch.train.classifier import ClassifierTrainer
    from unmore_tpu_torch.train.detector import DetectorTrainer
    from unmore_tpu_torch.train.objectness import ObjectnessTrainer
    from unmore_tpu_torch.train.optim import init_like_flax

    _init()
    rank = dist.process_index()
    inputs = torch.load(os.path.join(folder, "inputs.pt"), weights_only=False)
    out = {"gathered": dist.all_gather_objects({"rank": rank, "rows": dist.host_shard_indices(5).tolist()})}
    if dist.is_main():
        with open(os.path.join(folder, "main_writes.txt"), "a") as f:
            f.write(f"rank {rank}\n")
    dist.barrier("written")
    out["main_writes_seen"] = open(os.path.join(folder, "main_writes.txt")).read()

    model = BinaryClassifier(stage_blocks=inputs["classifier_blocks"])
    model.load_state_dict(inputs["classifier"])
    trainer = ClassifierTrainer(model, OptimConfig(**inputs["classifier_optim"]))
    batch = _rows(inputs["classifier_batch"])
    out["classifier_loss"] = [float(trainer.train_step(batch)["loss"]) for _ in range(2)]
    _weights(out, "classifier", model)

    cfg = TrainObjectnessConfig(**inputs["objectness_cfg"])
    model = ObjectnessNet("dpt_base", "tanh", True, **inputs["objectness_kwargs"])
    model.load_state_dict(inputs["objectness"])
    trainer = ObjectnessTrainer(model, cfg, dtype="float32")
    batch = _rows(inputs["objectness_batch"])
    out["objectness_losses"] = [{k: float(v) for k, v in trainer.train_step(batch).items()} for _ in range(2)]
    _weights(out, "objectness", model)

    model = CascadeMaskRCNN(DetectorConfig(**inputs["cad_cfg"]))
    init_like_flax(model, inputs["cad_seed"])
    trainer = DetectorTrainer(model.double(), DetectorConfig(**inputs["cad_cfg"]), inputs["cad_optim"],
                              dtype="float32")
    losses = [float(trainer.train_step(_rows(inputs["cad_batch"]))["total"])]
    params, stats = trainer.flat.data.clone(), trainer.stats.clone()
    losses.append(float(trainer.train_step(_rows(inputs["cad_bad_batch"]))["total"]))
    out["cad"] = {"losses": losses, "stats": stats, "skipped": int(trainer.skipped), "rng": trainer.rng.copy(),
                  "kept": torch.equal(trainer.flat.data, params) and torch.equal(trainer.stats, stats),
                  "digest": _digest(params, stats, trainer.opt.trace)}
    if dist.is_main():
        out["cad"]["params"] = params
    torch.save(out, os.path.join(folder, f"rank{rank}.pt"))


def tiny_objectness(args_like, dtype="bfloat16", device=None):
    """The stage-2 CLIs' objectness net at test widths (``cli.common.build_objectness``'s signature)."""
    from unmore_tpu_torch.cli import common
    from unmore_tpu_torch.models.objectness import ObjectnessNet
    from unmore_tpu_torch.models.vit import ViTConfig

    model = ObjectnessNet("dpt_base", args_like.sdf_activation, args_like.use_bg_sdf,
                          vit_config=ViTConfig(depth=2, dim=32, heads=2, mlp_dim=64, pretrain_grid=4),
                          hooks=(0, 1, 1, 1), widths=(8, 16, 24, 24), features=16)
    return model.to(common.resolve_device(device), common.DTYPES[dtype]).eval()


def tiny_classifier(dtype="bfloat16", device=None):
    from unmore_tpu_torch.cli import common
    from unmore_tpu_torch.models.resnet import BinaryClassifier

    return BinaryClassifier(stage_blocks=(1, 1, 1, 1)).to(common.resolve_device(device), common.DTYPES[dtype]).eval()


def stage2(folder: str, discovery_argv: list, scoring_argv: list):
    """The discovery CLI, then the scoring CLI on its merged boxes, with
    :func:`tiny_objectness` and :func:`tiny_classifier` in place of the full
    models; then rank 0 cuts its discovery partial file to its stamp, first
    record and a torn line, and both ranks run the discovery CLI again,
    which must resume."""
    import json

    from unmore_tpu_torch.cli import common, object_reasoning, object_scoring

    _init()
    common.build_objectness, common.build_classifier = tiny_objectness, tiny_classifier
    os.chdir(folder)
    object_reasoning.main(discovery_argv)
    object_scoring.main(scoring_argv)
    dist.barrier("first run")
    run = os.path.join("results_reasoning", discovery_argv[discovery_argv.index("--run_name") + 1])
    first = json.load(open(os.path.join(run, "discovery_results.json"))) if dist.is_main() else None
    dist.barrier("read")
    if dist.is_main():
        part = os.path.join(run, "partial_results_p0.jsonl")
        lines = open(part).read().splitlines()
        with open(part, "w") as f:
            f.write("\n".join(lines[:2]) + "\n" + lines[2][: len(lines[2]) // 2])
    dist.barrier("cut")
    object_reasoning.main(discovery_argv)
    if dist.is_main():
        again = json.load(open(os.path.join(run, "discovery_results.json")))
        with open("resumed.json", "w") as f:
            json.dump({"first": first, "again": again}, f)
