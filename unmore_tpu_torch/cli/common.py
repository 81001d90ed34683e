"""Shared CLI plumbing: model construction, weights, partial results.

Weights load from any of three formats, told apart by trying the msgpack
parse first:

* a msgpack checkpoint written by the JAX trainers (flax
  ``msgpack_serialize`` of the trainer state), read by
  :mod:`unmore_tpu_torch.train.checkpoints` and carried across by
  ``*_state_dict_from_flax``;
* a reference PyTorch ``.ckpt`` (``{'model_state_dict': ...}``);
* a plain state_dict saved by this package.

Without a checkpoint, :func:`init_random_variables` fills the models with
the JAX package's seeded flax init.
"""

from __future__ import annotations

import datetime
import hashlib
import json
import os
import sys

import numpy as np
import torch

from unmore_tpu_torch import resolve_device
from unmore_tpu_torch.cli import supervisor
from unmore_tpu_torch.models.convert import (
    classifier_state_dict_from_flax, load_objectness_state_dict, load_torch_checkpoint,
    objectness_state_dict_from_flax,
)
from unmore_tpu_torch.models.flax_init import init_like_flax
from unmore_tpu_torch.models.objectness import ObjectnessNet
from unmore_tpu_torch.models.resnet import BinaryClassifier
from unmore_tpu_torch.parallel import distributed, mesh
from unmore_tpu_torch.train.checkpoints import try_msgpack_checkpoint

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def build_objectness(args_like, dtype="bfloat16", device=None) -> ObjectnessNet:
    """ObjectnessNet in eval mode on ``device`` (None = cuda) in ``dtype``;
    in bf16 its norms keep float32 leaves (``models/norms.py``)."""
    model = ObjectnessNet(
        backbone_type=getattr(args_like, "backbone_type", "dpt_large"),
        sdf_activation=getattr(args_like, "sdf_activation", None),
        use_bg_sdf=getattr(args_like, "use_bg_sdf", False),
        # crops per packed encoder sequence: the crop chunks must divide by it
        vit_pack=getattr(args_like, "vit_pack", 1) or 1,
    )
    return model.to(resolve_device(device), DTYPES[dtype]).eval()


def build_classifier(dtype="bfloat16", device=None) -> BinaryClassifier:
    """The existence classifier in eval mode on ``device`` in ``dtype``; in
    bf16 its BatchNorms keep float32 parameters and statistics."""
    return BinaryClassifier().to(resolve_device(device), DTYPES[dtype]).eval()


def load_objectness_weights(model: ObjectnessNet, path: str):
    """A JAX msgpack checkpoint (its ``params``, or the whole tree when it
    is a bare param tree) or a torch checkpoint, into ``model``."""
    ckpt = try_msgpack_checkpoint(path)
    if ckpt is None:
        sd = load_torch_checkpoint(path)
    else:
        params = ckpt["params"] if "params" in ckpt else ckpt
        sd = objectness_state_dict_from_flax(params, model.sdf_activation, model.use_bg_sdf)
    load_objectness_state_dict(model, sd)


def load_classifier_weights(model: BinaryClassifier, path: str):
    """A JAX msgpack checkpoint (its ``params`` and ``batch_stats``) or a
    torch checkpoint, into ``model``."""
    ckpt = try_msgpack_checkpoint(path)
    if ckpt is None:
        sd = load_torch_checkpoint(path)
    else:
        if "params" in ckpt and "batch_stats" in ckpt:
            ckpt = {"params": ckpt["params"], "batch_stats": ckpt["batch_stats"]}
        sd = classifier_state_dict_from_flax(ckpt)
    model.load_state_dict(sd, strict=True)


def init_random_variables(*models: torch.nn.Module, seed: int = 0):
    """Fill each model, on its device, with the weights of the JAX package's
    ``init_random_variables`` for the same seed: flax's init of every model
    from the one root key ``PRNGKey(seed)`` (``models/flax_init.py``). A
    model's weights depend only on the seed, not on its dtype beyond
    rounding or on the other models."""
    for model in models:
        init_like_flax(model, seed)


def make_apply_fns(objectness: torch.nn.Module, classifier: torch.nn.Module):
    """(objectness_fn, classifier_fn) in the engine's calling convention."""

    def objectness_fn(crops, compute_center=True):
        return objectness(crops, compute_center=compute_center)

    def classifier_fn(crops):
        return classifier(crops)[:, 0]

    return objectness_fn, classifier_fn


# the stage-2 ranks meet once, at the gather after their shards, and one may
# finish its shard hours before another
STAGE2_GATHER_TIMEOUT = datetime.timedelta(hours=12)


def device_name(args) -> str:
    """The stage CLIs' device: ``--device``; else this rank's card over
    several ranks, else CUDA card ``--gpu_index``."""
    if args.device:
        return args.device
    if distributed.process_count() > 1:
        return str(distributed.local_device())
    return f"cuda:{args.gpu_index}"


def setup_device(args) -> torch.device:
    """:func:`device_name` resolved (a missing card raises) and made the
    current CUDA device; TF32 off, so that f32 means f32 in cuDNN
    convolutions and cuBLAS matmuls."""
    device = resolve_device(device_name(args))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return device


def launch_local_ranks(main, raw_argv: list, n_local: int) -> None:
    """Unless a launcher started this process: with ``n_local`` > 1 run
    ``main(raw_argv)`` in that many spawned ranks of this host and exit with
    their exit code; else return."""
    if n_local > 1 and not mesh.launched():
        sys.exit(mesh.launch(main, (raw_argv,), n_local))


def pin_run_name(args, raw_argv: list, default: str) -> list:
    """``raw_argv`` with ``--run_name`` set (``default`` when it is not
    given), so that every rank and every restart writes to one folder. In a
    rank that an outside launcher started the name must be given: the ranks
    could not agree on a time stamp."""
    if args.run_name is None:
        if mesh.launched():
            raise SystemExit("several ranks need --run_name, so that they write to one result folder")
        args.run_name = default
    return [*supervisor.strip_flag(raw_argv, "--run_name", True), "--run_name", args.run_name]


def partial_fingerprint(args_like, input_paths, skip=()):
    """Fingerprint of everything that determines a stage-2 CLI's per-image
    results: the parsed args (minus launch flags that cannot change
    outputs, and the port's ``--device``, which the JAX CLIs lack, so that
    one command line gets one fingerprint in both packages) plus the byte
    sizes of the input files. A changed checkpoint or input rotates the
    partial file instead of reusing stale results."""
    base_skip = {
        "max_restarts", "hang_timeout_min", "busy_hang_timeout_min",
        "devices", "gpu_index", "device",
    } | set(skip)
    cfg = {k: v for k, v in sorted(vars(args_like).items()) if k not in base_skip}
    for p in input_paths:
        try:
            cfg[f"_input:{p}"] = os.path.getsize(p)
        except (OSError, TypeError):
            cfg[f"_input:{p}"] = None
    blob = json.dumps(cfg, sort_keys=True, default=str).encode()
    return hashlib.sha1(blob).hexdigest()


def load_partial_jsonl(path: str, field: str, fingerprint: str | None = None):
    """Load a per-group durability JSONL written by the stage-2 CLIs.

    Each line is ``{"image_id": int, <field>: ...}``, one per processed
    image (an empty ``field`` still marks the image done). Returns
    ``(done_ids, kept)``, ``kept`` mapping image_id -> the non-empty value.
    Torn tail lines are skipped. A file stamped with a different
    ``fingerprint`` is rotated to ``<path>.stale`` and the run starts
    fresh; a matching or unstamped file gets the stamp.
    """
    done_ids, kept = set(), {}
    meta_fp = None
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue  # torn tail from a mid-append kill
                if "_meta" in rec:
                    meta_fp = rec.get("fingerprint")
                    continue
                if "image_id" not in rec:
                    continue
                image_id = int(rec["image_id"])
                done_ids.add(image_id)
                if rec[field]:
                    kept[image_id] = rec[field]
        if fingerprint is not None and meta_fp is not None and meta_fp != fingerprint:
            os.replace(path, path + ".stale")
            print(
                f"partial file {path} was produced under different inputs "
                f"(fingerprint mismatch); rotated to .stale and starting fresh",
                flush=True,
            )
            done_ids, kept, meta_fp = set(), {}, None
    if fingerprint is not None and meta_fp is None:
        with open(path, "a") as f:
            f.write(json.dumps({"_meta": 1, "fingerprint": fingerprint}) + "\n")
    return done_ids, kept


class NpEncoder(json.JSONEncoder):
    """JSON encoder accepting numpy scalars and arrays."""

    def default(self, obj):
        if isinstance(obj, np.integer):
            return int(obj)
        if isinstance(obj, np.floating):
            return float(obj)
        if isinstance(obj, np.bool_):
            return bool(obj)
        if isinstance(obj, np.ndarray):
            return obj.tolist()
        return super().default(obj)
