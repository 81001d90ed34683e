"""The port's discovery CLI and its plumbing, on the CPU with tiny models.

The CLI keeps the JAX package's file contracts: configs JSON, a per-group
partial JSONL stamped with an input fingerprint (a rerun skips what it
holds), ``discovery_results.json`` and ``stage_timings.json``. Weights load
from a reference-format ``.ckpt`` and from a plain port state_dict.
"""

import json
import os

import numpy as np
import pytest
import torch

from unmore_tpu.cli import common as jax_common
from unmore_tpu_torch.cli import common, object_reasoning
from unmore_tpu_torch.models.objectness import ObjectnessNet
from unmore_tpu_torch.models.resnet import BinaryClassifier
from unmore_tpu_torch.models.vit import ViTConfig

TINY = dict(vit_config=ViTConfig(depth=2, dim=32, heads=2, mlp_dim=64, pretrain_grid=4),
            hooks=(0, 1, 1, 1), widths=(8, 16, 24, 24), features=16)


def tiny_objectness(args_like, dtype="bfloat16", device=None):
    model = ObjectnessNet("dpt_base", args_like.sdf_activation, args_like.use_bg_sdf, **TINY)
    return model.to(common.resolve_device(device), common.DTYPES[dtype]).eval()


def tiny_classifier(dtype="bfloat16", device=None):
    return BinaryClassifier(stage_blocks=(1, 1, 1, 1)).to(common.resolve_device(device), common.DTYPES[dtype]).eval()


@pytest.fixture
def coco(tmp_path):
    from PIL import Image

    rng = np.random.RandomState(0)
    (tmp_path / "images").mkdir()
    images = []
    for i, (h, w) in enumerate([(64, 96), (80, 80), (48, 64)]):
        Image.fromarray((rng.rand(h, w, 3) * 255).astype(np.uint8)).save(tmp_path / "images" / f"{i}.png")
        images.append({"id": 10 + i, "file_name": f"{i}.png", "height": h, "width": w})
    with open(tmp_path / "instances.json", "w") as f:
        json.dump({"images": images, "annotations": [], "categories": []}, f)
    return tmp_path


ARGS = ["--device", "cpu", "--dtype", "float32", "--sdf_activation", "tanh", "--use_bg_sdf", "--analyze_cc",
        "--image_size", "32", "--canvas_size", "96", "--max_proposals", "64", "--max_splits", "64",
        "--max_active", "64", "--crop_chunk", "32", "--crop_chunk_tail", "16", "--exist_chunk", "64",
        "--n_round", "2", "--class_score_thres", "0", "--run_name", "smoke", "--devices", "1",
        # flags of the TPU build: accepted and ignored
        "--pallas_decode", "on", "--boundary_segment", "4", "--vit_pack", "2", "--max_restarts", "0"]


def test_cli_writes_the_contract_files_and_resumes(coco, monkeypatch):
    monkeypatch.setattr(common, "build_objectness", tiny_objectness)
    monkeypatch.setattr(common, "build_classifier", tiny_classifier)
    monkeypatch.chdir(coco)
    argv = ["--coco_image_dir", "images", "--coco_annotations", "instances.json", *ARGS]
    object_reasoning.main(argv)
    out = coco / "results_reasoning" / "smoke"
    assert sorted(os.listdir(out)) == [
        "configs_object_reasoning.json", "discovery_results.json", "partial_results_p0.jsonl", "stage_timings.json",
    ]
    lines = [json.loads(x) for x in (out / "partial_results_p0.jsonl").read_text().splitlines()]
    assert lines[0]["_meta"] == 1 and len(lines) == 4
    assert sorted(r["image_id"] for r in lines[1:]) == [10, 11, 12]
    results = json.loads((out / "discovery_results.json").read_text())
    for boxes in results.values():
        assert np.asarray(boxes).ndim == 2 and np.asarray(boxes).shape[1] == 4
    assert json.loads((out / "configs_object_reasoning.json").read_text())["image_size"] == 32

    # a rerun with the same inputs skips every image and keeps the results
    object_reasoning.main(argv)
    assert len((out / "partial_results_p0.jsonl").read_text().splitlines()) == 4
    assert json.loads((out / "discovery_results.json").read_text()) == results


def test_help_names_the_ignored_flags(capsys):
    with pytest.raises(SystemExit):
        object_reasoning.parse_args(["--help"])
    text = " ".join(capsys.readouterr().out.split())
    for flag in ("--pallas_decode", "--boundary_segment", "--vit_pack", "--devices", "--gpu_index",
                 "--max_restarts", "--hang_timeout_min", "--busy_hang_timeout_min"):
        assert flag in text
    # four flags of the TPU build; --max_restarts and --hang_timeout_min supervise the run, and
    # --devices and --gpu_index pick the cards
    assert text.count("ignored by this build") >= 4


def test_partial_plumbing_matches_the_jax_package(tmp_path):
    class Args:
        pass

    args = Args()
    args.seed, args.max_restarts, args.image_size = 3, 2, 128
    p = str(tmp_path / "ckpt")
    with open(p, "wb") as f:
        f.write(b"12345")
    assert common.partial_fingerprint(args, [p, None]) == jax_common.partial_fingerprint(args, [p, None])
    for mod, name in ((common, "port.jsonl"), (jax_common, "jax.jsonl")):
        path = str(tmp_path / name)
        with open(path, "w") as f:
            f.write('{"image_id": 1, "boxes": [[0, 0, 1, 1]]}\n{"image_id": 2, "boxes": []}\n')
        assert mod.load_partial_jsonl(path, "boxes", fingerprint="a") == ({1, 2}, {1: [[0, 0, 1, 1]]})
        with open(path, "a") as f:
            f.write('{"image_id": 3, "boxes": [[0, 0, 2, 2]]}\n{"image_')  # torn tail of a killed append
        assert mod.load_partial_jsonl(path, "boxes", fingerprint="a")[0] == {1, 2, 3}
        # a different fingerprint rotates the file and starts fresh
        assert mod.load_partial_jsonl(path, "boxes", fingerprint="b") == (set(), {})
        assert os.path.exists(path + ".stale")
    assert json.dumps({"a": np.float32(1.5), "b": np.arange(2)}, cls=common.NpEncoder) == '{"a": 1.5, "b": [0, 1]}'


@pytest.mark.parametrize("wrap", [True, False])
def test_weights_load_from_reference_ckpt_and_port_state_dict(tmp_path, wrap):
    class Args:
        sdf_activation, use_bg_sdf = "tanh", True

    src_obj, src_cls = tiny_objectness(Args, "float32", "cpu"), tiny_classifier("float32", "cpu")
    common.init_random_variables(src_obj, src_cls, seed=4)
    for model, name in ((src_obj, "obj.ckpt"), (src_cls, "cls.ckpt")):
        sd = model.state_dict()
        torch.save({"model_state_dict": sd, "epoch": 3} if wrap else sd, tmp_path / name)
    obj, cls = tiny_objectness(Args, "float32", "cpu"), tiny_classifier("float32", "cpu")
    common.load_objectness_weights(obj, str(tmp_path / "obj.ckpt"))
    common.load_classifier_weights(cls, str(tmp_path / "cls.ckpt"))
    for a, b in ((obj, src_obj), (cls, src_cls)):
        for (k, v), (_, w) in zip(a.state_dict().items(), b.state_dict().items()):
            torch.testing.assert_close(v, w, rtol=0, atol=0, msg=k)


def test_random_weights_depend_only_on_the_seed():
    class Args:
        sdf_activation, use_bg_sdf = "tanh", True

    a, b = tiny_objectness(Args, "float32", "cpu"), tiny_objectness(Args, "bfloat16", "cpu")
    common.init_random_variables(a, seed=1)
    common.init_random_variables(tiny_classifier("float32", "cpu"), b, seed=1)
    for (k, v), (_, w) in zip(a.state_dict().items(), b.state_dict().items()):
        torch.testing.assert_close(v.to(torch.bfloat16), w, rtol=0, atol=0, msg=k)


def _jax_cli(name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"jax_{name}", os.path.join(os.path.dirname(__file__), "..", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


STAGE2_ARGV = ["--coco_image_dir", "images", "--coco_annotations", "instances.json", "--sdf_activation", "tanh",
               "--use_bg_sdf", "--run_name", "r", "--gpu_index", "1"]


@pytest.mark.parametrize("cli", ["object_reasoning", "object_scoring"])
def test_one_command_line_has_one_fingerprint_in_both_packages(cli, tmp_path):
    import importlib

    port = importlib.import_module(f"unmore_tpu_torch.cli.{cli}")
    ckpt = tmp_path / "c.ckpt"
    ckpt.write_bytes(b"123")
    argv = STAGE2_ARGV + (["--raw_annotations_path", "r/discovery_results.json"] if cli == "object_scoring" else [])
    inputs = [str(ckpt), None]
    want = jax_common.partial_fingerprint(_jax_cli(cli).parse_args(argv), inputs)
    for extra in ([], ["--device", "cpu"], ["--device", "cuda:3"]):
        assert common.partial_fingerprint(port.parse_args(argv + extra), inputs) == want


@pytest.mark.parametrize("cli", ["object_reasoning", "object_scoring"])
def test_stage2_device_defaults_to_the_gpu_index_card(cli):
    import importlib

    port = importlib.import_module(f"unmore_tpu_torch.cli.{cli}")
    argv = STAGE2_ARGV[:-2] + (["--raw_annotations_path", "r/d.json"] if cli == "object_scoring" else [])
    assert common.device_name(port.parse_args(argv)) == "cuda:0"
    assert common.device_name(port.parse_args(argv + ["--gpu_index", "2"])) == "cuda:2"
    assert common.device_name(port.parse_args(argv + ["--gpu_index", "2", "--device", "cpu"])) == "cpu"
