"""The port's reader of the JAX trainers' msgpack checkpoints.

Checkpoints are written by the JAX package's ``save_checkpoint``: an
objectness trainer-state-like tree and a classifier tree with
``batch_stats``, each with a bfloat16 leaf, a numpy-scalar leaf and a leaf
that flax splits into chunks (``flax.serialization.MAX_CHUNK_SIZE`` lowered
here). The reader must give ``msgpack_restore``'s leaves (bfloat16 as the
same values in float32), the loaded models must match the JAX models to
atol 2e-4, and both CLIs must load such files in an interpreter where
``msgpack``, ``flax`` and ``jax`` cannot be imported.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from flax import serialization

from unmore_tpu.train.checkpoints import save_checkpoint
from unmore_tpu_torch.cli import common
from unmore_tpu_torch.train.checkpoints import (
    MsgpackError, load_msgpack_checkpoint, parse_msgpack_checkpoint, try_msgpack_checkpoint,
)
from tests.test_torch_cli import coco  # noqa: F401  (the fixture)
from tests.test_torch_models import _perturb, flax_objectness_params
from tests.test_torch_scoring import jax_tiny_classifier, port_tiny_classifier, port_tiny_objectness

ROOT = Path(__file__).resolve().parents[1]


class Args:
    sdf_activation, use_bg_sdf = "tanh", True


def tiny_trees():
    fobj, obj_params = flax_objectness_params(seed=21)
    fcls = jax_tiny_classifier("float32")
    cls_vars = jax.device_get(
        jax.jit(lambda k: fcls.init(k, jnp.zeros((1, 32, 32, 3)), train=False))(jax.random.PRNGKey(22))
    )
    cls_vars = {"params": _perturb(cls_vars["params"], 23), "batch_stats": _perturb(cls_vars["batch_stats"], 24)}
    extras = {
        "bf16_leaf": jnp.asarray(np.random.RandomState(1).randn(3, 5), jnp.bfloat16),
        "scalar_leaf": np.float32(2.5),
        "chunked_leaf": np.arange(3000, dtype=np.float32).reshape(30, 100),
        "count": np.int32(7),
    }
    objectness = {"params": obj_params, "opt_state": {"mu": _perturb(obj_params, 25), **extras}, "step": 120}
    classifier = {**cls_vars, "opt_state": dict(extras), "step": np.int64(2**40)}
    return (fobj, objectness), (fcls, classifier)


def assert_same_tree(got, want, path="ckpt"):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_same_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same_tree(g, w, f"{path}/{i}")
    elif isinstance(want, (np.ndarray, np.generic, jax.Array)):
        w = np.asarray(want)
        if w.dtype == jnp.bfloat16:
            w = w.astype(np.float32)
        assert isinstance(got, np.generic) == isinstance(want, np.generic), path
        assert np.asarray(got).dtype == w.dtype and np.asarray(got).shape == w.shape, path
        np.testing.assert_array_equal(np.asarray(got), w, err_msg=path)
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


@pytest.fixture
def small_chunks(monkeypatch):
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 4096)


@pytest.mark.parametrize("which", ["objectness", "classifier"])
def test_reader_gives_msgpack_restore_leaves(which, tmp_path, small_chunks):
    (_, obj_tree), (_, cls_tree) = tiny_trees()
    path = tmp_path / f"{which}.ckpt"
    save_checkpoint(str(path), obj_tree if which == "objectness" else cls_tree)
    data = path.read_bytes()
    assert b"__msgpack_chunked_array__" in data
    want = serialization.msgpack_restore(data)
    got = load_msgpack_checkpoint(str(path))
    assert_same_tree(got, want)
    assert got["opt_state"]["bf16_leaf"].dtype == np.float32
    np.testing.assert_array_equal(got["opt_state"]["chunked_leaf"], np.arange(3000).reshape(30, 100))


def test_reader_decodes_numpy_scalars_bfloat16_and_plain_values():
    rng = np.random.RandomState(2)
    tree = {
        "f32": np.float32(1.25), "i64": np.int64(-3), "bf16_scalar": jnp.bfloat16(3.0),
        "bf16": jnp.asarray(rng.randn(64) * 1e3, jnp.bfloat16), "u8": rng.randint(0, 255, (4, 3)).astype(np.uint8),
        "f64": rng.randn(2, 2), "empty": np.zeros((0, 3), np.float32), "nested": {"deep": {"x": np.ones(2, np.int16)}},
        "ints": [0, 127, 128, 255, 256, 65536, 2**33, -1, -32, -33, -200, -40000, -2**33],
        "floats": [0.5, -1e300], "misc": [None, True, False, "", "t" * 40, "u" * 300, b"\x00\x01"],
        "long_list": list(range(20)), "big_map": {str(i): i for i in range(20)},
    }
    data = serialization.msgpack_serialize(tree)
    got = parse_msgpack_checkpoint(data)
    assert_same_tree(got, serialization.msgpack_restore(data))
    assert isinstance(got["f32"], np.float32) and got["f32"] == 1.25
    assert got["bf16_scalar"].dtype == np.float32 and got["bf16_scalar"] == 3.0
    np.testing.assert_array_equal(got["bf16"], np.asarray(tree["bf16"]).astype(np.float32))


def test_other_files_are_not_msgpack_checkpoints(tmp_path):
    torch.save({"model_state_dict": {"w": torch.ones(2)}}, tmp_path / "t.ckpt")
    assert try_msgpack_checkpoint(str(tmp_path / "t.ckpt")) is None
    data = serialization.msgpack_serialize({"w": np.ones(3, np.float32)})
    for bad in (data[:-3], data + b"\x00", serialization.msgpack_serialize([1, 2]), b"\xc1"):
        with pytest.raises(MsgpackError):
            parse_msgpack_checkpoint(bad)


@pytest.mark.parametrize("which", ["objectness", "classifier"])
def test_models_loaded_from_msgpack_match_jax(which, tmp_path, small_chunks):
    (fobj, obj_tree), (fcls, cls_tree) = tiny_trees()
    path = str(tmp_path / f"{which}.ckpt")
    x = np.random.RandomState(4).rand(2, 32, 32, 3).astype(np.float32)
    if which == "objectness":
        save_checkpoint(path, obj_tree)
        model = port_tiny_objectness(Args, "float32", "cpu")
        common.load_objectness_weights(model, path)
        want = fobj.apply({"params": obj_tree["params"]}, jnp.asarray(x))
        with torch.no_grad():
            got = model(torch.from_numpy(x))
        for key in ("sdf_maps", "center_fields"):
            np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=2e-4)
    else:
        save_checkpoint(path, cls_tree)
        model = port_tiny_classifier("float32", "cpu")
        common.load_classifier_weights(model, path)
        want = fcls.apply({"params": cls_tree["params"], "batch_stats": cls_tree["batch_stats"]}, jnp.asarray(x))
        with torch.no_grad():
            got = model(torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)


CLI_WITHOUT_JAX = """
import sys
for name in ("jax", "flax", "msgpack", "unmore_tpu"):
    sys.modules[name] = None
from unmore_tpu_torch.cli import common, object_reasoning, object_scoring
from unmore_tpu_torch.models.objectness import ObjectnessNet
from unmore_tpu_torch.models.resnet import BinaryClassifier
from unmore_tpu_torch.models.vit import ViTConfig

def tiny_objectness(args_like, dtype="bfloat16", device=None):
    model = ObjectnessNet("dpt_base", args_like.sdf_activation, args_like.use_bg_sdf,
                          vit_config=ViTConfig(depth=4, dim=32, heads=2, mlp_dim=64, pretrain_grid=4),
                          features=16, hooks=(0, 1, 2, 3), widths=(8, 16, 24, 24))
    return model.to(common.resolve_device(device), common.DTYPES[dtype]).eval()

def tiny_classifier(dtype="bfloat16", device=None):
    return BinaryClassifier(stage_blocks=(1, 1, 1, 1)).to(common.resolve_device(device), common.DTYPES[dtype]).eval()

common.build_objectness, common.build_classifier = tiny_objectness, tiny_classifier
obj, cls = sys.argv[1], sys.argv[2]
model_args = ["--device", "cpu", "--dtype", "float32", "--sdf_activation", "tanh", "--use_bg_sdf",
              "--image_size", "32", "--canvas_size", "96", "--coco_image_dir", "images",
              "--coco_annotations", "instances.json", "--objectness_resume", obj, "--binary_classifier_resume", cls]
object_reasoning.main(model_args + ["--max_proposals", "64", "--max_splits", "32", "--max_active", "32",
                                    "--crop_chunk", "32", "--crop_chunk_tail", "16", "--exist_chunk", "32",
                                    "--n_round", "1", "--run_name", "nojax", "--start_idx", "0", "--end_idx", "1"])
object_scoring.main(model_args + ["--crop_chunk", "8", "--raw_annotations_path", "scoring/discovery_results.json"])
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "msgpack", "unmore_tpu") and sys.modules[m]]
assert not bad, bad
print("loaded without jax")
"""


def test_both_clis_load_msgpack_checkpoints_without_jax_flax_msgpack(coco, small_chunks):  # noqa: F811
    (_, obj_tree), (_, cls_tree) = tiny_trees()
    obj, cls = str(coco / "objectness.ckpt"), str(coco / "classifier.ckpt")
    save_checkpoint(obj, obj_tree)
    save_checkpoint(cls, cls_tree)
    (coco / "scoring").mkdir()
    (coco / "scoring" / "discovery_results.json").write_text(json.dumps({"11": [[4, 6, 50, 60], [-3, 0, 30, 41.5]]}))
    out = subprocess.run([sys.executable, "-c", CLI_WITHOUT_JAX, obj, cls], cwd=coco, capture_output=True,
                         text=True, timeout=300, env=dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2"))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "loaded without jax" in out.stdout
    assert (coco / "results_reasoning" / "nojax_0_1" / "discovery_results.json").exists()
    anns = json.loads((coco / "scoring" / "object_discovery_with_scores.json").read_text())
    assert anns and {a["image_id"] for a in anns} == {11}
