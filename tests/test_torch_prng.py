"""The port's ``jax.random`` stream (``unmore_tpu_torch/utils/prng.py``)
against the installed JAX, on the CPU. Every comparison is bit for bit:

* ``prng_key``, ``split`` (n in 1, 2, 3, 33) and ``uniform`` (n in 1, 1000,
  4128) on several keys; rows of a split against the whole split;
* the detector's ``uniform_draws`` for a global batch of 3 on a narrow config
  (canvas 64) against the JAX package's ``split`` -> ``vmap(uniform)``
  (``unmore_tpu/detector/cascade_rcnn.py``), whole and by image rows;
* ``DetectorTrainer.next_draws`` over 3 steps against the JAX step's
  ``jax.random.split(state.rng)`` chain, with one rank and with two ranks
  each taking its rows of the global batch;
* a JAX checkpoint's ``rng`` leaf resumed in the port through the CLI's
  ``load_training_state`` continues JAX's draws, and the ``rng`` that the
  port writes after a step is the key that the JAX step splits next.

The stream is JAX's with ``jax_threefry_partitionable`` true (JAX's default
since 0.5); the first test asserts that the installed JAX has it, so that a
change of that default shows here. The JAX references are built once per
file.
"""

import jax
import numpy as np
import pytest
import torch

from unmore_tpu.train.checkpoints import save_checkpoint
from unmore_tpu_torch.cli import train_net
from unmore_tpu_torch.detector.cascade_rcnn import (
    CascadeMaskRCNN, DetectorConfig, train_proposal_count, uniform_draws,
)
from unmore_tpu_torch.detector.anchors import fpn_anchors
from unmore_tpu_torch.parallel import distributed
from unmore_tpu_torch.train.detector import DetectorTrainer
from unmore_tpu_torch.utils import prng

SEEDS = (0, 1, 42, 2**31 + 3)
SPLITS = (1, 2, 3, 33)
UNIFORMS = (1, 1000, 4128)
CFG = DetectorConfig(image_size=64, max_gt=8, gt_mask_res=16, rpn_pre_nms_topk_train=32, rpn_post_nms_topk_train=32,
                     stage_samples=16, stage_blocks=(1, 1, 1, 1))
GLOBAL_BATCH = 4  # the trainer's: 2 images a rank over two ranks
STEPS = 3


def _keys():
    """PRNGKey(seed) for each seed, and a split-off key with both words large."""
    keys = [jax.random.PRNGKey(s) for s in SEEDS]
    return keys + [jax.random.split(jax.random.PRNGKey(7), 5)[3]]


def _jax_draws(step_key, batch, A, P):
    """The JAX package's draws of one training step (``cascade_rcnn.py``)."""
    rngs = jax.random.split(step_key, batch * 2).reshape(batch, 2, 2)
    return {"rpn": np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (A,)))(rngs[:, 0])),
            "stage0": np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (P,)))(rngs[:, 1]))}


def _jax_chain(rng, batch, A, P, steps=STEPS):
    """``rng, step = jax.random.split(rng)`` and the step's draws, ``steps``
    times: [(the key after the step, the draws)]."""
    out = []
    for _ in range(steps):
        rng, step = jax.random.split(rng)
        out.append((np.asarray(rng), _jax_draws(step, batch, A, P)))
    return out


@pytest.fixture(scope="module")
def ref():
    A = sum(len(a) for a in fpn_anchors(CFG.image_size))
    P = train_proposal_count(CFG) + CFG.max_gt
    keys = _keys()
    resumed_from = jax.random.split(jax.random.PRNGKey(11))[0]
    return {
        "A": A, "P": P, "keys": [np.asarray(k) for k in keys],
        "split": [[np.asarray(jax.random.split(k, n)) for n in SPLITS] for k in keys],
        "uniform": [[np.asarray(jax.random.uniform(k, (n,))) for n in UNIFORMS] for k in keys],
        "draws3": _jax_draws(jax.random.PRNGKey(5), 3, A, P),
        "chain": _jax_chain(jax.random.PRNGKey(0), GLOBAL_BATCH, A, P),
        "resumed_from": np.asarray(resumed_from),
        "resumed_chain": _jax_chain(resumed_from, GLOBAL_BATCH, A, P, steps=2),
    }


@pytest.fixture(scope="module")
def trainer():
    torch.manual_seed(0)
    return DetectorTrainer(CascadeMaskRCNN(CFG), CFG, dtype="float32")


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def test_the_installed_jax_splits_partitionably():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key(seed):
    np.testing.assert_array_equal(prng.prng_key(seed).numpy(), np.asarray(jax.random.PRNGKey(seed)))


def test_prng_key_of_a_64_bit_seed():
    with jax.enable_x64(True):
        want = np.asarray(jax.random.PRNGKey(2**40 + 7))
    np.testing.assert_array_equal(prng.prng_key(2**40 + 7).numpy(), want)


@pytest.mark.parametrize("n", SPLITS)
def test_split(ref, n):
    for key, want in zip(ref["keys"], ref["split"]):
        got = prng.split(key, n)
        assert got.shape == (n, 2)
        np.testing.assert_array_equal(got.numpy(), want[SPLITS.index(n)])


@pytest.mark.parametrize("n", UNIFORMS)
def test_uniform(ref, n):
    for key, want in zip(ref["keys"], ref["uniform"]):
        got = prng.uniform(torch.from_numpy(key.astype(np.int64)), n)
        assert got.dtype == torch.float32 and got.shape == (n,)
        np.testing.assert_array_equal(_bits(got), _bits(want[UNIFORMS.index(n)]))
    assert 0.0 <= float(got.min()) and float(got.max()) < 1.0


def test_split_rows_equal_the_whole_split(ref):
    key = ref["keys"][-1]
    whole = prng.split(key, 33)
    for start, stop in ((0, 33), (0, 1), (5, 17), (32, 33), (7, 7)):
        assert torch.equal(prng.split(key, 33, start, stop), whole[start:stop])
    with pytest.raises(ValueError):
        prng.split(key, 33, 30, 34)


def test_uniform_draws_equal_the_jax_packages(ref):
    step = np.asarray(jax.random.PRNGKey(5))
    got = uniform_draws(CFG, step, 3, "cpu")
    for k in ("rpn", "stage0"):
        assert got[k].shape == ref["draws3"][k].shape == (3, (ref["A"], ref["P"])[k == "stage0"])
        np.testing.assert_array_equal(_bits(got[k]), _bits(ref["draws3"][k]))
        rows = uniform_draws(CFG, step, 3, "cpu", start=1, stop=3)[k]
        assert torch.equal(rows, got[k][1:3])


@pytest.mark.parametrize("ranks", (1, 2))
def test_trainer_draws_follow_the_jax_steps(ref, trainer, monkeypatch, ranks):
    local = GLOBAL_BATCH // ranks
    monkeypatch.setattr(distributed, "process_count", lambda: ranks)
    for rank in range(ranks):
        monkeypatch.setattr(distributed, "process_index", lambda: rank)
        trainer.rng = prng.prng_key(0).numpy().astype(np.uint32)  # the CLI's first key
        for rng, want in ref["chain"]:
            got = trainer.next_draws(local)
            for k in ("rpn", "stage0"):
                np.testing.assert_array_equal(_bits(got[k]), _bits(want[k][rank * local:(rank + 1) * local]))
            np.testing.assert_array_equal(trainer.rng, rng)
            assert trainer.rng.dtype == np.uint32


def test_resume_continues_the_stream_across_packages(ref, trainer, tmp_path):
    tree = trainer.state_tree()
    tree["rng"] = ref["resumed_from"]
    path = str(tmp_path / "jax.ckpt")
    save_checkpoint(path, tree)  # the JAX package's writer
    trainer.rng = prng.prng_key(0).numpy().astype(np.uint32)
    train_net.load_training_state(trainer, path)
    np.testing.assert_array_equal(trainer.rng, ref["resumed_from"])
    rng, want = ref["resumed_chain"][0]
    got = trainer.next_draws(GLOBAL_BATCH)
    for k in ("rpn", "stage0"):
        np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]))
    # the port's checkpoint after that step holds the key that the JAX step splits next
    np.testing.assert_array_equal(trainer.checkpoint_tensors()["rng"].numpy().astype(np.uint32), rng)
    rng, want = ref["resumed_chain"][1]
    got = trainer.next_draws(GLOBAL_BATCH)
    np.testing.assert_array_equal(_bits(got["rpn"]), _bits(want["rpn"]))
