"""Whole CAD training steps and checkpoints of the port against the JAX package's.

The tiny detector of ``tests/test_torch_cad_train.py`` takes two training
steps in both packages, a finite one and one whose loss is NaN, in float64
on both sides (JAX under ``jax.enable_x64``; in f32 the gradient is
ill-conditioned at this size, see that file). The port is fed the draws the
JAX step makes. Expected within 1e-6 (BatchNorm statistics 1e-5): the
parameters, the statistics, the SGD trace and count and the step after each
step; the NaN step keeps the parameters and statistics and still moves the
trace and the count, as optax does. Checkpoints cross both ways with equal
leaves: a JAX-written ``DetectorTrainState`` resumes in the port, and the
port's file restores in flax against a JAX target.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from tests.test_torch_cad_train import (
    JCFG64, OPTIM, PORT_CFG, _batch, _draws, _f64, _np, _port_model, _tbatch, _tdraws, draw_sizes, initial_state,
)
from unmore_tpu.detector.cascade_rcnn import CascadeMaskRCNN as JaxDetector
from unmore_tpu.train.checkpoints import load_checkpoint, save_checkpoint
from unmore_tpu.train.detector import make_detector_train_step
from unmore_tpu_torch.detector.cascade_rcnn import DetectorConfig
from unmore_tpu_torch.train import checkpoints
from unmore_tpu_torch.train.detector import DetectorTrainer


@pytest.fixture(scope="module")
def world():
    _, tx, state = initial_state()
    port_cfg = DetectorConfig(**PORT_CFG)
    A, P0 = draw_sizes(port_cfg)
    batch = _batch()
    bad = dict(batch, gt_scores=np.where(batch["gt_valid"], np.nan, 0.0).astype(np.float32))
    batch64, bad64 = _f64(batch), _f64(bad)
    step = make_detector_train_step(JaxDetector(JCFG64), tx, JCFG64)
    states, step_draws = [_f64(state)], []
    with jax.enable_x64(True):
        for b in (batch64, bad64):
            step_draws.append(_np(_draws(jax.random.split(jnp.asarray(states[-1].rng))[1], A, P0)))
            new, _ = step(jax.tree_util.tree_map(jnp.asarray, states[-1]), b)
            states.append(_np(new))
    return dict(state=state, states=states, step_draws=step_draws, batch64=batch64, bad64=bad64, port_cfg=port_cfg)


def _state_equal(trainer, jstate, atol=1e-6, stats_atol=1e-5):
    tree = trainer.state_tree()
    assert int(tree["step"]) == int(jstate.step)
    np.testing.assert_array_equal(np.asarray(tree["opt_state"]["2"]["1"]["count"]),
                                  np.asarray(jstate.opt_state[2][1].count))
    for name, got, want, tol in (("params", tree["params"], jstate.params, atol),
                                 ("batch_stats", tree["batch_stats"], jstate.batch_stats, stats_atol),
                                 ("trace", tree["opt_state"]["2"]["0"]["trace"], jstate.opt_state[2][0].trace, atol)):
        assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(_np(want)), name
        for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
            np.testing.assert_allclose(a, b, atol=tol, rtol=0, err_msg=name)


def test_whole_steps_match_including_a_nonfinite_one(world):
    trainer = DetectorTrainer(_port_model(world, dtype=torch.float64), world["port_cfg"], OPTIM, dtype="float32")
    before = trainer.state_tree()
    out = trainer.train_step(_tbatch(world["batch64"]), _tdraws(world["step_draws"][0]))
    assert np.isfinite(float(out["total"])) and int(trainer.skipped) == 0
    _state_equal(trainer, world["states"][1])
    kept = (trainer.flat.data.clone(), trainer.stats.clone(), trainer.opt.trace.clone())
    out = trainer.train_step(_tbatch(world["bad64"]), _tdraws(world["step_draws"][1]))
    assert not np.isfinite(float(out["total"])) and int(trainer.skipped) == 1
    _state_equal(trainer, world["states"][2])
    # the skipped step kept parameters and statistics, and moved the trace
    assert torch.equal(trainer.flat.data, kept[0]) and torch.equal(trainer.stats, kept[1])
    assert not torch.equal(trainer.opt.trace, kept[2])
    assert int(before["step"]) == 0 and int(trainer.step) == 2


def test_checkpoints_cross_both_ways(world, tmp_path):
    # after two steps: non-zero trace and count 2 (float64 steps, saved as float32)
    jstate = jax.tree_util.tree_map(lambda x: x.astype(np.float32) if x.dtype == np.float64 else x,
                                    world["states"][2])
    path = str(tmp_path / "jax.ckpt")
    save_checkpoint(path, jax.tree_util.tree_map(jnp.asarray, jstate))
    trainer = DetectorTrainer(_port_model(world), world["port_cfg"], OPTIM, dtype="float32")
    trainer.load_tree(checkpoints.load_msgpack_checkpoint(path))
    _state_equal(trainer, jstate, atol=0, stats_atol=0)
    np.testing.assert_array_equal(trainer.rng, np.asarray(jstate.rng))
    # the port's file, restored by flax against the JAX state as target
    mine = str(tmp_path / "port.ckpt")
    checkpoints.save_checkpoint(mine, trainer.state_tree())
    restored = load_checkpoint(mine, target=jax.tree_util.tree_map(jnp.asarray, world["states"][0]))
    _state_equal(trainer, restored, atol=0, stats_atol=0)
    assert int(restored.step) == 2 and int(restored.opt_state[2][1].count) == 2
    assert np.asarray(restored.rng).dtype == np.uint32
    np.testing.assert_array_equal(np.asarray(restored.rng), trainer.rng)
    assert serialization.to_state_dict(restored).keys() == {"step", "params", "batch_stats", "opt_state", "rng"}
