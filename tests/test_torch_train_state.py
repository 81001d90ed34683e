"""The port's stage-1 trainers against the JAX package's, on the CPU in f32:
their state. The spike guard skips a batch as the JAX step does, leaving
parameters, moments and counts as they were; the classifier's steps,
BatchNorm statistics (atol 2e-6 after 3 SGD steps, see the test) and eval
step; checkpoints go both ways (a file the port writes restores in the JAX
trainer with ``target=`` and the next step's loss agrees, and the
reverse); the seeded fresh init and the weight converters. The models,
batches and tolerances are ``tests/test_torch_train.py``'s, which holds the
losses, gradients and optimizer updates.
"""

import jax
import numpy as np
import pytest
import torch
from flax import serialization

from tests.test_torch_train import (  # noqa: F401  (the two fixtures)
    HIGH, OPTIMS, as_jax, as_torch, configs, flax_model, make_batch, one_torch_thread, pair, port_model,
)
from unmore_tpu.config import OptimConfig as JaxOptimConfig
from unmore_tpu.models.resnet import BinaryClassifier as FlaxBinaryClassifier
from unmore_tpu.train import classifier as jax_classifier
from unmore_tpu.train import objectness as jax_objectness
from unmore_tpu.train.checkpoints import load_checkpoint, save_checkpoint as jax_save_checkpoint
from unmore_tpu_torch.config import OptimConfig
from unmore_tpu_torch.models.convert import classifier_state_dict_from_flax, objectness_state_dict_from_flax
from unmore_tpu_torch.models.resnet import BinaryClassifier
from unmore_tpu_torch.train import checkpoints
from unmore_tpu_torch.train.classifier import ClassifierTrainer
from unmore_tpu_torch.train.objectness import ObjectnessTrainer
from unmore_tpu_torch.train.optim import init_like_flax


# -------------------------------------------------------------- spike guard
def guard_batches():
    good = {"image": np.zeros((2, 32, 32, 3), np.float32), "center_field": np.zeros((2, 32, 32, 2), np.float32),
            "sdf": np.zeros((2, 32, 32), np.float32), "saliency_mask": np.full((2, 32, 32), 0.5, np.float32)}
    return good, dict(good, sdf=np.full((2, 32, 32), 1e4, np.float32)), dict(good, sdf=np.full((2, 32, 32), np.nan,
                                                                                                  np.float32))


def snapshot(trainer):
    return {"params": trainer.flat.data.clone(), **{k: v.clone() for k, v in trainer.opt.state_tensors().items()}}


def assert_unchanged(before, trainer):
    after = {"params": trainer.flat.data, **trainer.opt.state_tensors()}
    for k in before:
        assert torch.equal(before[k], after[k]), k


def test_spike_guard_skips_exploding_batches(flax_model):
    state, step, _, trainer = pair(flax_model, skip_loss_above=100.0, spike_guard_warmup=0)
    good, big, _ = guard_batches()
    before = snapshot(trainer)
    m = trainer.train_step(as_torch(big))
    state_bad, m_jax = step(state, as_jax(big))
    assert float(m["skipped"]) == float(m_jax["skipped"]) == 1.0
    assert_unchanged(before, trainer)  # parameters, moments and both counts
    assert int(trainer.step) == int(state_bad.step) == 1
    assert int(trainer.opt.count) == int(state_bad.opt_state[0].count) == 0
    m = trainer.train_step(as_torch(good))
    _, m_jax = step(state_bad, as_jax(good))
    assert float(m["skipped"]) == float(m_jax["skipped"]) == 0.0
    assert not torch.equal(before["params"], trainer.flat.data)
    assert int(trainer.opt.count) == int(trainer.opt.sched_count) == 1


def test_spike_guard_warmup_grace(flax_model):
    state, step, _, trainer = pair(flax_model, skip_loss_above=100.0, spike_guard_warmup=2)
    _, big, nan = guard_batches()
    expected = []
    for batch, skipped in ((big, 0.0), (nan, 1.0), (big, 1.0)):  # warmup, non-finite, armed
        before = snapshot(trainer)
        m = trainer.train_step(as_torch(batch))
        state, m_jax = step(state, as_jax(batch))
        expected.append(float(m_jax["skipped"]))
        assert float(m["skipped"]) == skipped
        if skipped:
            assert_unchanged(before, trainer)
        else:
            assert not torch.equal(before["params"], trainer.flat.data)
    assert expected == [0.0, 1.0, 1.0]
    assert int(trainer.step) == 3 and int(trainer.opt.count) == int(state.opt_state[0].count) == 1


# --------------------------------------------------------------- classifier
def classifier_pair(seed=0, optimizer="adam"):
    """The JAX classifier (the CLI's Adam on the schedule, or SGD) and the
    port's, from the same flax weights."""
    fmodel = FlaxBinaryClassifier(stage_blocks=(1, 1), precision=HIGH)
    optim = dict(optimizer=optimizer, learning_rate=1e-3, lr_scheduler_milestones=(2,))
    tx = jax_objectness.make_optimizer(JaxOptimConfig(**optim))
    state = jax_classifier.init_classifier_state(fmodel, tx, jax.random.PRNGKey(seed), 32)
    model = BinaryClassifier(stage_blocks=(1, 1))
    model.load_state_dict(classifier_state_dict_from_flax(jax.device_get(
        {"params": state.params, "batch_stats": state.batch_stats})))
    return fmodel, tx, state, ClassifierTrainer(model, OptimConfig(**optim))


def classifier_batch(seed=0):
    rng = np.random.RandomState(seed)
    images = np.concatenate([rng.rand(4, 32, 32, 3) * 0.3, rng.rand(4, 32, 32, 3) * 0.3 + 0.7])
    return {"image": (images * 255).astype(np.uint8), "label": np.array([0, 0, 0, 0, 1, 1, 1, 1], np.float32)}


@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
def test_classifier_steps_batch_stats_and_eval_match_jax(optimizer):
    fmodel, tx, state, trainer = classifier_pair(optimizer=optimizer)
    step = jax_classifier.make_classifier_train_step(fmodel, tx)
    batch = classifier_batch()
    want, got = [], []
    for _ in range(3):
        state, m = step(state, as_jax(batch))
        want.append(float(m["loss"]))
        got.append(float(trainer.train_step(as_torch(batch))["loss"]))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    if optimizer == "adam":  # Adam's sign flips where g ~ 0 move the weights, and so the statistics
        return
    # flax's rule: momentum 0.9 on the biased batch variance. The port takes
    # torch.var_mean; flax's f32 E[x^2] - E[x]^2 rounds with cancellation,
    # up to 1.4e-6 on variances near 0.9 here (12 ulps), hence 2e-6
    stats = trainer.checkpoint_tree({k: v.detach().numpy().copy() for k, v in trainer.checkpoint_tensors().items()})
    for a, b in zip(jax.tree_util.tree_leaves(stats["batch_stats"]),
                    jax.tree_util.tree_leaves(jax.device_get(state.batch_stats))):
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-6)
    hits, total, pred = jax_classifier.make_eval_step(fmodel)(state.params, state.batch_stats, as_jax(batch))
    p_hits, p_total, p_pred = trainer.eval_step(as_torch(batch))
    assert float(p_hits) == float(hits) and float(p_total) == float(total) == 8.0
    np.testing.assert_allclose(p_pred.numpy(), np.asarray(pred), atol=1e-5)


# ------------------------------------------------------------- checkpoints
def test_writer_bytes_equal_flax_msgpack(monkeypatch):
    rng = np.random.RandomState(0)
    tree = {"step": np.asarray(7, np.int32), "params": {"b": rng.randn(30, 100).astype(np.float32),
                                                        str(11): rng.randn(3).astype(np.float32), "2": {}},
            "scalars": {"n": np.int32(5), "f": 1.5, "i": -40000, "big": 2**40, "s": "x" * 40, "none": None,
                        "t": True, "u8": np.arange(70000, dtype=np.uint8)},
            "many": {str(i): np.float32(i) for i in range(20)}, "T": rng.randn(4, 5).astype(np.float32).T}
    for chunk in (2**30, 1024):
        monkeypatch.setattr(checkpoints, "MAX_CHUNK_SIZE", chunk)
        monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", chunk)
        assert b"".join(bytes(c) for c in checkpoints.serialize(tree)) == serialization.msgpack_serialize(tree)


@pytest.mark.parametrize("optimizer", OPTIMS)
def test_port_checkpoint_resumes_in_jax_and_back(flax_model, optimizer, tmp_path):
    state, step, tx, trainer = pair(flax_model, optimizer)
    batch = make_batch(6)
    for _ in range(3):  # crosses the milestone
        trainer.train_step(as_torch(batch))
    writer = checkpoints.AsyncCheckpointer()
    writer.save(str(tmp_path / "port.ckpt"), trainer.checkpoint_tensors(), trainer.checkpoint_tree)
    assert writer.wait()["bytes"] == (tmp_path / "port.ckpt").stat().st_size
    assert not (tmp_path / "port.ckpt.tmp").exists()
    restored = load_checkpoint(str(tmp_path / "port.ckpt"),
                               target=jax_objectness.init_state(flax_model, tx, jax.random.PRNGKey(9), 32))
    assert int(restored.step) == 3
    restored, m = step(restored, as_jax(batch))
    np.testing.assert_allclose(float(trainer.train_step(as_torch(batch))["total"]), float(m["total"]), rtol=1e-5)

    jax_save_checkpoint(str(tmp_path / "jax.ckpt"), restored)
    resumed = ObjectnessTrainer(port_model(), trainer.cfg)
    resumed.load_tree(checkpoints.load_msgpack_checkpoint(str(tmp_path / "jax.ckpt")))
    assert int(resumed.step) == 4 and int(resumed.opt.sched_count) == 4
    _, m = step(restored, as_jax(batch))
    np.testing.assert_allclose(float(resumed.train_step(as_torch(batch))["total"]), float(m["total"]), rtol=1e-5)


def test_classifier_checkpoint_resumes_in_jax_and_back(tmp_path):
    fmodel, tx, state, trainer = classifier_pair()
    step = jax_classifier.make_classifier_train_step(fmodel, tx)
    batch = classifier_batch(1)
    for _ in range(3):
        trainer.train_step(as_torch(batch))
    checkpoints.save_checkpoint(str(tmp_path / "port.ckpt"), trainer.checkpoint_tree(
        {k: v.detach().numpy().copy() for k, v in trainer.checkpoint_tensors().items()}))
    restored = load_checkpoint(str(tmp_path / "port.ckpt"),
                               target=jax_classifier.init_classifier_state(fmodel, tx, jax.random.PRNGKey(3), 32))
    restored, m = step(restored, as_jax(batch))
    np.testing.assert_allclose(float(trainer.train_step(as_torch(batch))["loss"]), float(m["loss"]), rtol=1e-4)
    jax_save_checkpoint(str(tmp_path / "jax.ckpt"), restored)
    _, _, _, resumed = classifier_pair(seed=5)
    resumed.load_tree(checkpoints.load_msgpack_checkpoint(str(tmp_path / "jax.ckpt")))
    _, m = step(restored, as_jax(batch))
    np.testing.assert_allclose(float(resumed.train_step(as_torch(batch))["loss"]), float(m["loss"]), rtol=1e-4)


# -------------------------------------------------------------------- init
def test_fresh_init_uses_flax_families_and_skips_port_only_leaves():
    model = port_model()
    init_like_flax(model, seed=3)
    again = port_model()
    init_like_flax(again, seed=3)
    for (name, p), q in zip(model.named_parameters(), again.parameters()):
        assert torch.equal(p, q), name  # the seed decides
    sd = dict(model.named_parameters())
    m = "backbone.pretrained.model."
    assert torch.count_nonzero(sd[m + "cls_token"]) == 0
    assert abs(float(sd[m + "pos_embed"].detach().std()) - 0.02) < 0.005
    assert torch.count_nonzero(sd[m + "blocks.0.attn.qkv.bias"]) == 0
    assert torch.all(sd[m + "blocks.0.norm1.weight"] == 1)
    w = sd["sdf_prediction_head.1.weight"].detach()  # 3x3 conv, fan_in 512 * 9
    std = (1 / (512 * 9)) ** 0.5
    assert abs(float(w.std()) - std) < 0.05 * std and float(w.abs().max()) <= 2 * std / 0.8796256610342398 + 1e-7
    trainer = ObjectnessTrainer(model, configs()[0])
    assert not any("refinenet4.resConfUnit1" in n for n in trainer.flat.names)
    assert not any(p.requires_grad for n, p in sd.items() if "refinenet4.resConfUnit1" in n)
    tree = trainer.params_tree(trainer.flat.data)
    assert "rcu1" not in tree["backbone"]["refinenet4"] and "rcu1" in tree["backbone"]["refinenet3"]
    assert trainer.flat.data.numel() == sum(p.numel() for n, p in sd.items() if "refinenet4.resConfUnit1" not in n)


def test_weights_to_jax_are_the_inverse_of_the_loaders():
    from unmore_tpu.models.convert import convert_classifier_state_dict, convert_objectness_state_dict
    from unmore_tpu_torch.models.convert import classifier_flax_from_state_dict, objectness_flax_from_state_dict

    gen = torch.Generator().manual_seed(0)
    model = port_model()
    sd = {k: torch.randn(v.shape, generator=gen) for k, v in model.state_dict().items()}
    tree = objectness_flax_from_state_dict(sd)
    want = convert_objectness_state_dict(sd)
    del want["backbone"]["refinenet4"]["rcu1"]  # refinenet4 never runs it: not a JAX leaf
    for (kp, a), (kw, b) in zip(*(jax.tree_util.tree_flatten_with_path(t)[0] for t in (tree, want))):
        assert kp == kw
        np.testing.assert_array_equal(a, b)
    back = objectness_state_dict_from_flax(tree)
    assert set(sd) - set(back) == {k for k in sd if k.startswith("backbone.scratch.refinenet4.resConfUnit1.")}
    for k, v in back.items():
        assert torch.equal(v, sd[k]), k

    classifier = BinaryClassifier(stage_blocks=(1, 1))
    sd = {k: torch.randn(v.shape, generator=gen) if v.is_floating_point() else v
          for k, v in classifier.state_dict().items()}
    variables = classifier_flax_from_state_dict(sd)
    want = convert_classifier_state_dict(sd)
    for (kp, a), (kw, b) in zip(*(jax.tree_util.tree_flatten_with_path(t)[0] for t in (variables, want))):
        assert kp == kw
        np.testing.assert_array_equal(a, b)
    back = classifier_state_dict_from_flax(variables)
    for k, v in sd.items():
        assert torch.equal(back[k], v) or k.endswith("num_batches_tracked"), k
