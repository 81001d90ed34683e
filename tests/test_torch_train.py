"""The port's stage-1 trainers against the JAX package's, on the CPU in f32.

Weights are made by flax (the JAX package's ``init_state``), carried into
the port (``*_state_dict_from_flax``), and the same numpy batches go
through both trainers at ``Precision.HIGHEST``. Tolerances: each loss term
atol 1e-6; gradients after one step against the same step in float64, on
each leaf's L2 norm: the port's f32 gradients within rtol 1e-4 / atol
1e-6, the JAX package's and the port's within 1e-3 of each other (the
JAX package's own f32 gradients lie up to 2.3e-4 from the float64 ones on
the center head, where ReLU inputs within rounding of zero flip in one f32
computation and not the other, so 1e-4 between the two packages cannot
hold element by element or by norm); the optimizer
update from equal gradients atol 1e-7 (Adam, SGD, LARS); the losses over 5
steps rtol 1e-4 (Adam's parameters are not compared element by element
after a step: ``g / (|g| + eps)`` flips sign where g ~ 0); BatchNorm's
running statistics after 3 SGD steps atol 2e-6 (see the test). Checkpoints go both ways: a
file the port writes restores in the JAX trainer with ``target=`` and the
next step's loss agrees, and the reverse.
"""

import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch
from flax import serialization

from unmore_tpu.config import ModelConfig as JaxModelConfig
from unmore_tpu.config import OptimConfig as JaxOptimConfig
from unmore_tpu.config import TrainObjectnessConfig as JaxTrainConfig
from unmore_tpu.models.objectness import ObjectnessNet as FlaxObjectnessNet
from unmore_tpu.models.resnet import BinaryClassifier as FlaxBinaryClassifier
from unmore_tpu.models.vit import ViTConfig as FlaxViTConfig
from unmore_tpu.train import classifier as jax_classifier
from unmore_tpu.train import objectness as jax_objectness
from unmore_tpu.train.checkpoints import load_checkpoint, save_checkpoint as jax_save_checkpoint
from unmore_tpu_torch.config import ModelConfig, OptimConfig, TrainObjectnessConfig
from unmore_tpu_torch.data.votecut import synthesize_labels
from unmore_tpu_torch.models.convert import (
    classifier_state_dict_from_flax, flax_tree, load_objectness_state_dict, objectness_state_dict_from_flax,
)
from unmore_tpu_torch.models.objectness import ObjectnessNet
from unmore_tpu_torch.models.resnet import BinaryClassifier
from unmore_tpu_torch.models.vit import ViTConfig
from unmore_tpu_torch.train import checkpoints
from unmore_tpu_torch.train.classifier import ClassifierTrainer, bce_loss
from unmore_tpu_torch.train.objectness import ObjectnessTrainer, objectness_losses
from unmore_tpu_torch.train.optim import FlatParams, Optimizer, init_like_flax

HIGH = jax.lax.Precision.HIGHEST
TINY = dict(depth=2, dim=32, heads=2, mlp_dim=64, pretrain_grid=4)
TINY_DPT = dict(features=16, hooks=(0, 1, 1, 1), widths=(8, 16, 24, 24))
OPTIMS = ("adam", "sgd", "lars")


def optim_kwargs(optimizer="adam", **kw):
    return dict(dict(optimizer=optimizer, learning_rate=3e-4, lr_scheduler_milestones=(2,)), **kw)


def configs(optimizer="adam", **train):
    port = TrainObjectnessConfig(model=ModelConfig(image_size=32), optim=OptimConfig(**optim_kwargs(optimizer)), **train)
    jax_cfg = JaxTrainConfig(model=JaxModelConfig(image_size=32), optim=JaxOptimConfig(**optim_kwargs(optimizer)),
                             **train)
    return port, jax_cfg


@pytest.fixture(scope="module")
def flax_model():
    return FLAX_MODEL


FLAX_MODEL = FlaxObjectnessNet(backbone_type="dpt_base", vit_config=FlaxViTConfig(**TINY), precision=HIGH, **TINY_DPT)


@functools.lru_cache(maxsize=None)
def flax_params():
    """The flax-initialized weights (one compile for the whole module)."""
    init = jax.jit(lambda k: FLAX_MODEL.init(k, jnp.zeros((1, 32, 32, 3)))["params"])
    return jax.device_get(init(jax.random.PRNGKey(0)))


@functools.lru_cache(maxsize=None)
def jax_step(optimizer="adam", **train):
    """(tx, jitted JAX train step, port config): compiled once per config."""
    port_cfg, jax_cfg = configs(optimizer, **train)
    tx = jax_objectness.make_optimizer(jax_cfg.optim)
    return tx, jax_objectness.make_train_step(FLAX_MODEL, tx, jax_cfg), port_cfg


def port_model(params=None, remat_vit=False):
    model = ObjectnessNet("dpt_base", "tanh", True, vit_config=ViTConfig(**TINY), remat_vit=remat_vit, **TINY_DPT)
    if params is not None:
        load_objectness_state_dict(model, objectness_state_dict_from_flax(params))
    return model


def make_batch(seed=0, n=4, size=32):
    """A batch as the pipeline makes it: blob images through the port's
    synthesize_labels (smooth SDF targets, unit center fields)."""
    rng = np.random.default_rng(seed)
    samples = []
    while len(samples) < n:
        h, w = rng.integers(48, 96, 2)
        image = rng.random((h, w, 3), dtype=np.float32)
        mask = np.zeros((h, w), np.uint8)
        y, x = rng.integers(4, h // 2), rng.integers(4, w // 2)
        mask[y : y + h // 3, x : x + w // 3] = 1
        image[mask > 0] = rng.random(3)
        s = synthesize_labels(image, mask, size, True, rng)
        if s is not None and 0 < s.saliency_mask.sum() < s.saliency_mask.size:
            samples.append(s)
    return {"image": np.stack([s.image for s in samples]), "center_field": np.stack([s.center_field for s in samples]),
            "sdf": np.stack([s.sdf for s in samples]), "saliency_mask": np.stack([s.saliency_mask for s in samples])}


def as_torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def as_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def pair(flax_model, optimizer="adam", **train):
    """A JAX (state, step) and a port trainer from the same flax weights."""
    tx, step, port_cfg = jax_step(optimizer, **train)
    params = flax_params()
    state = jax_objectness.TrainState(step=jnp.zeros((), jnp.int32), params=jax.tree_util.tree_map(jnp.asarray, params),
                                      opt_state=tx.init(params))
    return state, step, tx, ObjectnessTrainer(port_model(params), port_cfg)


# ------------------------------------------------------------------ losses
@pytest.mark.parametrize("sdf_loss,center_loss", [("l1", "l2"), ("l2", "l1")])
def test_each_loss_term_matches_jax(sdf_loss, center_loss):
    port_cfg, jax_cfg = configs(sdf_loss_type=sdf_loss, center_field_loss_type=center_loss)
    rng = np.random.RandomState(1)
    batch = make_batch(2, 3, 16)
    # predictions in the model's ranges: the targets plus noise, a tanh SDF
    out = {"center_fields": (batch["center_field"] + 0.3 * rng.randn(3, 16, 16, 2)).astype(np.float32),
           "sdf_maps": np.tanh(batch["sdf"] + 0.3 * rng.randn(3, 16, 16)).astype(np.float32)}
    want = jax_objectness.objectness_losses({k: jnp.asarray(v) for k, v in out.items()}, as_jax(batch), jax_cfg)
    got = objectness_losses(as_torch(out), as_torch(batch), port_cfg)
    assert set(got) == set(want) == {"center_field", "sdf", "sdf_gradient", "sdf_binary_mask", "total"}
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=0, atol=1e-6, err_msg=k)
    pred, target = rng.rand(64).astype(np.float32), (rng.rand(64) > 0.5).astype(np.float32)
    pred[:2] = [0.0, 1.0]  # clipped
    np.testing.assert_allclose(float(bce_loss(torch.from_numpy(pred), torch.from_numpy(target))),
                               float(jax_classifier.bce_loss(jnp.asarray(pred), jnp.asarray(target))), atol=1e-6)


@functools.lru_cache(maxsize=None)
def flax_grad_fn(jax_cfg):
    """The JAX gradient of the total loss, jitted once for the module."""

    def loss_fn(p, batch):
        b = jax_objectness.decode_wire_batch(batch)
        return jax_objectness.objectness_losses(FLAX_MODEL.apply({"params": p}, b["image"]), b, jax_cfg)["total"]

    return jax.jit(jax.grad(loss_fn))


def flax_grads(params, batch, jax_cfg):
    return jax.device_get(flax_grad_fn(jax_cfg)(params, batch))


@pytest.mark.parametrize("remat_vit", [False, True])
def test_gradients_after_one_step_match_jax(flax_model, remat_vit):
    state, _, _, trainer = pair(flax_model)
    if remat_vit:
        trainer = ObjectnessTrainer(port_model(flax_params(), remat_vit=True), trainer.cfg)
    batch = make_batch(3)
    want = flax_grads(state.params, as_jax(batch), configs()[1])
    trainer.flat.grad.zero_()
    trainer.loss(as_torch(batch))["total"].backward()
    got = trainer.params_tree(trainer.flat.grad)
    # the same step in float64 (the port's modules), the reference of both f32 results
    model64 = port_model(flax_params()).double()
    losses64 = objectness_losses(model64({k: torch.from_numpy(v).double() for k, v in batch.items()}["image"]),
                                 {k: torch.from_numpy(v).double() for k, v in batch.items()}, trainer.cfg)
    losses64["total"].backward()
    exact = flax_tree({n: p.grad for n, p in model64.named_parameters() if p.grad is not None}, trainer.layout)
    flat_want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    flat_exact = dict(jax.tree_util.tree_flatten_with_path(exact)[0])
    assert set(flat_got) == set(flat_exact) == set(flat_want) - {
        k for k in flat_want if "'rcu1'" in jax.tree_util.keystr(k) and "'refinenet4'" in jax.tree_util.keystr(k)}
    for k, v in flat_got.items():  # on each leaf's norm (see the module note)
        name, norm = jax.tree_util.keystr(k), np.linalg.norm(flat_exact[k])
        assert np.linalg.norm(v - flat_exact[k]) <= 1e-4 * norm + 1e-6, name
        assert np.linalg.norm(flat_want[k] - flat_exact[k]) <= 1e-3 * norm + 1e-6, name
        assert np.linalg.norm(v - flat_want[k]) <= 1e-3 * norm + 1e-6, name


# --------------------------------------------------------------- optimizers
def random_tree(like, seed, scale):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(lambda a: (rng.randn(*np.shape(a)) * scale).astype(np.float32), like)


@functools.lru_cache(maxsize=None)
def jax_update(tx):
    """optax's update and apply of ``tx``, jitted once per optimizer."""

    def update(grads, opt_state, params):
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    return jax.jit(update)


@pytest.mark.parametrize("optimizer", OPTIMS)
def test_optimizer_update_from_equal_gradients(flax_model, optimizer):
    state, _, tx, trainer = pair(flax_model, optimizer)
    params = random_tree(state.params, 5, 0.1)
    trainer.flat.data.copy_(trainer.params_flat(params))
    opt_state = tx.init(params)
    for k in range(3):  # crosses the milestone at 2
        grads = random_tree(params, 10 + k, 1e-2)
        params, opt_state = jax_update(tx)(grads, opt_state, params)
        trainer.flat.grad.copy_(trainer.params_flat(grads))
        trainer.opt.step()
        got = trainer.params_tree(trainer.flat.data)
        for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(jax.device_get(params))):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-7)
    assert int(trainer.opt.sched_count) == 3


def test_schedule_changes_on_the_milestone_update():
    schedule = optax.piecewise_constant_schedule(3e-4, {2: 0.1, 5: 0.1})
    model = torch.nn.Linear(2, 2)
    opt = Optimizer(OptimConfig(optimizer="sgd", learning_rate=3e-4, lr_scheduler_milestones=(5, 2),
                                lr_scheduler_gamma=0.1), FlatParams(model, ["weight", "bias"]))
    rates = []
    for _ in range(6):
        rates.append(float(opt.learning_rate()))
        opt.step()
    np.testing.assert_allclose(rates, [float(schedule(c)) for c in range(6)], rtol=1e-7)
    np.testing.assert_allclose(rates, [3e-4, 3e-4, 3e-5, 3e-5, 3e-5, 3e-6], rtol=1e-6)
    constant = Optimizer(OptimConfig(optimizer="adam", lr_scheduler_type="constant"), FlatParams(model, ["weight"]))
    assert float(constant.learning_rate()) == pytest.approx(1e-4)


@pytest.mark.parametrize("optimizer", OPTIMS)
def test_losses_over_five_steps_match_jax(flax_model, optimizer):
    state, step, _, trainer = pair(flax_model, optimizer)
    batch = make_batch(4)
    want, got = [], []
    for _ in range(5):
        state, m = step(state, as_jax(batch))
        want.append(float(m["total"]))
        got.append(float(trainer.train_step(as_torch(batch))["total"]))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert int(trainer.step) == int(state.step) == 5


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
