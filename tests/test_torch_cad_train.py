"""The port's CAD training path against the JAX package's on the CPU.

One tiny detector (``tests/test_detector.py``'s ``_tiny_cfg``: canvas 64,
trunk blocks (1, 1, 1, 1), RPN top-k 32, 16 stage samples) and one jitted
JAX function of every reference value a precision, built once per file. The
samplers' uniform draws are JAX's (``jax.random.uniform`` of the keys the
JAX code splits), passed to the port. The modules are held against the JAX
functions run op by op (the port gives their bits: a jit's fusions round
differently); the whole forward against one jit. Tolerances: labels, sample
masks and matched indices exact; module losses and mask targets 1e-6; the
training forward in f32: losses 3e-5 relative (measured up to 1.2e-5, the
cascade heads' f32 sums in another order), new BatchNorm statistics 1e-5.
Gradients are held in float64 on both sides (JAX under
``jax.enable_x64``): at this size the f32 gradient is ill-conditioned (the
JAX package's own f32 trunk gradient lies 1.65e-2 of the max-abs from its
f64 one, where the two packages' f64 gradients agree to 1.5e-7). There:
losses 1e-5 relative, gradients 2e-4 of their max-abs (as
``tests/test_model_parity.py``), statistics 1e-5. The optimizer over five
f32 steps 1e-6, its state included; PreciseBN 5e-5 (measured 1.7e-5:
flax's E[x^2] - E[x]^2 and the inverted momentum). Whole steps and
checkpoints: ``tests/test_torch_cad_steps.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import optax

from tests.test_detector import _tiny_cfg
from unmore_tpu.detector import anchors as jax_anchors
from unmore_tpu.detector import box_ops as jbox
from unmore_tpu.detector import heads as jheads
from unmore_tpu.detector.cascade_rcnn import CascadeMaskRCNN as JaxDetector
from unmore_tpu.detector.cascade_rcnn import detector_forward_train as jax_forward_train
from unmore_tpu.detector.rpn import rpn_losses as jax_rpn_losses
from unmore_tpu.train.detector import init_detector_state, make_detector_optimizer
from unmore_tpu.train.precise_bn import precise_bn_stats as jax_precise_bn_stats
from unmore_tpu_torch.detector import box_ops, convert, heads
from unmore_tpu_torch.detector.cascade_rcnn import (
    CascadeMaskRCNN, DetectorConfig, detector_forward_train, normalize, train_proposal_count,
)
from unmore_tpu_torch.detector.rpn import rpn_losses
from unmore_tpu_torch.train.detector import DetectorSGD, DetectorTrainer
from unmore_tpu_torch.train.optim import FlatParams
from unmore_tpu_torch.train.precise_bn import precise_bn_stats

JCFG = dataclasses.replace(_tiny_cfg(), stage_samples=16, precision=jax.lax.Precision.HIGHEST)
JCFG64 = dataclasses.replace(JCFG, dtype=jnp.float64)
PORT_CFG = dict(image_size=64, max_gt=8, gt_mask_res=16, rpn_pre_nms_topk_train=32, rpn_pre_nms_topk_test=16,
                rpn_post_nms_topk_train=32, rpn_post_nms_topk_test=16, stage_samples=16, detections_per_image=8,
                stage_blocks=(1, 1, 1, 1))
OPTIM = dict(base_lr=0.01, warmup_iters=4)
B = 2


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _boxes(rng, n, lo, hi, size):
    xy = rng.rand(n, 2).astype(np.float32) * size
    wh = rng.rand(n, 2).astype(np.float32) * (hi - lo) + lo
    return np.concatenate([xy - wh / 2, xy + wh / 2], -1).astype(np.float32)


def _batch(seed=0):
    """Two 64x64 images in the wire format (uint8 images and masks): three
    GTs of scores 0.9/0.8/0.6 on the first, one on the second, which is a
    single-object (ImageNet) image."""
    rng = np.random.RandomState(seed)
    G, R = JCFG.max_gt, JCFG.gt_mask_res
    gt_boxes = np.zeros((B, G, 4), np.float32)
    gt_valid = np.zeros((B, G), bool)
    gt_scores = np.zeros((B, G), np.float32)
    gt_masks = np.zeros((B, G, R, R), np.uint8)
    yy, xx = np.mgrid[:R, :R]
    for b, n in enumerate((3, 1)):
        for g in range(n):
            x1, y1 = rng.rand(2) * 28
            w, h = rng.rand(2) * 20 + 16
            gt_boxes[b, g] = [x1, y1, min(x1 + w, 64), min(y1 + h, 64)]
            gt_valid[b, g] = True
            gt_scores[b, g] = (0.9, 0.8, 0.6)[g]
            r = rng.rand() * 3 + 5
            gt_masks[b, g] = np.clip(255 * (r - np.hypot(yy - 7.5, xx - 7.5)), 0, 255).astype(np.uint8)
    return {"images": (rng.rand(B, 64, 64, 3) * 255).astype(np.uint8),
            "image_hw": np.array([[64, 64], [56, 60]], np.float32), "gt_boxes": gt_boxes, "gt_scores": gt_scores,
            "gt_valid": gt_valid, "gt_masks": gt_masks, "is_single_object": np.array([0.0, 1.0], np.float32)}


def _modules_inputs(rng):
    """Seeded inputs of the matchers, samplers and losses, batch of 2."""
    anchors = np.concatenate(jax_anchors.fpn_anchors(64)).astype(np.float32)
    A, G, P = len(anchors), 6, 40
    gt = np.stack([_boxes(rng, G, 8, 40, 64) for _ in range(B)])
    gt[:, 1] = gt[:, 0]  # a duplicate GT: ties in the best-per-GT match
    valid = np.ones((B, G), bool)
    valid[0, 4:] = False
    valid[1] = False  # no valid GT: every anchor bg
    return {
        "anchors": anchors, "objectness": rng.randn(B, A).astype(np.float32) * 2,
        "deltas": rng.randn(B, A, 4).astype(np.float32) * 0.3, "gt_boxes": gt, "gt_valid": valid,
        "gt_valid2": np.ones((B, G), bool), "gt_scores": rng.uniform(0.3, 1.0, (B, G)).astype(np.float32),
        "proposals": np.concatenate([np.stack([_boxes(rng, P - 8, 6, 40, 64) for _ in range(B)]),
                                     gt[:, :4] + rng.randn(B, 4, 4).astype(np.float32),
                                     np.zeros((B, 4, 4), np.float32)], 1),
        "prop_valid": np.arange(P)[None].repeat(B, 0) < P - 4,
        "scores": rng.randn(B, P, 2).astype(np.float32), "box_deltas": rng.randn(B, P, 4).astype(np.float32) * 0.5,
        "drop_w": (rng.rand(B, P) > 0.3).astype(np.float32),
        "mask_logits": rng.randn(B, P, 28, 28).astype(np.float32) * 3,
        "roi_masks": rng.rand(B, G, 16, 16).astype(np.float32),
        "single": np.array([0.0, 1.0], np.float32),
        "iou_a": np.round(rng.rand(B, 5, 30), 1).astype(np.float32),  # ties
        "keys": jax.random.split(jax.random.PRNGKey(5), B * 2).reshape(B, 2, 2),
    }


def _jax_modules(m):
    """Every module-level JAX reference, vmapped over the batch."""
    A, P = m["anchors"].shape[0], m["proposals"].shape[1]
    G = m["gt_boxes"].shape[1]
    out = {"rpn_u": jax.vmap(lambda k: jax.random.uniform(k, (A,)))(m["keys"][:, 0]),
           "s0_u": jax.vmap(lambda k: jax.random.uniform(k, (P + G,)))(m["keys"][:, 1])}
    out["rpn"] = jax.vmap(lambda o, d, g, v, k: jax_rpn_losses(m["anchors"], o, d, g, v, k))(
        m["objectness"], m["deltas"], m["gt_boxes"], m["gt_valid"], m["keys"][:, 0])
    out["match"] = jax.vmap(lambda iou: jbox.match_proposals(iou, (0.3, 0.7), (0, -1, 1), True))(m["iou_a"])
    out["match_plain"] = jax.vmap(lambda iou: jbox.match_proposals(iou, (0.5,), (0, 1)))(m["iou_a"])
    out["subsample"] = jax.vmap(lambda lab, k: jbox.subsample_labels(lab, 12, 0.25, k))(
        out["match"][1], m["keys"][:, 0, :])
    out["s0"] = jax.vmap(lambda p, pv, g, s, v, k: jheads.sample_stage0(p, pv, g, s, v, k, 16, 0.25, 0.5))(
        m["proposals"], m["prop_valid"], m["gt_boxes"], m["gt_scores"], m["gt_valid"], m["keys"][:, 1])
    out["mal"] = jax.vmap(lambda p, pv, g, s, v: jheads.match_and_label(p, pv, g, s, v, 0.6))(
        m["proposals"], m["prop_valid"], m["gt_boxes"], m["gt_scores"], m["gt_valid2"])
    mal = out["mal"]
    out["ce"] = jax.vmap(jheads.softmax_ce_soft_targets)(m["scores"], mal["fg"], mal["gt_score"], m["drop_w"],
                                                         m["prop_valid"])
    out["reg"] = jax.vmap(lambda p, d, f, gb, gs, v: jheads.soft_box_reg_loss(p, d, f, gb, gs, v, (10., 10., 5., 5.)))(
        m["proposals"], m["box_deltas"], mal["fg"], mal["gt_box"], mal["gt_score"], m["prop_valid"])
    out["drop"] = jax.vmap(jheads.droploss_weights)(m["proposals"] + m["box_deltas"], m["gt_boxes"], m["gt_valid2"],
                                                    m["single"])
    targets = jax.vmap(lambda gm, gb, mi, p: jheads.crop_gt_mask_to_proposals(gm, gb, mi, p, 28))(
        m["roi_masks"], m["gt_boxes"], mal["matched_idx"], m["proposals"])
    out["crop"] = targets
    out["mask"] = jax.vmap(jheads.mask_loss_weighted)(m["mask_logits"], targets, mal["fg"], mal["gt_score"])
    out["l1"] = (jbox.smooth_l1(m["deltas"], m["deltas"][::-1]), jbox.smooth_l1(m["deltas"], m["deltas"][::-1], 0.5))
    return out


def _draws(step_rng, A, P0):
    rngs = jax.random.split(step_rng, B * 2).reshape(B, 2, 2)
    return {"rpn": jax.vmap(lambda k: jax.random.uniform(k, (A,)))(rngs[:, 0]),
            "stage0": jax.vmap(lambda k: jax.random.uniform(k, (P0,)))(rngs[:, 1])}


def _f64(tree):
    """Every float32 leaf of ``tree`` as float64 numpy (the rest as numpy)."""
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float64) if np.asarray(x).dtype == np.float32
                                  else np.asarray(x), tree)


def initial_state():
    """(the JAX detector, its optimizer, its initial ``DetectorTrainState``
    as numpy, with random BatchNorm statistics)."""
    jmodel = JaxDetector(JCFG)
    tx = make_detector_optimizer(**OPTIM)
    state = init_detector_state(jmodel, tx, jax.random.PRNGKey(7), JCFG)
    rng = np.random.RandomState(1)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, x: rng.uniform(0.5, 1.5, x.shape).astype(np.float32) if p[-1].key == "var"
        else rng.uniform(-0.1, 0.1, x.shape).astype(np.float32), _np(state.batch_stats))
    return jmodel, tx, _np(state.replace(batch_stats=stats))


def draw_sizes(port_cfg):
    """(anchors, stage-0 proposals with the GTs) of an image: the draws' sizes."""
    return sum(len(a) for a in jax_anchors.fpn_anchors(64)), train_proposal_count(port_cfg) + JCFG.max_gt


@pytest.fixture(scope="module")
def world():
    jmodel, _, state = initial_state()
    batch = _batch()
    port_cfg = DetectorConfig(**PORT_CFG)
    A, P0 = draw_sizes(port_cfg)
    m = _modules_inputs(np.random.RandomState(2))

    def forward32(params, batch_stats, batch, rng):
        _, step_rng = jax.random.split(rng)
        losses, new_stats = jax_forward_train(jmodel, {"params": params, "batch_stats": batch_stats}, JCFG, batch,
                                              step_rng)

        def bn_apply(v, b):
            return jmodel.apply(v, (b - 0.5) * 2, train=True, mutable=["batch_stats"])[1]["batch_stats"]

        images = jnp.asarray(batch["images"], jnp.float32) / 255.0
        precise = jax_precise_bn_stats(bn_apply, params, batch_stats, [images, images[::-1] ** 2])
        return {"losses": losses, "new_stats": new_stats, "draws": _draws(step_rng, A, P0), "precise": precise}

    want = _np(jax.jit(forward32)(state.params, state.batch_stats, batch, state.rng))
    # the modules op by op: a jit's fusions round differently (a fused IoU
    # recomputed beside its max loses the RPN's iou == best-per-GT ties)
    want["modules"] = _np(_jax_modules(m))

    # the gradient in float64, the draws too
    jmodel64 = JaxDetector(JCFG64)
    state64, batch64 = _f64(state), _f64(batch)

    def forward64(params, batch_stats, batch, rng):
        _, step_rng = jax.random.split(rng)

        def loss_fn(p):
            losses, new_stats = jax_forward_train(jmodel64, {"params": p, "batch_stats": batch_stats}, JCFG64,
                                                  batch, step_rng)
            return sum(losses.values()), (losses, new_stats)

        (_, (losses, new_stats)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        return {"losses": losses, "grads": grads, "new_stats": new_stats, "draws": _draws(step_rng, A, P0)}

    with jax.enable_x64(True):
        want64 = _np(jax.jit(forward64)(state64.params, state64.batch_stats, batch64, jnp.asarray(state64.rng)))
    return dict(state=state, batch=batch, batch64=batch64, want=want, want64=want64, m=m, port_cfg=port_cfg)


def _port_model(world, remat=True, dtype=torch.float32):
    model = CascadeMaskRCNN(dataclasses.replace(world["port_cfg"], remat_backbone=remat))
    state = world["state"]
    model.load_state_dict(convert.state_dict_from_flax({"params": state.params, "batch_stats": state.batch_stats}))
    return model.to(dtype)


def _tbatch(batch):
    return {k: _t(v) for k, v in batch.items()}


def _tdraws(d):
    return {k: _t(v) for k, v in d.items()}


def _rel(got, want):
    return abs(got - want) / max(abs(want), 1e-12)


def test_smooth_l1_and_match_proposals(world):
    m, want = world["m"], world["want"]["modules"]
    a, b = _t(m["deltas"]), _t(m["deltas"][::-1])
    np.testing.assert_allclose(box_ops.smooth_l1(a, b).numpy(), want["l1"][0], atol=1e-6)
    np.testing.assert_allclose(box_ops.smooth_l1(a, b, 0.5).numpy(), want["l1"][1], atol=1e-6)
    for key, args in (("match", ((0.3, 0.7), (0, -1, 1), True)), ("match_plain", ((0.5,), (0, 1)))):
        idx, labels = box_ops.match_proposals(_t(m["iou_a"]), *args)
        np.testing.assert_array_equal(idx.numpy(), want[key][0])
        np.testing.assert_array_equal(labels.numpy(), want[key][1])
    assert (want["match"][1] == -1).any() and (want["match"][1] == 1).any()


def test_subsample_labels_with_jax_draws(world):
    want = world["want"]["modules"]
    draws = jax.vmap(lambda k: jax.random.uniform(k, (30,)))(world["m"]["keys"][:, 0, :])
    sampled, fg = box_ops.subsample_labels(_t(want["match"][1]), 12, 0.25, _t(draws))
    np.testing.assert_array_equal(sampled.numpy(), want["subsample"][0])
    np.testing.assert_array_equal(fg.numpy(), want["subsample"][1])
    assert (want["subsample"][1].sum(axis=1) == 3).all()  # the fg cap, 12 x 0.25, binds


def test_rpn_losses_match(world):
    m, want = world["m"], world["want"]["modules"]
    got = rpn_losses(_t(m["anchors"]), _t(m["objectness"]), _t(m["deltas"]), _t(m["gt_boxes"]), _t(m["gt_valid"]),
                     _t(want["rpn_u"]))
    for k in ("loss_rpn_cls", "loss_rpn_loc"):
        np.testing.assert_allclose(got[k].numpy(), want["rpn"][k], atol=1e-6, rtol=1e-6)
    assert want["rpn"]["loss_rpn_loc"][0] > 0 and want["rpn"]["loss_rpn_loc"][1] == 0  # image 2: no valid GT


def test_stage_matching_and_sampling_match(world):
    m, want = world["m"], world["want"]["modules"]
    s0 = heads.sample_stage0(_t(m["proposals"]), _t(m["prop_valid"]), _t(m["gt_boxes"]), _t(m["gt_scores"]),
                             _t(m["gt_valid"]), _t(want["s0_u"]), 16, 0.25, 0.5)
    for k in ("valid", "fg", "matched_idx", "boxes", "gt_score", "gt_box"):
        np.testing.assert_array_equal(s0[k].numpy(), want["s0"][k], err_msg=k)
    assert want["s0"]["fg"][0].sum() > 0 and not want["s0"]["fg"][1].any()
    mal = heads.match_and_label(_t(m["proposals"]), _t(m["prop_valid"]), _t(m["gt_boxes"]), _t(m["gt_scores"]),
                                _t(m["gt_valid2"]), 0.6)
    for k in ("matched_idx", "fg", "gt_score", "gt_box"):
        np.testing.assert_array_equal(mal[k].numpy(), want["mal"][k], err_msg=k)


def test_head_losses_and_mask_targets_match(world):
    m, want = world["m"], world["want"]["modules"]
    mal = {k: _t(v) for k, v in want["mal"].items()}
    got = {
        "ce": heads.softmax_ce_soft_targets(_t(m["scores"]), mal["fg"], mal["gt_score"], _t(m["drop_w"]),
                                            _t(m["prop_valid"])),
        "reg": heads.soft_box_reg_loss(_t(m["proposals"]), _t(m["box_deltas"]), mal["fg"], mal["gt_box"],
                                       mal["gt_score"], _t(m["prop_valid"]), (10.0, 10.0, 5.0, 5.0)),
        "drop": heads.droploss_weights(_t(m["proposals"] + m["box_deltas"]), _t(m["gt_boxes"]), _t(m["gt_valid2"]),
                                       _t(m["single"])),
        "crop": heads.crop_gt_mask_to_proposals(_t(m["roi_masks"]), _t(m["gt_boxes"]), mal["matched_idx"],
                                                _t(m["proposals"]), 28),
    }
    got["mask"] = heads.mask_loss_weighted(_t(m["mask_logits"]), got["crop"], mal["fg"], mal["gt_score"])
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), want[k], atol=1e-6, rtol=1e-6, err_msg=k)
    assert (want["drop"][0] == 0).any() and (want["drop"][1] == 1).all()
    assert all(want[k].min() > 0 for k in ("ce", "reg", "mask"))


def _forward(world, dtype, want):
    model = _port_model(world, dtype=dtype).train()
    batch = world["batch"] if dtype == torch.float32 else world["batch64"]
    losses = detector_forward_train(model, model.cfg, _tbatch(batch), _tdraws(want["draws"]))
    assert list(losses) == sorted(want["losses"])
    return model, losses


def _assert_stats_match(model, want):
    stats = convert.flax_from_state_dict(model.state_dict())["batch_stats"]
    assert jax.tree_util.tree_structure(stats) == jax.tree_util.tree_structure(want["new_stats"])
    for got_s, want_s in zip(jax.tree_util.tree_leaves(stats), jax.tree_util.tree_leaves(want["new_stats"])):
        np.testing.assert_allclose(got_s, want_s, atol=1e-5, rtol=1e-5)


def test_forward_train_losses_and_stats_match_in_float32(world):
    want = world["want"]
    model, losses = _forward(world, torch.float32, want)
    for k, v in losses.items():
        assert want["losses"][k] > 0, k
        assert _rel(float(v), float(want["losses"][k])) <= 3e-5, (k, float(v), want["losses"][k])
    _assert_stats_match(model, want)


def test_forward_train_losses_grads_and_stats_match(world):
    """In float64 on both sides: f32 gradients of this tiny detector are
    ill-conditioned (the JAX package's own f32 trunk gradient is 1.65e-2 of
    the max-abs away from its f64 one), so they say nothing about the port."""
    want = world["want64"]
    model, losses = _forward(world, torch.float64, want)
    for k, v in losses.items():
        assert want["losses"][k] > 0, k
        assert _rel(float(v), float(want["losses"][k])) <= 1e-5, (k, float(v), want["losses"][k])
    sum(losses.values()).backward()
    grads = convert.flax_from_state_dict({**{n: p.grad for n, p in model.named_parameters()},
                                          **{n: b for n, b in model.named_buffers() if "running" in n}})["params"]
    assert jax.tree_util.tree_structure(grads) == jax.tree_util.tree_structure(dict(want["grads"]))
    flat_want = jax.tree_util.tree_leaves(want["grads"])
    scale = max(np.abs(g).max() for g in flat_want)
    for got_g, want_g in zip(jax.tree_util.tree_leaves(grads), flat_want):
        np.testing.assert_allclose(got_g, want_g, atol=2e-4 * scale)
    _assert_stats_match(model, want)


def test_remat_updates_batchnorm_once():
    """A checkpointed trunk recomputes its forward in the backward pass; the
    running statistics after one step equal those without checkpoints."""
    cfg = DetectorConfig(**PORT_CFG)
    torch.manual_seed(0)
    weights = CascadeMaskRCNN(cfg).state_dict()
    stats = []
    for remat in (True, False):
        model = CascadeMaskRCNN(dataclasses.replace(cfg, remat_backbone=remat))
        model.load_state_dict(weights)
        trainer = DetectorTrainer(model, model.cfg, OPTIM, dtype="float32")
        initial = trainer.stats.clone()
        trainer.generator.manual_seed(3)
        trainer.train_step(_tbatch(_batch(1)))
        stats.append(trainer.stats.clone())
        assert not torch.equal(stats[-1], initial)
    torch.testing.assert_close(stats[0], stats[1], rtol=0, atol=1e-7)


def test_optimizer_five_steps_match_optax():
    """Warmup (4 steps), a clipped step, a step with non-finite gradients
    (zeroed, parameters kept, state updated, as the JAX step does) and a step
    past warmup, on a small module."""
    torch.manual_seed(0)
    net = torch.nn.Sequential(torch.nn.Linear(5, 4), torch.nn.Linear(4, 3))
    flat = FlatParams(net, [n for n, _ in net.named_parameters()])
    opt = DetectorSGD(flat, **OPTIM)
    tx = make_detector_optimizer(**OPTIM)
    params = {n: jnp.asarray(p.detach().numpy()) for n, p in net.named_parameters()}
    state = tx.init(params)
    rng = np.random.RandomState(0)
    scales = (0.01, 5.0, 0.1, 0.02, 0.3)  # step 2: norm > 1, clipped
    for i, scale in enumerate(scales):
        grads = {n: rng.randn(*p.shape).astype(np.float32) * scale for n, p in params.items()}
        if i == 2:
            grads["0.weight"][0, 0] = np.nan
        ok = all(np.isfinite(g).all() for g in grads.values())
        flat.grad.copy_(flat.flatten(grads))
        opt.step(torch.tensor(ok))
        jgrads = {n: jnp.where(ok, g, 0.0) for n, g in grads.items()}
        updates, state = tx.update(jgrads, state, params)
        params = jax.tree_util.tree_map(lambda new, old: jnp.where(ok, new, old), optax.apply_updates(params, updates),
                                        params)
        got = dict(zip(flat.names, flat.views(flat.data)))
        trace = dict(zip(flat.names, flat.views(opt.trace)))
        for n in params:
            np.testing.assert_allclose(got[n].numpy(), params[n], atol=1e-6, rtol=0)
            np.testing.assert_allclose(trace[n].numpy(), state[2][0].trace[n], atol=1e-6, rtol=0)
        assert int(opt.count) == int(state[2][1].count) == i + 1
        if i == 1:
            assert float(optax.global_norm(grads)) > 1.0


def test_precise_bn_matches(world):
    model = _port_model(world)
    images = _t(world["batch"]["images"]).float() / 255.0
    before = {k: v.clone() for k, v in model.state_dict().items()}
    got = precise_bn_stats(model, lambda x: model.backbone.trunk(((x - 0.5) * 2).permute(0, 3, 1, 2)),
                           [images, images.flip(0) ** 2])
    assert all(torch.equal(v, model.state_dict()[k]) for k, v in before.items())
    got = convert.flax_from_state_dict({**dict(model.named_parameters()), **got})["batch_stats"]
    want = world["want"]["precise"]
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a, b, atol=5e-5, rtol=0)


def test_normalize_matches_for_training_images(world):
    from unmore_tpu.detector.cascade_rcnn import _normalize

    np.testing.assert_allclose(normalize(_t(world["batch"]["images"])).permute(0, 2, 3, 1).numpy(),
                               np.asarray(_normalize(world["batch"]["images"])), atol=1e-6)
