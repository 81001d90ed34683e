"""The port's stage-2 ops against the JAX package's, on seeded numpy inputs.

Resampling to atol 1e-5 (f32 arithmetic in the same order; the JAX side at
``Precision.HIGHEST``); connected components, NMS and seeds exact.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from unmore_tpu.ops import connected_components as jcc
from unmore_tpu.ops import fields as jfields
from unmore_tpu.ops import image as jimage
from unmore_tpu.ops.nms import nms_mask as jnms
from unmore_tpu.reasoning import proposals as jprop
from unmore_tpu_torch.ops import connected_components as tcc
from unmore_tpu_torch.ops import fields as tfields
from unmore_tpu_torch.ops import image as timage
from unmore_tpu_torch.ops.nms import nms_mask as tnms
from unmore_tpu_torch.reasoning import proposals as tprop


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("shape,out_hw", [((2, 7, 9, 3), (13, 5)), ((1, 4, 4, 16), (8, 8))])
def test_resize_bilinear(align_corners, shape, out_hw):
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    want = np.asarray(jimage.resize_bilinear(jnp.asarray(x), out_hw, align_corners=align_corners))
    got = timage.resize_bilinear(torch.from_numpy(x), out_hw, align_corners=align_corners).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    # the NCHW form used inside the models is the same resize
    nchw = timage.resize_bilinear_nchw(torch.from_numpy(x).permute(0, 3, 1, 2), out_hw, align_corners)
    np.testing.assert_allclose(nchw.permute(0, 2, 3, 1).numpy(), want, atol=1e-5)


def test_resize_bilinear_bf16_input_runs_in_f32():
    x = np.random.RandomState(1).rand(1, 6, 6, 4).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = timage.resize_bilinear(xb, (12, 12), align_corners=True)
    assert got.dtype == torch.float32
    want = timage.resize_bilinear(xb.float(), (12, 12), align_corners=True)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_image_gradients():
    x = np.random.RandomState(2).randn(3, 11, 13).astype(np.float32)
    want = jimage.image_gradients(jnp.asarray(x))
    got = timage.image_gradients(torch.from_numpy(x))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


@pytest.mark.parametrize("batched", [False, True])
def test_crop_and_resize(batched):
    rng = np.random.RandomState(3)
    images = rng.rand(2, 50, 70, 3).astype(np.float32)
    P = 37
    x1 = rng.uniform(-5, 60, P)
    y1 = rng.uniform(-5, 40, P)
    boxes = np.stack(
        [x1, y1, x1 + rng.uniform(0.3, 40, P), y1 + rng.uniform(0.3, 30, P)], axis=1
    ).astype(np.float32)
    boxes[0] = (0, 0, 70, 50)  # the full image
    boxes[1] = (10, 10, 10.5, 10.5)  # sub-pixel box
    idx = rng.randint(0, 2, P).astype(np.int32)
    if batched:
        want = jimage.crop_and_resize(jnp.asarray(images), jnp.asarray(boxes), out_size=16, chunk=8,
                                      image_idx=jnp.asarray(idx))
        got = timage.crop_and_resize(torch.from_numpy(images), torch.from_numpy(boxes), out_size=16, chunk=8,
                                     image_idx=torch.from_numpy(idx))
    else:
        want = jimage.crop_and_resize(jnp.asarray(images[0]), jnp.asarray(boxes), out_size=16, chunk=8)
        got = timage.crop_and_resize(torch.from_numpy(images[0]), torch.from_numpy(boxes), out_size=16, chunk=8)
    assert got.shape == (P, 16, 16, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def _masks(seed, B=4, S=40):
    rng = np.random.RandomState(seed)
    masks = (rng.rand(B, S, S) > 0.55).astype(np.int32)  # many small components
    masks[1] = 0
    masks[1, 5:15, 5:30] = 1  # one blob
    masks[1, 20:35, 2:8] = 1  # and another
    masks[2] = 0  # empty
    masks[3] = 1  # full
    return masks


@pytest.mark.parametrize("max_iters", [1024, 3])
def test_label_components_batched_matches_per_mask(max_iters):
    masks = _masks(4)
    got = tcc.label_components(torch.from_numpy(masks), max_iters=max_iters).numpy()
    for b in range(masks.shape[0]):
        want = np.asarray(jcc.label_components(jnp.asarray(masks[b]), max_iters=max_iters))
        np.testing.assert_array_equal(got[b], want)


def test_component_boxes():
    masks = _masks(5)
    labels = tcc.label_components(torch.from_numpy(masks))
    boxes, valid, counts = tcc.component_boxes(labels, max_components=6)
    assert int(counts[0]) == 6  # more components than slots: capped
    for b in range(masks.shape[0]):
        jl = jcc.label_components(jnp.asarray(masks[b]))
        wb, wv, wc = jcc.component_boxes(jl, max_components=6)
        np.testing.assert_array_equal(boxes[b].numpy(), np.asarray(wb))
        np.testing.assert_array_equal(valid[b].numpy(), np.asarray(wv))
        assert int(counts[b]) == int(wc)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nms_mask_with_ties_and_padding(seed):
    rng = np.random.RandomState(seed)
    N = 60
    xy = rng.uniform(0, 50, (N, 2))
    wh = rng.uniform(5, 30, (N, 2))
    boxes = np.concatenate([xy, xy + wh], axis=1).astype(np.float32)
    boxes[10] = boxes[3]  # exact duplicates tie on IoU 1
    scores = rng.choice([0.2, 0.5, 0.9], N).astype(np.float32)  # many score ties
    valid = rng.rand(N) > 0.2
    valid[0] = True
    boxes[np.flatnonzero(~valid)[:5]] = boxes[0]  # padding on a valid box never suppresses it
    want = np.asarray(jnms(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid), iou_threshold=0.5))
    got = tnms(torch.from_numpy(boxes), torch.from_numpy(scores), torch.from_numpy(valid), 0.5).numpy()
    np.testing.assert_array_equal(got, want)
    assert not got[~valid].any()


def test_nms_all_equal_scores_keeps_index_order():
    boxes = np.array([[0, 0, 10, 10], [1, 1, 11, 11], [0, 0, 10, 10], [50, 50, 60, 60]], np.float32)
    valid = np.array([False, True, True, True])
    got = tnms(torch.from_numpy(boxes), torch.ones(4), torch.from_numpy(valid), 0.5).numpy()
    want = np.asarray(jnms(jnp.asarray(boxes), jnp.ones(4), jnp.asarray(valid), iou_threshold=0.5))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [False, True, False, True])


@pytest.mark.parametrize("hw", [(480, 640), (200, 200), (96, 96), (1, 1), (333, 17)])
def test_seed_proposals_identical(hw):
    np.testing.assert_array_equal(tprop.seed_proposals(*hw), jprop.seed_proposals(*hw))
    assert tprop.max_seed_count(*hw) == jprop.max_seed_count(*hw)


def test_field_ops_match_jax():
    rng = np.random.RandomState(6)
    sdf = (rng.randn(3, 32, 32) * 2).astype(np.float32)
    center = rng.randn(3, 32, 32, 2).astype(np.float32)
    sdf[0] = -1.0
    sdf[0, 4:28, 4:28] = 2.0
    union = tfields.union_binary_mask(torch.from_numpy(sdf), torch.from_numpy(center))
    np.testing.assert_array_equal(
        union.numpy(), np.asarray(jfields.union_binary_mask(jnp.asarray(sdf), jnp.asarray(center)))
    )
    np.testing.assert_array_equal(
        tfields.batch_erode(union, 5, 2).numpy(), np.asarray(jfields.batch_erode(jnp.asarray(union.numpy()), 5, 2))
    )
    np.testing.assert_allclose(
        tfields.anti_center_map(torch.from_numpy(center)).numpy(),
        np.asarray(jfields.anti_center_map(jnp.asarray(center))),
        atol=2e-5,
    )
    np.testing.assert_array_equal(tfields._anti_center_kernel(5), jfields._anti_center_kernel(5))
