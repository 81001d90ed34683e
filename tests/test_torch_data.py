"""The port's stage-1 data pipeline against the JAX package's (OpenCV).

Same inputs and the same ``np.random.Generator`` seeds through
``synthesize_labels``, ``classifier_sample`` and ``batch_iterator`` of both
packages: images and SDF to atol 1e-5, masks and labels exact, the
generators still in step afterwards. The chamfer EDT (plain numpy and the
g++ library) against ``cv2.distanceTransform``: equal bits between the two
port versions, and within 3e-6 of the map's largest distance of OpenCV,
which (through Intel IPP) keeps some running sums more exactly than
sequential float32 additions; the difference grows with the distance, so
1e-6 absolute holds only up to distances of ~30 pixels (the measured
relative differences are up to 2.6e-6). Where a background square's EDT
maximum is a near-tie, the two
packages may pick different squares; the test holds the port's pick to a
maximum of OpenCV's map within that bound.
"""

import itertools
import os

import cv2
import numpy as np
import pytest

from unmore_tpu.data import existence as jax_existence
from unmore_tpu.data import votecut as jax_votecut
from unmore_tpu_torch.data import existence, votecut
from unmore_tpu_torch.data.prefetch import PrefetchIterator
from unmore_tpu_torch.ops import labels
from unmore_tpu_torch.ops.labels import distance_transform, distance_transform_plain

IMAGE_SHAPES = [(375, 500), (500, 375), (333, 500), (237, 190), (60, 50), (360, 400)]


def blob_world(seed, h, w):
    """An image with one solid rectangle-and-disc object and its mask."""
    rng = np.random.RandomState(seed)
    image = rng.rand(h, w, 3).astype(np.float32)
    yy, xx = np.mgrid[:h, :w]
    cy, cx = rng.randint(h // 4, 3 * h // 4), rng.randint(w // 4, 3 * w // 4)
    mask = ((yy - cy) ** 2 + (xx - cx) ** 2 < (min(h, w) // 5) ** 2)
    mask[cy : cy + h // 6, max(cx - w // 3, 0) : cx] = True
    image[mask] = rng.rand(3)
    return image, mask.astype(np.uint8)


@pytest.mark.parametrize("shape", [(64, 48), (100, 130), (37, 91), (128, 128)])
def test_edt_library_plain_and_opencv(shape):
    rng = np.random.RandomState(shape[0])
    _, mask = blob_world(shape[1], *shape)
    holes = mask.copy()
    holes[rng.rand(*shape) < 0.03] = 0
    for m in (mask, 1 - mask, np.pad(1 - mask, 10), holes, holes * 255):
        got = distance_transform(m)
        np.testing.assert_array_equal(got, distance_transform_plain(m))
        want = cv2.distanceTransform(m.astype(np.uint8), cv2.DIST_L2, 3)
        np.testing.assert_allclose(got, want, rtol=0, atol=3e-6 * want.max())
    full = np.ones(shape, np.uint8)  # no zero pixel: FLT_MAX, as OpenCV
    np.testing.assert_array_equal(distance_transform(full), cv2.distanceTransform(full, cv2.DIST_L2, 3))


def test_edt_at_the_pre_resize_size():
    _, mask = blob_world(3, 400, 400)
    for m in (mask, 1 - mask):
        want = cv2.distanceTransform(m, cv2.DIST_L2, 3)
        got = distance_transform(m)
        assert np.abs(got - want).max() <= 3e-6 * want.max()


@pytest.mark.parametrize("src,dst", [((375, 500), (400, 400)), ((360, 400), (400, 400)), ((237, 190), (400, 400)),
                                     ((400, 400), (128, 128)), ((97, 83), (128, 128)), ((5, 3), (128, 128))])
def test_resizes_match_opencv(src, dst):
    big = np.random.RandomState(0).rand(src[0] + 7, src[1] + 9, 3).astype(np.float32)
    x = big[3 : 3 + src[0], 5 : 5 + src[1]]  # a crop: strided rows, as the pipeline passes them
    want = cv2.resize(np.ascontiguousarray(x), dst[::-1], interpolation=cv2.INTER_LINEAR)
    got = labels.resize_linear(x, dst)
    np.testing.assert_array_equal(got, labels.resize_linear_plain(x, dst))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-7)
    np.testing.assert_array_equal(labels.resize_linear(x[..., 0], dst), labels.resize_linear_plain(x[..., 0], dst))
    np.testing.assert_allclose(labels.resize_linear(x[..., 0], dst), want[..., 0], rtol=0, atol=2e-7)
    m = (big[..., 0] > 0.5).astype(np.uint8)[3 : 3 + src[0], 5 : 5 + src[1]]
    want = cv2.resize(np.ascontiguousarray(m), dst[::-1], interpolation=cv2.INTER_NEAREST)
    np.testing.assert_array_equal(labels.resize_nearest(m, dst), want)
    np.testing.assert_array_equal(labels.resize_nearest_plain(m, dst), want)


@pytest.mark.parametrize("shape", IMAGE_SHAPES)
@pytest.mark.parametrize("use_bg_sdf,random_crop", [(True, True), (False, True), (True, False)])
def test_synthesize_labels_matches_jax(shape, use_bg_sdf, random_crop):
    image, mask = blob_world(7, *shape)
    for seed in range(3):
        r_jax, r_port = np.random.default_rng(seed), np.random.default_rng(seed)
        want = jax_votecut.synthesize_labels(image, mask, 128, use_bg_sdf, r_jax, random_crop=random_crop)
        got = votecut.synthesize_labels(image, mask, 128, use_bg_sdf, r_port, random_crop=random_crop)
        if want is None:
            assert got is None
            continue
        np.testing.assert_allclose(got.image, want.image, rtol=0, atol=1e-5)
        np.testing.assert_allclose(got.sdf, want.sdf, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(got.saliency_mask, want.saliency_mask)
        np.testing.assert_allclose(got.center_field, want.center_field, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(got.object_center, want.object_center)
        assert r_port.integers(0, 2**31) == r_jax.integers(0, 2**31), "the generators fell out of step"
    assert votecut.synthesize_labels(image, np.zeros_like(mask), 64) is None


def test_classifier_sample_matches_jax():
    exact = near_tie = 0
    for k in range(60):
        image, mask = blob_world(k % 12, *IMAGE_SHAPES[k % len(IMAGE_SHAPES)])
        r_jax, r_port = np.random.default_rng(k), np.random.default_rng(k)
        want_img, want_label = jax_existence.classifier_sample(image, mask, mask, 64, r_jax)
        got_img, got_label = existence.classifier_sample(image, mask, mask, 64, r_port)
        assert got_label == want_label and got_img.shape == (64, 64, 3) and got_img.dtype == np.float32
        assert r_port.integers(0, 2**31) == r_jax.integers(0, 2**31), "the generators fell out of step"
        if np.abs(got_img - want_img).max() <= 1e-5:
            exact += 1
            continue
        # a background square whose EDT maximum is a near-tie: the port's
        # centre must be a maximum of OpenCV's map within the EDT bound
        assert want_label == 0.0
        bg = np.pad((1 - (mask > 0)).astype(np.uint8), 10)
        d_cv = cv2.distanceTransform(bg, cv2.DIST_L2, 3)[10:-10, 10:-10]
        d_port = distance_transform(bg)[10:-10, 10:-10]
        at = np.unravel_index(int(d_port.argmax()), d_port.shape)
        assert d_cv.max() - d_cv[at] <= 3e-6 * d_cv.max()
        near_tie += 1
    assert exact >= 50, (exact, near_tie)


def test_background_square_crop_matches_jax_on_unique_maxima():
    image, mask = blob_world(1, 100, 100)
    mask[:, :60] = 1  # the background is a strip: its EDT maximum is unique
    mask[20:, 90:] = 1
    np.testing.assert_array_equal(existence.background_square_crop(image, mask),
                                  jax_existence.background_square_crop(image, mask))


def test_batch_iterator_wire_format_matches_jax():
    image, mask = blob_world(5, 120, 160)
    batches = []
    for module in (jax_votecut, votecut):
        rng = np.random.default_rng(11)
        it = module.batch_iterator(lambda i, m=module, r=rng: m.synthesize_labels(image, mask, 32, rng=r), 10, 4, rng)
        batches.append([next(it) for _ in range(2)])
    for want, got in zip(*batches):
        assert {k: v.dtype for k, v in got.items()} == {"image": np.uint8, "center_field": np.float16,
                                                         "sdf": np.float16, "saliency_mask": np.uint8}
        assert got["image"].shape == (4, 32, 32, 3) and got["center_field"].shape == (4, 32, 32, 2)
        assert np.abs(got["image"].astype(int) - want["image"].astype(int)).max() <= 1  # rounding at .5
        np.testing.assert_array_equal(got["saliency_mask"], want["saliency_mask"])
        np.testing.assert_allclose(got["sdf"].astype(np.float32), want["sdf"].astype(np.float32), atol=1e-3)
        np.testing.assert_array_equal(got["center_field"], want["center_field"])


def test_png_loading_matches_opencv(tmp_path):
    rng = np.random.RandomState(0)
    img = (rng.rand(30, 40, 3) * 255).astype(np.uint8)
    # PNG bytes under the ImageNet name: both decoders give the same pixels
    assert cv2.imwrite(str(tmp_path / "a.png"), img[..., ::-1])
    os.replace(tmp_path / "a.png", tmp_path / "a.JPEG")
    cases = {"binary255": (rng.rand(30, 40) > 0.5) * 255, "binary01": (rng.rand(30, 40) > 0.5) * 1,
             "rotated": (rng.rand(40, 30) > 0.5) * 255}
    for name, m in cases.items():
        cv2.imwrite(str(tmp_path / f"{name}.png"), m.astype(np.uint8))
        want = jax_votecut.load_image_mask_pair(str(tmp_path / "a.JPEG"), str(tmp_path / f"{name}.png"))
        got = votecut.load_image_mask_pair(str(tmp_path / "a.JPEG"), str(tmp_path / f"{name}.png"))
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    assert votecut.load_image_mask_pair(str(tmp_path / "missing.JPEG"), str(tmp_path / "binary01.png")) == (None, None)


def test_prefetch_threads_deliver_and_surface_errors():
    counter = itertools.count()  # next() on it is atomic: the workers share it

    it = PrefetchIterator(make_batch=lambda: next(counter), num_workers=3, depth=2)
    try:
        got = [next(it) for _ in range(20)]
        assert len(set(got)) == 20 and 0.0 <= it.starved_fraction <= 1.0
    finally:
        it.close()

    def broken():
        raise OSError("disk gone")

    it = PrefetchIterator(worker_fns=[broken])
    with pytest.raises(OSError, match="disk gone"):
        next(it)
