"""The port's fused center decode against the JAX package's.

On the CPU the wrapper runs the plain version; it is held against both the
JAX XLA path (``center_singularity_scores``) and the Pallas kernel in
interpret mode, with the bar of ``tests/test_pallas_decode.py``: union
exact, scores to atol 2e-5, argmax equal wherever the score is > 1e-4. The
kernel's launch geometry (bands, shared memory, scratch) is checked here
too. The CUDA kernel against the plain version needs the card; those tests
skip here. JAX is imported inside the tests that use it, so that on the
card's machine, which has no JAX, the file runs with

    python -m pytest --noconftest tests/test_torch_decode.py -m cuda
"""

import numpy as np
import pytest
import torch

from unmore_tpu_torch.ops import decode, fields
from unmore_tpu_torch.ops.fields import center_singularity_scores


def decode_inputs(B, S, seed):
    """Random fields plus one crop with an eroded blob and one all-background crop."""
    rng = np.random.RandomState(seed)
    sdf = (rng.randn(B, S, S) * 2).astype(np.float32)
    center = rng.randn(B, S, S, 2).astype(np.float32)
    sdf[0] = -1.0
    sdf[0, S // 8 : S - S // 8, S // 8 : S - S // 8] = 2.0
    if B > 1:
        sdf[1] = -1.0
        center[1] = 0.0
    return sdf, center


def assert_decode_bar(got, want):
    got_s, got_yx, got_u = (np.asarray(a) for a in got)
    want_s, want_yx, want_u = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(got_u, want_u)
    np.testing.assert_allclose(got_s, want_s, atol=2e-5)
    pos = want_s > 1e-4
    np.testing.assert_array_equal(got_yx[pos], want_yx[pos])
    return pos


@pytest.mark.parametrize("reference", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("B,S,seed", [(3, 64, 0), (4, 48, 1)])
def test_decode_matches_jax(reference, B, S, seed):
    import jax.numpy as jnp

    from unmore_tpu.ops.fields import center_singularity_scores as jax_xla_decode
    from unmore_tpu.ops.pallas.decode import fused_center_decode as jax_pallas_decode

    sdf, center = decode_inputs(B, S, seed)
    if reference == "xla":
        want = jax_xla_decode(jnp.asarray(sdf), jnp.asarray(center))
    else:
        want = jax_pallas_decode(jnp.asarray(sdf), jnp.asarray(center), interpret=True)
    got = decode.fused_center_decode(torch.from_numpy(sdf), torch.from_numpy(center))
    pos = assert_decode_bar([t.numpy() for t in got], want)
    assert pos[0], "the blob crop must give a meaningful score"
    assert got[1].dtype == torch.int32 and got[2].dtype == torch.int32


def test_cpu_call_never_touches_the_library_loader(monkeypatch):
    def refuse():
        raise AssertionError("library loader called for a CPU tensor")

    monkeypatch.setattr(decode, "_load_library", refuse)
    monkeypatch.setattr(decode, "load_library", refuse)
    before = decode.fused_center_decode.launches
    sdf, center = decode_inputs(2, 32, 2)
    decode.fused_center_decode(torch.from_numpy(sdf), torch.from_numpy(center))
    assert decode.fused_center_decode.launches == before


@pytest.mark.parametrize(
    "sdf_shape,center_shape,dtype",
    [((2, 16, 16), (2, 16, 16, 2), torch.float64), ((2, 16, 8), (2, 16, 8, 2), torch.float32),
     ((2, 16, 16), (2, 16, 16, 3), torch.float32), ((1, 300, 300), (1, 300, 300, 2), torch.float32)],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(sdf_shape, center_shape, dtype):
    with pytest.raises((TypeError, ValueError)):
        decode.fused_center_decode(torch.zeros(sdf_shape, dtype=dtype), torch.zeros(center_shape, dtype=dtype))


def test_wrapper_rejects_non_contiguous_fields():
    center = torch.zeros(2, 16, 16, 4)[..., 1:3]
    with pytest.raises(ValueError):
        decode.fused_center_decode(torch.zeros(2, 16, 16), center)


def test_wrapper_rejects_taps_past_the_parameter_limit():
    sdf, center = decode_inputs(1, 32, 3)
    with pytest.raises(ValueError, match="anti_k"):
        decode.fused_center_decode(torch.from_numpy(sdf), torch.from_numpy(center), anti_k=decode.MAX_ANTI_K + 2)


@pytest.mark.parametrize("erode_k,rounds", [(9, 3), (5, 2), (7, 1), (3, 4), (1, 2)])
def test_erosion_rounds_are_one_box_erosion(erode_k, rounds):
    # the kernel erodes once by a box of side 2 * rounds * (k // 2) + 1 where
    # the plain version runs `rounds` zero-padded k x k erosions
    rng = np.random.RandomState(erode_k * 10 + rounds)
    masks = torch.from_numpy((rng.rand(4, 100, 100) < 0.97).astype(np.int32))
    masks[0, 30:90, 20:70] = 1  # a blob with a large interior
    box = 2 * rounds * (erode_k // 2) + 1
    np.testing.assert_array_equal(fields.batch_erode(masks, erode_k, rounds).numpy(),
                                  fields.batch_erode(masks, box, 1).numpy())


@pytest.mark.parametrize("S", [1, 15, 16, 17, 48, 100, 128, 256])
def test_bands_cover_every_row_once(S):
    rows, n = decode.bands(S)
    assert rows % decode.STRIP_ROWS == 0
    covered = np.zeros(S, np.int64)
    for b in range(n):
        lo, hi = b * rows, min((b + 1) * rows, S)
        assert lo < hi, "every band holds a row"
        covered[lo:hi] += 1
    np.testing.assert_array_equal(covered, 1)


def test_scoring_shared_memory_fits_a_block():
    smem_per_block = 232_448  # what a block may use on Hopper (227 KB)
    for S in range(1, decode.MAX_SIZE + 1):
        for anti_k in range(1, decode.MAX_ANTI_K + 1, 2):
            # 1 KiB left for the kernel's static shared memory (its warp maxima)
            assert decode.smem_bytes(S, anti_k) + 1024 <= smem_per_block, (S, anti_k)
    # the main path's crop: two 2 KiB masks, and cy and cx over a band's rows +- 2 by 128 + 4 columns
    assert decode.smem_bytes(128, 5) == 2 * 2048 + 2 * 4 * (decode.BAND_ROWS + 4) * 132


@pytest.mark.parametrize("S,words", [(1, 1), (32, 1), (48, 2), (100, 4), (128, 4), (256, 8)])
def test_workspace_holds_keys_and_padded_bits(S, words):
    B = 3
    # the 64-bit keys come first, at the allocation's alignment; the bits follow
    assert decode.workspace_bytes(B, S) == 8 * B + 4 * B * S * words


def card_inputs(case):
    """(sdf [B,S,S], center [B,S,S,2], decode keyword arguments) of a card case."""
    rng = np.random.RandomState(11)
    if case in ("random_256", "random_32"):
        B = int(case.split("_")[1])
        return (*decode_inputs(B, 128, B), {})
    if case in ("S48", "S100", "S256"):
        S = int(case[1:])
        return (*decode_inputs(8, S, S), {})
    if case == "erode5x2_anti3":
        return (*decode_inputs(8, 64, 5), dict(border=4, erode_k=5, erode_rounds=2, anti_k=3))
    if case == "border0_erode1":  # no border: every pixel of a band takes part
        return (*decode_inputs(4, 48, 6), dict(border=0, erode_k=1, erode_rounds=1, anti_k=3))
    S = 128
    sdf = 1.0 + np.abs(rng.randn(16, S, S)).astype(np.float32)  # all foreground
    if case == "dense":
        return sdf, (rng.randn(16, S, S, 2) * 0.3).astype(np.float32), {}
    yy, xx = np.mgrid[:S, :S].astype(np.float32)
    if case == "all_negative":  # a source everywhere: every interior score < 0
        center = np.stack([yy - 61.5, xx - 70.5], axis=-1) * np.float32(0.01)
        return sdf, np.broadcast_to(center, (16, S, S, 2)).astype(np.float32).copy(), {}
    assert case == "tie"  # one sink patch, copied into bands 1 and 5 of each crop
    dy, dx = np.mgrid[-6:7, -6:7].astype(np.float32)
    norm = np.maximum(np.hypot(dy, dx), 1.0)
    center = np.zeros((16, S, S, 2), np.float32)
    for b in range(16):
        patch = np.stack([-dy / norm, -dx / norm], -1) + rng.randn(13, 13, 2).astype(np.float32) * 0.1
        x0 = 20 + 5 * b
        center[b, 18:31, x0 : x0 + 13] = patch
        center[b, 84:97, x0 : x0 + 13] = patch
    return sdf, center, {}


CARD_CASES = ["random_256", "random_32", "dense", "tie", "all_negative", "S48", "S100", "S256",
              "erode5x2_anti3", "border0_erode1"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES)
def test_kernel_matches_plain_on_the_card(case):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    sdf, center, kw = card_inputs(case)
    s, c = torch.from_numpy(sdf).cuda(), torch.from_numpy(center).cuda()
    before = decode.fused_center_decode.launches
    got = decode.fused_center_decode(s, c, **kw)
    torch.cuda.synchronize()
    assert decode.fused_center_decode.launches == before + 1
    want = center_singularity_scores(
        s, c, border=kw.get("border", 10), erode_kernel=kw.get("erode_k", 9),
        erode_rounds=kw.get("erode_rounds", 3), anti_kernel=kw.get("anti_k", 5),
    )
    got, want = [t.cpu().numpy() for t in got], [t.cpu().numpy() for t in want]
    pos = assert_decode_bar(got, want)
    if case == "all_negative":  # the max is a border pixel's 0, first at index 0
        np.testing.assert_array_equal(got[0], 0.0)
        np.testing.assert_array_equal(got[1], 0)
    elif case == "tie":  # the first of the two equal maxima, in the upper band
        assert pos.all() and (got[1][:, 0] < 64).all()
    elif case != "border0_erode1":
        assert pos.any(), "some crop must give a meaningful score"
