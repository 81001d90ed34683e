"""The port's fused center decode against the JAX package's.

On the CPU the wrapper runs the plain version; it is held against both the
JAX XLA path (``center_singularity_scores``) and the Pallas kernel in
interpret mode, with the bar of ``tests/test_pallas_decode.py``: union
exact, scores to atol 2e-5, argmax equal wherever the score is > 1e-4. The
CUDA kernel against the plain version needs the card; that test skips here.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from unmore_tpu.ops.fields import center_singularity_scores as jax_xla_decode
from unmore_tpu.ops.pallas.decode import fused_center_decode as jax_pallas_decode
from unmore_tpu_torch.ops import decode
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


@pytest.mark.cuda
@pytest.mark.parametrize("B", [256, 32])
def test_kernel_matches_plain_on_the_card(B):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    sdf, center = decode_inputs(B, 128, B)
    s, c = torch.from_numpy(sdf).cuda(), torch.from_numpy(center).cuda()
    before = decode.fused_center_decode.launches
    got = decode.fused_center_decode(s, c)
    torch.cuda.synchronize()
    assert decode.fused_center_decode.launches == before + 1
    want = center_singularity_scores(s, c)
    assert_decode_bar([t.cpu().numpy() for t in got], [t.cpu().numpy() for t in want])
