"""The linear SDF head evaluated as its fold (``models/objectness.py``).

Without ReLUs the SDF head (conv1x1, conv3x3, conv1x1, conv1x1, then tanh,
sine or nothing) is one 3x3 convolution plus a bias map that differs on the
one-pixel border. ``ObjectnessNet.forward`` takes the fold when no gradient
is wanted. Here the fold is held against the four convolutions: exactly in
float64, and in bf16 no further from the float32 head than the chain is.
The relu head and every forward with a gradient keep the chain bit for bit.
The card tests run on a machine with an NVIDIA card, without the suite's
conftest (it imports JAX):
``python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_sdf_fold.py -m cuda``.
"""

import pytest
import torch

from unmore_tpu_torch.models.objectness import ObjectnessNet, conv_head, fold_linear_head, folded_head
from unmore_tpu_torch.models.vit import ViTConfig
from unmore_tpu_torch.utils import tracing

TINY = dict(depth=4, dim=32, heads=2, mlp_dim=64, pretrain_grid=4)
TINY_DPT = dict(features=16, hooks=(0, 1, 2, 3), widths=(8, 16, 24, 24))
FOLDS = "models.sdf_fold.calls"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: under the suite's parallel workers, torch's thread
    pool contends with theirs for the cores and runs many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def linear_head(in_ch, final_act, seed=0, dtype=torch.float64):
    """A linear SDF head with biases large enough that the border term of
    the fold matters."""
    torch.manual_seed(seed)
    head = conv_head(in_ch, 1, use_relu=False, final_act=final_act)
    with torch.no_grad():
        for m in head:
            if isinstance(m, torch.nn.Conv2d):
                m.bias.normal_(0.0, 0.5)
    return head.to(dtype)


def tiny_net(sdf_activation="tanh", use_bg_sdf=True, seed=0):
    torch.manual_seed(seed)
    return ObjectnessNet("dpt_base", sdf_activation, use_bg_sdf, vit_config=ViTConfig(**TINY), **TINY_DPT).eval()


def rel_l2(got, want):
    return float((got.double() - want.double()).norm() / want.double().norm())


@pytest.mark.parametrize("final_act", ["tanh", "sine", None])
@pytest.mark.parametrize("hw", [(16, 16), (16, 24), (3, 5)])
def test_fold_equals_the_four_convolutions_in_float64(final_act, hw):
    head = linear_head(8, final_act)
    x = torch.randn(2, 8, *hw, dtype=torch.float64)
    with torch.no_grad():
        want = head(x)
        got = folded_head(head, x)
        _, bias = fold_linear_head(head, *hw)
    assert got.shape == want.shape and got.dtype == torch.float64
    assert (got - want).abs().max() <= 1e-10
    # the border differs from the interior, so the test holds the padding's part
    assert (bias[0, 0, 0] - bias[0, 1, 1]).abs() > 1e-3


@pytest.mark.parametrize("case", ["relu_head", "grad_enabled"])
def test_no_fold_where_it_must_not_apply(case):
    """The relu head, and any forward with a gradient, run the four
    convolutions bit for bit; gradients reach all four."""
    model = tiny_net(**({"use_bg_sdf": False} if case == "relu_head" else {}))
    head = model.sdf_prediction_head
    assert any(isinstance(m, torch.nn.ReLU) for m in head) == (case == "relu_head")
    x = torch.rand(2, 32, 32, 3)
    before = tracing.counter(FOLDS)
    with torch.set_grad_enabled(case == "grad_enabled"):
        got = model(x)["sdf_maps"]
        feat = model.backbone(x.permute(0, 3, 1, 2))
        want = head(feat)[:, 0].float()
    assert tracing.counter(FOLDS) == before
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    if case == "grad_enabled":
        got.square().sum().backward()
        convs = [m for m in head if isinstance(m, torch.nn.Conv2d)]
        assert len(convs) == 4
        for m in convs:
            assert m.weight.grad is not None and m.weight.grad.abs().sum() > 0
            assert m.bias.grad is not None and m.bias.grad.abs().sum() > 0


def bf16_head_and_references():
    """A bf16 linear head drawn in float32 at lecun-normal scales, as a
    deployment's weights, and two float32 references: the weights as drawn,
    and the bf16 weights in float32 (only the arithmetic differs)."""
    drawn = linear_head(256, "tanh", dtype=torch.float32)
    with torch.no_grad():
        for m in drawn:
            if isinstance(m, torch.nn.Conv2d):
                m.weight.normal_(0.0, m.weight[0].numel() ** -0.5)
    head = linear_head(256, "tanh", dtype=torch.bfloat16)
    head.load_state_dict(drawn.state_dict())
    rounded = linear_head(256, "tanh", dtype=torch.float32)
    rounded.load_state_dict({k: v.float() for k, v in head.state_dict().items()})
    return head, drawn, rounded


@pytest.mark.parametrize("scale", [1.0, 30.0])  # tanh mostly linear; mostly saturated, as in the cell
def test_fold_in_bf16_is_no_further_from_float32_than_the_chain(scale):
    head, drawn, rounded = bf16_head_and_references()
    torch.manual_seed(1)
    x = (torch.nn.functional.avg_pool2d(torch.randn(2, 256, 32, 32), 9, 1) * scale).bfloat16()
    with torch.no_grad():
        chain = head(x)[:, 0].float()
        fold = folded_head(head, x)[:, 0]
        assert fold.dtype == torch.float32
        for ref in (drawn, rounded):
            want = ref(x.float())[:, 0]
            assert rel_l2(fold, want) <= rel_l2(chain, want)


def test_fold_under_autocast_stays_as_close_to_float32_as_the_chain():
    """A float32 model under bf16 autocast (the stage-1 trainer's
    predictions): autocast leaves the float64 fold as it is, and the
    convolution runs in bf16, as the chain's would."""
    model = tiny_net()
    x = torch.rand(2, 32, 32, 3)
    want = model(x)["sdf_maps"].detach()
    with torch.autocast("cpu", dtype=torch.bfloat16):
        chain = model(x)["sdf_maps"].detach()
        with torch.no_grad():
            fold = model(x)["sdf_maps"]
    assert fold.dtype == torch.float32 and rel_l2(chain, want) > 0
    assert rel_l2(fold, want) <= rel_l2(chain, want)


def test_each_folded_forward_counts_once():
    model = tiny_net()
    x = torch.rand(2, 32, 32, 3)
    before = tracing.counter(FOLDS)
    with torch.inference_mode():
        model(x)
        model(x, compute_center=False)
    with torch.no_grad():
        model(x)
    assert tracing.counter(FOLDS) == before + 3
    with torch.enable_grad():
        model(x)
    tiny_net(use_bg_sdf=False)(x)
    with torch.no_grad():
        tiny_net(use_bg_sdf=False)(x)
    assert tracing.counter(FOLDS) == before + 3


@pytest.mark.parametrize("sdf_activation", ["tanh", "sine", None])
def test_sdf_maps_are_the_same_with_or_without_the_center_head(sdf_activation):
    model = tiny_net(sdf_activation)
    x = torch.rand(3, 32, 32, 3)
    with torch.inference_mode():
        full = model(x)
        sdf_only = model(x, compute_center=False)
    assert set(sdf_only) == {"sdf_maps"} and full["sdf_maps"].dtype == torch.float32
    torch.testing.assert_close(sdf_only["sdf_maps"], full["sdf_maps"], rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [256, 32])
def test_fold_on_the_card_at_crop_128_without_host_reads(chunk):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # the float32 references in float32
    try:
        fold, chain, wants = card_heads(chunk)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    assert fold.shape == (chunk, 128, 128) and fold.dtype == torch.float32
    for want in wants:
        assert rel_l2(fold, want) <= rel_l2(chain, want)


def card_heads(chunk):
    """(fold, chain, float32 references) of the full-width head on one chunk
    of 128x128 maps; the fold runs where a host read raises."""
    head, drawn, rounded = (h.cuda() for h in bf16_head_and_references())
    torch.manual_seed(chunk)
    x = (torch.nn.functional.avg_pool2d(torch.randn(chunk, 256, 136, 136, device="cuda"), 9, 1) * 30).bfloat16()
    with torch.inference_mode():
        chain = head(x)[:, 0].float()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            fold = folded_head(head, x)[:, 0]
        finally:
            torch.cuda.set_sync_debug_mode("default")
        wants = [torch.cat([ref(x[i:i + 32].float())[:, 0] for i in range(0, chunk, 32)]) for ref in (drawn, rounded)]
    return fold, chain, wants
