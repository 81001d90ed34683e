"""ObjectnessNet's forward replayed as a CUDA graph (``models/objectness.py``).

At inference on a card the second call with an input signature captures the
forward and every later one replays it. On the CPU every call runs eagerly;
the control flow around the graph (signatures, counters, the static input,
the clones, dropping the graphs) is held here with a stand-in graph that
runs the forward again where a card would replay it. The card tests run on
a machine with an NVIDIA card, without the suite's conftest (it imports JAX):
``python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_objectness_graphs.py -m cuda``.
"""

import types

import pytest
import torch

from unmore_tpu_torch.models import objectness
from unmore_tpu_torch.models.objectness import ObjectnessNet
from unmore_tpu_torch.models.vit import ViTConfig
from unmore_tpu_torch.utils import tracing

TINY = dict(depth=4, dim=32, heads=2, mlp_dim=64, pretrain_grid=4)
TINY_DPT = dict(features=16, hooks=(0, 1, 2, 3), widths=(8, 16, 24, 24))
FOLDS = "models.sdf_fold.calls"
COUNTERS = (tracing.GRAPH_CAPTURES, tracing.GRAPH_REPLAYS, FOLDS)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: under the suite's parallel workers, torch's thread
    pool contends with theirs for the cores and runs many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_net(seed=0):
    torch.manual_seed(seed)
    return ObjectnessNet("dpt_base", "tanh", True, vit_config=ViTConfig(**TINY), **TINY_DPT).eval()


def counts():
    return [tracing.counter(c) for c in COUNTERS]


def moved(before):
    """(captures, replays, folds) since ``before``."""
    return [a - b for a, b in zip(counts(), before)]


class StandInGraph(objectness._Graph):
    """:class:`objectness._Graph` on the CPU: the capture runs the forward
    once into the static outputs, and each replay runs it again on the
    static input and writes the static outputs in place, as a replay does."""

    def __init__(self, images, dtype, pool, forward):
        self.x = torch.empty(images.shape, dtype=dtype, device=images.device).permute(0, 3, 1, 2)
        self.out = forward(self.x)

        def replay():
            for k, v in forward(self.x).items():
                self.out[k].copy_(v)

        self.graph = types.SimpleNamespace(replay=replay)


@pytest.fixture
def graphs_on_the_cpu(monkeypatch):
    """The graph path taken on the CPU: every input without a gradient or
    autocast is replayable, and graphs are :class:`StandInGraph`."""
    monkeypatch.setattr(objectness, "replayable",
                        lambda images: not torch.is_grad_enabled() and not torch.is_autocast_enabled("cpu"))
    monkeypatch.setattr(objectness, "_Graph", StandInGraph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: "pool")


def eager(model, images, compute_center=True):
    dtype = model.center_field_prediction_head[0].weight.dtype
    return model._forward(images.permute(0, 3, 1, 2).to(dtype), compute_center, model.sdf_head_is_linear)


def test_the_cpu_a_gradient_and_autocast_run_eagerly():
    model = tiny_net()
    x = torch.rand(2, 32, 32, 3)
    before = counts()
    for _ in range(3):
        with torch.inference_mode():
            model(x)
        with torch.no_grad():
            model(x, compute_center=False)
        model(x)["sdf_maps"].sum().backward()
        with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16):
            model(x)
    # folded: the inference and no-grad calls and the one under autocast
    assert moved(before) == [0, 0, 9]
    assert model._graphs == {}


def test_a_cpu_input_is_not_replayable():
    x = torch.rand(2, 32, 32, 3)
    with torch.inference_mode():
        assert not objectness.replayable(x)


@pytest.mark.parametrize("compute_center", [True, False])
def test_the_second_call_captures_and_later_calls_replay(graphs_on_the_cpu, compute_center):
    model = tiny_net()
    xs = [torch.rand(2, 32, 32, 3) for _ in range(5)]
    before = counts()
    with torch.inference_mode():
        for i, x in enumerate(xs):
            got = model(x, compute_center)
            assert moved(before) == [int(i >= 1), max(i - 1, 0), i + 1]
            want = eager(model, x, compute_center)
            assert got.keys() == want.keys()
            for k in want:
                torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    assert len(model._graphs) == 1


def test_the_fold_counts_once_per_call_on_every_path(graphs_on_the_cpu):
    model = tiny_net()
    x = torch.rand(2, 32, 32, 3)
    before = counts()
    with torch.inference_mode():
        model(x)  # eager, first sighting
        model(x)  # capture and replay
        model(x)  # replay
    with torch.no_grad():
        model(x)  # another signature: eager
    model(x)  # a gradient: the chain, not the fold
    with torch.no_grad(), torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        model(x)  # seen, but no capture under a profiler
    assert moved(before) == [1, 1, 5]


def test_signatures_are_captured_apart(graphs_on_the_cpu):
    model = tiny_net()
    before = counts()
    with torch.inference_mode():
        for _ in range(3):
            for shape in ((2, 32, 32, 3), (4, 32, 32, 3), (2, 64, 32, 3)):
                for compute_center in (True, False):
                    model(torch.rand(shape), compute_center)
    with torch.no_grad():  # inference mode is part of the signature
        model(torch.rand(2, 32, 32, 3))
    assert moved(before)[:2] == [6, 6]
    assert len(model._graphs) == 7 and list(model._graphs.values()).count(None) == 1


def test_two_calls_share_no_storage(graphs_on_the_cpu):
    model = tiny_net()
    a, b, c = (torch.rand(2, 32, 32, 3) for _ in range(3))
    with torch.inference_mode():
        model(a)
        first = model(b)  # captured, then replayed
        second = model(c)  # replayed
        want_b, want_c = eager(model, b), eager(model, c)
    for k in first:
        assert first[k].untyped_storage().data_ptr() != second[k].untyped_storage().data_ptr()
        torch.testing.assert_close(first[k], want_b[k], rtol=0, atol=0)
        torch.testing.assert_close(second[k], want_c[k], rtol=0, atol=0)
        assert not torch.equal(first[k], second[k])


def test_a_replay_reads_the_parameters_as_they_are(graphs_on_the_cpu):
    model = tiny_net()
    x = torch.rand(2, 32, 32, 3)
    with torch.inference_mode():
        model(x)
        model(x)
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(0.9)
    before = counts()
    with torch.inference_mode():
        got = model(x)
        want = eager(model, x)
    assert moved(before) == [0, 1, 1]
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)


@pytest.mark.parametrize("how", ["to", "load_state_dict"])
def test_a_cast_or_a_state_dict_drops_the_graphs(graphs_on_the_cpu, how):
    model = tiny_net()
    x = torch.rand(2, 32, 32, 3)
    with torch.inference_mode():
        model(x)
        model(x)
    assert len(model._graphs) == 1
    if how == "to":
        model.to(torch.float64)
        x = x.double()
    else:
        model.load_state_dict(tiny_net(seed=1).state_dict(), assign=True)
    assert model._graphs == {}
    before = counts()
    with torch.inference_mode():
        for _ in range(3):
            got = model(x)
        want = eager(model, x)
    assert moved(before) == [1, 1, 3]
    for k in want:
        assert got[k].dtype == want[k].dtype
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)


# ---- on the card ----------------------------------------------------------

@pytest.fixture(scope="module")
def dpt_large():
    """The full-width DPT-Large ObjectnessNet in bf16 on the card, with the
    module's default init (the numbers here need no trained weights)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.manual_seed(0)
    with torch.device("cuda"):
        model = ObjectnessNet("dpt_large", "tanh", True)
    return model.to(torch.bfloat16).eval()


def card_crops(n, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.rand(n, 128, 128, 3, device="cuda", generator=g)


@pytest.mark.cuda
@pytest.mark.parametrize("compute_center", [True, False])
@pytest.mark.parametrize("chunk", [256, 32])
def test_a_replay_on_the_card_is_the_eager_forward_bit_for_bit(dpt_large, chunk, compute_center):
    model = dpt_large
    model._drop_graphs()
    xs = [card_crops(chunk, seed) for seed in range(4)]
    before = counts()
    with torch.inference_mode():
        outs = [model(x, compute_center) for x in xs[:3]]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            outs.append(model(xs[3], compute_center))  # a replay: no host read
        finally:
            torch.cuda.set_sync_debug_mode("default")
        wants = [eager(model, x, compute_center) for x in xs]
    assert moved(before) == [1, 2, 4]
    for got, want in zip(outs, wants):
        assert got.keys() == want.keys() == ({"sdf_maps", "center_fields"} if compute_center else {"sdf_maps"})
        for k in want:
            assert got[k].dtype == want[k].dtype == torch.float32
            assert torch.equal(got[k], want[k]), (k, (got[k] - want[k]).abs().max().item())
    for k in outs[2]:  # the outputs of two replays stay distinct
        assert outs[2][k].data_ptr() != outs[3][k].data_ptr() and not torch.equal(outs[2][k], outs[3][k])


@pytest.mark.cuda
def test_a_cast_on_the_card_drops_the_graphs_and_captures_anew(dpt_large):
    model = dpt_large
    x = card_crops(32, 7)
    n = 5
    try:
        with torch.inference_mode():
            for _ in range(3):
                model(x, False)
        assert len(model._graphs) >= 1
        model.to(torch.float32)
        assert model._graphs == {}
        before = counts()
        with torch.inference_mode():
            for _ in range(n):
                got = model(x, False)
            want = eager(model, x, False)
        assert moved(before) == [1, n - 2, n]
        assert torch.equal(got["sdf_maps"], want["sdf_maps"])
    finally:
        model.to(torch.bfloat16)
