"""The slice as a whole: both discovery engines with real (tiny) models.

A tiny DPT ObjectnessNet and a tiny ResNet classifier, flax random init
carried into the port by ``*_state_dict_from_flax``; crop 32, one 96x96
image, five boundary rounds, CC analysis on. The JAX side runs in f32 at
``Precision.HIGHEST``, the port in f32 on the CPU. Stats must be equal and
boxes agree to 1e-3.
"""

import numpy as np
import jax
import jax.numpy as jnp

from unmore_tpu.models.resnet import BinaryClassifier as FlaxBinaryClassifier
from unmore_tpu.reasoning.engine import ObjectDiscoveryEngine as JaxEngine
from unmore_tpu.reasoning.engine import ReasoningConfig as JaxConfig
from unmore_tpu_torch.cli.common import make_apply_fns
from unmore_tpu_torch.models.convert import classifier_state_dict_from_flax
from unmore_tpu_torch.models.resnet import BinaryClassifier
from unmore_tpu_torch.reasoning.engine import ObjectDiscoveryEngine, ReasoningConfig
from tests.test_reasoning_engine import make_world
from tests.test_torch_engine import assert_same_results
from tests.test_torch_models import HIGH, _perturb, flax_objectness_params, port_objectness

CONFIG = dict(crop_size=32, canvas_size=96, max_proposals=64, max_splits=64, max_active=64,
              crop_chunk=16, crop_chunk_tail=8, exist_chunk=64, n_round=5, analyze_cc=True)


def test_slice_with_carried_weights_matches_jax():
    fobj, obj_params = flax_objectness_params(seed=7)
    fcls = FlaxBinaryClassifier(stage_blocks=(1, 1, 1, 1), precision=HIGH)
    cls_vars = jax.device_get(
        jax.jit(lambda k: fcls.init(k, jnp.zeros((1, 32, 32, 3)), train=False))(jax.random.PRNGKey(8))
    )
    cls_vars = {"params": _perturb(cls_vars["params"], 9), "batch_stats": cls_vars["batch_stats"]}

    def jax_objectness(variables, crops, compute_center=True):
        return fobj.apply({"params": variables["objectness"]}, crops)

    def jax_classifier(variables, crops):
        return fcls.apply(variables["classifier"], crops)[:, 0]

    jax_engine = JaxEngine(jax_objectness, jax_classifier, JaxConfig(**CONFIG),
                           variables={"objectness": obj_params, "classifier": cls_vars})

    classifier = BinaryClassifier(stage_blocks=(1, 1, 1, 1)).eval()
    classifier.load_state_dict(classifier_state_dict_from_flax(cls_vars), strict=True)
    port = ObjectDiscoveryEngine(*make_apply_fns(port_objectness(obj_params), classifier),
                                 ReasoningConfig(**CONFIG), device="cpu")

    world = make_world(96, [(10, 12, 50, 60), (50, 30, 90, 80)])
    world_q = np.clip(world * 255.0 + 0.5, 0, 255).astype(np.uint8)
    got = port.discover_batch([world_q])
    want = jax_engine.discover_batch([world_q])
    assert_same_results(got, want)
    stats = got[0]["stats"]
    assert stats["n_exist"] > 0 and stats["boundary_rounds"] > 0, stats
