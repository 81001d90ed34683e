"""The slice as a whole: both discovery engines with real (tiny) models.

A tiny DPT ObjectnessNet and a tiny ResNet classifier; crop 32, one 96x96
image, five boundary rounds, CC analysis on. The JAX side runs in f32 at
``Precision.HIGHEST``, the port in f32 on the CPU. Stats must be equal and
boxes agree to 1e-3. The weights are either flax's random init carried into
the port by ``*_state_dict_from_flax``, or each package's own seeded
``init_random_variables`` with nothing carried across.
"""

import numpy as np
import jax
import jax.numpy as jnp

from unmore_tpu.cli import common as jax_common
from unmore_tpu.models.objectness import ObjectnessNet as FlaxObjectnessNet
from unmore_tpu.models.resnet import BinaryClassifier as FlaxBinaryClassifier
from unmore_tpu.models.vit import ViTConfig as FlaxViTConfig
from unmore_tpu.reasoning.engine import ObjectDiscoveryEngine as JaxEngine
from unmore_tpu.reasoning.engine import ReasoningConfig as JaxConfig
from unmore_tpu_torch.cli.common import init_random_variables, make_apply_fns
from unmore_tpu_torch.models.convert import classifier_state_dict_from_flax
from unmore_tpu_torch.models.objectness import ObjectnessNet
from unmore_tpu_torch.models.resnet import BinaryClassifier
from unmore_tpu_torch.models.vit import ViTConfig
from unmore_tpu_torch.reasoning.engine import ObjectDiscoveryEngine, ReasoningConfig
from tests.test_reasoning_engine import make_world
from tests.test_torch_engine import assert_same_results
from tests.test_torch_models import HIGH, TINY, TINY_DPT, _perturb, flax_objectness_params, port_objectness

CONFIG = dict(crop_size=32, canvas_size=96, max_proposals=64, max_splits=64, max_active=64,
              crop_chunk=16, crop_chunk_tail=8, exist_chunk=64, n_round=5, analyze_cc=True)


def assert_engines_agree(fobj, fcls, obj_params, cls_vars, objectness, classifier):
    """The JAX engine on (``fobj``, ``fcls``) with the JAX variables and the
    port's on (``objectness``, ``classifier``): the same discovery of one
    two-object world, which finds and evolves boxes."""

    def jax_objectness(variables, crops, compute_center=True):
        return fobj.apply({"params": variables["objectness"]}, crops)

    def jax_classifier(variables, crops):
        return fcls.apply(variables["classifier"], crops)[:, 0]

    jax_engine = JaxEngine(jax_objectness, jax_classifier, JaxConfig(**CONFIG),
                           variables={"objectness": obj_params, "classifier": cls_vars})
    port = ObjectDiscoveryEngine(*make_apply_fns(objectness, classifier), ReasoningConfig(**CONFIG), device="cpu")

    world = make_world(96, [(10, 12, 50, 60), (50, 30, 90, 80)])
    world_q = np.clip(world * 255.0 + 0.5, 0, 255).astype(np.uint8)
    got = port.discover_batch([world_q])
    want = jax_engine.discover_batch([world_q])
    assert_same_results(got, want)
    stats = got[0]["stats"]
    assert stats["n_exist"] > 0 and stats["boundary_rounds"] > 0, stats


def test_slice_with_carried_weights_matches_jax():
    fobj, obj_params = flax_objectness_params(seed=7)
    fcls = FlaxBinaryClassifier(stage_blocks=(1, 1, 1, 1), precision=HIGH)
    cls_vars = jax.device_get(
        jax.jit(lambda k: fcls.init(k, jnp.zeros((1, 32, 32, 3)), train=False))(jax.random.PRNGKey(8))
    )
    cls_vars = {"params": _perturb(cls_vars["params"], 9), "batch_stats": cls_vars["batch_stats"]}
    classifier = BinaryClassifier(stage_blocks=(1, 1, 1, 1)).eval()
    classifier.load_state_dict(classifier_state_dict_from_flax(cls_vars), strict=True)
    assert_engines_agree(fobj, fcls, obj_params, cls_vars, port_objectness(obj_params), classifier)


def test_seeded_slice_without_carried_weights_matches_jax():
    """Both packages' ``init_random_variables`` from seed 0 (a tiny
    ``dpt_large``-style net and the classifier), no weights carried across:
    the same discovery on the same world."""
    fobj = FlaxObjectnessNet(backbone_type="dpt_large", sdf_activation="tanh", use_bg_sdf=True,
                             vit_config=FlaxViTConfig(**TINY), precision=HIGH, **TINY_DPT)
    fcls = FlaxBinaryClassifier(stage_blocks=(1, 1, 1, 1), precision=HIGH)
    obj_params, cls_vars = jax_common.init_random_variables(fobj, fcls, crop_size=32, seed=0)
    obj = ObjectnessNet("dpt_large", "tanh", True, vit_config=ViTConfig(**TINY), **TINY_DPT).eval()
    classifier = BinaryClassifier(stage_blocks=(1, 1, 1, 1)).eval()
    init_random_variables(obj, classifier, seed=0)
    assert_engines_agree(fobj, fcls, obj_params, cls_vars, obj, classifier)
