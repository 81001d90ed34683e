"""The port's data parallelism (``unmore_tpu_torch/parallel``) on the CPU.

The sharding helpers equal the JAX package's for 1-5 processes and 0-11
items (``jax.process_index`` / ``process_count`` patched: no JAX processes
are spawned). ``--devices`` and ``--num-gpus`` resolve without a card. One
two-rank gloo world (``tests/torch_parallel_workers.py`` ``steps``, spawned
once for the file through ``mesh.launch``, with a group timeout of 120 s and
a join timeout of 450 s that kills the ranks and fails) gathers objects,
meets at a barrier, writes once from rank 0, and takes two steps each of
three trainers on its rows of global batches, which the tests hold against:

* the classifier (ResNet (1, 1, 1, 1), 32^2 crops, SGD, f32): the JAX
  package's step on a 2-device mesh (``make_classifier_train_step(...,
  mesh)``) on the same global batch and weights, whose BatchNorm takes the
  global batch's statistics: losses rtol 1e-4 (as the one-device test
  of ``tests/test_torch_train.py``); parameters within twice the distance
  between the JAX package's own one-device and two-device steps (2.4e-5 on
  the stem's kernel: train-mode BatchNorm over 8 values at the last stage's
  1x1 grid makes the f32 gradient ill-conditioned), running statistics
  within the larger of that and 2e-6 (``tests/test_torch_train.py``'s bound
  for flax's ``E[x^2] - E[x]^2``);
* the objectness trainer (the tiny ViT/DPT widths of
  ``tests/test_training.py``, SGD, f32): the port's one-rank steps on the
  whole batch, losses rtol 1e-5 and parameters atol 1e-6;
* the CAD (``tests/test_torch_cad_train.py``'s narrow detector, f64, the
  trainer's own draws, which a rank draws for the global batch and cuts to
  its rows): the one-rank step, parameters and statistics atol 1e-10; then a
  step whose loss is NaN on rank 1 only is skipped on both ranks.

Both ranks end every step with equal parameters, bit for bit.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from tests.test_torch_cad_train import OPTIM as CAD_OPTIM
from tests.test_torch_cad_train import PORT_CFG as CAD_CFG
from tests.test_torch_cad_train import _batch as cad_batch
from tests.test_torch_train import TINY, TINY_DPT, as_jax, as_torch, make_batch
from unmore_tpu.config import OptimConfig as JaxOptimConfig
from unmore_tpu.models.resnet import BinaryClassifier as FlaxBinaryClassifier
from unmore_tpu.parallel import distributed as jax_dist
from unmore_tpu.train import classifier as jax_classifier
from unmore_tpu.train import objectness as jax_objectness
from unmore_tpu_torch.cli import common, object_reasoning, object_scoring, supervisor, train_net, train_objectness_net
from unmore_tpu_torch.config import OptimConfig, TrainObjectnessConfig
from unmore_tpu_torch.detector.cascade_rcnn import CascadeMaskRCNN, DetectorConfig
from unmore_tpu_torch.models.convert import classifier_state_dict_from_flax
from unmore_tpu_torch.models.objectness import ObjectnessNet
from unmore_tpu_torch.models.vit import ViTConfig
from unmore_tpu_torch.parallel import distributed, mesh
from unmore_tpu_torch.train.detector import DetectorTrainer
from unmore_tpu_torch.train.objectness import ObjectnessTrainer
from unmore_tpu_torch.train.optim import init_like_flax
from unmore_tpu_torch.utils import prng
from tests import torch_parallel_workers

JOIN_TIMEOUT_S = 450
CLS_BLOCKS = (1, 1, 1, 1)
CLS_OPTIM = dict(optimizer="sgd", learning_rate=1e-2, lr_scheduler_milestones=(100,))
OBJ_OPTIM = dict(optimizer="sgd", learning_rate=1e-2, lr_scheduler_milestones=(100,))
OBJ_KWARGS = dict(vit_config=ViTConfig(**TINY), **TINY_DPT)


# ------------------------------------------------------- sharding helpers
@pytest.mark.parametrize("n_items", range(12))
@pytest.mark.parametrize("count", range(1, 6))
def test_sharding_helpers_match_the_jax_package(count, n_items, monkeypatch):
    monkeypatch.setattr(jax, "process_count", lambda: count)
    monkeypatch.setattr(distributed, "process_count", lambda: count)
    for index in range(count):
        monkeypatch.setattr(jax, "process_index", lambda: index)
        monkeypatch.setattr(distributed, "process_index", lambda: index)
        assert distributed.host_shard_range(n_items) == jax_dist.host_shard_range(n_items)
        np.testing.assert_array_equal(distributed.host_shard_indices(n_items), jax_dist.host_shard_indices(n_items))
    if n_items % count:
        for fn in (distributed.local_batch_size, jax_dist.local_batch_size):
            with pytest.raises(ValueError, match="not divisible"):
                fn(n_items)
    else:
        assert distributed.local_batch_size(n_items) == jax_dist.local_batch_size(n_items) == n_items // count


# ---------------------------------------------------- worlds and devices
@pytest.fixture
def no_world(monkeypatch):
    """A clean slate for :func:`distributed.initialize` (restored after)."""
    for k in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID", "MASTER_ADDR", "MASTER_PORT",
              "RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(distributed, "_world", None)
    return monkeypatch


def test_initialize_reads_the_jax_variables_then_torchruns(no_world):
    distributed.initialize()  # one process: nothing to join
    assert distributed.world() is None and distributed.process_count() == 1 and distributed.is_main()
    assert distributed.local_rows({"x": np.arange(4)})["x"].tolist() == [0, 1, 2, 3]
    no_world.setenv("JAX_COORDINATOR_ADDRESS", "10.0.0.1:1234")
    no_world.setenv("JAX_NUM_PROCESSES", "4")
    no_world.setenv("JAX_PROCESS_ID", "2")
    no_world.setenv("WORLD_SIZE", "8")  # the JAX package's variables come first
    distributed.initialize()
    w = distributed.world()
    assert (w.rank, w.size, w.local_rank, w.host, w.port) == (2, 4, 0, "10.0.0.1", 1234)
    assert distributed.host_shard_indices(10).tolist() == [2, 6] and not distributed.is_main()
    distributed.initialize(backend="nccl")  # a second call changes nothing
    assert distributed.world() is w

    no_world.setattr(distributed, "_world", None)
    for k in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID", "WORLD_SIZE"):
        no_world.delenv(k)
    no_world.setenv("JAX_NUM_PROCESSES", "1")
    distributed.initialize("h:9", None)  # one process from the environment: nothing to join
    assert distributed.world() is None
    distributed.initialize("h:9", 1, 0)  # the caller's own address and count: a world of one rank
    assert distributed.world().size == 1 and distributed.process_count() == 1
    no_world.setattr(distributed, "_world", None)
    no_world.delenv("JAX_NUM_PROCESSES")
    for k, v in dict(MASTER_ADDR="h", MASTER_PORT="29500", RANK="5", WORLD_SIZE="8", LOCAL_RANK="1",
                     LOCAL_WORLD_SIZE="4").items():
        no_world.setenv(k, v)
    distributed.initialize()
    w = distributed.world()
    assert (w.rank, w.size, w.local_rank, w.local_size, w.port) == (5, 8, 1, 4, 29500)
    assert distributed.local_device() == torch.device("cuda", 1)
    # the rank's rows of its host's batch, and the stage CLIs' card
    rows = distributed.local_rows({"x": np.arange(8), "n": 3})
    assert rows["x"].tolist() == [2, 3] and rows["n"] == 3
    with pytest.raises(ValueError, match="not divisible"):
        distributed.local_rows({"x": np.arange(6)})
    args = object_reasoning.parse_args(["--coco_image_dir", "i", "--coco_annotations", "a"])
    assert common.device_name(args) == "cuda:1"
    assert common.device_name(object_reasoning.parse_args(["--coco_image_dir", "i", "--coco_annotations", "a",
                                                           "--device", "cpu"])) == "cpu"


def test_devices_and_num_gpus_resolve_without_a_card(no_world):
    no_world.setattr(torch.cuda, "device_count", lambda: 0)
    assert mesh.local_ranks(-1, None) == 1  # no card: one rank, which names the missing card
    with pytest.raises(ValueError, match="2 cards asked for, 0 visible"):
        mesh.local_ranks(2, None)
    assert mesh.local_ranks(-1, "cpu") == 1 and mesh.local_ranks(3, "cpu") == 3
    no_world.setattr(torch.cuda, "device_count", lambda: 4)
    assert mesh.local_ranks(-1, None) == 4 and mesh.local_ranks(2, None) == 2 and mesh.local_ranks(0, None) == 1
    assert mesh.local_ranks(-1, "cuda:3") == 1
    with pytest.raises(ValueError, match="5 cards asked for, 4 visible"):
        mesh.local_ranks(5, None)
    with pytest.raises(ValueError, match="names one card"):
        mesh.local_ranks(2, "cuda:1")

    # the CLIs: one rank spawns nothing; several spawn this module's main with the run name pinned
    launched = []
    no_world.setattr(mesh, "launch", lambda fn, args, n: launched.append((fn, args, n)) or 0)
    common.launch_local_ranks(object_reasoning.main, ["--x"], 1)
    assert launched == []
    with pytest.raises(SystemExit) as exit_:
        object_reasoning.main(["--coco_image_dir", "i", "--coco_annotations", "a", "--devices", "2"])
    assert exit_.value.code == 0
    fn, (argv,), n = launched.pop()
    assert fn is object_reasoning.main and n == 2 and argv[-2] == "--run_name" and argv[-1].endswith("_COCO_test")
    with pytest.raises(SystemExit):
        object_scoring.main(["--coco_image_dir", "i", "--coco_annotations", "a", "--raw_annotations_path", "r/d.json"])
    assert launched.pop()[2] == 4  # -1: every visible card
    with pytest.raises(ValueError, match="5 cards asked for"):
        object_reasoning.main(["--coco_image_dir", "i", "--coco_annotations", "a", "--devices", "5"])
    # --num-gpus keeps the JAX CLI's meaning: parsed, ignored, every visible card runs a rank
    assert train_net.parse_args(["--num-gpus", "8", "--num-machines", "2"]).num_gpus == 8
    with pytest.raises(SystemExit):
        train_net.main(["--num-gpus", "1", "--eval-only", "MODEL.WEIGHTS", "w"])
    assert launched.pop()[2] == 4
    # the trainers refuse a supervised run only under an outside launcher; a run whose ranks are
    # spawned here is supervised as one child, which spawns them all (no --max_restarts left in it)
    supervised = []
    no_world.setattr(supervisor, "supervise",
                     lambda build, max_restarts, hang_timeout=None: supervised.append(build(0)) or 0)
    for cli, argv in ((train_net, ["--eval-only", "--max-restarts", "1"]),
                      (train_objectness_net, ["--train_existence", "--max_restarts", "1"])):
        with pytest.raises(SystemExit) as exit_:
            cli.main(argv)
        assert exit_.value.code == 0
        child = supervised.pop()
        assert child[1:3] == ["-m", cli.__spec__.name] and not any("restarts" in a for a in child)
        for k, v in (("WORLD_SIZE", "2"), ("JAX_NUM_PROCESSES", "2")):
            no_world.setenv(k, v)
            with pytest.raises(SystemExit, match="needs the ranks spawned here"):
                cli.main(argv)
            no_world.delenv(k)
    assert launched == [] and supervised == []


# --------------------------------------------------- the two-rank world
def classifier_inputs():
    """flax's classifier and SGD state, the port's weights from it, a
    global batch of 8 (four of each label: each rank holds one label)."""
    fmodel = FlaxBinaryClassifier(stage_blocks=CLS_BLOCKS)
    tx = jax_objectness.make_optimizer(JaxOptimConfig(**CLS_OPTIM))
    state = jax_classifier.init_classifier_state(fmodel, tx, jax.random.PRNGKey(3), 32)
    weights = classifier_state_dict_from_flax(jax.device_get({"params": state.params,
                                                              "batch_stats": state.batch_stats}))
    rng = np.random.RandomState(0)
    images = np.concatenate([rng.rand(4, 32, 32, 3) * 0.3, rng.rand(4, 32, 32, 3) * 0.3 + 0.7])
    batch = {"image": (images * 255).astype(np.uint8), "label": np.array([0, 0, 0, 0, 1, 1, 1, 1], np.float32)}
    return fmodel, tx, state, weights, batch


def objectness_cfg():
    return dict(optim=OptimConfig(**OBJ_OPTIM), skip_loss_above=1000.0, spike_guard_warmup=0)


CAD_SEED = 5


def cad_batches():
    """The CAD's global batch of 2 in f64, and the same with rank 1's
    pseudo-label scores NaN."""
    batch = {k: np.asarray(v, np.float64) if v.dtype == np.float32 else v for k, v in cad_batch().items()}
    bad = dict(batch, gt_scores=batch["gt_scores"].copy())
    bad["gt_scores"][1] = np.where(bad["gt_valid"][1], np.nan, 0.0)  # rank 1's image only
    return batch, bad


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    folder = tmp_path_factory.mktemp("two_ranks")
    _, _, _, cls_weights, cls_batch = classifier_inputs()
    obj = ObjectnessNet("dpt_base", "tanh", True, **OBJ_KWARGS)
    init_like_flax(obj, 4)
    cad_b, cad_bad = cad_batches()
    inputs = dict(classifier_blocks=CLS_BLOCKS, classifier=cls_weights, classifier_optim=CLS_OPTIM,
                  classifier_batch=cls_batch, objectness_cfg=objectness_cfg(), objectness_kwargs=OBJ_KWARGS,
                  objectness=obj.state_dict(), objectness_batch=make_batch(seed=1, n=4, size=32),
                  cad_cfg=CAD_CFG, cad_seed=CAD_SEED, cad_optim=CAD_OPTIM, cad_batch=cad_b, cad_bad_batch=cad_bad)
    torch.save(inputs, folder / "inputs.pt")
    (folder / "main_writes.txt").write_text("")
    assert mesh.launch(torch_parallel_workers.steps, (str(folder),), 2, timeout=JOIN_TIMEOUT_S) == 0
    ranks = [torch.load(folder / f"rank{r}.pt", weights_only=False) for r in range(2)]
    return dict(inputs=inputs, ranks=ranks)


def test_objects_gather_in_rank_order_and_rank_zero_writes_once(world):
    for r in world["ranks"]:
        assert r["gathered"] == [{"rank": 0, "rows": [0, 2, 4]}, {"rank": 1, "rows": [1, 3]}]
        assert r["main_writes_seen"] == "rank 0\n"  # seen by both after the barrier


def _assert_ranks_equal(world, key):
    a, b = (r[f"{key}_digest"] for r in world["ranks"])
    assert a == b, key


def _jax_classifier_steps(mesh_devices):
    """Two JAX classifier steps from the world's initial state, on one
    device or on a mesh; (losses, port-named state dict)."""
    fmodel, tx, state, _, batch = classifier_inputs()
    mesh2 = None
    if mesh_devices > 1:
        mesh2 = Mesh(np.asarray(jax.devices()[:mesh_devices]), ("data",))
        state = jax.device_put(state, NamedSharding(mesh2, PartitionSpec()))
        batch = jax.device_put(as_jax(batch), NamedSharding(mesh2, PartitionSpec("data")))
    step = jax_classifier.make_classifier_train_step(fmodel, tx, mesh2)
    losses = []
    for _ in range(2):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    return losses, classifier_state_dict_from_flax(jax.device_get({"params": state.params,
                                                                   "batch_stats": state.batch_stats}))


def test_classifier_step_equals_the_jax_packages_two_device_mesh_step(world):
    want_loss, want = _jax_classifier_steps(2)
    _, one_device = _jax_classifier_steps(1)
    _assert_ranks_equal(world, "classifier")
    got = world["ranks"][0]
    np.testing.assert_allclose(got["classifier_loss"], want_loss, rtol=1e-4)
    port = {k: v.numpy() for k, v in got["classifier"].items()}
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    params = [k for k in want if k not in stats and not k.endswith("num_batches_tracked")]

    def dist_(a, keys):
        return max(float(np.abs(np.asarray(a[k]) - np.asarray(want[k])).max()) for k in keys)

    for keys, floor in ((params, 0.0), (stats, 2e-6)):
        jax_own = dist_(one_device, keys)
        assert dist_(port, keys) <= max(2 * jax_own, floor), (dist_(port, keys), jax_own)


def test_objectness_steps_equal_one_rank_steps(world):
    inputs = world["inputs"]
    model = ObjectnessNet("dpt_base", "tanh", True, **OBJ_KWARGS)
    model.load_state_dict(inputs["objectness"])
    trainer = ObjectnessTrainer(model, TrainObjectnessConfig(**inputs["objectness_cfg"]), dtype="float32")
    want = [{k: float(v) for k, v in trainer.train_step(as_torch(inputs["objectness_batch"])).items()}
            for _ in range(2)]
    _assert_ranks_equal(world, "objectness")
    got = world["ranks"][0]
    for g, w in zip(got["objectness_losses"], want):
        assert g.keys() == w.keys() and g["skipped"] == w["skipped"] == 0.0
        np.testing.assert_allclose([g[k] for k in w], [w[k] for k in w], rtol=1e-5)
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(got["objectness"][k].numpy(), v.numpy(), rtol=0, atol=1e-6, err_msg=k)


def test_cad_steps_equal_one_rank_steps_and_skip_a_nonfinite_global_step_on_both_ranks(world):
    inputs = world["inputs"]
    model = CascadeMaskRCNN(DetectorConfig(**CAD_CFG))
    init_like_flax(model, CAD_SEED)
    trainer = DetectorTrainer(model.double(), DetectorConfig(**CAD_CFG), CAD_OPTIM, dtype="float32")
    first = float(trainer.train_step(as_torch(inputs["cad_batch"]))["total"])
    assert np.isfinite(first)
    a, b = (r["cad"] for r in world["ranks"])
    # parameters and statistics after the first step, the trace after the second: equal bits
    assert a["digest"] == b["digest"]
    rng = prng.split(prng.split(prng.prng_key(0))[0])[0].numpy()  # one key split a step on every rank
    for r in (a, b):
        assert np.isclose(r["losses"][0], first, rtol=1e-10)
        # rank 1's NaN made the global loss NaN: both ranks skipped the step and
        # kept parameters and statistics
        assert not np.isfinite(r["losses"][1]) and r["skipped"] == 1 and r["kept"]
        np.testing.assert_array_equal(r["rng"], rng)
    for got, want in ((a["params"], trainer.flat.data), (a["stats"], trainer.stats)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-10)
