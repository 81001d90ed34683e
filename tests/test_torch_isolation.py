"""The port stands alone: no JAX, no flax, nothing of the JAX package.

Every module of ``unmore_tpu_torch``, the ``scripts`` among them,
imports in a fresh interpreter where ``jax``, ``flax``, ``msgpack``,
``yaml``, ``cv2`` and ``unmore_tpu`` cannot be imported; no Python source of the port, nor its host libraries
``csrc/*.cpp``, nor ``chip_smoke.py``, names the JAX package; and the entry
points refuse to pick the CPU on their own when no card is present.
"""

import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "unmore_tpu_torch"

IMPORT_ALL = """
import importlib, pkgutil, sys
for blocked in ("jax", "flax", "msgpack", "yaml", "cv2", "unmore_tpu"):
    sys.modules[blocked] = None
import unmore_tpu_torch
names = [m.name for m in pkgutil.walk_packages(unmore_tpu_torch.__path__, "unmore_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "flax", "msgpack", "yaml", "cv2", "unmore_tpu") and sys.modules[m] is not None]
assert not bad, bad
print(" ".join(names))
"""


def test_every_module_imports_without_jax():
    out = subprocess.run(
        [sys.executable, "-c", IMPORT_ALL], cwd=ROOT, capture_output=True, text=True, timeout=300
    )
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.strip().splitlines()[-1].split())
    assert len(names) >= 30
    # the chain's scripts and the other programs, which the JAX package writes with OpenCV or JAX, import
    # without them
    assert {f"unmore_tpu_torch.scripts.{m}" for m in (
        "make_synthetic_shapes", "make_imagenet_training_json", "parse_discovery_stats", "scale_report", "scale_chain",
        "sticky_ab", "max_active_ab", "preprocess_votecut", "vis_votecut", "check_parity", "ap_vs_published")} <= names


def test_sources_never_name_the_jax_package():
    pattern = re.compile(r"\bunmore_tpu\b(?!_torch)|^\s*(import|from)\s+(jax|flax)\b", re.M)
    files = sorted(PORT.rglob("*.py")) + sorted((PORT / "csrc").glob("*.cpp")) + [ROOT / "chip_smoke.py"]
    assert PORT / "csrc" / "cocoeval.cpp" in files and PORT / "detector" / "cascade_rcnn.py" in files
    assert len(files) > 30
    hits = [f"{p.relative_to(ROOT)}: {m.group(0)}" for p in files for m in pattern.finditer(p.read_text())]
    assert not hits, hits


@pytest.mark.parametrize("entry", ["engine", "scoring_engine", "build_objectness", "build_classifier",
                                   "resolve_device", "detector_evaluator", "ab_and_parity_scripts"])
def test_entry_points_default_to_cuda_and_raise_without_it(entry, monkeypatch):
    from unmore_tpu_torch import resolve_device
    from unmore_tpu_torch.cli.common import build_classifier, build_objectness
    from unmore_tpu_torch.detector.cascade_rcnn import DetectorConfig
    from unmore_tpu_torch.detector.evaluation import DetectorEvaluator
    from unmore_tpu_torch.reasoning.engine import ObjectDiscoveryEngine, ReasoningConfig
    from unmore_tpu_torch.reasoning.scoring import ObjectScoringEngine
    from unmore_tpu_torch.scripts import sticky_ab

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {
        "engine": lambda: ObjectDiscoveryEngine(lambda c, cc=True: None, lambda c: None, ReasoningConfig()),
        "scoring_engine": lambda: ObjectScoringEngine(lambda c, cc=True: None, lambda c: None),
        "build_objectness": lambda: build_objectness(None),
        "build_classifier": lambda: build_classifier(),
        "resolve_device": lambda: resolve_device(None),
        "detector_evaluator": lambda: DetectorEvaluator(None, DetectorConfig()),
        # the device of sticky_ab, max_active_ab and check_parity
        "ab_and_parity_scripts": lambda: sticky_ab.main(["--synth", "w", "--objectness", "o", "--classifier", "c"]),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()
    assert resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("cli", ["object_reasoning", "object_scoring", "train_net"])
def test_cli_refuses_to_fall_back_to_the_cpu(cli, tmp_path, monkeypatch):
    import importlib

    module = importlib.import_module(f"unmore_tpu_torch.cli.{cli}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    argv = {
        "object_reasoning": ["--coco_image_dir", str(tmp_path), "--coco_annotations", "none.json"],
        "object_scoring": ["--coco_image_dir", str(tmp_path), "--coco_annotations", "none.json",
                           "--raw_annotations_path", "discovery_results.json"],
        "train_net": ["--eval-only", "--test-json", "none.json", "--test-image-dir", str(tmp_path)],
    }[cli]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        module.main(argv)
