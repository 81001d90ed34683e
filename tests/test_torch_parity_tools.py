"""The port's real-weights parity harness and AP comparison, on fixtures.

The fixture is the one of ``tests/test_parity_harness.py``: the
reference-shaped torch models of ``tests/torch_ref.py`` (a miniature DPT
objectness net and the full ResNet-50 classifier) save reference-format
``.ckpt`` files and an activation dump of their own forward with hooks at the
reference's tap names. The port's ``check_parity --tiny --device cpu --tol
5e-4``, run in this process, passes on those weights and fails with one
``scratch`` weight moved by 0.05. ``ap_vs_published`` prints the JAX
script's AP figures on one small GT / prediction pair.
"""

import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.torch_ref import TorchDPTObjectness, TorchResNet50Classifier
from unmore_tpu_torch.scripts import ap_vs_published, check_parity
from unmore_tpu_torch.utils import rle

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: under the suite's parallel workers, torch's thread
    pool contends with theirs for the cores and runs many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dump(tmp_path_factory):
    folder = tmp_path_factory.mktemp("parity")
    torch.manual_seed(0)
    model = TorchDPTObjectness().eval()
    cls = TorchResNet50Classifier().eval()
    x = np.random.RandomState(0).rand(2, 3, 64, 64).astype(np.float32)
    taps, hooks = {}, []
    for name in check_parity.TAPS:
        def keep(_m, _i, out, name=name):
            taps[name] = out.detach().numpy()

        hooks.append(getattr(model.backbone.scratch, name).register_forward_hook(keep))
    with torch.no_grad():
        out = model(torch.from_numpy(x))
        existence = cls(torch.from_numpy(x)).numpy()
    for h in hooks:
        h.remove()
    np.savez_compressed(folder / "ref.npz", input=x, center_fields=out["center_fields"].numpy(),
                        sdf_maps=out["sdf_maps"].numpy(), existence=existence, **taps)
    torch.save({"model_state_dict": model.state_dict()}, folder / "objectness.ckpt")
    torch.save({"model_state_dict": cls.state_dict()}, folder / "classifier.ckpt")
    return folder, model.state_dict()


def run(folder, objectness_ckpt, capsys):
    code = check_parity.main(["--npz", str(folder / "ref.npz"), "--objectness_ckpt", str(objectness_ckpt),
                              "--classifier_ckpt", str(folder / "classifier.ckpt"), "--tiny", "--device", "cpu",
                              "--tol", "5e-4"])
    return code, capsys.readouterr().out


def test_check_parity_passes_on_matching_weights(dump, capsys):
    folder, _ = dump
    code, out = run(folder, folder / "objectness.ckpt", capsys)
    assert code == 0 and "PARITY OK" in out, out
    lines = {line.split()[0]: line for line in out.splitlines() if "max|d|=" in line}
    # the fixture runs its fusion blocks' parts, not the blocks: only the layer*_rn taps fire
    assert set(lines) == {"center_fields", "sdf_maps", "existence", "layer1_rn", "layer2_rn", "layer3_rn",
                          "layer4_rn"}, out
    assert all(line.endswith(" ok") for line in lines.values())
    assert "classifier parity:" in out


def test_check_parity_fails_on_a_perturbed_weight(dump, tmp_path, capsys):
    folder, sd = dump
    key = next(k for k in sd if k.endswith("weight") and "scratch" in k)
    torch.save({"model_state_dict": {**sd, key: sd[key] + 0.05}}, tmp_path / "perturbed.ckpt")
    code, out = run(folder, tmp_path / "perturbed.ckpt", capsys)
    assert code == 1 and "PARITY FAIL" in out, out
    assert " FAIL" in next(line for line in out.splitlines() if line.split() and line.split()[0] == "sdf_maps")


def test_check_parity_needs_a_card_unless_told_cpu(dump, monkeypatch):
    folder, _ = dump
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        check_parity.main(["--npz", str(folder / "ref.npz"), "--objectness_ckpt", str(folder / "objectness.ckpt"),
                           "--tiny"])


def gt_and_predictions(folder: Path):
    rng = np.random.RandomState(3)
    gt = {"images": [], "annotations": [], "categories": [{"id": 1, "name": "fg"}]}
    published, ours = [], []
    for image_id in (1, 2, 3):
        gt["images"].append({"id": image_id, "file_name": f"{image_id}.jpg", "height": 64, "width": 80})
        for _ in range(4):
            x, y, w, h = (int(v) for v in (rng.randint(0, 50), rng.randint(0, 40), rng.randint(6, 28),
                                           rng.randint(6, 22)))
            mask = np.zeros((64, 80), np.uint8)
            mask[y : y + h, x : x + w] = 1
            gt["annotations"].append({"id": len(gt["annotations"]) + 1, "image_id": image_id, "category_id": 1,
                                      "bbox": [x, y, w, h], "area": int(mask.sum()), "iscrowd": 0,
                                      "segmentation": rle.encode(mask)})
            for preds, shift in ((published, 1), (ours, 4)):
                moved = np.roll(mask, shift, axis=1)
                preds.append({"image_id": image_id, "category_id": 1, "bbox": [x + shift, y, w, h],
                              "segmentation": rle.encode(moved), "score": float(rng.rand())})
    (folder / "gt.json").write_text(json.dumps(gt))
    (folder / "published.json").write_text(json.dumps({"annotations": published}))
    (folder / "ours.json").write_text(json.dumps(ours))


@pytest.mark.parametrize("extra", [[], ["--segm"], ["--ours", "ours.json", "--segm"]])
def test_ap_vs_published_prints_the_jax_figures(extra, tmp_path, capsys, monkeypatch):
    gt_and_predictions(tmp_path)
    argv = ["--published", str(tmp_path / "published.json"), "--gt", str(tmp_path / "gt.json"),
            *[str(tmp_path / a) if a.endswith(".json") else a for a in extra]]
    spec = importlib.util.spec_from_file_location("jax_ap_vs_published",
                                                  ROOT / "scripts" / "parity" / "ap_vs_published.py")
    jax_script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_script)
    monkeypatch.setattr(sys, "argv", ["ap_vs_published", *argv])
    jax_script.main()
    want = capsys.readouterr().out
    ap_vs_published.main(argv)
    got = capsys.readouterr().out
    assert got == want and "[bbox]" in got
    if "--ours" in extra:
        assert "AP50 gap" in got and got.count("[") == 2
