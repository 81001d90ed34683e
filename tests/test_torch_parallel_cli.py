"""The port's stage-2 CLIs over two ranks, on the CPU with tiny models.

One two-rank gloo world (``tests/torch_parallel_workers.py`` ``stage2``,
spawned once for the file through ``mesh.launch``, with a group timeout of
120 s and a join timeout of 450 s that kills the ranks and fails) runs the
discovery CLI on three images, then the scoring CLI on its merged boxes, each
rank on its strided shard. The same CLIs on one rank, in this process, are
the reference: the merged ``discovery_results.json`` equals the one-rank
file as a dict (the JAX package fills it in process order) and the merged
annotation list equals the one-rank list after sorting by image and box
(it is concatenated in rank order); each rank writes its own partial file,
named as the JAX package names them. Then rank 0's partial file is cut to
its stamp, its first record and a torn line, and the rerun resumes: rank 0
discovers only what it lost, and the merged file is unchanged.
"""

import json

import numpy as np
import pytest

from tests import torch_parallel_workers
from unmore_tpu_torch.cli import common, object_reasoning, object_scoring
from unmore_tpu_torch.parallel import mesh

JOIN_TIMEOUT_S = 450
SIZES = [(48, 64), (64, 64), (40, 56)]
MODEL = ["--device", "cpu", "--dtype", "float32", "--sdf_activation", "tanh", "--use_bg_sdf", "--image_size", "32",
         "--canvas_size", "64", "--coco_image_dir", "images", "--coco_annotations", "instances.json"]
DISCOVERY = ["--analyze_cc", "--max_proposals", "32", "--max_splits", "32", "--max_active", "32", "--crop_chunk",
             "32", "--crop_chunk_tail", "16", "--exist_chunk", "32", "--n_round", "2", "--class_score_thres", "0",
             "--center_score_max_thres", "1.0"]


def argv(devices: int, run: str):
    disc = MODEL + DISCOVERY + ["--devices", str(devices), "--run_name", run]
    score = MODEL + ["--devices", str(devices), "--crop_chunk", "16",
                     "--raw_annotations_path", f"results_reasoning/{run}/discovery_results.json"]
    return disc, score


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from PIL import Image

    folder = tmp_path_factory.mktemp("stage2_ranks")
    rng = np.random.RandomState(0)
    (folder / "images").mkdir()
    images = []
    for i, (h, w) in enumerate(SIZES):
        Image.fromarray((rng.rand(h, w, 3) * 255).astype(np.uint8)).save(folder / "images" / f"{i}.png")
        images.append({"id": 10 + i, "file_name": f"{i}.png", "height": h, "width": w})
    with open(folder / "instances.json", "w") as f:
        json.dump({"images": images, "annotations": [], "categories": []}, f)

    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(folder)
        mp.setattr(common, "build_objectness", torch_parallel_workers.tiny_objectness)
        mp.setattr(common, "build_classifier", torch_parallel_workers.tiny_classifier)
        disc, score = argv(1, "one")
        object_reasoning.main(disc)
        object_scoring.main(score)
    disc, score = argv(2, "two")
    assert mesh.launch(torch_parallel_workers.stage2, (str(folder), disc, score), 2, timeout=JOIN_TIMEOUT_S) == 0
    return folder


def _read(path):
    return json.loads(path.read_text())


def test_merged_discovery_equals_one_rank(runs):
    one = _read(runs / "results_reasoning" / "one" / "discovery_results.json")
    two = _read(runs / "results_reasoning" / "two" / "discovery_results.json")
    assert len(one) > 0 and two == one


def test_each_rank_writes_its_partial_files(runs):
    out = runs / "results_reasoning" / "two"
    names = sorted(p.name for p in out.iterdir())
    assert names == ["configs_object_reasoning.json", "configs_object_scoring.json", "discovery_results.json",
                     "object_discovery_with_scores.json", "partial_results_p0.jsonl", "partial_results_p1.jsonl",
                     "scoring_partial_p0.jsonl", "scoring_partial_p1.jsonl", "stage_timings.json"]
    for kind in ("partial_results", "scoring_partial"):
        for rank, ids in ((0, {10, 12}), (1, {11})):
            recs = []
            for line in (out / f"{kind}_p{rank}.jsonl").read_text().splitlines():
                try:
                    recs.append(json.loads(line))
                except json.JSONDecodeError:
                    assert (kind, rank) == ("partial_results", 0)  # the torn line of the resume
            assert recs[0]["_meta"] == 1
            # after the resume, rank 0's record of image 12 rides on the torn line
            assert {r["image_id"] for r in recs[1:]} == ({10} if (kind, rank) == ("partial_results", 0) else ids)


def test_merged_scores_equal_one_rank_after_sorting(runs):
    def key(a):
        return a["image_id"], tuple(a["bbox"])

    one = sorted(_read(runs / "results_reasoning" / "one" / "object_discovery_with_scores.json"), key=key)
    two = sorted(_read(runs / "results_reasoning" / "two" / "object_discovery_with_scores.json"), key=key)
    assert len(one) > 0 and two == one


def test_a_rank_resumes_from_its_half_written_partial_file(runs):
    resumed = _read(runs / "resumed.json")
    assert resumed["again"] == resumed["first"]
    lines = (runs / "results_reasoning" / "two" / "partial_results_p0.jsonl").read_text().splitlines()
    # the stamp, the kept record, the torn line with the rediscovered record appended to it
    assert len(lines) == 3 and json.loads(lines[0])["_meta"] == 1 and json.loads(lines[1])["image_id"] == 10
    assert lines[2].endswith("}") and '"image_id": 12' in lines[2]
