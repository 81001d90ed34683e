"""The port's CLI supervisor (``--max_restarts``) and its wiring.

Mirrors the supervisor cases of ``tests/test_supervisor.py`` with time
limits of a few seconds, checks that there is no busy-wedge watchdog, that
both CLIs launch themselves as ``-m`` children (the discovery CLI with its
run name pinned), and drills a kill: the scoring CLI's child is killed after
its first image group, and the restarted run must write what an unsupervised
run writes.
"""

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

from unmore_tpu_torch.cli import object_reasoning, object_scoring, supervisor
from unmore_tpu_torch.cli.supervisor import child_argv, retryable, strip_flag, supervise
from tests.test_torch_cli import coco  # noqa: F401  (the fixture)

ROOT = Path(__file__).resolve().parents[1]


def test_retryable_codes():
    assert not retryable(0)  # clean finish
    assert not retryable(2)  # argparse usage error: deterministic
    assert retryable(supervisor.FATAL_EXIT_CODE) and supervisor.FATAL_EXIT_CODE == 3
    assert retryable(1)  # crash
    assert retryable(-9)  # killed


def test_strip_flag_spellings_and_module_child():
    argv = ["--a", "1", "--max_restarts", "5", "--b", "--max_restarts=7", "--c", "2"]
    assert strip_flag(argv, "--max_restarts", True) == ["--a", "1", "--b", "--c", "2"]
    assert strip_flag(["--resume", "--x"], "--resume", False) == ["--x"]
    assert child_argv("pkg.mod", argv, "--max_restarts") == [sys.executable, "-m", "pkg.mod", "--a", "1", "--b",
                                                              "--c", "2"]


def test_loss_window_corrupt_warmup_exemption():
    from unmore_tpu_torch.train.resilience import CorruptionDetector

    d = CorruptionDetector()
    # a large finite loss under LR warmup does not count; after warmup it does
    assert not d.loss_window_corrupt(5300.0, in_warmup=True)
    assert d.loss_window_corrupt(5300.0, in_warmup=False)
    assert d.loss_window_corrupt(5300.0)  # the stage-1 CLI's call: no warmup exemption
    # non-finite counts even during warmup
    assert d.loss_window_corrupt(float("nan"), in_warmup=True)
    assert d.loss_window_corrupt(float("inf"), in_warmup=True)
    # the ceiling is configurable (--corrupt-loss-ceiling)
    assert d.loss_window_corrupt(200.0, ceiling=100.0)
    assert not d.loss_window_corrupt(200.0, ceiling=1e4)


def test_supervise_restarts_until_success(tmp_path):
    marker, log = str(tmp_path / "marker"), str(tmp_path / "attempts.txt")
    # fails with the fail-fast code once, then succeeds
    script = (
        "import os, sys\n"
        f"open({log!r}, 'a').write(sys.argv[1] + chr(10))\n"
        f"if not os.path.exists({marker!r}):\n"
        f"    open({marker!r}, 'w').close()\n"
        "    sys.exit(3)\n"
    )
    rc = supervise(lambda attempt: [sys.executable, "-c", script, f"attempt{attempt}"], max_restarts=3,
                   restart_delay=0.0)
    assert rc == 0
    assert Path(log).read_text().splitlines() == ["attempt0", "attempt1"]


def test_supervise_budget_exhausted_and_usage_error_not_retried():
    calls = []

    def build(code):
        def argv(attempt):
            calls.append(attempt)
            return [sys.executable, "-c", f"import sys; sys.exit({code})"]
        return argv

    assert supervise(build(3), max_restarts=2, restart_delay=0.0, log=lambda m: None) == 3
    assert calls == [0, 1, 2]  # first launch + 2 restarts
    calls.clear()
    assert supervise(build(2), max_restarts=5, restart_delay=0.0, log=lambda m: None) == 2
    assert calls == [0]


def test_supervise_hang_watchdog_kills_and_restarts(tmp_path):
    marker = str(tmp_path / "hung_once")
    # attempt 0 prints one line, then hangs; attempt 1 exits 0
    script = (
        "import os, sys, time\n"
        f"if not os.path.exists({marker!r}):\n"
        f"    open({marker!r}, 'w').close()\n"
        "    print('starting', flush=True)\n"
        "    time.sleep(60)\n"
    )
    msgs = []
    t0 = time.monotonic()
    rc = supervise(lambda attempt: [sys.executable, "-I", "-c", script], max_restarts=2, restart_delay=0.0,
                   log=msgs.append, hang_timeout=2.0)
    assert rc == 0
    assert any("killing hung child" in m for m in msgs)
    assert any("hang (no output)" in m for m in msgs)
    assert time.monotonic() - t0 < 30.0


def test_supervise_watchdog_spares_talkative_child(capfd):
    script = "import time\nfor i in range(5):\n    print('tick', i, flush=True)\n    time.sleep(0.5)\n"
    msgs = []
    rc = supervise(lambda attempt: [sys.executable, "-I", "-c", script], max_restarts=0, log=msgs.append,
                   hang_timeout=2.0)
    assert rc == 0 and not msgs
    assert "tick 4" in capfd.readouterr().out


def test_silent_busy_child_is_not_killed_early():
    """No busy-wedge watchdog: a child that spins silently (as a host
    thread waiting on a CUDA stream does) runs until the hang timeout."""
    script = "import time\nprint('up', flush=True)\nt = time.time()\nwhile time.time() - t < 4:\n    pass\n"
    msgs = []
    rc = supervise(lambda attempt: [sys.executable, "-I", "-c", script], max_restarts=0, log=msgs.append,
                   hang_timeout=30.0)
    assert rc == 0 and not msgs


def test_children_import_the_package_from_any_directory(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("PYTHONPATH", raising=False)
    argv = [sys.executable, "-m", "unmore_tpu_torch.cli.supervisor"]
    assert supervise(lambda attempt: argv, max_restarts=0) == 0


def captured_launch(monkeypatch):
    seen = {}

    def fake_supervise(build_argv, max_restarts, hang_timeout=None):
        seen.update(argv=list(build_argv(0)), max_restarts=max_restarts, hang_timeout=hang_timeout)
        return 0

    monkeypatch.setattr(supervisor, "supervise", fake_supervise)
    return seen


def test_discovery_cli_pins_its_run_name_and_launches_itself_as_a_module(monkeypatch):
    seen = captured_launch(monkeypatch)
    base = ["--coco_image_dir", "images", "--coco_annotations", "a.json", "--max_restarts", "2",
            "--hang_timeout_min", "0.5"]
    with pytest.raises(SystemExit) as exit_:
        object_reasoning.main(base)
    assert exit_.value.code == 0
    argv = seen["argv"]
    assert argv[:3] == [sys.executable, "-m", "unmore_tpu_torch.cli.object_reasoning"]
    assert "--max_restarts" not in argv and argv.count("--run_name") == 1
    assert argv[-2] == "--run_name" and argv[-1].endswith("_COCO_test")
    assert seen["max_restarts"] == 2 and seen["hang_timeout"] == 30.0
    with pytest.raises(SystemExit):
        object_reasoning.main(base + ["--run_name=mine", "--hang_timeout_min", "0"])
    assert seen["argv"][-2:] == ["--run_name", "mine"] and seen["hang_timeout"] is None


def test_scoring_cli_launches_itself_as_a_module(monkeypatch):
    seen = captured_launch(monkeypatch)
    with pytest.raises(SystemExit):
        object_scoring.main(["--coco_image_dir", "i", "--coco_annotations", "a.json", "--max_restarts=1",
                             "--raw_annotations_path", "r/discovery_results.json"])
    assert seen["argv"] == [sys.executable, "-m", "unmore_tpu_torch.cli.object_scoring", "--coco_image_dir", "i",
                            "--coco_annotations", "a.json", "--raw_annotations_path", "r/discovery_results.json"]
    assert seen["max_restarts"] == 1 and seen["hang_timeout"] == 1800.0


@pytest.mark.parametrize("cli", [object_reasoning, object_scoring])
def test_help_says_what_the_supervision_flags_do(cli, capsys):
    with pytest.raises(SystemExit):
        cli.parse_args(["--help"])
    text = " ".join(capsys.readouterr().out.split())
    # the last mention of each flag is its help entry, after the usage line
    restarts = text.split("--max_restarts MAX_RESTARTS")[-1].split("--hang_timeout_min")[0]
    assert "relaunch it up to N times" in restarts and "ignored" not in restarts
    busy = text.split("--busy_hang_timeout_min BUSY_HANG_TIMEOUT_MIN")[-1]
    assert busy.lstrip().startswith("accepted for compatibility and ignored by this build") and "spins" in busy


def _children(pid):
    kids = []
    for task in Path(f"/proc/{pid}/task").iterdir():
        kids += [int(k) for k in (task / "children").read_text().split()]
    return kids


def test_killed_scoring_child_restarts_and_resumes_to_the_unsupervised_output(coco):  # noqa: F811
    """dpt_base at crop 32 in bf16 on the CPU (the child builds its own
    models: a monkeypatched tiny model would not reach it), one image a
    group, two groups."""
    rng_boxes = {"10": [[0, 0, 40, 30], [20, 10, 96, 64]], "12": [[2, 3, 50, 40], [-5, 4, 60, 45]]}
    paths = {}
    for name in ("unsupervised", "supervised"):
        (coco / name).mkdir()
        paths[name] = coco / name / "discovery_results.json"
        paths[name].write_text(json.dumps(rng_boxes))
    args = ["--device", "cpu", "--dtype", "bfloat16", "--backbone_type", "dpt_base", "--sdf_activation", "tanh",
            "--use_bg_sdf", "--image_size", "32", "--canvas_size", "96", "--image_batch", "1",
            "--coco_image_dir", "images", "--coco_annotations", "instances.json"]
    # two threads a process: the test runs beside other test workers
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    cmd = [sys.executable, "-m", "unmore_tpu_torch.cli.object_scoring", *args]
    plain = subprocess.run(cmd + ["--raw_annotations_path", str(paths["unsupervised"])], cwd=coco, env=env,
                           capture_output=True, text=True, timeout=600)
    assert plain.returncode == 0, plain.stderr[-3000:]

    proc = subprocess.Popen(cmd + ["--raw_annotations_path", str(paths["supervised"]), "--max_restarts", "1"],
                            cwd=coco, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines, killed = [], None
    try:
        for line in proc.stdout:
            lines.append(line)
            if killed is None and line.startswith("[1/2] images"):
                (killed,) = _children(proc.pid)
                os.kill(killed, signal.SIGKILL)
        assert proc.wait(timeout=600) == 0, "".join(lines)
    finally:
        if proc.poll() is None:
            proc.kill()
    log = "".join(lines)
    assert killed is not None and f"child died (exit -{int(signal.SIGKILL)})" in log, log
    assert "supervisor: restart 1/1" in log and "resuming: " in log, log
    got = json.loads((coco / "supervised" / "object_discovery_with_scores.json").read_text())
    want = json.loads((coco / "unsupervised" / "object_discovery_with_scores.json").read_text())
    assert got == want and len(got) > 0
