"""Supervised restarts of a trainer whose ranks the CLI spawns itself.

``--max_restarts`` on a trainer that spawns a host's ranks supervises the
spawning process: a restart relaunches every rank from the newest
checkpoint, and the watchdog kills the child's whole process group. Both
checks run two CPU ranks of the port's existence trainer, through a script
file that puts a tiny classifier in place of the CLI's model and answers
two for the host's rank count (two cards' worth of ranks on the CPU); the
ranks re-import that file, so they see the same stand-ins.
"""

import os
import re
import signal
import subprocess
import sys
import time
from pathlib import Path

from tests.test_torch_train_cli import write_world
from unmore_tpu_torch.cli import supervisor

ROOT = Path(__file__).resolve().parents[1]
TWO_RANKS = """
import sys

from unmore_tpu_torch.cli import supervisor
from unmore_tpu_torch.cli import train_objectness_net as cli
from unmore_tpu_torch.models.resnet import BinaryClassifier
from unmore_tpu_torch.parallel import mesh

cli.build_classifier_model = lambda a: BinaryClassifier(stage_blocks=(1, 1))
mesh.local_ranks = lambda devices, device: 2
# the supervised child is this file again, so that it and its ranks get the stand-ins too
supervisor.child_argv = lambda module, argv, flag: [sys.executable, __file__, *supervisor.strip_flag(argv, flag, True)]

if __name__ == "__main__":
    cli.main(sys.argv[1:])
"""
SILENT_RANKS = """
import os
import signal
import sys
import threading
import time


def ranks_up(folder):
    return len([n for n in os.listdir(folder) if n.startswith("pid")]) == 2


def rank(folder):
    # torch's spawn sends a rank SIGINT when the spawner dies; a rank blocked in a collective or a
    # device wait does not act on it, so this one ignores it
    signal.signal(signal.SIGINT, signal.SIG_IGN)
    with open(os.path.join(folder, f"pid{os.environ['RANK']}"), "w") as f:
        f.write(str(os.getpid()))
    time.sleep(600)


def heartbeat(folder):
    while not ranks_up(folder):  # silent once both ranks run
        print("waiting for the ranks", flush=True)
        time.sleep(0.2)


if __name__ == "__main__":
    threading.Thread(target=heartbeat, args=(sys.argv[1],), daemon=True).start()
    from unmore_tpu_torch.parallel import mesh  # torch takes seconds to import

    mesh.launch(rank, (sys.argv[1],), 2)
"""


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if k not in ("WORLD_SIZE", "JAX_NUM_PROCESSES")}
    return dict(env, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1", **extra)


def test_two_ranks_restart_together_from_the_newest_checkpoint(tmp_path):
    script = tmp_path / "two_ranks.py"
    script.write_text(TWO_RANKS)
    marker = tmp_path / "fault_marker"
    args = write_world(tmp_path) + ["--train_existence", "--train_iter", "5", "--save_ckpt_every", "2",
                                    "--log_every", "2", "--evaluate_every", "100"]
    # windows 4 and 6 are corrupt on both ranks: rank 0 exits 3 at step 6, the launcher stops rank 1
    out = subprocess.run([sys.executable, str(script), *args, "--run_name", "sup", "--max_restarts", "1"],
                         capture_output=True, text=True, timeout=300, cwd=tmp_path,
                         env=_env(UNMORE_FAULT_INJECT_AT=f"4:{marker}"))
    log = out.stdout + out.stderr
    assert out.returncode == 0, log[-3000:]
    assert "FATAL: 2 consecutive corrupt loss windows at iter 6" in log
    assert "supervisor: child died (fail-fast)" in log and "supervisor: restart 1/1" in log
    # the fatal exit waits for iter 4's write: both ranks resume from it
    run = "results_objectness/existence/sup"
    resumed = re.findall(rf"resumed from {run}/ckpt/iter_(\d)_model.ckpt at iter (\d)", log)
    assert len(resumed) == 2 and resumed[0] == resumed[1] and resumed[0][0] == resumed[0][1] == "4", log
    start = resumed[0][0]

    # an uninterrupted two-rank run from that checkpoint ends at the same bytes
    ref = subprocess.run([sys.executable, str(script), *args, "--run_name", "ref",
                          "--resume", f"{run}/ckpt/iter_{start}_model.ckpt"],
                         capture_output=True, text=True, timeout=300, cwd=tmp_path, env=_env())
    assert ref.returncode == 0, (ref.stdout + ref.stderr)[-3000:]
    final = "ckpt/iter_6_model.ckpt"
    got = (tmp_path / run / final).read_bytes()
    assert got == (tmp_path / "results_objectness/existence/ref" / final).read_bytes()


def _alive(pid: int) -> bool:
    """True while ``pid`` runs (a zombie waiting for its reaper counts as gone)."""
    try:
        state = Path(f"/proc/{pid}/stat").read_text().rsplit(")", 1)[1].split()[0]
    except FileNotFoundError:
        return False
    return state != "Z"


def _wait_gone(pids):
    deadline = time.monotonic() + 10.0
    while any(_alive(p) for p in pids) and time.monotonic() < deadline:
        time.sleep(0.1)
    return [p for p in pids if _alive(p)]


def test_watchdog_kill_leaves_no_rank_alive(tmp_path):
    """The child spawns two ranks, then goes silent: the hang watchdog kills
    its whole process group."""
    script = tmp_path / "silent.py"
    script.write_text(SILENT_RANKS)
    msgs = []
    t0 = time.monotonic()
    rc = supervisor.supervise(lambda attempt: [sys.executable, str(script), str(tmp_path)], max_restarts=0,
                              restart_delay=0.0, log=msgs.append, hang_timeout=3.0)
    assert rc != 0 and any("killing hung child" in m for m in msgs)
    assert time.monotonic() - t0 < 60.0
    assert not _wait_gone([int((tmp_path / f"pid{r}").read_text()) for r in range(2)])


def test_a_terminated_supervisor_takes_its_childs_session_along(tmp_path):
    """SIGTERM to the supervisor (as a chain stopped at its time limit sends
    to its process group, which the child's own session is not in) kills
    the child and what the child started."""
    child = ("import os, subprocess, sys, time\n"
             "grand = subprocess.Popen([sys.executable, '-c', 'import time; time.sleep(600)'])\n"
             f"open({str(tmp_path / 'pids')!r}, 'w').write(f'{{os.getpid()}} {{grand.pid}}')\n"
             "time.sleep(600)\n")
    code = ("import sys\nfrom unmore_tpu_torch.cli import supervisor\n"
            f"sys.exit(supervisor.supervise(lambda a: [sys.executable, '-c', {child!r}], 0))\n")
    sup = subprocess.Popen([sys.executable, "-c", code], env=_env())
    t0 = time.monotonic()
    while not (tmp_path / "pids").exists() and time.monotonic() - t0 < 60.0:
        time.sleep(0.05)
    time.sleep(0.2)
    pids = [int(p) for p in (tmp_path / "pids").read_text().split()]
    sup.terminate()
    assert sup.wait(timeout=60) == 128 + signal.SIGTERM
    assert len(pids) == 2 and not _wait_gone(pids)
