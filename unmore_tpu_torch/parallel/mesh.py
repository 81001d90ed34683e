"""The local data-parallel group (port of the JAX package's
``parallel/mesh.py``).

The JAX package puts every local chip into one ``Mesh(('data',))`` inside
one process. The port runs one rank per card: when no launcher started the
ranks, :func:`launch` starts one process per local card (the reference's
detectron2 ``launch()``) with torchrun's environment, joins them and returns
the first failing rank's exit code. A host started by the JAX package's
launcher variables (``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``,
``JAX_PROCESS_ID``: one process per host) is node ``JAX_PROCESS_ID`` of
``JAX_NUM_PROCESSES``, and its ranks follow those of the hosts before it. The
rendezvous store lives in the launching process of node 0 (on a port the
system picks when there is one node), so that no rank is special and a
restarted rank rejoins it.
"""

from __future__ import annotations

import os
import time

import torch

from unmore_tpu_torch.parallel import distributed

_JAX_VARS = ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID")


def launched() -> bool:
    """True in a rank that a launcher started (torchrun or :func:`launch`)."""
    return int(os.environ.get("WORLD_SIZE", "1")) > 1


def local_ranks(devices: int, device: str | None) -> int:
    """The local ranks of a CLI run. With the default device (a card per
    rank): ``devices`` cards, -1 for every visible card, as the JAX CLIs'
    ``--devices`` and ``data_parallel_mesh()``; more than are visible
    raises. An explicit CUDA ``device`` is one card, one rank; ``cpu`` runs
    ``devices`` ranks on the CPU (at least one)."""
    if device is not None:
        if torch.device(device).type == "cpu":
            return max(devices, 1)
        if devices > 1:
            raise ValueError(f"--device {device} names one card; leave it out to run on {devices} cards")
        return 1
    visible = torch.cuda.device_count()
    if devices < 0:
        return max(visible, 1)  # no card: one rank, which names the missing card when it starts
    n = max(devices, 1)
    if n > visible:
        raise ValueError(f"{n} cards asked for, {visible} visible")
    return n


def _rank_main(local_rank: int, fn, args, env: dict, first_rank: int):
    """A spawned rank: torchrun's variables for this rank, then ``fn(*args)``."""
    for k in _JAX_VARS:
        os.environ.pop(k, None)
    os.environ.update(env, RANK=str(first_rank + local_rank), LOCAL_RANK=str(local_rank))
    fn(*args)
    distributed.shutdown()


def launch(fn, args=(), n_local: int = 1, timeout: float | None = None) -> int:
    """Run ``fn(*args)`` (a module-level function) in ``n_local`` spawned
    ranks of this host and wait for them. Returns 0, or the exit code of
    the first rank that failed (1 for an exception, whose traceback is
    printed); the other ranks are then stopped. After ``timeout`` seconds
    every rank still alive is killed and TimeoutError raised."""
    node = int(os.environ.get("JAX_PROCESS_ID", "0"))
    nodes = int(os.environ.get("JAX_NUM_PROCESSES", "1"))
    if nodes > 1:
        host, port = os.environ["JAX_COORDINATOR_ADDRESS"].rsplit(":", 1)
        port = int(port)
    else:
        host, port = "127.0.0.1", 0
    store = None
    if node == 0:  # held open until every rank has finished
        store = torch.distributed.TCPStore(host, port, None, True, timeout=distributed.DEFAULT_TIMEOUT,
                                           wait_for_workers=False)
        port = store.port
    env = {"WORLD_SIZE": str(nodes * n_local), "LOCAL_WORLD_SIZE": str(n_local), "MASTER_ADDR": host,
           "MASTER_PORT": str(port), "TORCHELASTIC_USE_AGENT_STORE": "True"}
    ctx = torch.multiprocessing.start_processes(_rank_main, args=(fn, tuple(args), env, node * n_local),
                                                nprocs=n_local, join=False, start_method="spawn")
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while not ctx.join(timeout=None if deadline is None else max(deadline - time.monotonic(), 0.0),
                           grace_period=10.0):
            if deadline is not None and time.monotonic() >= deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                for p in ctx.processes:
                    p.join()
                raise TimeoutError(f"{n_local} ranks still running after {timeout:.0f} s: killed")
    except torch.multiprocessing.ProcessExitedException as exc:
        print(f"launch: {exc}", flush=True)
        return exc.exit_code or 1
    except torch.multiprocessing.ProcessRaisedException as exc:
        print(f"launch: {exc}", flush=True)
        return 1
    return 0
