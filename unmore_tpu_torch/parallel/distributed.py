"""Data parallelism over ranks on ``torch.distributed`` (port of the JAX
package's ``parallel/distributed.py``).

The JAX package runs one process per host over a global ``Mesh(('data',))``
of every chip, and lets GSPMD insert the gradient psum. The port runs one
process per card (a *rank*), PyTorch's idiom:

* a JAX process corresponds to a port rank for image sharding
  (:func:`host_shard_range`, :func:`host_shard_indices`), the ``_p{index}``
  partial files, :func:`is_main` writes, :func:`all_gather_objects` and
  :func:`barrier`;
* the chips inside one JAX process are the *local ranks* of one host
  (:func:`local_rank`, :func:`local_world_size`); a host's ranks share the
  data stream that the JAX process draws and keep their rows of it
  (:func:`local_rows`);
* GSPMD's implicit gradient psum is :func:`all_reduce_mean_` of a trainer's
  flat gradient buffer, and train-mode BatchNorm takes global-batch
  statistics through :func:`all_reduce_sum_`
  (:mod:`unmore_tpu_torch.models.resnet`).

:func:`initialize` records the world from its arguments or the
environment; the process group is made at the first collective, with a
timeout, so that a stage-2 rank that was restarted still joins the one
gather at the end of its shard. Collectives run only ``all_reduce`` and
``broadcast`` on device tensors, and gather Python objects on a gloo group
on the CPU: the same code runs on NCCL over separate cards, on gloo on the
CPU, and on gloo with CUDA tensors for two ranks that share one card
(NCCL refuses two ranks on one device). A one-process run makes no group
and every helper degenerates to its identity, so the CLIs need no
branching. The world is this process's (as ``torch.distributed``'s default
group is), so it lives in this module.
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import numpy as np
import torch
import torch.distributed as tdist

DEFAULT_TIMEOUT = datetime.timedelta(minutes=30)


@dataclasses.dataclass(frozen=True)
class World:
    """This process's place in a run of ``size`` ranks, ``local_size`` of
    them on its host, meeting at ``host:port``."""

    rank: int
    size: int
    local_rank: int
    local_size: int
    host: str
    port: int
    backend: str | None
    timeout: datetime.timedelta


_world: World | None = None
_groups: dict = {}  # "default" and "cpu" process groups, made at the first collective


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, local_device_ids=None, *, backend: str | None = None,
               timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> None:
    """Join a multi-rank run; a no-op for one process, or when already
    initialised. Only the caller's own ``coordinator_address`` and
    ``num_processes`` make a world of one rank, whose collectives run on its
    own process group (a check that the backend works on one card).

    The arguments fall back to the JAX package's variables
    (``JAX_COORDINATOR_ADDRESS`` "host:port", ``JAX_NUM_PROCESSES``,
    ``JAX_PROCESS_ID``), so that one launcher script serves both packages,
    then to torchrun's (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``). ``local_device_ids``
    (its first entry) is the rank's card among the host's. ``backend``
    None means NCCL for CUDA tensors and gloo for CPU tensors
    (``"cpu:gloo,cuda:nccl"``; gloo alone without CUDA); an explicit one is
    used for both. Every collective that waits longer than ``timeout``
    raises."""
    global _world
    if _world is not None:
        return
    env = os.environ
    explicit = coordinator_address is not None and num_processes is not None
    coordinator_address = coordinator_address or env.get("JAX_COORDINATOR_ADDRESS")
    if num_processes is None and "JAX_NUM_PROCESSES" in env:
        num_processes = int(env["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in env:
        process_id = int(env["JAX_PROCESS_ID"])
    if coordinator_address and num_processes and (num_processes > 1 or explicit):
        host, port = coordinator_address.rsplit(":", 1)
        rank, size = int(process_id or 0), num_processes
        local_rank, local_size = (int(local_device_ids[0]) if local_device_ids else 0), 1
    elif int(env.get("WORLD_SIZE", "1")) > 1:
        host, port = env["MASTER_ADDR"], env["MASTER_PORT"]
        rank, size = int(env["RANK"]), int(env["WORLD_SIZE"])
        local_rank = int(env.get("LOCAL_RANK", "0"))
        local_size = int(env.get("LOCAL_WORLD_SIZE", "1"))
    else:
        return  # one process
    if not 0 <= rank < size:
        raise ValueError(f"rank {rank} outside a world of {size}")
    _world = World(rank, size, local_rank, local_size, host, int(port), backend, timeout)


def world() -> World | None:
    """The world of :func:`initialize`, or None for a one-process run."""
    return _world


def _group(kind: str = "default"):
    """The default process group (``kind`` "default") or the gloo group for
    Python objects on the CPU ("cpu"), made at the first call."""
    if not _groups:
        w = _world
        backend = w.backend or ("cpu:gloo,cuda:nccl" if torch.cuda.is_available() else "gloo")
        tdist.init_process_group(backend, init_method=f"tcp://{w.host}:{w.port}", rank=w.rank,
                                 world_size=w.size, timeout=w.timeout)
        _groups["default"] = tdist.group.WORLD
        _groups["cpu"] = tdist.group.WORLD if backend == "gloo" else tdist.new_group(backend="gloo",
                                                                                     timeout=w.timeout)
    return _groups[kind]


def shutdown() -> None:
    """Leave the run: destroy its process groups (at the end of a rank's run)."""
    global _world
    if _groups:
        tdist.destroy_process_group()
        _groups.clear()
    _world = None


def process_index() -> int:
    return _world.rank if _world else 0


def process_count() -> int:
    return _world.size if _world else 1


def local_rank() -> int:
    """This rank's index among its host's ranks (its card)."""
    return _world.local_rank if _world else 0


def local_world_size() -> int:
    return _world.local_size if _world else 1


def is_main() -> bool:
    """True on the rank that owns checkpoint and log writes."""
    return process_index() == 0


def local_device() -> torch.device:
    """This rank's card: ``cuda:<local rank>``."""
    return torch.device("cuda", local_rank())


def host_shard_range(n_items: int) -> tuple[int, int]:
    """Deterministic contiguous [start, end) of n_items for this rank;
    earlier ranks get the remainder (the reference's manual
    ``--start_idx/--end_idx`` job splitting)."""
    p, n = process_index(), process_count()
    base, rem = divmod(n_items, n)
    start = p * base + min(p, rem)
    return start, start + base + (1 if p < rem else 0)


def host_shard_indices(n_items: int) -> np.ndarray:
    """Strided index shard (balanced across ranks for per-item costs that
    vary, e.g. image sizes)."""
    return np.arange(process_index(), n_items, process_count())


def local_batch_size(global_batch: int) -> int:
    n = process_count()
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by {n} processes")
    return global_batch // n


def local_rows(batch: dict) -> dict:
    """This rank's rows of a batch that its host's stream drew for all of
    the host's ranks: the ``local_rank``-th of ``local_world_size`` equal
    parts along axis 0 of every array with a batch axis; other values pass
    through."""
    n, r = local_world_size(), local_rank()
    if n == 1:
        return batch
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray) and v.ndim:
            if len(v) % n:
                raise ValueError(f"batch of {len(v)} rows not divisible by {n} local ranks")
            b = len(v) // n
            v = v[r * b:(r + 1) * b]
        out[k] = v
    return out


def all_reduce_sum_(tensor: torch.Tensor) -> torch.Tensor:
    """Sum ``tensor`` over the ranks, in place; returns it."""
    if _world is not None:
        tdist.all_reduce(tensor, op=tdist.ReduceOp.SUM, group=_group())
    return tensor


def all_reduce_mean_(tensor: torch.Tensor) -> torch.Tensor:
    """Mean of ``tensor`` over the ranks, in place (the gradient psum of the
    JAX package's data-parallel step, divided by the rank count as the
    global batch's mean loss needs); returns it."""
    if _world is not None:
        all_reduce_sum_(tensor).div_(_world.size)
    return tensor


def all_gather_objects(obj) -> list:
    """Every rank's picklable ``obj``, in rank order (the reference's
    ``comm.gather`` of evaluation results)."""
    if _world is None:
        return [obj]
    out = [None] * process_count()
    tdist.all_gather_object(out, obj, group=_group("cpu"))
    return out


def barrier(name: str = "barrier") -> None:
    """Wait until every rank reaches this point (``name`` labels it in
    errors)."""
    if _world is not None:
        try:
            tdist.barrier(group=_group("cpu"))
        except RuntimeError as exc:
            raise RuntimeError(f"barrier {name!r}: {exc}") from exc
