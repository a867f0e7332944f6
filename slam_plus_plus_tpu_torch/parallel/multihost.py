"""Multi-process entry: torch.distributed wiring (port of
slam_plus_plus_tpu/parallel/multihost.py).

The reference is single-process (SURVEY.md §2.3 P6: no MPI/NCCL anywhere in
its tree); multi-process execution is the capability the JAX package adds
with ``jax.distributed``.  The port runs one process per rank, each on one
device, joined by ``torch.distributed``:

  * ``initialize`` takes the coordinator, the process count and this
    process's id from its arguments, else from ``SLAMPP_COORD`` /
    ``SLAMPP_NPROCS`` / ``SLAMPP_PROC_ID``, and calls
    ``init_process_group``.  The coordinator is ``HOST:PORT`` (a
    ``tcp://`` rendezvous: rank 0 serves the store and waits for every
    rank) or a ``file://`` path (a FileStore, which needs no free port);
  * the backend follows the device: NCCL for ``cuda``, gloo for ``cpu``;
    ``backend="gloo"`` may be asked for CUDA tensors (gloo stages them
    through the host), as when several ranks share one card, which NCCL
    refuses;
  * with nothing configured, ``initialize`` returns False and the run is
    single-process.  Unlike the JAX module, which takes a failed cluster
    auto-detection as a single-process run, a configured run that cannot
    reach its coordinator raises: a tcp rendezvous within about twice
    ``timeout_s`` (the store's connect retries), a gloo group once its
    peers miss ``timeout_s``.

The sharded classes (parallel/dist.py, dist_cholesky.py, sharded_ba.py)
take the process group to run over (default: the world group) and an
explicit device; no device mesh is built, since a mesh binds rank r to
``cuda:r`` and one card may carry several ranks.

CLI: ``python -m slam_plus_plus_tpu_torch.app.main --dist-coord HOST:PORT
--dist-nprocs N --dist-procid I`` (see app/main.py), or the SLAMPP_*
variables.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

#: seconds a configured rendezvous may take before initialize raises
DEFAULT_TIMEOUT_S = 60.0


def default_backend(device) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return "nccl"
    if dev.type == "cpu":
        return "gloo"
    raise ValueError(f"unsupported device {dev}; use 'cpu' or 'cuda'")


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None, *, device="cuda",
               timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join the process group; True once a multi-process runtime is up
    (already, or now), False for a single-process run (no coordinator and
    no process count, in the arguments or the environment).

    backend: None follows ``device`` (``default_backend``).  Raises
    ValueError on a partial configuration, and torch.distributed's error
    when the coordinator cannot be reached in time."""
    if dist.is_initialized():
        return True
    coordinator = coordinator or os.environ.get("SLAMPP_COORD")
    if num_processes is None and os.environ.get("SLAMPP_NPROCS"):
        num_processes = int(os.environ["SLAMPP_NPROCS"])
    if process_id is None and os.environ.get("SLAMPP_PROC_ID"):
        process_id = int(os.environ["SLAMPP_PROC_ID"])
    if coordinator is None and num_processes is None:
        return False
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError("a multi-process run needs the coordinator, the process count and "
                         "this process's id (--dist-coord / --dist-nprocs / --dist-procid, "
                         "or SLAMPP_COORD / SLAMPP_NPROCS / SLAMPP_PROC_ID)")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} outside 0..{num_processes - 1}")
    init = coordinator if coordinator.startswith("file://") else f"tcp://{coordinator}"
    dist.init_process_group(backend or default_backend(device), init_method=init,
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return True


def is_multiprocess() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def process_summary() -> str:
    """This process's rank, the world size and the backend."""
    if not dist.is_initialized():
        return "process 0/1, single-process (no process group)"
    return (f"process {dist.get_rank()}/{dist.get_world_size()}, backend "
            f"{dist.get_backend()}, 1 local / {dist.get_world_size()} global devices")
