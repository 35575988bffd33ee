"""Process bootstrap for multi-process runs (port of krepp_tpu/parallel/boot.py).

`init_distributed` joins this process to a `torch.distributed` process
group. It must run before the process's first CUDA call: it picks the
rank's own card (`torch.cuda.set_device`), so that NCCL ranks on one
machine take distinct cards.

Usage (one process per rank, every rank running the same program):

    from krepp_tpu_torch.parallel.boot import init_distributed
    init_distributed("localhost:29500", 2, rank)   # or the KREPP_* env vars
    from krepp_tpu_torch.parallel.multihost import MultiHostQueryEngine

Backends: NCCL on the card, gloo on the host. Two ranks that share one
card need gloo (`backend="gloo"` or KREPP_DIST_BACKEND=gloo): NCCL refuses
them, and `init_distributed` raises before it would.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

DEFAULT_TIMEOUT_S = 300


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None, device="cuda",
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """torch.distributed.init_process_group with env-var defaults.

    KREPP_COORDINATOR (host:port of rank 0), KREPP_NUM_PROCESSES,
    KREPP_PROCESS_ID and KREPP_DIST_BACKEND (nccl | gloo) stand in for
    arguments left None. The backend defaults to nccl for device "cuda" and
    gloo for "cpu". `timeout_s` bounds the rendezvous and every collective,
    so a rank whose peer died raises instead of hanging."""
    import torch
    import torch.distributed as dist

    from .. import resolve_device

    coordinator_address = coordinator_address or os.environ.get(
        "KREPP_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("KREPP_NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("KREPP_PROCESS_ID", "0"))
    dev = resolve_device(device)
    backend = (backend or os.environ.get("KREPP_DIST_BACKEND")
               or ("nccl" if dev.type == "cuda" else "gloo"))
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: nccl or gloo")
    if coordinator_address is None:
        raise ValueError("init_distributed needs the coordinator's host:port "
                         "(argument or KREPP_COORDINATOR)")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} outside 0..{num_processes - 1}")
    if dev.type == "cuda":
        have = torch.cuda.device_count()
        if backend == "nccl" and num_processes > have:
            raise RuntimeError(
                f"{num_processes} NCCL ranks need {num_processes} CUDA "
                f"devices but this machine has {have}; ranks that share a "
                "card need the gloo backend (KREPP_DIST_BACKEND=gloo)")
        torch.cuda.set_device(rank_devices(process_id, num_processes, have)[0])
    elif backend == "nccl":
        raise ValueError("the nccl backend needs --device cuda")
    if "://" not in coordinator_address:
        coordinator_address = "tcp://" + coordinator_address
    dist.init_process_group(backend=backend, init_method=coordinator_address,
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s))


def rank_devices(rank: int, world: int, have: int):
    """The card indices rank `rank` of `world` may use on a machine with
    `have` cards: an equal block each; when there are fewer cards than
    ranks (gloo only), ranks share them round robin, one card each."""
    block = have // world
    if block == 0:
        return [rank % have]
    return list(range(rank * block, (rank + 1) * block))


def shutdown_distributed() -> None:
    """Leave the process group, if this process joined one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
