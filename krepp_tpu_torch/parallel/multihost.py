"""Multi-process querying: the sharded engine over a mesh spanning processes.

Port of krepp_tpu/parallel/multihost.py. One process per rank joins a
torch.distributed process group (parallel/boot.py); the global mesh is laid
out in rank order, as `jax.devices()` is: rank r owns cells
[r * L, (r + 1) * L) of the row-major [n_data, n_shard] grid, L = n_data *
n_shard / processes, and uploads only those cells' shard blocks (the
counterpart of `make_array_from_callback`). Every process runs the same
program on the same inputs (SPMD convention), and runs the cells it owns
at once, a host thread a cell (ShardedQueryEngine); collectives are called
on the calling thread only, once every cell's step has returned, in one
order on every process. Two layouts exist: a data
row inside one process (L a multiple of n_shard; only the gather of the
rows' outputs crosses processes), or a data row over several processes
(n_shard a multiple of L; the shard merge itself crosses them).

The collectives of ShardedQueryEngine become torch.distributed calls:
`_reduce_across` an all_reduce (or all_gather, for event lanes) over the
processes of one data row, `_gather_rows` an all_gather of the rows'
probe outputs over one process of each row; every process then holds the
whole batch's outputs, which the reference gets by all-gathering them
after the step. NCCL runs them on the rank's card; under gloo, tensors go
through host memory explicitly.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .. import resolve_device
from .boot import init_distributed, rank_devices  # noqa: F401  (re-export)
from .mesh import QueryMesh, ShardedQueryEngine

_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
        "max": dist.ReduceOp.MAX}


def make_global_mesh(n_data: int, n_shard: int, device="cuda") -> QueryMesh:
    """The [n_data, n_shard] mesh over every process of the group, in rank
    order; this process's cells are its own devices (the host repeated for
    "cpu"; on the card its block of `rank_devices`, which must hold L
    cards), the others' None."""
    world, rank = dist.get_world_size(), dist.get_rank()
    cells = n_data * n_shard
    spec = f"--mesh {n_data}x{n_shard}"
    if cells % world:
        raise ValueError(f"{spec}: {cells} cells do not split evenly over "
                         f"{world} processes")
    L = cells // world
    if L % n_shard and n_shard % L:
        raise ValueError(f"{spec} over {world} processes: {L} cells a "
                         f"process neither hold whole data rows nor divide "
                         f"one ({n_shard} shards)")
    dev = resolve_device(device)
    if dev.type == "cpu":
        local = [dev] * L
    else:
        have = torch.cuda.device_count()
        mine = rank_devices(rank, world, have)
        if len(mine) < L:
            raise RuntimeError(
                f"{spec} over {world} processes asks for {L} CUDA devices a "
                f"process but this machine has {have} ({len(mine)} a "
                "process)")
        local = [torch.device("cuda", i) for i in mine[:L]]
    devices, ranks = [], []
    for g in range(n_data):
        flat = range(g * n_shard, (g + 1) * n_shard)
        ranks.append([f // L for f in flat])
        devices.append([local[f % L] if f // L == rank else None
                        for f in flat])
    return QueryMesh(devices, ranks, rank)


class MultiHostQueryEngine(ShardedQueryEngine):
    """ShardedQueryEngine over a mesh that spans processes (see the module
    docstring); every process gets the whole batch's results."""

    def __init__(self, dindex, mesh: QueryMesh, hdist_th: int = 4,
                 concurrent: bool = True):
        self._nccl = dist.get_backend() == "nccl"
        # every process creates every group, in the same order
        self._row_groups = {}
        for g, row in enumerate(mesh.ranks):
            members = sorted(set(row))
            if len(members) > 1:
                grp = dist.new_group(members)
                if mesh.rank in members:
                    self._row_groups[g] = (grp, len(members))
        # one process of each data row (the j-th of its row), in row order
        per_row = len(set(mesh.ranks[0]))
        self._col_group = None
        for j in range(per_row):
            members = sorted({sorted(set(row))[j] for row in mesh.ranks})
            if len(members) > 1:
                grp = dist.new_group(members)
                if mesh.rank in members:
                    self._col_group = (grp, len(members))
        super().__init__(dindex, mesh, hdist_th, concurrent)

    def _to_comm(self, x):
        """The tensor a collective takes: on the rank's card for NCCL, in
        host memory for gloo; bools as uint8."""
        if x.dtype == torch.bool:
            x = x.to(torch.uint8)
        if self._nccl:
            return x.to(torch.cuda.current_device()).contiguous()
        return x.cpu().contiguous()

    def _all_gather(self, x, group):
        grp, size = group
        y = self._to_comm(x)
        outs = [torch.empty_like(y) for _ in range(size)]
        dist.all_gather(outs, y, group=grp)
        return torch.cat(outs).to(x.device, x.dtype)

    def _reduce_across(self, g: int, x, op: str):
        group = self._row_groups.get(g)
        if group is None:
            return x
        if op == "cat":
            return self._all_gather(x, group)
        y = self._to_comm(x)
        dist.all_reduce(y, op=_OPS[op], group=group[0])
        return y.to(x.device, x.dtype)

    def _gather_rows(self, rows):
        own = super()._gather_rows(rows)
        if self._col_group is None:
            return own
        return tuple(self._all_gather(x, self._col_group) for x in own)
