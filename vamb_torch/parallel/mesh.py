"""The process group, the mesh over it, sharding helpers and the collectives.

Port of `vamb_tpu/parallel/mesh.py`. `vamb_tpu` meshes every device of its
processes in one SPMD program; the port runs one process a card (torch's
idiom), so a `Mesh` is the process group with this rank's place in it and
its device. `vamb_tpu`'s `warm_backend_async` has no counterpart: it warms
JAX's backend on a thread while the FASTA is parsed, and torch has no
backend to warm (CUDA initializes at the first use of the card).

Collectives. The port's few helpers over `torch.distributed` fix the order
of every float sum that crosses ranks: they gather every rank's value and
add them in rank order, on every rank alike, and never trust NCCL's or
gloo's reduction order for a sum that a decision reads (integer counts,
whose sum has no order, ride in the same gathers). Each call is tallied by kind
in `Mesh.traffic`: calls, the bytes of its result on this rank and the
largest such result. A gloo group's collectives take host tensors, so a
card's tensor goes to the host and back: that is gloo's transport (two
processes can share one card over gloo, where NCCL refuses two ranks on one
device). Every process group is created with a finite timeout, so a rank
that dies makes the others fail rather than hang.
"""

import gc
import os
from datetime import timedelta
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

DEFAULT_TIMEOUT_S = 600.0

# (process_id, num_processes) and the local rank, recorded by
# distributed_init so callers (the CLI's output gating in __main__.run)
# can consult them without a process group at hand
_process_info: tuple[int, int] = (0, 1)
_local_rank = 0


def process_info() -> tuple[int, int]:
    "(process_id, num_processes) as recorded at distributed_init time."
    return _process_info


def distributed_init(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    auto: bool = False,
    device="cuda",
    backend: Optional[str] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> bool:
    """Join the processes of a multi-process run. Returns True if there are
    several.

    Explicit mode: the coordinator's `host:port` (a `tcp://` rendezvous; an
    address with a scheme, such as `file:///path`, is used as it is), the
    number of processes and this process's id. Auto mode (`auto=True`, the
    CLI's `--dist`): torchrun's environment, `RANK`, `WORLD_SIZE`,
    `MASTER_ADDR` and `MASTER_PORT`, the counterpart of
    `jax.distributed.initialize()`'s discovery. A single-process explicit
    call is a no-op. The backend is NCCL for `device` "cuda" and gloo for
    "cpu" unless `backend` names one (gloo on the card: several processes
    sharing one card). A rank's card is `LOCAL_RANK`, else its process id
    modulo the cards it sees."""
    global _process_info, _local_rank
    dev_type = torch.device(device).type
    backend = backend or ("nccl" if dev_type == "cuda" else "gloo")
    timeout = timedelta(seconds=timeout_s)
    if num_processes is not None and num_processes > 1:
        if coordinator_address is None or process_id is None:
            raise ValueError("an explicit multi-process launch needs a coordinator and a process id")
        init = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
        cards = max(1, torch.cuda.device_count()) if dev_type == "cuda" else 1
        local = int(os.environ.get("LOCAL_RANK", process_id % cards))
        if dev_type == "cuda":
            torch.cuda.set_device(local)
        dist.init_process_group(backend, init_method=init, world_size=num_processes,
                                rank=process_id, timeout=timeout)
    elif auto:
        local = int(os.environ.get("LOCAL_RANK", 0))
        if dev_type == "cuda":
            torch.cuda.set_device(local)
        dist.init_process_group(backend, init_method="env://", timeout=timeout)
    else:
        return False
    _local_rank = local
    _process_info = (dist.get_rank(), dist.get_world_size())
    return _process_info[1] > 1


def distributed_close() -> None:
    """Leave the run's process group, if this process joined one. Drop every
    reference to it first (the meshes that hold it): a group whose last
    reference outlives `destroy_process_group` is torn down at the
    interpreter's exit, where gloo's threads can abort the process after
    its work is done."""
    global _process_info
    if dist.is_available() and dist.is_initialized():
        gc.collect()
        dist.destroy_process_group()
    _process_info = (0, 1)


class Mesh:
    """A 1-D mesh of `size` ranks, one device each: the process group
    (None for a lone process, whose collectives are the identity), this
    rank, the size, this rank's device, and the tally of its collectives
    (`traffic`: kind -> {"calls", "bytes", "max_bytes"})."""

    def __init__(self, group, rank: int, size: int, device: torch.device):
        self.group = group
        self.rank = rank
        self.size = size
        self.device = torch.device(device)
        self.traffic: dict = {}
        self._via_host = group is not None and self.device.type == "cuda" and (
            dist.get_backend(group) == "gloo")

    def __repr__(self) -> str:
        return f"Mesh(rank {self.rank} of {self.size} on {self.device})"

    def block(self, n: int) -> tuple[int, int]:
        "This rank's contiguous block [lo, hi) of n rows (or columns)."
        return self.rank * n // self.size, (self.rank + 1) * n // self.size

    def _tally(self, kind: str, nbytes: int) -> None:
        t = self.traffic.setdefault(kind, {"calls": 0, "bytes": 0, "max_bytes": 0})
        t["calls"] += 1
        t["bytes"] += nbytes
        t["max_bytes"] = max(t["max_bytes"], nbytes)

    def reset_traffic(self) -> None:
        self.traffic = {}

    def all_gather(self, t: torch.Tensor, kind: str) -> torch.Tensor:
        "Every rank's `t` (the same shape on each), stacked in rank order: (size, *t.shape)."
        t = t.contiguous()
        self._tally(kind, t.numel() * t.element_size() * self.size)
        if self.group is None:
            return t[None].clone()
        src = t.cpu() if self._via_host else t
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        return torch.stack(parts).to(t.device)

    def sum_ranks(self, t: torch.Tensor, kind: str) -> torch.Tensor:
        """The sum of every rank's `t`, added in rank order ((t0 + t1) + t2
        ...), the same bits on every rank; at size 1, `t`'s own."""
        parts = self.all_gather(t, kind)
        total = parts[0]
        for r in range(1, self.size):
            total = total + parts[r]
        return total

    def broadcast(self, t: torch.Tensor, src: int, kind: str) -> torch.Tensor:
        "Rank `src`'s `t` on every rank (a new tensor on `t`'s device)."
        t = t.contiguous()
        self._tally(kind, t.numel() * t.element_size())
        if self.group is None:
            return t.clone()
        buf = t.to("cpu", copy=True) if self._via_host else t.clone()
        dist.broadcast(buf, src, group=self.group)
        return buf.to(t.device)

    def gather_rows(self, t: torch.Tensor, kind: str) -> torch.Tensor:
        """Every rank's `t` (rows of any count, the same trailing shape)
        concatenated in rank order: the counts, then the rows padded to the
        largest count, two collectives."""
        counts = self.all_gather(torch.tensor([t.shape[0]], device=t.device), kind + " counts")
        counts = counts[:, 0].tolist()
        most = max(counts)
        padded = torch.zeros((most, *t.shape[1:]), dtype=t.dtype, device=t.device)
        padded[: t.shape[0]] = t
        parts = self.all_gather(padded, kind)
        return torch.cat([parts[r, : counts[r]] for r in range(self.size)])


def make_mesh(n_devices: Optional[int] = None, device="cuda") -> Mesh:
    """The 1-D mesh over every process of the run (the default group), or
    over this lone process where no group was joined; `n_devices`, where
    given, must be their number. A rank's device is `cuda:<local rank>` for
    "cuda", else the CPU."""
    dev = torch.device(device)
    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
        if n_devices is not None and n_devices != world:
            raise ValueError(f"Requested {n_devices} devices but the run has {world} processes")
        if dev.type == "cuda":
            dev = torch.device("cuda", _local_rank)
        return Mesh(dist.group.WORLD, dist.get_rank(), world, dev)
    if n_devices is not None and n_devices != 1:
        raise ValueError(f"Requested {n_devices} devices but only 1 process runs")
    return Mesh(None, 0, 1, dev)


def shard_rows(array, mesh: Mesh) -> torch.Tensor:
    """This rank's contiguous block of `array`'s rows on its device (`P(axis)`'s
    block layout); the row count must be a multiple of the mesh's size."""
    array = torch.as_tensor(np.asarray(array))
    if array.shape[0] % mesh.size:
        raise ValueError(f"{array.shape[0]} rows do not split over {mesh.size} ranks")
    lo, hi = mesh.block(array.shape[0])
    return array[lo:hi].to(mesh.device)


def shard_rows_padded(array, mesh: Mesh) -> torch.Tensor:
    """`shard_rows` after zero-padding the rows to a multiple of the mesh's
    size. Callers that gather rows by index must draw indices below the
    original length so the padding rows are never touched."""
    array = np.asarray(array)
    pad = (-array.shape[0]) % mesh.size
    if pad:
        array = np.concatenate([array, np.zeros((pad, *array.shape[1:]), array.dtype)])
    return shard_rows(array, mesh)


def replicate(tree: Any, mesh: Mesh):
    """Rank 0's values on every rank: a module's parameters and buffers in
    place (returns the module), or a tensor, dict, list or tuple of them as
    new tensors."""
    if isinstance(tree, nn.Module):
        with torch.no_grad():
            for t in (*tree.parameters(), *tree.buffers()):
                t.copy_(mesh.broadcast(t.detach(), 0, "replicate"))
        return tree
    if isinstance(tree, dict):
        return {k: replicate(v, mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(replicate(v, mesh) for v in tree)
    return mesh.broadcast(torch.as_tensor(tree, device=mesh.device), 0, "replicate")
