"""The generic training loop shared by the model families, and its schedule.

Port of `vamb_tpu/models/training.py`. There one epoch is a jitted
`lax.scan` over shuffled minibatches (`make_scan_epoch_fn`), and a run of
epochs at one batch size is one dispatch (`run_segments_aot`, which also
compiles the segments' programs concurrently). PyTorch runs the same loop
eagerly (`train_epochs`), so there is nothing to compile ahead and no
counterpart of the concurrent compilation. It keeps `vamb_tpu`'s key chain
exactly (threefry, utils/threefry.py):

* each epoch takes `rng, key = split(rng)`;
* without `epoch_extra` the key splits in two, `perm_key, scan_key`; with
  it, in three, `perm_key, scan_key, extra_key`, even where the hook
  returns None (no dropout);
* the epoch's rows are `permutation(perm_key, n)[: nb * bs]` (drop-last
  batches, batch size doubled at the batchsteps);
* step i takes `key, sub = split(key)` from `scan_key`, or with
  `step_keys` k > 1, `key, *subs = split(key, k + 1)` (the AAE's five-way
  split has k = 4);
* an epoch's metrics are the mean over its steps.

`MetricsDrain` lets epochs run back to back: an epoch's metrics are copied
to the host without a sync and logged `lag` epochs later. `check_replicas`
holds data-parallel training's replicated parameters to being bit-identical
on every rank.

Data parallelism (`train_epochs(mesh=)`, `vamb_tpu`'s `make_scan_epoch_fn(
mesh=)`, which shards each gathered batch row-wise under GSPMD): every
rank draws the same global streams and holds the whole dataset; rank r
computes on its rows `mesh.block(bs)` of each global batch, and of the
epoch hook's and the step draws' batch-sized tensors (`rows_of`), inside
`layers.global_batch(mesh, bs)`, so BatchNorm takes the global batch's
statistics and the loss's means are the rank's share of the global
batch's. The step's optimizer sums the flat gradient over the ranks. The
model is replicated from rank 0 first, the epoch's metrics are summed over
the ranks in rank order, and the replicas are checked after every epoch.
"""

import time
from collections import deque
from typing import Callable, Optional

import numpy as np
import torch

from ..parallel import replicate
from ..utils import threefry
from . import layers
from .dataset import batchsize_at_epoch, num_batches


def rows_of(tree, lo: int, hi: int):
    """Rows [lo, hi) of every tensor in `tree` (a tensor, or a tuple, list
    or dict of them, nested; anything else is kept as it is)."""
    if torch.is_tensor(tree):
        return tree[lo:hi]
    if isinstance(tree, dict):
        return {k: rows_of(v, lo, hi) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(rows_of(v, lo, hi) for v in tree)
    return tree


def train_epochs(
    step: Callable,
    data: tuple,
    rng,
    n_obs: int,
    nepochs: int,
    batchsize: int,
    batchsteps_list: list[int],
    emit: Callable,
    epoch_extra: Optional[Callable] = None,
    step_keys: int = 1,
    step_draws: Optional[Callable] = None,
    mesh=None,
    model=None,
    log: Optional[Callable[[str], None]] = None,
):
    """Run `nepochs` epochs of `step` over `data` (row-aligned tensors on
    one device) from the key chain `rng`; returns the chain's next key.

    `step(batch, key, extra, i) -> metrics` is one optimizer step on the
    tuple of batch rows, with the step's key (a pair of ints; a tuple of
    `step_keys` pairs when that is above 1), the epoch's
    `epoch_extra(extra_key, batchsize)` (None without the hook) and the
    step index; `metrics` is a 1-D tensor. With `step_draws(keys,
    batchsize)`, the epoch's step keys turn into the steps' random draws in
    one call, and step i gets the result's item i in place of its key.
    `emit(epoch, values, batchsize, seconds)` logs an epoch's mean metrics
    (through `MetricsDrain`).

    With `mesh`, training is data-parallel over its ranks (see the module
    notes): `model` (the module `step` trains) is replicated from rank 0,
    and its parameters and buffers are held bit-identical on every rank
    after each epoch (`check_replicas`, which logs to `log`); `step` gets
    this rank's rows of the batch, the hook's result and its draws, and
    must sum its gradient over the ranks."""
    drain = MetricsDrain(emit)
    device = data[0].device
    if mesh is not None:
        replicate(model, mesh)
        replicas = [*model.parameters(), *model.buffers()]
    for epoch0, seg_len in segment_plan(nepochs, batchsteps_list):
        bs = min(batchsize_at_epoch(batchsize, batchsteps_list, epoch0), n_obs)
        nb = num_batches(n_obs, bs)
        lo, hi = (0, bs) if mesh is None else mesh.block(bs)  # this rank's rows of a batch
        for epoch in range(epoch0, epoch0 + seg_len):
            rng, key = threefry.split_host(rng)
            if epoch_extra is None:
                perm_key, scan_key = threefry.split_host(key)
                extra = None
            else:
                perm_key, scan_key, extra_key = threefry.split_host(key, 3)
                extra = rows_of(epoch_extra(extra_key, bs), lo, hi)
            idx = threefry.permutation(perm_key, n_obs, device)[: nb * bs]
            shuf = tuple(a[idx] for a in data)
            keys = []
            for _ in range(nb):
                scan_key, *subs = threefry.split_host(scan_key, step_keys + 1)
                keys.append(subs[0] if step_keys == 1 else tuple(subs))
            per_step = keys if step_draws is None else [
                rows_of(d, lo, hi) for d in step_draws(keys, bs)]
            total = None
            with layers.global_batch(mesh, bs):
                for i in range(nb):
                    batch = tuple(a[i * bs + lo : i * bs + hi] for a in shuf)
                    metrics = step(batch, per_step[i], extra, i)
                    total = metrics if total is None else total + metrics
            if mesh is not None:
                total = mesh.sum_ranks(total, "metrics")
            drain.push(epoch, total / nb, bs)
            if mesh is not None:
                check_replicas(replicas, mesh, log or (lambda _m: None))
    drain.flush()
    return torch.tensor(rng)


class MetricsDrain:
    """Emit per-epoch metric lines without a host sync each epoch.

    Each epoch's metrics vector is copied to pinned host memory without
    blocking, behind a CUDA event, and its line is emitted `lag` epochs
    later, when the copy has landed. `flush()` drains the rest. The "(X.XXs)"
    of a line is the wall time since the previous line: at steady state the
    epoch's time."""

    def __init__(self, emit: Callable[[int, np.ndarray, int, float], None], lag: int = 2):
        self._emit = emit
        self._lag = max(0, lag)
        self._pending: deque = deque()
        self._last = time.time()

    def push(self, epoch: int, metrics: torch.Tensor, batchsize: int) -> None:
        metrics = metrics.detach()
        if metrics.is_cuda:
            host = torch.empty(metrics.shape, dtype=metrics.dtype, pin_memory=True)
            host.copy_(metrics, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        else:
            host, event = metrics.clone(), None
        self._pending.append((epoch, host, event, batchsize))
        while len(self._pending) > self._lag:
            self._drain_one()

    def _drain_one(self) -> None:
        epoch, host, event, batchsize = self._pending.popleft()
        if event is not None:
            event.synchronize()
        now = time.time()
        self._emit(epoch, host.numpy(), batchsize, now - self._last)
        self._last = now

    def flush(self) -> None:
        while self._pending:
            self._drain_one()


def param_checksum(params) -> torch.Tensor:
    """A device int64 checksum of the parameters' bits: each float32 word
    times a weight by its position, summed (wrapping). Equal parameters give
    equal checksums; a changed word changes it."""
    words = torch.cat([p.detach().reshape(-1) for p in params]).view(torch.int32).to(torch.int64)
    weight = torch.arange(words.numel(), device=words.device) % 65521 + 1
    return (words * weight).sum()


def check_replicas(params, mesh, log: Callable[[str], None]) -> None:
    """Raise unless every rank of `mesh` holds the same parameters (their
    `param_checksum`s, gathered), and log the checksum."""
    sums = mesh.all_gather(param_checksum(params)[None], "checksums")[:, 0].tolist()
    if len(set(sums)) != 1:
        raise RuntimeError(f"data-parallel replicas diverged: parameter checksums {sums} by rank")
    log(f"\t\tParameters identical on {mesh.size} ranks (checksum {sums[0]})")


def segment_plan(nepochs, batchsteps_list, checkpoint_every=None):
    """Yield (epoch_start, seg_len) runs of constant batch size, bounded by
    batch-size doubling steps, optional checkpoint multiples and the end of
    training."""
    epoch = 0
    while epoch < nepochs:
        seg_end = min((s for s in batchsteps_list if s > epoch), default=nepochs)
        if checkpoint_every:
            seg_end = min(seg_end, (epoch // checkpoint_every + 1) * checkpoint_every)
        seg_end = min(seg_end, nepochs)
        yield epoch, seg_end - epoch
        epoch = seg_end


def validate_batchsteps(nepochs: int, batchsteps: Optional[list]) -> list[int]:
    "Reference batchsteps validation (encode.py:563-573)."
    if batchsteps is None:
        return []
    batchsteps = list(batchsteps)
    if not all(isinstance(i, int) for i in batchsteps):
        raise ValueError("All elements of batchsteps must be integers")
    if max(batchsteps, default=0) >= nepochs:
        raise ValueError("Max batchsteps must not equal or exceed nepochs")
    return sorted(set(batchsteps))
