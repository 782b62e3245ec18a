"""Data parallelism over several processes, one card each (`torch.distributed`).

Counterpart of `vamb_tpu/parallel`, which runs SPMD programs over a
`jax.sharding.Mesh`. The scale axis of the problem is N contigs (rows of
the feature and latent matrices), so the strategy is the same:

* **Data-parallel training** of every model (the VAE, Taxometer, VAEVAE
  and the AAE): every rank draws the same global batches from the shared
  threefry streams and computes on its own rows of each, parameters
  replicated. The flat gradient (each of the AAE's three phases' its own)
  and BatchNorm's batch sums are combined across ranks, the losses' means
  are over the global batch, so BatchNorm's statistics are the global
  batch's and the parameters stay bit-identical on every rank.
* **Row-sharded clustering**: rank r holds a contiguous block of the
  latent matrix's columns; each medoid's distances are computed on the
  shard, and only small payloads cross ranks (the query's features, the
  60-bin histogram, the density and counts, the wander step's top C keys,
  the emitted members).
* **Several hosts**: `distributed_init` from an explicit coordinator, or
  from torchrun's environment (`--dist`).

Unlike `vamb_tpu`, where one process drives every local device, the port
runs one process a card, as torch does. Every float sum that crosses ranks
is taken by the helpers of `mesh.py` in rank order on every rank, never in
NCCL's or gloo's order, so each rank decides alike.
"""

from .mesh import (  # noqa: F401
    Mesh,
    distributed_close,
    distributed_init,
    make_mesh,
    process_info,
    replicate,
    shard_rows,
    shard_rows_padded,
)
