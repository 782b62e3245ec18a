"""Training-schedule helpers shared by the model families.

Copies of `vamb_tpu/models/training.py:segment_plan` and
`validate_batchsteps`; the jitted multi-epoch scan machinery there has no
counterpart, because PyTorch runs the epoch loop eagerly.
"""

from typing import Optional


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
