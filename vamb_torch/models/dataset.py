"""Dataset: the normalization contract + device-resident batching.

Replicates the reference's `make_dataloader` normalization exactly
(reference vamb/encode.py:53-146) — it is load-bearing for bin parity:

1. per-sample depths scaled so each sample column sums to 1e6;
2. per-contig relative abundance: rows divided by their total (all-zero rows
   set to the uniform 1/S *before* division);
3. total abundance -> log(clip(.., 1e-3)) -> zscored, as a (N,1) column;
4. TNF columns zscored;
5. per-contig loss weights w = max(ln(len) - 5, 2), rescaled to mean 1.

The arrays are plain numpy, bit-identical to `vamb_tpu.models.dataset`;
the trainer (models/vae.py) moves them to the card once and shuffles them
there with `torch.randperm` per epoch. `drop_last` semantics match the
reference (incomplete trailing batch dropped whenever N > batchsize).
"""

from typing import NamedTuple

import numpy as np

from ..utils import zscore


class VAEDataset(NamedTuple):
    """Normalized training arrays (host numpy; the trainer moves them to the card)."""

    depths: np.ndarray  # (N, S) rows sum to 1
    tnf: np.ndarray  # (N, 103) columns zscored
    abundance: np.ndarray  # (N, 1) log total abundance, zscored
    weights: np.ndarray  # (N, 1) mean-1 length weights

    @property
    def n_obs(self) -> int:
        return len(self.depths)

    @property
    def nsamples(self) -> int:
        return self.depths.shape[1]


def make_dataset(
    abundance: np.ndarray,
    tnf: np.ndarray,
    lengths: np.ndarray,
    destroy: bool = False,
) -> VAEDataset:
    """Normalize raw abundance/TNF/lengths into VAE training inputs.

    With `destroy=True` the input arrays are mutated in place to halve peak
    host RAM (reference encode.py:94-96 semantics).
    """
    if not isinstance(abundance, np.ndarray) or not isinstance(tnf, np.ndarray):
        raise ValueError("TNF and abundance must be Numpy arrays")
    if len(abundance) != len(tnf) or len(tnf) != len(lengths):
        raise ValueError(
            "Lengths of abundance, TNF and lengths arrays must be the same"
        )
    if not (abundance.dtype == tnf.dtype == np.float32):
        raise ValueError("TNF and abundance must be Numpy arrays of dtype float32")

    if not destroy:
        abundance = abundance.copy()
        tnf = tnf.copy()

    sample_depths_sum = abundance.sum(axis=0)
    if np.any(sample_depths_sum == 0):
        raise ValueError(
            "One or more samples have zero depth in all sequences, "
            "so cannot be depth normalized"
        )
    abundance *= 1_000_000 / sample_depths_sum

    total_abundance = abundance.sum(axis=1)
    zero_total = total_abundance == 0
    abundance[zero_total] = 1 / abundance.shape[1]
    nonzero_total = np.where(zero_total, 1.0, total_abundance)
    abundance /= nonzero_total.reshape(-1, 1)

    total_abundance = np.log(total_abundance.clip(min=0.001))
    zscore(total_abundance, inplace=True)
    zscore(tnf, axis=0, inplace=True)

    lengths_f = lengths.astype(np.float32)
    weights = np.log(lengths_f) - 5.0
    weights[weights < 2.0] = 2.0
    weights *= len(weights) / weights.sum()

    return VAEDataset(
        depths=abundance,
        tnf=tnf,
        abundance=total_abundance.reshape(-1, 1).astype(np.float32),
        weights=weights.reshape(-1, 1).astype(np.float32),
    )


def num_batches(n_obs: int, batchsize: int) -> int:
    """Number of batches per epoch with reference drop_last semantics.

    When n_obs > batchsize the trailing incomplete batch is dropped; when
    n_obs <= batchsize there is exactly one (smaller) batch.
    """
    if batchsize < 1:
        raise ValueError(f"Batch size must be minimum 1, not {batchsize}")
    if n_obs <= batchsize:
        return 1
    return n_obs // batchsize


def batchsize_at_epoch(start_batchsize: int, batchsteps: list[int], epoch: int) -> int:
    "Batch size after applying the doubling schedule up to (and incl.) `epoch`."
    return start_batchsize * 2 ** sum(1 for s in batchsteps if s <= epoch)
