"""Core host-side utilities: IO, arrays, hashing, binsplitting, threefry.

Copies of `vamb_tpu/utils` (itself after the reference's vamb/vambtools.py):
FASTA parsing with SAM-spec identifier validation, compression-sniffing
reader, growable arrays, z-scoring, mantissa masking for cross-platform
reproducibility, identifier ref-hashing, cluster/bin TSV + FASTA IO.
"""

from .arrays import PushArray, zscore, mask_lower_bits, validate_input_array
from .io import (
    Reader,
    FastaEntry,
    byte_iterfasta,
    read_npz,
    write_npz,
    write_clusters,
    read_clusters,
    write_bins,
    concatenate_fasta,
    concatenate_fasta_ios,
    CLUSTERS_HEADER,
)
from .hashing import RefHasher
from .binsplit import BinSplitter

__all__ = [
    "PushArray",
    "zscore",
    "mask_lower_bits",
    "validate_input_array",
    "Reader",
    "FastaEntry",
    "byte_iterfasta",
    "read_npz",
    "write_npz",
    "write_clusters",
    "read_clusters",
    "write_bins",
    "concatenate_fasta",
    "concatenate_fasta_ios",
    "CLUSTERS_HEADER",
    "RefHasher",
    "BinSplitter",
]
