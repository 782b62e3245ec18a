"""Composition: streaming FASTA -> 4-mer counts -> 103-dim TNF per contig.

Host-side copy of `vamb_tpu/composition.py` (the TNF stage runs on numpy in
both packages, so `composition.npz` is bit-identical). The host streams and
counts k-mers with bounded buffers (batches of ~1000 contigs of counts) and
projects them with BLAS. The final matrix has its 12 low mantissa bits
zeroed for cross-platform stability (reference parsecontigs.py:211).
"""

from pathlib import Path
from typing import IO, Iterable, Optional, Sequence, TypeVar, Union

import numpy as np

from .utils import PushArray, RefHasher, byte_iterfasta, mask_lower_bits
from .utils.arrays import numpy_inplace_maskarray, validate_input_array
from .ops.tnf import project_fourmers_numpy
from .utils.kmers import kmercounts_batch

# Flush raw counts to the projection whenever this many float32s
# accumulate (1000 contigs' worth; reference uses 256_000 at :202).
_RAW_BUFFER_FLOATS = 256_000


class CompositionMetaData:
    """Metadata of a composition: identifiers, lengths, keep-mask, refhash.

    * identifiers: object array of str identifiers of kept sequences
    * lengths: uint32/int array of kept sequence lengths
    * mask: bool array over the ORIGINAL file entries (True = kept)
    * refhash: md5 digest over the ordered kept identifiers
    * minlength: the filter used
    """

    __slots__ = ["identifiers", "lengths", "mask", "refhash", "minlength"]

    def __init__(
        self,
        identifiers: np.ndarray,
        lengths: np.ndarray,
        mask: np.ndarray,
        minlength: int,
    ):
        assert len(identifiers) == len(lengths)
        assert identifiers.dtype == np.dtype("O")
        assert np.issubdtype(lengths.dtype, np.integer)
        assert mask.dtype == bool
        assert mask.sum() == len(lengths)
        assert lengths.min(initial=minlength) >= minlength

        if len(set(identifiers)) < len(identifiers):
            raise ValueError(
                "Sequence names must be unique, but are not. "
                "Only the identifier (e.g. header before whitespace) is used as "
                "sequence identifier. Verify identifier uniqueness."
            )

        self.identifiers = identifiers
        self.lengths = lengths
        self.mask = mask
        self.minlength = minlength
        self.refhash = RefHasher.hash_refnames(identifiers)

    @property
    def nseqs(self) -> int:
        return len(self.identifiers)

    def filter_mask(self, mask: Sequence[bool]):
        "Keep only entries where `mask` (length nseqs) is True."
        assert len(mask) == self.nseqs
        ind = 0
        for i in range(len(self.mask)):
            if self.mask[i]:
                self.mask[i] &= mask[ind]
                ind += 1

        self.identifiers = self.identifiers[mask]
        self.lengths = self.lengths[mask]
        self.refhash = RefHasher.hash_refnames(self.identifiers)

    def filter_min_length(self, length: int):
        if length <= self.minlength:
            return None
        self.filter_mask(self.lengths >= length)
        self.minlength = length


C = TypeVar("C", bound="Composition")


class Composition:
    "A CompositionMetaData plus its (nseqs, 103) float32 TNF matrix."

    __slots__ = ["metadata", "matrix"]

    def __init__(self, metadata: CompositionMetaData, matrix: np.ndarray):
        assert matrix.dtype == np.float32
        assert matrix.shape == (metadata.nseqs, 103)
        self.metadata = metadata
        self.matrix = matrix

    def count_bases(self) -> int:
        return int(self.metadata.lengths.sum())

    @property
    def nseqs(self) -> int:
        return self.metadata.nseqs

    def save(self, io: Union[str, Path, IO[bytes]]):
        np.savez(
            io,
            matrix=self.matrix,
            identifiers=self.metadata.identifiers,
            lengths=self.metadata.lengths,
            mask=self.metadata.mask,
            minlength=self.metadata.minlength,
        )

    @classmethod
    def load(cls, io: Union[str, IO[bytes], Path]):
        arrs = np.load(io, allow_pickle=True)
        metadata = CompositionMetaData(
            validate_input_array(arrs["identifiers"]),
            validate_input_array(arrs["lengths"]),
            validate_input_array(arrs["mask"]),
            arrs["minlength"].item(),
        )
        return cls(metadata, validate_input_array(arrs["matrix"]))

    def filter_min_length(self, length: int):
        if length <= self.metadata.minlength:
            return None
        mask = self.metadata.lengths >= length
        self.metadata.filter_mask(mask)
        self.metadata.minlength = length
        numpy_inplace_maskarray(self.matrix, mask)

    @classmethod
    def from_file(
        cls: type[C],
        filehandle: Iterable[bytes],
        filename: Optional[str],
        minlength: int = 2000,
    ) -> C:
        """Stream a binary FASTA filehandle into a Composition.

        Contigs shorter than `minlength` are dropped (recorded in the mask).
        A contig with zero countable 4-mers is an error, as it carries no
        composition signal.

        The 256->103 projection runs on the host (BLAS sgemm): it does ~53
        FLOPs per input byte, so shipping the 256-dim counts to the card
        would move 3.5x the bytes of uploading the finished 103-dim
        features once for training.
        """
        if minlength < 4:
            raise ValueError(f"Minlength must be at least 4, not {minlength}")

        projected = PushArray(np.float32)
        lengths = PushArray(np.int32)
        mask = bytearray()
        contignames: list[str] = list()
        # Sequences are buffered and 4-mer-counted in ONE native call per
        # flush (per-contig ctypes overhead dominated count time for short
        # contigs).
        flush_contigs = _RAW_BUFFER_FLOATS // 256  # 1000
        seq_buf: list[bytes] = []
        hdr_buf: list[str] = []

        def flush():
            if not seq_buf:
                return
            counts_mat = kmercounts_batch(seq_buf).astype(np.float32)
            sums = counts_mat.sum(axis=1)
            if (sums == 0).any():
                bad = hdr_buf[int(np.argmax(sums == 0))]
                raise ValueError(
                    f'TNF value of contig "{bad}" is all zeros. '
                    "This implies that the sequence contained no 4-mers of A, C, G, T "
                    "or U, making this sequence uninformative. This is probably a "
                    "mistake. Verify that the sequence contains usable information "
                    "(e.g. is not all N's)"
                )
            seq_buf.clear()
            hdr_buf.clear()
            projected.extend(project_fourmers_numpy(counts_mat).ravel())

        for entry in byte_iterfasta(filehandle, filename):
            length = len(entry)
            skip = length < minlength
            mask.append(not skip)
            if skip:
                continue

            seq_buf.append(bytes(entry.sequence))
            hdr_buf.append(entry.header)
            if len(seq_buf) >= flush_contigs:
                flush()

            lengths.append(len(entry))
            contignames.append(entry.identifier)

        flush()
        tnfs_arr = projected.take()
        mask_lower_bits(tnfs_arr, 12)

        assert tnfs_arr.shape[0] % 103 == 0
        tnfs_arr.shape = (len(tnfs_arr) // 103, 103)
        lengths_arr = lengths.take()

        metadata = CompositionMetaData(
            np.array(contignames, dtype=object),
            lengths_arr,
            np.array(mask, dtype=bool),
            minlength,
        )
        return cls(metadata, tnfs_arr)
