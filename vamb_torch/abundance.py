"""Abundance: per-sample, per-contig depth matrix.

Host-side copy of `vamb_tpu/abundance.py`, TSV path only: the merged
`strobealign --aemb` format, strict header `contigname\\t<sample...>`; rows
validated against the composition mask and refhash (reference
parsebam.py:239-311). The BAM path (`from_files`) is not ported yet and
raises.
"""

from itertools import zip_longest
from math import isfinite
from pathlib import Path
from typing import IO, Iterable, Optional, Sequence, TypeVar, Union

import numpy as np

from .composition import CompositionMetaData
from .utils import RefHasher
from .utils.arrays import validate_input_array

A = TypeVar("A", bound="Abundance")


class Abundance:
    """Depth matrix of shape (nseqs, nsamples) with its sample names.

    The refhash records which contig catalogue the rows belong to, so later
    stages can refuse mismatched inputs. The on-disk npz schema (keys
    ``matrix``/``samplenames``/``minid``/``refhash``) is shared with the
    reference so cached artifacts interoperate.
    """

    __slots__ = ["matrix", "samplenames", "minid", "refhash"]

    def __init__(
        self,
        matrix: np.ndarray,
        samplenames: Sequence[str],
        minid: float,
        refhash: bytes,
    ):
        rows, cols = matrix.shape  # also rejects non-2D input
        if matrix.dtype != np.float32:
            raise ValueError(f"Abundance matrix must be float32, got {matrix.dtype}")
        if cols != len(samplenames):
            raise ValueError(
                f"{len(samplenames)} sample names for a {cols}-column matrix"
            )
        if not (isfinite(minid) and 0.0 <= minid <= 1.0):
            raise ValueError(f"minid must lie in [0, 1], got {minid}")
        self.matrix = matrix
        self.samplenames = np.array(samplenames, dtype=object)
        self.minid = minid
        self.refhash = refhash

    @property
    def nseqs(self) -> int:
        return self.matrix.shape[0]

    @property
    def nsamples(self) -> int:
        return self.matrix.shape[1]

    def _fields(self) -> dict:
        return {slot: getattr(self, slot) for slot in self.__slots__}

    def save(self, io: Union[Path, IO[bytes]]):
        "Write the npz artifact (uncompressed: loads faster, still small)."
        np.savez(io, **self._fields())

    @classmethod
    def load(
        cls: type[A], io: Union[str, Path, IO[bytes]], refhash: Optional[bytes]
    ) -> A:
        """Read an npz artifact; if `refhash` is given, verify the stored
        hash against it and fail with first-mismatch diagnostics."""
        stored = np.load(io, allow_pickle=True)
        scalars = {k: stored[k].item() for k in ("minid", "refhash")}
        abundance = cls(
            validate_input_array(stored["matrix"]),
            stored["samplenames"],
            scalars["minid"],
            scalars["refhash"],
        )
        if refhash is not None:
            RefHasher.verify_refhash(
                abundance.refhash,
                refhash,
                "the loaded Abundance object",
                "the given refhash",
                None,
            )
        return abundance

    @classmethod
    def from_tsv(cls: type[A], path: Path, comp_metadata: CompositionMetaData) -> A:
        """Parse a merged abundance TSV against a composition's metadata.

        Header must be `contigname\\t<sample names...>`; the file must contain
        exactly one row per ORIGINAL FASTA entry (the composition's mask says
        which rows are kept), in the same order.
        """
        seen_identifiers: list[str] = []
        with open(path) as file:
            try:
                header = next(file)
            except StopIteration:
                raise ValueError(
                    f"Found no TSV header in abundance file '{path}'"
                ) from None
            columns = header.rstrip("\r\n").split("\t")
            if len(columns) < 2:
                raise ValueError(
                    f'Expected at least 2 columns in abundance TSV file at "{path}"'
                )
            if columns[0] != "contigname":
                raise ValueError('First column in header must be "contigname"')
            samples = columns[1:]
            n_samples = len(samples)
            matrix = np.empty((comp_metadata.nseqs, n_samples), dtype=np.float32)
            matrix_row = 0

            # Line number minus two: header is already consumed, zero-indexed.
            for line_number_minus_two, (line, should_keep) in enumerate(
                zip_longest(file, comp_metadata.mask)
            ):
                if line is None:
                    raise ValueError(
                        f'Too few rows in abundance TSV file "{path}", expected '
                        f"{len(comp_metadata.mask) + 1}, got {line_number_minus_two + 1}"
                    )

                line = line.rstrip()
                if not line:
                    # Only trailing blank lines are tolerated
                    for next_line in file:
                        if next_line.rstrip():
                            raise ValueError(
                                "Found an empty line not at end of abundance TSV file"
                                f'"{path}"'
                            )
                    break

                if should_keep is None:
                    raise ValueError(
                        f'Too many rows in abundance TSV file "{path}", expected '
                        f"{len(comp_metadata.mask) + 1} sequences, got at least "
                        f"{line_number_minus_two + 2}"
                    )

                if not should_keep:
                    continue

                fields = line.split("\t")
                if len(fields) != n_samples + 1:
                    raise ValueError(
                        f'In abundance TSV file "{path}", on line '
                        f"{line_number_minus_two + 2}, expected {n_samples + 1} "
                        f"columns, found {len(fields)}"
                    )
                for i in range(n_samples):
                    matrix[matrix_row, i] = float(fields[i + 1])
                matrix_row += 1
                seen_identifiers.append(fields[0])

        RefHasher.verify_refhash(
            RefHasher.hash_refnames(seen_identifiers),
            comp_metadata.refhash,
            "abundance TSV",
            "composition",
            (seen_identifiers, comp_metadata.identifiers),
        )

        return cls(matrix, samples, 0.0, comp_metadata.refhash)

    @classmethod
    def from_files(cls: type[A], *args, **kwargs) -> A:
        "BAM input is not ported yet (ROADMAP queue 1, item 1: `bam.py`)."
        raise NotImplementedError(
            "vamb_torch does not read BAM files yet (ROADMAP queue 1, item 1: "
            "the BAM path); pass --abundance_tsv or --abundance instead"
        )
