"""Abundance: per-sample, per-contig depth matrix.

Host-side copy of `vamb_tpu/abundance.py`: the merged `strobealign
--aemb` TSV, strict header `contigname\\t<sample...>`, with rows validated
against the composition mask and refhash (reference parsebam.py:239-311),
and BAM files through the native coverage reader (`bam.py`), in chunks of
at most 16 files that can spill to a cache directory.
"""

from itertools import zip_longest
from math import isfinite
from pathlib import Path
from typing import IO, Iterable, Optional, Sequence, TypeVar, Union

import numpy as np

from .composition import CompositionMetaData
from .utils import RefHasher
from .utils.arrays import mask_lower_bits, validate_input_array

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
    def from_files(
        cls: type[A],
        paths: list[Path],
        cache_directory: Optional[Path],
        comp_metadata: CompositionMetaData,
        verify_refhash: bool,
        minid: float,
        nthreads: int,
    ) -> A:
        """Compute depths from BAM files via the native coverage reader.

        Per-contig depth is the 10%/10% trimmed mean of per-position coverage,
        counting only reads with nucleotide identity >= minid (reference
        parsebam.py:195-237 semantics via pycoverm/CoverM).
        """
        if minid < 0 or minid > 1:
            raise ValueError(f"minid must be between 0 and 1, not {minid}")
        if nthreads < 1:
            raise ValueError(f"nthreads must be > 0, not {nthreads}")

        from .bam import coverage_from_bams

        # Out-of-core: at most min(nthreads, 16) BAMs at a time (reference
        # parsebam.py:117-122); with a cache directory each chunk's columns
        # spill to npz and are reassembled at the end (parsebam.py:151-193),
        # so peak RAM is one chunk.
        chunksize = min(nthreads, 16)
        chunks = [paths[i : i + chunksize] for i in range(0, len(paths), chunksize)]
        headers: Optional[list[str]] = None
        chunk_results: list = []  # matrices, or cache paths when spilling
        spill = cache_directory is not None and len(chunks) > 1
        if spill:
            Path(cache_directory).mkdir(parents=True, exist_ok=True)
        for chunk_i, chunk in enumerate(chunks):
            chunk_headers, chunk_matrix = coverage_from_bams(
                [str(p) for p in chunk], minid=minid, nthreads=chunksize,
                trim_lower=0.1, trim_upper=0.1,
            )
            if headers is None:
                headers = chunk_headers
            elif chunk_headers != headers:
                raise ValueError(
                    f"BAM files {chunk} have different reference sequences "
                    "than earlier files; all BAMs must be mapped to the same "
                    "contig catalogue"
                )
            if spill:
                spill_path = Path(cache_directory).joinpath(f"chunk_{chunk_i}.npz")
                np.savez(spill_path, matrix=chunk_matrix)
                chunk_results.append(spill_path)
            else:
                chunk_results.append(chunk_matrix)
        assert headers is not None
        if spill:
            matrix = np.empty((len(headers), len(paths)), dtype=np.float32)
            col = 0
            for spill_path in chunk_results:
                with np.load(spill_path) as arrs:
                    block = arrs["matrix"]
                matrix[:, col : col + block.shape[1]] = block
                col += block.shape[1]
                spill_path.unlink()
        else:
            matrix = np.concatenate(chunk_results, axis=1)

        if len(comp_metadata.mask) != len(headers):
            raise ValueError(
                f"CompositionMetaData used to create Abundance object was created "
                f"with {len(comp_metadata.mask)} sequences, but number of reference "
                f"sequences in BAM files are {len(headers)}. Make sure the BAM files "
                "were created by mapping to the same FASTA file which you used to "
                "create the Composition object."
            )

        kept_headers = [h for (h, m) in zip(headers, comp_metadata.mask) if m]
        matrix = matrix[np.asarray(comp_metadata.mask, dtype=bool)]
        refhash = RefHasher.hash_refnames(kept_headers)
        if verify_refhash:
            RefHasher.verify_refhash(
                refhash,
                comp_metadata.refhash,
                "FASTA file",
                "BAM",
                (kept_headers, comp_metadata.identifiers),
            )

        matrix = np.ascontiguousarray(matrix, dtype=np.float32)
        mask_lower_bits(matrix, 12)
        return cls(matrix, [str(p) for p in paths], minid, refhash)
