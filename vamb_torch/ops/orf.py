"""Metagenomic open-reading-frame caller (the Prodigal role).

Host numpy copy of `vamb_tpu/ops/orf.py`: the same proteins in the same
order. The reference delegates gene finding to ``pyrodigal.GeneFinder(meta=True)``
(reference vamb/parsemarkers.py:278).  This module is a from-scratch,
dependency-free equivalent used by the native marker-prediction backend:
it enumerates candidate protein-coding ORFs on both strands of a contig
and translates them with the bacterial/archaeal code (NCBI table 11).

Design notes (and honest deviations from Prodigal):

* Prodigal scores start/stop context with a GC-frame model and selects a
  non-overlapping gene set by dynamic programming.  We instead enumerate
  every maximal stop-free run per frame and emit one candidate per run
  (first start codon -> stop).  Over-prediction is acceptable for the
  marker pipeline because the downstream profile-HMM trusted cutoff
  (parsemarkers.py:256-260) is the precision filter, and duplicate
  markers on one contig are deduplicated anyway (parsemarkers.py:240).
* ``meta`` mode allows genes truncated by a contig edge; we mirror that:
  a run touching the 5' end may start without a start codon, and a run
  touching the 3' end may end without a stop.
* The hot path is vectorized numpy over byte arrays (codon ids via a
  strided view and a 64-entry lookup), not a per-base Python loop; the
  port also finds the runs and their first start codons with array ops
  and translates each frame once (vamb_tpu loops over every run).
"""

from typing import Iterator

import numpy as np

MIN_GENE_NT = 90  # Prodigal's default minimum gene length, in nucleotides

_BASE_CODE = np.full(256, 4, dtype=np.uint8)  # 4 = ambiguous
for _i, _b in enumerate(b"ACGT"):
    _BASE_CODE[_b] = _i
    _BASE_CODE[ord(chr(_b).lower())] = _i

_COMPLEMENT = np.arange(256, dtype=np.uint8)
for _a, _b in zip(b"ACGTacgt", b"TGCATGCA"):
    _COMPLEMENT[_a] = _b

# NCBI translation table 11, indexed by 16*b0 + 4*b1 + b2 with A,C,G,T=0..3.
_CODON_TABLE = np.frombuffer(
    b"KNKNTTTTRSRSIIMIQHQHPPPPRRRRLLLLEDEDAAAAGGGGVVVV*Y*YSSSS*CWCLFLF",
    dtype=np.uint8,
).copy()

_START_CODONS = frozenset(
    (0 * 16 + 3 * 4 + 2, 2 * 16 + 3 * 4 + 2, 3 * 16 + 3 * 4 + 2)  # ATG GTG TTG
)
_STOP_CODONS = frozenset(
    (3 * 16 + 0 * 4 + 0, 3 * 16 + 0 * 4 + 2, 3 * 16 + 2 * 4 + 0)  # TAA TAG TGA
)


def _codon_ids(codes: np.ndarray, frame: int) -> np.ndarray:
    """Codon ids (0..63, or 64 for any-ambiguous) for one reading frame."""
    usable = (len(codes) - frame) // 3
    if usable <= 0:
        return np.empty(0, dtype=np.int16)
    c = codes[frame : frame + usable * 3].reshape(usable, 3).astype(np.int16)
    ids = c[:, 0] * 16 + c[:, 1] * 4 + c[:, 2]
    ids[(c >= 4).any(axis=1)] = 64
    return ids


_IS_STOP = np.zeros(65, dtype=bool)
_IS_STOP[list(_STOP_CODONS)] = True
_IS_START = np.zeros(65, dtype=bool)
_IS_START[list(_START_CODONS)] = True


def _frame_orfs(
    ids: np.ndarray, min_codons: int = MIN_GENE_NT // 3
) -> Iterator[tuple[int, int]]:
    """Yield candidate (start_codon_idx, end_codon_idx_exclusive) per run.

    Runs are maximal stop-free codon stretches.  Interior runs must begin
    at a start codon; edge runs may be truncated (Prodigal meta-mode
    partial genes).  The stop codon is not part of the translated gene.
    The runs and each run's first start codon are found with array ops;
    only the runs long enough to hold a gene reach the Python loop.
    """
    n = len(ids)
    bounds = np.concatenate(([-1], np.flatnonzero(_IS_STOP[ids]), [n]))
    lo = bounds[:-1] + 1  # first codon after the previous stop
    hi = bounds[1:]  # the stop codon (or one-past-end)
    # the first start codon at or after each position (n where none)
    nxt = np.full(n + 1, n)
    starts = np.flatnonzero(_IS_START[ids])
    nxt[starts] = starts
    nxt = np.minimum.accumulate(nxt[::-1])[::-1]
    for j in np.flatnonzero(hi - lo >= min_codons):
        run_lo, run_hi = int(lo[j]), int(hi[j])
        begins = [run_lo] if j == 0 else []  # 5'-truncated candidate at the contig edge
        first = int(nxt[run_lo])
        if first < run_hi and first not in begins:
            begins.append(first)
        for begin in begins:
            if run_hi - begin >= min_codons:
                yield (begin, run_hi)


def _translate(ids: np.ndarray) -> str:
    aa = np.where(ids < 64, _CODON_TABLE[np.minimum(ids, 63)], ord("X"))
    return aa.astype(np.uint8).tobytes().decode()


def find_genes(sequence: bytes, min_length_nt: int = MIN_GENE_NT) -> list[str]:
    """All candidate protein sequences (both strands, 3 frames each).

    `sequence` is the raw contig bytes (case-insensitive; non-ACGT bases
    translate to 'X' and never form a start/stop).  Proteins whose gene
    would be shorter than `min_length_nt` are dropped; a leading 'M' is
    NOT forced for alternative starts (profile scoring is insensitive to
    the first residue, and HMMER-side local alignment ignores ends).
    """
    arr = np.frombuffer(sequence, dtype=np.uint8)
    min_codons = max(1, min_length_nt // 3)
    proteins: list[str] = []
    for strand_codes in (_BASE_CODE[arr], _BASE_CODE[_COMPLEMENT[arr][::-1]]):
        for frame in range(3):
            ids = _codon_ids(strand_codes, frame)
            frame_aa = None  # the frame translated once, sliced per gene
            for begin, end in _frame_orfs(ids, min_codons):
                if (end - begin) * 3 >= min_length_nt:
                    if frame_aa is None:
                        frame_aa = _translate(ids)
                    proteins.append(frame_aa[begin:end])
    return proteins
