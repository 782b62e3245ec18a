"""File IO: compression sniffing, FASTA parsing, npz and cluster/bin output.

Behavioral parity: reference vamb/vambtools.py:333-519 (Reader, FastaEntry,
byte_iterfasta), :602-646 (cluster TSV), :666-762 (bins + npz),
:765-813 (concatenate). Implementations are original; identifier validation
follows the SAM spec so FASTA headers always round-trip through BAM.
"""

import bz2
import collections
import gzip
import lzma
import re
from pathlib import Path
from typing import IO, Collection, Iterable, Iterator, Optional, Union

import numpy as np

from .kmers import kmercounts

CLUSTERS_HEADER = "clustername\tcontigname"


_MAGIC_OPENERS: list[tuple[bytes, object]] = [
    (b"\x1f\x8b", gzip.open),
    (b"BZh", bz2.open),
    (b"\xfd7zXZ\x00", lzma.open),
]


class Reader:
    """Transparently open a possibly-compressed file for binary reading.

    The compression format (gzip, bzip2, xz, or none) is decided by the
    file's leading magic bytes — the extension is never consulted, so
    mislabeled files still open correctly. Same role as the reference's
    sniffing reader (vambtools.py:333-375).
    """

    def __init__(self, filename: Union[str, Path]):
        self.filename = filename
        with open(filename, "rb") as raw:
            head = raw.read(8)
        for magic, opener in _MAGIC_OPENERS:
            if head.startswith(magic):
                self.filehandle = opener(filename, "rb")
                break
        else:
            self.filehandle = open(filename, "rb")

    def close(self):
        self.filehandle.close()

    def __enter__(self):
        return self

    def __exit__(self, _type, _value, _traceback):
        self.close()

    def __iter__(self):
        return self.filehandle


class FastaEntry:
    """One FASTA record: a validated identifier, description and sequence.

    The identifier (header text up to the first whitespace) must match the
    SAM specification's reference-name grammar — this is a hard contract,
    not style: abundance comes from BAM files whose reference names obey
    that grammar, so any FASTA header that can't appear in a BAM could
    never be joined with its coverage (reference vambtools.py:378-447 keeps
    the same rule). Sequences may contain IUPAC DNA/RNA codes only;
    whitespace inside sequence lines is dropped.
    """

    # the SAM reference-name pattern (leading '#' additionally excluded),
    # with an optional whitespace-separated description after it
    regex = re.compile(
        b"([0-9A-Za-z!$%&+./:;?@^_|~-][0-9A-Za-z!#$%&*+./:;=?@^_|~-]*)([^\\S\r\n][^\r\n]*)?$"
    )
    # IUPAC nucleotide codes, upper and lower case
    allowed = b"acgtuswkmyrbdhvn" + b"acgtuswkmyrbdhvn".upper()
    __slots__ = ["identifier", "description", "sequence"]

    def _verify_header(self, header: bytes) -> tuple[str, str]:
        m = self.regex.match(header)
        if m is None:
            raise ValueError(
                f'FASTA header "{header.decode()}" has an identifier that '
                "cannot occur as a BAM reference name (SAM spec pattern "
                f"{self.regex.pattern.decode()!r}), so its sequence could "
                "never be matched against BAM coverage. Rename the sequence."
            )
        identifier, description = m.groups()
        return (
            identifier.decode(),
            "" if description is None else description.decode(),
        )

    def __init__(self, header: bytes, sequence: bytearray):
        self.identifier, self.description = self._verify_header(header)
        cleaned = sequence.translate(None, b" \t\n\r")
        invalid = cleaned.translate(None, self.allowed)
        if invalid:
            raise ValueError(
                f"Sequence '{self.identifier}' contains byte "
                f"{invalid[0]} ('{chr(invalid[0])}'), which is not an "
                "IUPAC DNA/RNA code"
            )
        self.sequence: bytearray = cleaned

    @property
    def header(self) -> str:
        return self.identifier + self.description

    def __len__(self) -> int:
        return len(self.sequence)

    def format(self, width: int = 60) -> str:
        "Render as FASTA text with the sequence wrapped to `width` columns."
        seq = self.sequence.decode()
        wrapped = "\n".join(seq[start : start + width] for start in range(0, len(seq), width))
        return f">{self.header}\n{wrapped}"

    def kmercounts(self) -> np.ndarray:
        "Count 4-mers into a 256-slot uint32 vector (2-bit rolling encoding)."
        return kmercounts(bytes(self.sequence))


def _strip_newline(s: bytes) -> bytes:
    if len(s) > 0 and s[-1] == 10:
        if len(s) > 1 and s[-2] == 13:
            return s[:-2]
        return s[:-1]
    return s


def byte_iterfasta(
    filehandle: Iterable[bytes], filename: Optional[str]
) -> Iterator[FastaEntry]:
    """Yield FastaEntry objects from an iterator of binary FASTA lines.

    Streaming: only one record is buffered at a time. A record starts at
    each ``>`` line; everything until the next ``>`` (or EOF) is its
    sequence, accumulated into a single growing bytearray. Same contract
    as the reference parser (vambtools.py:471-518), independent
    implementation.
    """
    where = "" if filename is None else f"In file '{filename}', "
    pending_header: Optional[bytes] = None
    seq = bytearray()
    first = True

    for line in filehandle:
        if first:
            first = False
            if not isinstance(line, bytes):
                raise TypeError(
                    f"{where}first line is not binary. "
                    "Are you sure you are reading the file in binary mode?"
                )
            if not line.startswith(b">"):
                raise ValueError(
                    f"{where}FASTA file is invalid, first line does not begin with '>'"
                )
        if line.startswith(b">"):
            if pending_header is not None:
                yield FastaEntry(pending_header, seq)
                seq = bytearray()
            pending_header = _strip_newline(line[1:])
        else:
            seq += line

    if pending_header is not None:
        yield FastaEntry(pending_header, seq)
    # an empty file yields nothing: that is valid FASTA


def read_npz(file) -> np.ndarray:
    "Load a single-array .npz file (key 'arr_0')."
    npz = np.load(file)
    array = _validate(npz["arr_0"])
    npz.close()
    return array


def write_npz(file, array: np.ndarray):
    """Write a numpy array to an uncompressed .npz file.

    Deliberately uncompressed: these are float-matrix stage caches
    (TNF/abundance/latents/params) where deflate buys <10% size for
    seconds of single-core time per 100k contigs. np.load reads both
    variants transparently, so externally produced compressed npz files
    still load."""
    np.savez(file, array)


def _validate(array: np.ndarray) -> np.ndarray:
    if not array.flags["C_CONTIGUOUS"]:
        array = np.ascontiguousarray(array)
    if not array.flags["OWNDATA"]:
        array = array.copy()
    return array


def write_clusters(
    io: IO[str], clusters: Iterable[tuple[str, set[str]]], print_header: bool = True
) -> tuple[int, int]:
    "Write (clustername, contignames) pairs as a two-column TSV."
    n_clusters = 0
    n_contigs = 0
    if print_header:
        print(CLUSTERS_HEADER, file=io)
    for cluster_name, contig_names in clusters:
        n_clusters += 1
        n_contigs += len(contig_names)
        for contig_name in contig_names:
            print(cluster_name, contig_name, sep="\t", file=io)
    return (n_clusters, n_contigs)


def read_clusters(filehandle: Iterable[str], min_size: int = 1) -> dict[str, set[str]]:
    "Read a cluster TSV written by `write_clusters` into {name: set(contigs)}."
    contigsof: collections.defaultdict[str, set[str]] = collections.defaultdict(set)
    lines = iter(filehandle)
    header = next(lines)
    if header.rstrip(" \n") != CLUSTERS_HEADER:
        raise ValueError(
            f'Expected cluster TSV file to start with header: "{CLUSTERS_HEADER}"'
        )

    for line in lines:
        stripped = line.strip()
        if not stripped or stripped[0] == "#":
            continue
        clustername, contigname = stripped.split("\t")
        contigsof[clustername].add(contigname)

    return {cl: co for cl, co in contigsof.items() if len(co) >= min_size}


def create_dir_if_not_existing(path: Path) -> None:
    if path.is_dir():
        return None
    if path.is_file():
        raise FileExistsError(path)
    if not path.parent.is_dir():
        raise NotADirectoryError(path.parent)
    path.mkdir(exist_ok=True)


def write_bins(
    directory: Path,
    bins: Collection[tuple[str, Iterable[str]]],
    fastaio: Iterable[bytes],
    compress: bool,
    maxbins: Optional[int] = 1000,
):
    """Write one FASTA file per bin into `directory`.

    Sequences are gzip-cached in RAM while streaming the input FASTA once,
    then decompressed per-bin (reference vambtools.py:666-724). `maxbins`
    guards against accidentally creating tens of thousands of files.
    """
    if maxbins is not None and len(bins) > maxbins:
        raise ValueError(f"{len(bins)} bins exceed maxbins of {maxbins}")

    create_dir_if_not_existing(directory)

    keep: set[str] = set()
    for _, contigs in bins:
        keep.update(contigs)

    bytes_by_id: dict[str, bytes] = dict()
    for entry in byte_iterfasta(fastaio, None):
        if entry.identifier in keep:
            bytes_by_id[entry.identifier] = gzip.compress(
                entry.format().encode(), compresslevel=1
            )

    for binname, contigs in bins:
        for contig in contigs:
            if contig not in bytes_by_id:
                raise IndexError(
                    f'Contig "{contig}" in bin missing from input FASTA file'
                )

        base_output_name = directory.joinpath(binname)
        if compress:
            context = gzip.open(
                base_output_name.with_suffix(".fna.gz"), "wb", compresslevel=1
            )
        else:
            context = open(base_output_name.with_suffix(".fna"), "wb")

        with context as file:
            for contig in contigs:
                file.write(gzip.decompress(bytes_by_id[contig]))
                file.write(b"\n")

