"""Single-copy marker genes (SCGs) per contig.

Port of `vamb_tpu/markers.py` (behavioral parity: reference
vamb/parsemarkers.py). The data model, JSON save/load (the same file in
both packages), bin scoring, marker-name normalization and round-robin
FASTA splitting are copies. Gene prediction is pluggable, chosen as
`vamb_tpu` chooses it: the `PyhmmerBackend` uses the pyrodigal/pyhmmer
libraries (the reference's own dependencies) when importable, the
`SubprocessBackend` shells out to the `prodigal` + `hmmsearch`
executables when those are on PATH, and the self-contained
`NativeBackend` (built-in ORF caller + profile-HMM Forward scoring in the
hand-written CUDA kernel, ops/orf.py + ops/hmm.py) runs otherwise, on the
card unless the caller asks for the CPU. The chosen backend is logged.
Precomputed markers (`--markers markers.npz`) skip prediction entirely.
"""

import contextlib
import itertools
import json
import os
import shutil
import time
from collections import defaultdict
from multiprocessing.pool import Pool
from pathlib import Path
from typing import IO, Iterable, Optional, Sequence, Union

import numpy as np

from .log import logger
from .utils import RefHasher, Reader, byte_iterfasta

# Some markers have different names, but should be treated as the same SCG
# (reference parsemarkers.py:193-198).
NORMALIZE_MARKER_TRANS_DICT = {
    "TIGR00388": "TIGR00389",
    "TIGR00471": "TIGR00472",
    "TIGR00408": "TIGR00409",
    "TIGR02386": "TIGR02387",
}


class Markers:
    """Marker genes predicted for a collection of contigs.

    `markers` is a list with one element per contig: None if no markers,
    else a uint8 array of deduplicated marker IDs. `marker_names[i]` is the
    list of names sharing marker ID i. Refhash-coupled to the composition.
    """

    __slots__ = ["markers", "marker_names", "refhash"]

    def __init__(
        self,
        markers: list[Optional[np.ndarray]],
        marker_names: list[list[str]],
        refhash: bytes,
    ):
        if len(set(itertools.chain.from_iterable(marker_names))) != sum(
            len(i) for i in marker_names
        ):
            raise ValueError("Marker names are not unique, but must be")
        self.markers = markers
        self.marker_names = marker_names
        self.refhash = refhash

    @property
    def n_markers(self) -> int:
        return len(self.marker_names)

    @property
    def n_seqs(self) -> int:
        return len(self.markers)

    def score_bin(self, indices: Iterable[int]) -> tuple[float, float]:
        "(completeness, contamination) of a set of contig indices."
        counts = np.zeros(self.n_markers, dtype=np.uint8)
        for i in indices:
            mkrs = self.markers[i]
            if mkrs is None:
                continue
            for m in mkrs:
                counts[m] += 1
        n_unique = (counts > 0).sum()
        completeness = n_unique / self.n_markers
        contamination = (counts.sum() - n_unique) / self.n_markers
        return (completeness, contamination)

    def save(self, io: Union[Path, str, IO[str]]) -> None:
        representation = {
            "markers": [i if i is None else i.tolist() for i in self.markers],
            "marker_names": self.marker_names,
            "refhash": self.refhash.hex(),
        }
        if isinstance(io, (Path, str)):
            with open(io, "w") as file:
                json.dump(representation, file)
        else:
            json.dump(representation, io)

    @classmethod
    def load(cls, io: Union[Path, str, IO[str]], refhash: Optional[bytes]):
        if isinstance(io, (Path, str)):
            with open(io, "rb") as file:
                representation = json.load(file)
        else:
            representation = json.load(io)
        observed_refhash = bytes.fromhex(representation["refhash"])
        if refhash is not None:
            RefHasher.verify_refhash(
                observed_refhash, refhash, "Loaded markers", None, None
            )
        markers_as_arrays = [
            i if i is None else np.array(i, dtype=np.uint8)
            for i in representation["markers"]
        ]
        return cls(markers_as_arrays, representation["marker_names"], observed_refhash)

    @classmethod
    def from_files(
        cls,
        contigs: Path,
        hmm_path: Path,
        contignames: Sequence[str],
        tmpdir_to_create: Path,
        n_processes: int,
        target_refhash: Optional[bytes],
        backend: Optional["PredictorBackend"] = None,
        device="cuda",
    ):
        """Predict markers: gene finding -> HMM search vs `hmm_path`.

        The orchestration (round-robin FASTA split, process pool, result
        assembly, refhash verification — reference parsemarkers.py:123-178)
        is backend-independent; the per-file prediction runs through a
        `PredictorBackend`:

        * `PyhmmerBackend` — pyrodigal + pyhmmer libraries (the reference's
          own dependencies), used automatically when importable;
        * `SubprocessBackend` — `prodigal` + `hmmsearch` executables, used
          automatically when both are on PATH;
        * `NativeBackend` — the built-in ORF caller and the Forward kernel on
          `device`, used otherwise;
        * any custom object implementing `predict_file` / `marker_names`.
        """
        if backend is None:
            backend = select_backend(device)
        logger.info(f"\tMarker prediction backend: {type(backend).__name__}")
        n_processes = cap_processes(n_processes)
        marker_names = backend.marker_names(hmm_path)

        # Device-batched backends replace process parallelism with one big
        # batched dispatch; don't shard the FASTA for them.
        if getattr(backend, "in_process", False):
            n_processes = 1
        refhash, paths = split_file(contigs, contignames, tmpdir_to_create, n_processes)
        if target_refhash is not None:
            RefHasher.verify_refhash(
                refhash, target_refhash, "Markers FASTA file", None, None
            )

        index_of_name = {n: i for (i, n) in enumerate(contignames)}
        marker_list: list[Optional[np.ndarray]] = [None] * len(contignames)
        if getattr(backend, "in_process", False):
            sub_results = [backend.predict_file(p, hmm_path) for p in paths]
        else:
            with Pool(n_processes) as pool:
                sub_results = list(
                    pool.imap_unordered(
                        _predict_one_file, [(backend, p, hmm_path) for p in paths]
                    )
                )
        for sub_result in sub_results:
            for contig_name, markers in sub_result:
                marker_list[index_of_name[contig_name]] = markers
        shutil.rmtree(tmpdir_to_create)
        return cls(marker_list, marker_names, refhash)


def cap_processes(processes: int) -> int:
    "Cap to 64 (one temp file per process; reference parsemarkers.py:181-189)."
    if processes < 1:
        raise ValueError(f"Must use at least 1 process, not {processes}")
    if processes > 64:
        logger.warning(f"Processes set to {processes}, capping to 64")
        return 64
    return processes


def split_file(
    input: Path,
    contignames: Sequence[str],
    tmpdir_to_create: Path,
    n_splits: int,
) -> tuple[bytes, list[Path]]:
    "Round-robin split of masked FASTA entries into n temp files."
    names = set(contignames)
    os.mkdir(tmpdir_to_create)
    paths = [tmpdir_to_create.joinpath(str(i)) for i in range(n_splits)]
    with contextlib.ExitStack() as stack:
        filehandles = [stack.enter_context(open(fname, "w")) for fname in paths]
        refhasher = RefHasher()
        with Reader(input) as infile:
            for outfile, record in zip(
                itertools.cycle(filehandles),
                filter(lambda x: x.identifier in names, byte_iterfasta(infile, None)),
            ):
                refhasher.add_refname(record.identifier)
                print(record.format(), file=outfile)
    return (refhasher.digest(), paths)


def get_name_to_id(
    hmm_names: list[str],
) -> tuple[dict[str, int], list[list[str]]]:
    "Assign marker IDs, merging equivalent TIGR names; max 256 IDs."
    name_to_id: dict[str, int] = dict()
    for name in hmm_names:
        if name in NORMALIZE_MARKER_TRANS_DICT:
            continue
        name_to_id[name] = len(name_to_id)
    for old_name, new_name in NORMALIZE_MARKER_TRANS_DICT.items():
        if new_name in name_to_id:
            name_to_id[old_name] = name_to_id[new_name]
    if len(set(name_to_id.values())) > 256:
        raise ValueError("Maximum 256 marker IDs")
    id_to_names: defaultdict[int, list[str]] = defaultdict(list)
    for n, i in name_to_id.items():
        id_to_names[i].append(n)
    marker_names = [id_to_names[i] for i in range(len(id_to_names))]
    return name_to_id, marker_names


def _predict_one_file(
    args: "tuple[PredictorBackend, Path, Path]",
) -> list[tuple[str, np.ndarray]]:
    "Pool worker: run the (picklable) backend on one FASTA shard."
    backend, contig_path, hmm_path = args
    return backend.predict_file(contig_path, hmm_path)


# ------------------------------------------------------------------ backends


class PredictorBackend:
    """Gene-prediction + HMM-search backend protocol.

    Implementations must be picklable (instances cross a multiprocessing
    Pool boundary) and provide:

    * `marker_names(hmm_path) -> list[list[str]]` — merged marker-ID name
      groups, in ID order (see `get_name_to_id`);
    * `predict_file(contig_fasta, hmm_path) -> list[(contig_name, ids)]`
      — per-contig uint8 arrays of marker IDs found on that contig.
    """

    def marker_names(self, hmm_path: Path) -> list[list[str]]:
        raise NotImplementedError

    def predict_file(
        self, contig_path: Path, hmm_path: Path
    ) -> list[tuple[str, np.ndarray]]:
        raise NotImplementedError


def select_backend(device="cuda") -> PredictorBackend:
    """Pick the backend as `vamb_tpu` does: pyrodigal + pyhmmer when
    importable, else the prodigal + hmmsearch executables when both are on
    PATH, else the built-in one on `device`."""
    try:
        import pyhmmer  # noqa: F401
        import pyrodigal  # noqa: F401

        return PyhmmerBackend()
    except ImportError:
        pass
    if shutil.which("prodigal") and shutil.which("hmmsearch"):
        return SubprocessBackend()
    logger.info(
        "\tpyrodigal/pyhmmer and the prodigal/hmmsearch executables are all "
        f"absent; using the built-in ORF + profile-HMM backend on {device}"
    )
    return NativeBackend(device)


class PyhmmerBackend(PredictorBackend):
    "In-process prediction via pyrodigal + pyhmmer (reference parsemarkers.py:231-264)."

    CHUNK = 2048  # sequences digitized per hmmsearch batch

    def marker_names(self, hmm_path: Path) -> list[list[str]]:
        import pyhmmer

        with open(hmm_path, "rb") as file:
            hmms = list(pyhmmer.plan7.HMMFile(file))
        return get_name_to_id([h.name.decode() for h in hmms])[1]

    def predict_file(self, contig_path, hmm_path):
        import pyhmmer
        import pyrodigal

        with open(hmm_path, "rb") as file:
            hmms = list(pyhmmer.plan7.HMMFile(file))
        name_to_id, _ = get_name_to_id([h.name.decode() for h in hmms])

        result: list[tuple[str, np.ndarray]] = []
        chunk: list = []
        finder = pyrodigal.GeneFinder(meta=True)
        with open(contig_path, "rb") as file:
            for record in byte_iterfasta(file, None):
                chunk.append(record)
                if len(chunk) == self.CHUNK:
                    result.extend(self._chunk(chunk, hmms, name_to_id, finder))
                    chunk.clear()
            result.extend(self._chunk(chunk, hmms, name_to_id, finder))
        return result

    @staticmethod
    def _chunk(chunk, hmms, name_to_id, finder):
        import pyhmmer

        markers: defaultdict[str, set[int]] = defaultdict(set)
        alphabet = pyhmmer.easel.Alphabet.amino()
        digitized = []
        for record in chunk:
            for gene in finder.find_genes(record.sequence):
                seq = pyhmmer.easel.TextSequence(
                    name=record.identifier.encode(), sequence=gene.translate()
                ).digitize(alphabet)
                digitized.append(seq)
        for hmm, top_hits in zip(hmms, pyhmmer.hmmsearch(hmms, digitized)):
            marker_id = name_to_id[hmm.name.decode()]
            score_cutoff = hmm.cutoffs.trusted1
            assert score_cutoff is not None
            for hit in top_hits:
                if hit.score >= score_cutoff:
                    markers[hit.name.decode()].add(marker_id)
        return [
            (name, np.array(sorted(ids), dtype=np.uint8))
            for (name, ids) in markers.items()
        ]


class NativeBackend(PredictorBackend):
    """Fully self-contained prediction: built-in ORF caller + profile HMMs
    scored by the hand-written Forward kernel (`kernels.hmm_forward`).

    The prodigal role is filled by `ops.orf.find_genes` (six-frame
    candidate-ORF enumeration, table-11 translation) and the
    pyhmmer/hmmsearch role by `ops.hmm` (HMMER3 flat-file parsing, the
    multihit-local Forward algorithm on `device`, trusted-cutoff
    filtering). All genes of a file are encoded and uploaded once and
    scored against each profile in one kernel launch a batch, so process
    parallelism is replaced by device batching (`in_process = True`).

    Deviations (documented in ops/orf.py and ops/hmm.py): candidate-ORF
    enumeration instead of Prodigal's gene-selection DP, and no null-2
    biased-composition score correction; both err toward extra candidate
    hits, which the per-profile trusted cutoff then filters.
    """

    in_process = True

    def __init__(self, device="cuda"):
        self.device = device

    def marker_names(self, hmm_path: Path) -> list[list[str]]:
        from .ops import hmm as hmm_mod

        return get_name_to_id([p.name for p in hmm_mod.read_hmms(hmm_path)])[1]

    def predict_file(self, contig_path, hmm_path):
        from .ops import hmm as hmm_mod
        from .ops import orf

        profiles = hmm_mod.read_hmms(hmm_path)
        name_to_id, _ = get_name_to_id([p.name for p in profiles])

        begin = time.time()
        proteins: list[str] = []
        gene_contig: list[str] = []
        with open(contig_path, "rb") as file:
            for record in byte_iterfasta(file, None):
                for protein in orf.find_genes(record.sequence):
                    proteins.append(protein)
                    gene_contig.append(record.identifier)
        found = time.time()

        # encode/sort/upload the gene batches once; every profile reuses them
        encoded = hmm_mod.EncodedProteins(proteins, batch=8192, device=self.device)
        encoded_at = time.time()
        markers: defaultdict[str, set[int]] = defaultdict(set)
        for profile in profiles:
            cutoff = profile.trusted_cutoff
            if cutoff is None:
                raise ValueError(
                    f"HMM profile {profile.name!r} has no trusted cutoff (TC)"
                )
            local = hmm_mod.configure_local(profile)
            scores = hmm_mod.forward_scores(local, encoded)
            marker_id = name_to_id[profile.name]
            for gene_idx in np.flatnonzero(scores >= cutoff):
                markers[gene_contig[gene_idx]].add(marker_id)
        logger.info(
            f"\t\t{len(proteins)} candidate genes ({sum(map(len, proteins))} residues) "
            f"found in {found - begin:.2f} s, encoded in {encoded_at - found:.2f} s, "
            f"scored against {len(profiles)} profiles on {encoded.device} in "
            f"{time.time() - encoded_at:.2f} s"
        )
        return [
            (name, np.array(sorted(ids), dtype=np.uint8))
            for (name, ids) in markers.items()
        ]


class SubprocessBackend(PredictorBackend):
    """Prediction via the `prodigal` and `hmmsearch` executables.

    prodigal emits proteins named `<contig>_<geneidx>`; hmmsearch is run
    with `--cut_tc` (trusted sequence cutoffs — the same filter the
    pyhmmer path applies via `hmm.cutoffs.trusted1`) and its `--tblout`
    table is parsed for (gene, HMM) hits.
    """

    def marker_names(self, hmm_path: Path) -> list[list[str]]:
        return get_name_to_id(read_hmm_names(hmm_path))[1]

    def predict_file(self, contig_path, hmm_path):
        import subprocess
        import tempfile

        name_to_id, _ = get_name_to_id(read_hmm_names(hmm_path))
        with tempfile.TemporaryDirectory() as tmp:
            proteins = Path(tmp) / "proteins.faa"
            tbl = Path(tmp) / "hits.tbl"
            subprocess.run(
                [
                    "prodigal", "-p", "meta", "-q",
                    "-i", str(contig_path), "-a", str(proteins),
                ],
                check=True,
                capture_output=True,
            )
            subprocess.run(
                [
                    "hmmsearch", "--cut_tc", "--tblout", str(tbl),
                    str(hmm_path), str(proteins),
                ],
                check=True,
                capture_output=True,
            )
            with open(tbl) as file:
                per_contig = parse_hmmsearch_tblout(file, name_to_id)
        return [
            (name, np.array(sorted(ids), dtype=np.uint8))
            for name, ids in per_contig.items()
        ]


def read_hmm_names(hmm_path: Path) -> list[str]:
    "HMM names from a (plain or gzipped) HMMER3 flat file, in file order."
    names = []
    with Reader(hmm_path) as file:
        for raw in file:
            if raw.startswith(b"NAME "):
                names.append(raw.split(maxsplit=1)[1].strip().decode())
    if not names:
        raise ValueError(f"No NAME records found in HMM file {hmm_path}")
    return names


def parse_hmmsearch_tblout(
    lines: Iterable[str], name_to_id: dict[str, int]
) -> dict[str, set[int]]:
    """Parse `hmmsearch --tblout` output into {contig: marker ids}.

    Column 0 is the target (gene) name `<contig>_<idx>`; column 2 is the
    query HMM name. Scores need no filtering here — `--cut_tc` already
    applied the trusted cutoffs.
    """
    per_contig: dict[str, set[int]] = defaultdict(set)
    for line in lines:
        if line.startswith("#") or not line.strip():
            continue
        fields = line.split()
        gene, query = fields[0], fields[2]
        contig = gene.rsplit("_", 1)[0]
        marker_id = name_to_id.get(query)
        if marker_id is not None:
            per_contig[contig].add(marker_id)
    return per_contig
