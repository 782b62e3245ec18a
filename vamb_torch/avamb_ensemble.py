"""Avamb ensemble post-processing: dereplicate and de-overlap bin sets.

Port of `vamb_tpu/avamb_ensemble.py`, host code with no device part (the
`avamb_ensemble` subcommand). The Avamb workflow bins the same contigs
three ways (VAE latents, AAE z latents, AAE y one-hots), scores every bin
with CheckM2, and merges the three binnings into one non-redundant set; the
reference does that merge in Snakemake-driven scripts
(workflow_avamb/src/manual_drep_JN.py, rip_bins.py). The decision logic:

1. **Quality filtering** — drop bins below a completeness floor or above
   a contamination ceiling (CheckM2 `quality_report.tsv` percentages).
2. **Dereplication** — when two bins share contigs covering >= `min_cov`
   of the smaller bin's length, drop the one with the lower CheckM2 score
   (score = completeness - 5 * contamination, manual_drep_JN.py:223-224).
3. **Overlap ripping** — resolve the overlap graph's edges (weight =
   intersection length / smaller bin length, rip_bins.py:100-143)
   weakest first by removing the shared contigs from the *larger* bin
   (rip_bins.py:208-236), until the bins are disjoint.

The output is a standard clusters TSV whose bins are disjoint.
`score_bins_with_markers` estimates completeness and contamination from
single-copy marker genes (the port's `markers.Markers`) where no CheckM2
report is given, and `write_nc_outputs` writes the workflow's final
per-sample bin FASTAs and `quality_report.tsv`
(mv_bins_from_mdrep_clusters.py, transfer_contigs_and_aggregate_all_nc_bins.py:
301-320). Every output equals `vamb_tpu`'s byte for byte
(tests/test_torch_avamb_ensemble.py).
"""

from dataclasses import dataclass
from pathlib import Path
from typing import IO, Iterable, Mapping, Optional, Sequence, Union

from .log import logger

WEIGHT_EPSILON = 0.001  # rip_bins.py:151 "meaningless edge" threshold


@dataclass(frozen=True)
class BinQuality:
    completeness: float  # 0..1
    contamination: float  # 0.. (unbounded)

    @property
    def score(self) -> float:
        return self.completeness - 5.0 * self.contamination


def read_checkm2_quality(lines: Iterable[str]) -> dict[str, BinQuality]:
    """Parse a CheckM2 `quality_report.tsv` into {bin name: BinQuality}.

    Expects the standard header with Name/Completeness/Contamination
    columns; percentages are converted to fractions.
    """
    it = iter(lines)
    header = next(it).rstrip("\n").split("\t")
    try:
        i_name = header.index("Name")
        i_comp = header.index("Completeness")
        i_cont = header.index("Contamination")
    except ValueError as e:
        raise ValueError(
            "CheckM2 quality report must have Name, Completeness and "
            f"Contamination columns, got header {header}"
        ) from e
    out: dict[str, BinQuality] = {}
    for line in it:
        if not line.strip():
            continue
        fields = line.rstrip("\n").split("\t")
        quality = BinQuality(
            completeness=float(fields[i_comp]) / 100,
            contamination=float(fields[i_cont]) / 100,
        )
        if not 0.0 <= quality.completeness <= 1.0:
            raise ValueError(f"Completeness out of range: {fields[i_name]}")
        if quality.contamination < 0.0:
            raise ValueError(f"Negative contamination: {fields[i_name]}")
        out[fields[i_name]] = quality
    return out


def _bin_length(contigs: Iterable[str], length_of: Mapping[str, int]) -> int:
    return sum(length_of[c] for c in contigs)


def filter_by_quality(
    bins: Mapping[str, set[str]],
    qualities: Mapping[str, BinQuality],
    length_of: Mapping[str, int],
    min_completeness: float,
    max_contamination: float,
    min_bin_size: int,
) -> dict[str, set[str]]:
    "Keep bins that are scored, big enough, and pass the quality gates."
    kept: dict[str, set[str]] = {}
    for name, contigs in bins.items():
        quality = qualities.get(name)
        if quality is None:
            raise ValueError(
                f'Bin "{name}" has no entry in the CheckM2 quality report'
            )
        if (
            quality.completeness >= min_completeness
            and quality.contamination <= max_contamination
            and _bin_length(contigs, length_of) >= min_bin_size
        ):
            kept[name] = set(contigs)
    return kept


def dereplicate(
    bins: Mapping[str, set[str]],
    qualities: Mapping[str, BinQuality],
    length_of: Mapping[str, int],
    min_cov: float,
) -> dict[str, set[str]]:
    """Drop near-duplicate bins: for every pair sharing contigs that cover
    >= `min_cov` of the smaller bin, the lower-scoring bin is removed
    (ties keep the first in sorted-name order, deterministically)."""
    names = sorted(bins)
    sizes = {n: _bin_length(bins[n], length_of) for n in names}
    # contig -> bins that contain it; only multiply-assigned matter
    owners: dict[str, list[str]] = {}
    for name in names:
        for contig in bins[name]:
            owners.setdefault(contig, []).append(name)
    pairs = {
        tuple(sorted(pair))
        for bin_list in owners.values()
        if len(bin_list) > 1
        for i, a in enumerate(bin_list)
        for pair in [(a, b) for b in bin_list[i + 1 :]]
    }
    removed: set[str] = set()
    for a, b in sorted(pairs):
        if a in removed or b in removed:
            continue
        shared = bins[a] & bins[b]
        shared_len = _bin_length(shared, length_of)
        if shared_len / min(sizes[a], sizes[b]) >= min_cov:
            worse = b if qualities[a].score >= qualities[b].score else a
            removed.add(worse)
    return {n: set(bins[n]) for n in names if n not in removed}


def rip_overlaps(
    bins: Mapping[str, set[str]],
    length_of: Mapping[str, int],
    weight_threshold: float = WEIGHT_EPSILON,
) -> dict[str, set[str]]:
    """Make bins disjoint: resolve overlap edges weakest-first by removing
    the shared contigs from the larger bin (reference move rule,
    rip_bins.py:208-236). `weight_threshold` only orders the log message
    severity — every overlap is resolved so the output partitions.
    """
    out = {n: set(c) for n, c in bins.items()}
    sizes = {n: _bin_length(c, length_of) for n, c in out.items()}

    def weight_of(a: str, b: str) -> float:
        shared_len = _bin_length(out[a] & out[b], length_of)
        return shared_len / max(min(sizes[a], sizes[b]), 1)

    # Build the overlap graph once. Edges whose shared contigs all have
    # length 0 still count (weight 0): disjointness must hold regardless.
    owners: dict[str, list[str]] = {}
    for name, contigs in out.items():
        for contig in contigs:
            owners.setdefault(contig, []).append(name)
    pending: dict[tuple[str, str], float] = {}
    for bin_list in owners.values():
        if len(bin_list) > 1:
            srt = sorted(bin_list)
            for i, a in enumerate(srt):
                for b in srt[i + 1 :]:
                    pending.setdefault((a, b), 0.0)
    for a, b in pending:
        pending[(a, b)] = weight_of(a, b)

    # Resolve weakest-first. A rip removes the WHOLE intersection from the
    # loser, so the popped edge is fully resolved each iteration and rips
    # never create new overlaps — only edges incident to the loser need
    # their weights refreshed (an O(deg) update instead of rebuilding the
    # graph, which made the loop quadratic in the number of overlaps).
    n_ripped = 0
    while pending:
        weight, (a, b) = min((w, e) for e, w in pending.items())
        del pending[(a, b)]
        loser = a if sizes[a] >= sizes[b] else b  # larger bin gives up
        out[loser] -= out[a] & out[b]
        sizes[loser] = _bin_length(out[loser], length_of)
        for edge in [e for e in pending if loser in e]:
            x, y = edge
            if out[x] & out[y]:
                pending[edge] = weight_of(x, y)
            else:
                del pending[edge]
        n_ripped += 1
        if weight > weight_threshold:
            logger.info(
                f"\tRipped overlap (weight {weight:.4f}) out of bin {loser}"
            )
    if n_ripped:
        logger.info(f"\tResolved {n_ripped} bin overlaps")
    return {n: c for n, c in out.items() if c}


def ensemble_merge(
    binnings: Sequence[Mapping[str, set[str]]],
    qualities: Mapping[str, BinQuality],
    length_of: Mapping[str, int],
    min_completeness: float = 0.9,
    max_contamination: float = 0.05,
    min_cov: float = 0.75,
    min_bin_size: int = 200_000,
) -> dict[str, set[str]]:
    """Full pipeline: union the binnings, quality-filter, dereplicate,
    rip remaining overlaps. Bin names must be globally unique across the
    input binnings (the Avamb CLI prefixes vae_/z_/y_)."""
    union: dict[str, set[str]] = {}
    for binning in binnings:
        for name, contigs in binning.items():
            if name in union:
                raise ValueError(
                    f'Duplicate bin name "{name}" across input binnings'
                )
            union[name] = set(contigs)
    filtered = filter_by_quality(
        union, qualities, length_of,
        min_completeness, max_contamination, min_bin_size,
    )
    logger.info(
        f"\t{len(filtered)}/{len(union)} bins pass quality/size gates"
    )
    dereplicated = dereplicate(filtered, qualities, length_of, min_cov)
    logger.info(f"\t{len(dereplicated)} bins after dereplication")
    disjoint = rip_overlaps(dereplicated, length_of)
    logger.info(f"\t{len(disjoint)} final non-overlapping bins")
    return disjoint


def score_bins_with_markers(
    markers,
    bins: Mapping[str, set[str]],
    identifiers: Sequence[str],
) -> dict[str, BinQuality]:
    """Estimate every bin's quality from single-copy marker genes.

    Completeness = fraction of the marker set present at least once;
    contamination = surplus marker copies / marker-set size — exactly the
    counts `Markers.score_bin` computes (and the quantities the reference
    workflow obtains externally from CheckM2). `markers` is a
    `vamb_torch.markers.Markers`; `identifiers` aligns contig names to its
    row indices.
    """
    index_of = {name: i for i, name in enumerate(identifiers)}
    out: dict[str, BinQuality] = {}
    for name, contigs in bins.items():
        missing = [c for c in contigs if c not in index_of]
        if missing:
            raise KeyError(
                f'Bin "{name}" contains contig "{missing[0]}" '
                "not present in the composition the markers were predicted on"
            )
        completeness, contamination = markers.score_bin(
            index_of[c] for c in contigs
        )
        out[name] = BinQuality(
            completeness=float(completeness), contamination=float(contamination)
        )
    return out


def write_nc_outputs(
    outdir: Path,
    merged: Mapping[str, set[str]],
    qualities: Mapping[str, BinQuality],
    separator: Optional[str] = None,
    fasta_path: Optional[Path] = None,
    compress: bool = False,
) -> None:
    """Write the workflow's terminal artifacts for the final bin set.

    - `<outdir>/quality_report.tsv`: Name/Completeness/Contamination (in
      percent, CheckM2 units) for exactly the emitted bins — the
      reference's final quality file
      (transfer_contigs_and_aggregate_all_nc_bins.py:301-320).
    - With `fasta_path`: one FASTA per bin under `<outdir>/bins/<sample>/`
      where sample is the contig-name prefix before `separator` (the
      reference's per-sample NC folders, mv_bins_from_mdrep_clusters.py);
      with no separator all bins land in `<outdir>/bins/`.
    """
    import gzip

    from .utils.io import Reader, byte_iterfasta

    outdir.mkdir(parents=True, exist_ok=True)
    with open(outdir.joinpath("quality_report.tsv"), "w") as file:
        print("Name", "Completeness", "Contamination", sep="\t", file=file)
        for name in sorted(merged):
            quality = qualities[name]
            print(
                name,
                f"{quality.completeness * 100:.2f}",
                f"{quality.contamination * 100:.2f}",
                sep="\t",
                file=file,
            )
    if fasta_path is None:
        return
    bins_root = outdir.joinpath("bins")
    keep: set[str] = set()
    for contigs in merged.values():
        keep.update(contigs)
    # One streaming pass over the catalogue; sequences gzip-cached in RAM
    # until written (same policy as utils.io.write_bins).
    bytes_by_id: dict[str, bytes] = {}
    with Reader(fasta_path) as fastaio:
        for entry in byte_iterfasta(fastaio, None):
            if entry.identifier in keep:
                bytes_by_id[entry.identifier] = gzip.compress(
                    entry.format().encode(), compresslevel=1
                )
    for name, contigs in sorted(merged.items()):
        if separator:
            sample = next(iter(sorted(contigs))).split(separator)[0]
            directory = bins_root.joinpath(sample)
        else:
            directory = bins_root
        directory.mkdir(parents=True, exist_ok=True)
        suffix = ".fna.gz" if compress else ".fna"
        opener = (
            gzip.open(directory.joinpath(name + suffix), "wb", compresslevel=1)
            if compress
            else open(directory.joinpath(name + suffix), "wb")
        )
        with opener as file:
            for contig in sorted(contigs):
                data = bytes_by_id.get(contig)
                if data is None:
                    raise KeyError(
                        f'Contig "{contig}" in bin missing from input FASTA'
                    )
                file.write(gzip.decompress(data))
                file.write(b"\n")


def run_ensemble_files(
    output: Union[Path, IO[str]],
    cluster_paths: Sequence[Path],
    quality_path: Optional[Path],
    identifiers: Sequence[str],
    lengths,
    min_completeness: float = 0.9,
    max_contamination: float = 0.05,
    min_cov: float = 0.75,
    min_bin_size: int = 200_000,
    markers=None,
    nc_outdir: Optional[Path] = None,
    separator: Optional[str] = None,
    fasta_path: Optional[Path] = None,
    compress: bool = False,
) -> dict[str, set[str]]:
    """File-level wrapper used by the CLI.

    Bin qualities come from `quality_path` (a CheckM2 quality_report.tsv)
    or, when that is None, natively from `markers`. With `nc_outdir` the
    final near-complete bin artifacts (quality report, per-sample FASTAs)
    are written too.
    """
    from .utils import read_clusters, write_clusters

    length_of = {n: int(l) for n, l in zip(identifiers, lengths)}
    binnings = []
    for path in cluster_paths:
        with open(path) as file:
            clusters = read_clusters(file)
        for name, contigs in clusters.items():
            missing = [c for c in contigs if c not in length_of]
            if missing:
                raise KeyError(
                    f'Cluster file {path} contains contig "{missing[0]}" '
                    "not present in the composition"
                )
        binnings.append(clusters)
    if quality_path is not None:
        with open(quality_path) as file:
            qualities = read_checkm2_quality(file)
    elif markers is not None:
        # Build the union with the same duplicate check ensemble_merge
        # performs, so a name collision fails fast here instead of after
        # the expensive marker scoring pass.
        union: dict[str, set[str]] = {}
        for binning in binnings:
            for name, contigs in binning.items():
                if name in union:
                    raise ValueError(
                        f'Duplicate bin name "{name}" across input binnings'
                    )
                union[name] = set(contigs)
        logger.info("\tScoring bins with single-copy marker genes")
        qualities = score_bins_with_markers(markers, union, identifiers)
    else:
        raise ValueError(
            "Either a CheckM2 quality report or markers must be provided"
        )
    merged = ensemble_merge(
        binnings, qualities, length_of,
        min_completeness, max_contamination, min_cov, min_bin_size,
    )
    if isinstance(output, (str, Path)):
        with open(output, "w") as file:
            write_clusters(file, sorted(merged.items()))
    else:
        write_clusters(output, sorted(merged.items()))
    if nc_outdir is not None:
        write_nc_outputs(
            nc_outdir, merged, qualities, separator, fasta_path, compress
        )
    return merged
