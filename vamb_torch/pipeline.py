"""Pipeline stage functions: the glue between CLI options and the engine.

Port of `vamb_tpu/pipeline.py`'s `bin default` path (reference
vamb/__main__.py stage functions calc_tnf :885, calc_abundance :944,
trainvae :1065, cluster_and_write_files :1254, create_cluster_fasta_files
:1407, run_bin_default :1451) and of `recluster` (load_markers :1030,
run_reclustering :2071). Stage artifacts (`composition.npz`,
`abundance.npz`, `latent.npz`, `model.npz`, `markers.npz`) and the output
TSVs have `vamb_tpu`'s formats. The VAE, the clustering engine, the marker
genes' Forward scores and k-means run on `GeneralOptions.device` ("cuda"
unless the caller asks for "cpu").
"""

import itertools
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Collection, Iterable, Optional, Sequence

import numpy as np

from . import cluster as _cluster
from .abundance import Abundance
from .composition import Composition
from .log import logger
from .models import VAE, make_dataset
from .utils import BinSplitter, Reader, write_bins, write_npz

MINIMUM_SEQS = 100


# ------------------------------------------------------------------ options


@dataclass
class GeneralOptions:
    outdir: Path
    min_contig_length: int = 2000
    nthreads: int = 1
    refcheck: bool = True
    seed: int = 0
    device: str = "cuda"

    def __post_init__(self):
        if self.min_contig_length < 250:
            raise ValueError(
                f"Minimum contig length must be at least 250, not {self.min_contig_length}"
            )
        if self.nthreads < 1:
            raise ValueError(f"Must pass at least 1 thread, not {self.nthreads}")


@dataclass
class CompositionOptions:
    "Exactly one of `fasta` / `composition` must be given."
    fasta: Optional[Path] = None
    composition: Optional[Path] = None

    def __post_init__(self):
        if (self.fasta is None) == (self.composition is None):
            raise ValueError(
                "Exactly one of --fasta or --composition must be specified"
            )
        for p in (self.fasta, self.composition):
            if p is not None and not p.is_file():
                raise FileNotFoundError(p)


@dataclass
class AbundanceOptions:
    "Exactly one of `bampaths` / `abundance_tsv` / `abundancepath`."
    bampaths: Optional[list[Path]] = None
    abundance_tsv: Optional[Path] = None
    abundancepath: Optional[Path] = None
    min_alignment_id: float = 0.0

    def __post_init__(self):
        given = sum(
            x is not None
            for x in (self.bampaths, self.abundance_tsv, self.abundancepath)
        )
        if given != 1:
            raise ValueError(
                "Exactly one of --bamdir/--bamfiles, --abundance_tsv or "
                "--abundance must be specified"
            )
        for p in (self.abundance_tsv, self.abundancepath):
            if p is not None and not p.is_file():
                raise FileNotFoundError(p)


@dataclass
class VAEOptions:
    nhiddens: Optional[list[int]] = None
    nlatent: int = 32
    alpha: Optional[float] = None
    beta: float = 200.0
    dropout: Optional[float] = None
    nepochs: int = 300
    batchsize: int = 256
    batchsteps: list[int] = field(default_factory=lambda: [25, 75, 150, 225])
    precision: str = "f32"


@dataclass
class ClusterOptions:
    window_size: int = 300
    min_successes: int = 15
    max_clusters: Optional[int] = None
    # the vamb_tpu engine switches; ClusterGenerator rejects unported values
    distance_dtype: str = "float32"
    wander_kernel: str = "auto"
    wander_scope: str = "auto"


@dataclass
class BinOutputOptions:
    binsplitter: BinSplitter = field(
        default_factory=lambda: BinSplitter(None)
    )
    min_fasta_output_size: Optional[int] = None
    compress_fasta_output: bool = False


# ------------------------------------------------------------------- stages


def calc_tnf(
    options: CompositionOptions,
    min_contig_length: int,
    outdir: Path,
    binsplitter: BinSplitter,
) -> Composition:
    begintime = time.time()
    logger.info("Loading TNF")
    logger.info(f"\tMinimum sequence length: {min_contig_length}")

    if options.composition is not None:
        logger.info(f'\tLoading composition from npz at: "{options.composition}"')
        composition = Composition.load(options.composition)
        composition.filter_min_length(min_contig_length)
    else:
        logger.info(f"\tLoading data from FASTA file {options.fasta}")
        with Reader(options.fasta) as file:
            composition = Composition.from_file(
                file, str(options.fasta), minlength=min_contig_length
            )
        composition.save(outdir.joinpath("composition.npz"))

    binsplitter.initialize(composition.metadata.identifiers)

    if composition.nseqs < MINIMUM_SEQS:
        raise ValueError(
            f"Found only {composition.nseqs} contigs, but at least "
            f"{MINIMUM_SEQS} are required to work correctly. "
            "If you have this few sequences in a metagenomic assembly, "
            "it's probably an error somewhere in your workflow."
        )

    if not np.all(composition.metadata.mask):
        n_removed = len(composition.metadata.mask) - np.sum(composition.metadata.mask)
        logger.warning(
            f"The minimum sequence length has been set to {min_contig_length}, "
            f"but {n_removed} sequences fell below this threshold and were "
            "filtered away. Better results are obtained if the sequence file "
            "is filtered to the minimum sequence length before mapping."
        )

    elapsed = round(time.time() - begintime, 2)
    logger.info(
        f"\tKept {composition.count_bases()} bases in {composition.nseqs} sequences"
    )
    logger.info(f"\tProcessed TNF in {elapsed} seconds.")
    return composition


def calc_abundance(
    options: AbundanceOptions,
    outdir: Path,
    refcheck: bool,
    comp_metadata,
    nthreads: int,
) -> Abundance:
    begintime = time.time()
    logger.info("Loading depths")
    logger.info(
        f"\tReference hash: {comp_metadata.refhash.hex() if refcheck else 'None'}"
    )

    if options.abundancepath is not None:
        logger.info(f'\tLoading depths from npz at: "{options.abundancepath}"')
        abundance = Abundance.load(
            options.abundancepath, comp_metadata.refhash if refcheck else None
        )
        if abundance.nseqs != comp_metadata.nseqs:
            assert not refcheck
            raise ValueError(
                f"Loaded abundance has {abundance.nseqs} sequences, "
                f"but composition has {comp_metadata.nseqs}."
            )
    elif options.abundance_tsv is not None:
        logger.info(f'\tParsing abundance from TSV at "{options.abundance_tsv}"')
        abundance = Abundance.from_tsv(options.abundance_tsv, comp_metadata)
        abundance.save(outdir.joinpath("abundance.npz"))
        _log_samples(abundance)
    else:
        logger.info(
            f"\tParsing {len(options.bampaths)} BAM files with {nthreads} threads"
        )
        logger.info(f"\tMin identity: {options.min_alignment_id}")
        abundance = Abundance.from_files(
            list(options.bampaths),
            outdir.joinpath("tmp").joinpath("coverage"),
            comp_metadata,
            refcheck,
            options.min_alignment_id,
            nthreads,
        )
        abundance.save(outdir.joinpath("abundance.npz"))
        _log_samples(abundance)

    elapsed = round(time.time() - begintime, 2)
    logger.info(f"\tProcessed abundance in {elapsed} seconds.")
    return abundance


def _log_samples(abundance: Abundance) -> None:
    logger.info("\tOrder of columns is:")
    for i, samplename in enumerate(abundance.samplenames):
        logger.info(f"\t{i:>6}: {samplename}")


def load_composition_and_abundance(
    general: GeneralOptions,
    comp_options: CompositionOptions,
    abundance_options: AbundanceOptions,
    binsplitter: BinSplitter,
) -> tuple[Composition, Abundance]:
    composition = calc_tnf(
        comp_options, general.min_contig_length, general.outdir, binsplitter
    )
    abundance = calc_abundance(
        abundance_options,
        general.outdir,
        general.refcheck,
        composition.metadata,
        general.nthreads,
    )
    return composition, abundance


def trainvae(
    vae_options: VAEOptions,
    general: GeneralOptions,
    dataset,
) -> np.ndarray:
    begintime = time.time()
    logger.info("Creating and training VAE")

    vae = VAE(
        dataset.nsamples,
        nhiddens=vae_options.nhiddens,
        nlatent=vae_options.nlatent,
        alpha=vae_options.alpha,
        beta=vae_options.beta,
        dropout=vae_options.dropout,
        seed=general.seed,
        device=general.device,
        precision=vae_options.precision,
    )
    logger.info(f"\tCreated VAE on {vae.device}")
    vae.trainmodel(
        dataset,
        nepochs=vae_options.nepochs,
        batchsize=vae_options.batchsize,
        batchsteps=vae_options.batchsteps,
        modelfile=general.outdir.joinpath("model.npz"),
        logger=logger.info,
    )
    logger.info("\tEncoding to latent representation")
    latent = vae.encode(dataset)
    write_npz(general.outdir.joinpath("latent.npz"), latent)

    elapsed = round(time.time() - begintime, 2)
    logger.info(f"\tTrained VAE and encoded in {elapsed} seconds.")
    return latent


def cluster_and_write_files(
    cluster_options: ClusterOptions,
    binsplitter: BinSplitter,
    latent: np.ndarray,
    sequence_names: Sequence[str],
    sequence_lens: np.ndarray,
    seed: int,
    base_clusters_name: str,  # e.g. /foo/bar/vae -> /foo/bar/vae_clusters_unsplit.tsv
    fasta_path: Optional[Path] = None,
    bins_dir: Optional[Path] = None,
    min_fasta_size: int = 0,
    compress_fasta: bool = False,
    bin_prefix: Optional[str] = None,
    device="cuda",
):
    "Stream clusters to TSVs + metadata; optionally write per-bin FASTAs."
    begintime = time.time()
    logger.info("Clustering")
    logger.info(f"\tWindowsize: {cluster_options.window_size}")
    logger.info(
        f"\tMin successful thresholds detected: {cluster_options.min_successes}"
    )
    logger.info(f"\tMax clusters: {cluster_options.max_clusters}")
    logger.info(f"\tBinsplitter: {binsplitter.log_string()}")

    generator = _cluster.ClusterGenerator(
        latent,
        sequence_lens,
        windowsize=cluster_options.window_size,
        minsuccesses=cluster_options.min_successes,
        destroy=True,
        normalized=False,
        rng_seed=seed,
        device=device,
        distance_dtype=cluster_options.distance_dtype,
        wander_kernel=cluster_options.wander_kernel,
        wander_scope=cluster_options.wander_scope,
    )
    clusters = itertools.islice(generator, cluster_options.max_clusters)

    from .utils.io import CLUSTERS_HEADER

    stored_clusters: Optional[list[tuple[str, list[str]]]] = (
        [] if fasta_path is not None else None
    )
    n_processed = 0
    n_split_clusters = 0
    n_unsplit_clusters = 0
    n_total = latent.shape[0]
    last_decile_printed = 0

    split_path = None
    if not binsplitter.is_disabled():
        split_path = open(base_clusters_name + "_split.tsv", "w")

    try:
        with (
            open(base_clusters_name + "_metadata.tsv", "w") as metadata_file,
            open(base_clusters_name + "_unsplit.tsv", "w") as unsplit_file,
        ):
            print(
                "name\tradius\tpeak valley ratio\tkind\tbp\tncontigs\tmedoid",
                file=metadata_file,
            )
            print(CLUSTERS_HEADER, file=unsplit_file)
            if split_path is not None:
                print(CLUSTERS_HEADER, file=split_path)

            for cluster_index, cluster in enumerate(clusters):
                members = [sequence_names[int(i)] for i in cluster.members]
                name = str(cluster_index + 1)
                if bin_prefix is not None:
                    name = bin_prefix + name
                n_processed += len(members)
                n_unsplit_clusters += 1

                for member in members:
                    print(name, member, sep="\t", file=unsplit_file)
                if stored_clusters is not None and split_path is None:
                    stored_clusters.append((name, list(members)))

                if split_path is not None:
                    for split_name, split_members in binsplitter.split_bin(
                        name, members
                    ):
                        n_split_clusters += 1
                        if stored_clusters is not None:
                            stored_clusters.append((split_name, list(split_members)))
                        for split_member in split_members:
                            print(split_name, split_member, sep="\t", file=split_path)

                print(
                    name,
                    None if cluster.radius is None else round(cluster.radius, 3),
                    None
                    if cluster.observed_pvr is None
                    else round(cluster.observed_pvr, 2),
                    cluster.kind_str,
                    int(sum(sequence_lens[i] for i in cluster.members)),
                    len(members),
                    sequence_names[cluster.medoid],
                    file=metadata_file,
                    sep="\t",
                )

                current_decile = -(-10 * n_processed // n_total)
                for decile in range(last_decile_printed + 1, current_decile + 1):
                    logger.info(f"\t {decile * 10:3} % of contigs clustered")
                last_decile_printed = current_decile
    finally:
        if split_path is not None:
            split_path.close()

    binsplitter.log_clustering_result(
        n_total, n_split_clusters, n_unsplit_clusters, begintime
    )

    if fasta_path is not None and bins_dir is not None:
        assert stored_clusters is not None
        create_cluster_fasta_files(
            bins_dir,
            stored_clusters,
            fasta_path,
            sequence_lens,
            sequence_names,
            min_fasta_size,
            compress_fasta,
        )


def create_cluster_fasta_files(
    dir_to_populate: Path,
    clusters: Iterable[tuple[str, Collection[str]]],
    existing_fasta_path: Path,
    sequence_lens: Sequence[int],
    sequence_names: Sequence[str],
    min_bin_size: int,
    compress_output: bool,
) -> None:
    begintime = time.time()
    sizeof = dict(zip(sequence_names, sequence_lens))
    filtered = [
        (binname, list(contigs))
        for binname, contigs in clusters
        if sum(sizeof[c] for c in contigs) >= min_bin_size
    ]
    logger.info("Writing clusters.")
    logger.info(f"\tCompression: {compress_output}")
    with Reader(existing_fasta_path) as file:
        write_bins(dir_to_populate, filtered, file, compress_output, None)
    elapsed = round(time.time() - begintime, 2)
    logger.info(
        f"\tWrote clusters above {min_bin_size} bp to FASTA files in {elapsed} seconds."
    )


# ------------------------------------------------------------------ runners


@dataclass
class BinDefaultOptions:
    general: GeneralOptions
    comp: CompositionOptions
    abundance: AbundanceOptions
    vae: VAEOptions
    clustering: ClusterOptions
    output: BinOutputOptions


def run_bin_default(opt: BinDefaultOptions) -> None:
    "The flagship path (reference __main__.py:1451-1488)."
    composition, abundance = load_composition_and_abundance(
        opt.general, opt.comp, opt.abundance, opt.output.binsplitter
    )
    dataset = make_dataset(
        abundance.matrix,
        composition.matrix,
        composition.metadata.lengths,
        destroy=True,
    )
    latent = trainvae(opt.vae, opt.general, dataset)
    comp_metadata = composition.metadata
    del composition, abundance, dataset
    assert comp_metadata.nseqs == len(latent)

    fasta_out = None
    bins_dir = None
    if opt.output.min_fasta_output_size is not None:
        if opt.comp.fasta is None:
            raise ValueError(
                "FASTA output was requested (--minfasta), but no FASTA input "
                "was given (--fasta)"
            )
        fasta_out = opt.comp.fasta
        bins_dir = opt.general.outdir.joinpath("bins")

    cluster_and_write_files(
        opt.clustering,
        opt.output.binsplitter,
        latent,
        list(comp_metadata.identifiers),
        comp_metadata.lengths,
        opt.general.seed,
        str(opt.general.outdir.joinpath("vae_clusters")),
        fasta_path=fasta_out,
        bins_dir=bins_dir,
        min_fasta_size=opt.output.min_fasta_output_size or 0,
        compress_fasta=opt.output.compress_fasta_output,
        device=opt.general.device,
    )


def export_clusters(
    binsplitter: BinSplitter,
    clusters: Collection[tuple[str, Collection[str]]],
    base_clusters_name: str,
    fasta_output=None,  # (fasta_path, bins_dir, min_size, compress, names, lens)
) -> None:
    "Write precomputed clusters (reference __main__.py:1189-1252)."
    from .utils.io import CLUSTERS_HEADER

    begintime = time.time()
    split_file = None
    if not binsplitter.is_disabled():
        split_file = open(base_clusters_name + "_split.tsv", "w")
        print(CLUSTERS_HEADER, file=split_file)
    n_split = 0
    n_unsplit = len(clusters)
    n_total = sum(len(cl) for (_, cl) in clusters)
    try:
        with open(base_clusters_name + "_unsplit.tsv", "w") as unsplit:
            print(CLUSTERS_HEADER, file=unsplit)
            for name, contigs in clusters:
                for contig in contigs:
                    print(name, contig, sep="\t", file=unsplit)
                if split_file is not None:
                    for split_name, split_members in binsplitter.split_bin(
                        name, contigs
                    ):
                        n_split += 1
                        for member in split_members:
                            print(split_name, member, sep="\t", file=split_file)
    finally:
        if split_file is not None:
            split_file.close()
    binsplitter.log_clustering_result(n_total, n_split, n_unsplit, begintime)

    if fasta_output is not None:
        fasta_path, bins_dir, min_size, compress, names, lens = fasta_output
        create_cluster_fasta_files(
            bins_dir, clusters, fasta_path, lens, names, min_size, compress
        )


# ------------------------------------------------------------ reclustering


@dataclass
class MarkerOptions:
    "Markers from a precomputed file, or predicted from FASTA + .hmm."
    markers_path: Optional[Path] = None
    hmm_path: Optional[Path] = None
    fasta_path: Optional[Path] = None

    def __post_init__(self):
        if self.markers_path is None and self.hmm_path is None:
            raise ValueError(
                "Either --markers, or --hmm_path (with a FASTA input) "
                "must be specified"
            )
        if self.markers_path is None and (
            self.hmm_path is not None and self.fasta_path is None
        ):
            raise ValueError(
                "If markers are to be predicted with --hmm_path, the "
                "composition must be given as --fasta"
            )
        for p in (self.markers_path, self.hmm_path):
            if p is not None and not p.is_file():
                raise FileNotFoundError(p)


def load_markers(
    options: MarkerOptions,
    comp_metadata,
    existing_outdir: Path,
    n_threads: int,
    device="cuda",
):
    "Load or predict markers (reference __main__.py:1030-1062)."
    from .markers import Markers

    begin_time = time.time()
    logger.info("Loading markers")
    if options.markers_path is not None:
        logger.info(
            f'\tLoading markers from existing `markers.npz` at "{options.markers_path}"'
        )
        markers = Markers.load(options.markers_path, comp_metadata.refhash)
    else:
        logger.info("\tPredicting markers. This might take some time")
        logger.info(f"\t\tFASTA file located at {options.fasta_path}")
        logger.info(f"\t\tHMM profile file (.hmm file) located at {options.hmm_path}")
        markers = Markers.from_files(
            options.fasta_path,
            options.hmm_path,
            list(comp_metadata.identifiers),
            existing_outdir.joinpath("tmp_markers"),
            n_threads,
            comp_metadata.refhash,
            device=device,
        )
        markers.save(existing_outdir.joinpath("markers.npz"))
    elapsed = round(time.time() - begin_time, 2)
    logger.info(f"\tProcessed markers in {elapsed} seconds.")
    return markers


@dataclass
class ReclusteringOptions:
    general: GeneralOptions
    comp: CompositionOptions
    markers: MarkerOptions
    output: BinOutputOptions
    latent_path: Path = None
    algorithm: str = "kmeans"
    clusters_path: Optional[Path] = None
    taxonomy_path: Optional[Path] = None
    no_predictor: bool = False
    abundance: Optional[AbundanceOptions] = None

    def __post_init__(self):
        if self.latent_path is None or not Path(self.latent_path).is_file():
            raise FileNotFoundError(self.latent_path)
        if self.algorithm not in ("kmeans", "dbscan"):
            raise ValueError(f"Unknown reclustering algorithm {self.algorithm}")
        if self.algorithm == "kmeans" and self.clusters_path is None:
            raise ValueError(
                "If --algorithm is set to 'kmeans', --clusters_path must be set"
            )
        if self.algorithm == "dbscan" and self.taxonomy_path is None:
            raise ValueError(
                "If --algorithm is set to 'dbscan', --taxonomy must be set"
            )


def _taxonomy_is_refined(path: Path) -> bool:
    with open(path) as f:
        return f.readline().rstrip() == "contigs\tpredictions\tscores"


def run_reclustering(opt: ReclusteringOptions) -> None:
    "The `recluster` subcommand (reference __main__.py:2071-2184)."
    from . import reclustering
    from .taxonomy import Taxonomy
    from .utils import read_clusters, read_npz

    is_refined = opt.algorithm == "dbscan" and _taxonomy_is_refined(opt.taxonomy_path)
    if opt.algorithm == "dbscan" and not (
        is_refined or opt.no_predictor or opt.abundance is None
    ):
        raise NotImplementedError(
            "`recluster --algorithm dbscan` refines an unrefined taxonomy with "
            "Taxometer first, which is not ported yet (ROADMAP queue 1, item 7: "
            "taxonomy models); pass --no_predictor or a refined taxonomy"
        )
    composition = calc_tnf(
        opt.comp, opt.general.min_contig_length, opt.general.outdir,
        opt.output.binsplitter,
    )
    markers = load_markers(
        opt.markers, composition.metadata, opt.general.outdir, opt.general.nthreads,
        opt.general.device,
    )
    latent = read_npz(opt.latent_path)

    if opt.algorithm == "dbscan":
        if is_refined:
            logger.info(f'Loading refined taxonomy from file "{opt.taxonomy_path}"')
            taxonomy = Taxonomy.from_refined_file(
                opt.taxonomy_path, composition.metadata, True
            )
        else:
            logger.info(f'Loading unrefined taxonomy from file "{opt.taxonomy_path}"')
            taxonomy = Taxonomy.from_file(
                opt.taxonomy_path, composition.metadata, True
            )
        alg = reclustering.DBScanAlgorithm(
            composition.metadata, taxonomy, opt.general.nthreads
        )
        logger.info("Reclustering")
        logger.info("\tAlgorithm: DBSCAN")
    else:
        with open(opt.clusters_path) as file:
            clusters = read_clusters(file)
        contig_to_id = {
            c: i for (i, c) in enumerate(composition.metadata.identifiers)
        }
        clusters_as_ids: list[set[int]] = []
        for cluster in clusters.values():
            s = set()
            for contig in cluster:
                i = contig_to_id.get(contig)
                if i is None:
                    raise ValueError(
                        f'Contig "{contig}" found in the provided clusters file '
                        "is not found in the provided composition."
                    )
                s.add(i)
            clusters_as_ids.append(s)
        alg = reclustering.KmeansAlgorithm(
            clusters_as_ids,
            abs(opt.general.seed) % 4294967295,
            composition.metadata.lengths,
            opt.general.device,
        )
        logger.info("Reclustering")
        logger.info("\tAlgorithm: KMeans")

    reclustered = reclustering.recluster_bins(markers, latent, alg)
    logger.info("\tReclustering complete")

    identifiers = composition.metadata.identifiers
    clusters_dict = [
        (str(i), {identifiers[c] for c in cluster})
        for i, cluster in enumerate(reclustered)
    ]

    fasta_output = None
    if opt.output.min_fasta_output_size is not None:
        if opt.comp.fasta is None:
            raise ValueError(
                "FASTA output requested (--minfasta) but composition was not "
                "given as FASTA"
            )
        fasta_output = (
            opt.comp.fasta,
            opt.general.outdir.joinpath("bins"),
            opt.output.min_fasta_output_size,
            opt.output.compress_fasta_output,
            list(identifiers),
            composition.metadata.lengths,
        )

    export_clusters(
        opt.output.binsplitter,
        clusters_dict,
        str(opt.general.outdir.joinpath("clusters_reclustered")),
        fasta_output,
    )
