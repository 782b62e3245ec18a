"""Pipeline stage functions: the glue between CLI options and the engine.

Port of `vamb_tpu/pipeline.py`'s `bin default` path (reference
vamb/__main__.py stage functions calc_tnf :885, calc_abundance :944,
trainvae :1065, cluster_and_write_files :1254, create_cluster_fasta_files
:1407, run_bin_default :1451), of `recluster` (load_markers :1030,
run_reclustering :2071), of the taxonomy paths: `taxometer`
(predict_taxonomy :1542), `bin taxvamb` (:1941) and `taxonomy_benchmark`
(:1822), and of `bin avamb` (run_bin_aae :1491). Stage artifacts
(`composition.npz`, `abundance.npz`, `latent.npz`, `model.npz`,
`markers.npz`, `predictor_model.npz`, `vaevae_model.npz`,
`vaevae_latent.npz`, `aae_model.npz`, `aae_z_latent.npz`) and the output
TSVs have `vamb_tpu`'s formats. The
models, the clustering engine, the marker genes' Forward scores and
k-means run on `GeneralOptions.device` ("cuda" unless the caller asks for
"cpu").
"""

import itertools
import json
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
from .parallel import make_mesh, process_info
from .utils import BinSplitter, Reader, write_bins, write_npz

MINIMUM_SEQS = 100


def process_device(device: str) -> str:
    """This process's device: in a multi-process run on cards, its own card
    (`cuda:<local rank>`), else `device` as it is."""
    return str(make_mesh(device=device).device) if process_info()[1] > 1 else device


def default_mesh(device: str):
    """The mesh over every process of a multi-process run, or None for a
    lone process (vamb_tpu/pipeline.py:29-44, whose mesh spans the host's
    devices; here one process a card)."""
    if process_info()[1] <= 1:
        return None
    mesh = make_mesh(device=device)
    logger.info(f"\tUsing a {mesh.size}-process mesh for device compute ({mesh})")
    return mesh


# ------------------------------------------------------------------ options


@dataclass
class GeneralOptions:
    outdir: Path
    min_contig_length: int = 2000
    nthreads: int = 1
    refcheck: bool = True
    seed: int = 0
    device: str = "cuda"
    profile: bool = False

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
    primary = process_info()[0] == 0  # only process 0 saves the model and latent
    vae.trainmodel(
        dataset,
        nepochs=vae_options.nepochs,
        batchsize=vae_options.batchsize,
        batchsteps=vae_options.batchsteps,
        modelfile=general.outdir.joinpath("model.npz") if primary else None,
        logger=logger.info,
        mesh=default_mesh(general.device),
    )
    logger.info("\tEncoding to latent representation")
    latent = vae.encode(dataset)  # unsharded on every rank, as in vamb_tpu
    if primary:
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
        mesh=default_mesh(device),
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

    logger.info(
        f"\tEngine: subset wander {json.dumps(generator.subset_counts)}; "
        f"seed cache, bursts and lanes {json.dumps(generator.lane_counts)}"
    )
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


def fasta_output_paths(opt) -> tuple[Optional[Path], Optional[Path]]:
    """(input FASTA, bins directory) for `--minfasta`, or (None, None)
    without it; a `bin` run's options `opt` must then hold a FASTA input."""
    if opt.output.min_fasta_output_size is None:
        return None, None
    if opt.comp.fasta is None:
        raise ValueError(
            "FASTA output was requested (--minfasta), but no FASTA input "
            "was given (--fasta)"
        )
    return opt.comp.fasta, opt.general.outdir.joinpath("bins")


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

    fasta_out, bins_dir = fasta_output_paths(opt)

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


# ----------------------------------------------------- taxonomy runners


@dataclass
class TaxometerOptions:
    "Options of the Taxometer predictor (reference __main__.py:422-468)."
    taxonomy_path: Path
    nepochs: int = 100
    batchsize: int = 1024
    batchsteps: list[int] = field(default_factory=list)
    softmax_threshold: float = 0.5
    ploss: str = "flat_softmax"

    def __post_init__(self):
        if not (0.0 <= self.softmax_threshold <= 1.0):
            raise ValueError(
                f"Softmax threshold should be between 0 and 1, "
                f"currently {self.softmax_threshold}"
            )
        if self.ploss not in ("flat_softmax", "cond_softmax", "soft_margin"):
            raise ValueError(f"Unknown predictor loss {self.ploss}")
        if not self.taxonomy_path.is_file():
            raise FileNotFoundError(self.taxonomy_path)


def targets_from_taxonomy(contig_taxonomies) -> tuple[list[str], dict, list[int], np.ndarray]:
    "Graph + per-contig deepest-node targets (reference __main__.py:1563-1567)."
    from .models import hier

    nodes, ind_nodes, table_parent = hier.make_graph(contig_taxonomies)
    classes_order = [
        "root" if (t is None or len(t.ranks) == 0) else t.ranks[-1]
        for t in contig_taxonomies
    ]
    targets = np.array([ind_nodes[c] for c in classes_order])
    return nodes, ind_nodes, table_parent, targets


def _predicted_lineages(model, dataset, nodes: list[str], threshold: float) -> list:
    """Each row's nodes with probability above `threshold` in node order,
    the first (the root) left out, with their float32 probabilities
    (reference __main__.py:1615-1630)."""
    from .taxonomy import ContigTaxonomy, PredictedContigTaxonomy

    out = []
    for counts, cols, probs in model.predict_above(dataset, threshold):
        start = 0
        for end in np.cumsum(counts).tolist():
            ranks = [nodes[j] for j in cols[start + 1 : end].tolist()]
            out.append(PredictedContigTaxonomy(ContigTaxonomy(ranks), probs[start + 1 : end]))
            start = end
    return out


def predict_taxonomy(
    comp_metadata,
    abundance_matrix: np.ndarray,
    tnfs: np.ndarray,
    lengths: np.ndarray,
    out_dir: Path,
    options: TaxometerOptions,
    seed: int = 0,
    device="cuda",
):
    """Train Taxometer on `device` and write results_taxometer.tsv
    (reference __main__.py:1542-1642). Returns the PredictedTaxonomy. In a
    multi-process run the training is data-parallel over the processes'
    mesh, the prediction runs on every process, and only process 0 writes
    the model and the TSV."""
    from .models.taxometer import Taxometer
    from .taxonomy import PredictedTaxonomy, Taxonomy

    begintime = time.time()
    logger.info("Predicting taxonomy with Taxometer")
    taxonomies = Taxonomy.from_file(options.taxonomy_path, comp_metadata, False)
    nodes, ind_nodes, table_parent, targets = targets_from_taxonomy(
        taxonomies.contig_taxonomies
    )
    logger.info(f"\t{len(nodes)} nodes in the graph")

    model = Taxometer(
        abundance_matrix.shape[1],
        len(nodes),
        nodes,
        table_parent,
        nhiddens=[512, 512, 512, 512],
        hier_loss=options.ploss,
        seed=seed,
        device=device,
    )
    dataset = make_dataset(abundance_matrix, tnfs, lengths)
    logger.info("\tCreated dataloader")
    logger.info("Starting training the taxonomy predictor")
    logger.info(f"Using threshold {options.softmax_threshold}")
    primary = process_info()[0] == 0
    model.trainmodel(
        dataset,
        targets,
        nepochs=options.nepochs,
        batchsize=options.batchsize,
        batchsteps=options.batchsteps,
        modelfile=out_dir.joinpath("predictor_model.npz") if primary else None,
        logger=logger.info,
        mesh=default_mesh(device),
    )
    logger.info(f"\tTrained the taxonomy predictor in {round(time.time() - begintime, 2)} seconds.")

    logger.info("Writing the taxonomy predictions")
    predict_begin = time.time()
    predictions = _predicted_lineages(model, dataset, nodes, options.softmax_threshold)
    taxonomy = PredictedTaxonomy(predictions, comp_metadata, False)
    if primary:
        with open(out_dir.joinpath("results_taxometer.tsv"), "w") as file:
            taxonomy.write_as_tsv(file, comp_metadata)
    logger.info(f"\tPredicted the taxonomy in {round(time.time() - predict_begin, 2)} seconds.")
    logger.info(
        f"Completed taxonomy predictions in {round(time.time() - begintime, 2)} seconds."
    )
    return taxonomy


@dataclass
class TaxometerRunOptions:
    general: GeneralOptions
    comp: CompositionOptions
    abundance: AbundanceOptions
    taxometer: TaxometerOptions


def run_taxonomy_predictor(opt: TaxometerRunOptions) -> None:
    "The `taxometer` subcommand (reference __main__.py:1892-1938)."
    composition, abundance = load_composition_and_abundance(
        opt.general, opt.comp, opt.abundance, BinSplitter.inert_splitter()
    )
    predict_taxonomy(
        composition.metadata,
        abundance.matrix,
        composition.matrix,
        composition.metadata.lengths,
        opt.general.outdir,
        opt.taxometer,
        seed=opt.general.seed,
        device=opt.general.device,
    )


@dataclass
class BinTaxVambOptions:
    general: GeneralOptions
    comp: CompositionOptions
    abundance: AbundanceOptions
    vae: VAEOptions
    clustering: ClusterOptions
    output: BinOutputOptions
    taxonomy_path: Path = None
    no_predictor: bool = False
    taxometer: Optional[TaxometerOptions] = None
    ploss: str = "flat_softmax"


def run_vaevae(opt: BinTaxVambOptions) -> None:
    """The `bin taxvamb` subcommand (reference __main__.py:1941-2068): the
    taxonomy is read refined, read as given (`--no_predictor`), or refined
    by Taxometer first; then VAEVAE trains on it and its joint latent is
    clustered into `vaevae_clusters_*`."""
    from .models.vaevae import VAEVAE
    from .taxonomy import Taxonomy

    composition, abundance = load_composition_and_abundance(
        opt.general, opt.comp, opt.abundance, opt.output.binsplitter
    )
    abundance_matrix = abundance.matrix
    tnfs = composition.matrix
    lengths = composition.metadata.lengths
    contignames = composition.metadata.identifiers

    is_refined = opt.taxonomy_path is not None and _taxonomy_is_refined(opt.taxonomy_path)
    if is_refined:
        logger.info(f'Loading already-refined taxonomy from file "{opt.taxonomy_path}"')
        contig_taxonomies = Taxonomy.from_refined_file(
            opt.taxonomy_path, composition.metadata, False
        )
    elif opt.no_predictor:
        logger.info(f'Loading unrefined taxonomy from file "{opt.taxonomy_path}"')
        contig_taxonomies = Taxonomy.from_file(opt.taxonomy_path, composition.metadata, False)
    else:
        taxometer_opt = opt.taxometer or TaxometerOptions(
            taxonomy_path=opt.taxonomy_path, ploss=opt.ploss
        )
        predicted = predict_taxonomy(
            composition.metadata,
            abundance_matrix,
            tnfs,
            lengths,
            opt.general.outdir,
            taxometer_opt,
            seed=opt.general.seed,
            device=opt.general.device,
        )
        contig_taxonomies = predicted.to_taxonomy()

    nodes, ind_nodes, table_parent, targets = targets_from_taxonomy(
        contig_taxonomies.contig_taxonomies
    )
    begintime = time.time()
    logger.info("Creating and training VAEVAE")
    vae = VAEVAE(
        abundance_matrix.shape[1],
        len(nodes),
        nodes,
        table_parent,
        nhiddens=opt.vae.nhiddens,
        nlatent=opt.vae.nlatent,
        alpha=opt.vae.alpha,
        beta=opt.vae.beta,
        dropout=opt.vae.dropout,
        hier_loss=opt.ploss,
        seed=opt.general.seed,
        device=opt.general.device,
    )
    dataset = make_dataset(abundance_matrix, tnfs, lengths)
    primary = process_info()[0] == 0  # only process 0 saves the model and latent
    vae.trainmodel(
        dataset,
        targets,
        nepochs=opt.vae.nepochs,
        batchsize=opt.vae.batchsize,
        batchsteps=opt.vae.batchsteps,
        modelfile=opt.general.outdir.joinpath("vaevae_model.npz") if primary else None,
        logger=logger.info,
        mesh=default_mesh(opt.general.device),
    )
    logger.info(f"\tTrained VAEVAE in {round(time.time() - begintime, 2)} seconds.")
    encode_begin = time.time()
    latent = vae.encode_joint(dataset, targets)  # unsharded on every rank, as in vamb_tpu
    logger.info(f"{latent.shape} embedding shape")
    if primary:
        write_npz(opt.general.outdir.joinpath("vaevae_latent.npz"), latent)
    logger.info(f"\tEncoded the joint latent in {round(time.time() - encode_begin, 2)} seconds.")
    del vae, dataset

    fasta_out, bins_dir = fasta_output_paths(opt)

    cluster_and_write_files(
        opt.clustering,
        opt.output.binsplitter,
        latent,
        list(contignames),
        lengths,
        opt.general.seed,
        str(opt.general.outdir.joinpath("vaevae_clusters")),
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


# --------------------------------------------------------------- avamb


@dataclass
class AAEOptions:
    "Avamb AAE options (reference __main__.py:594-655 defaults)."
    nhiddens: int = 547
    nlatent_z: int = 283
    nlatent_y: int = 700
    sl: float = 0.00964
    slr: float = 0.5
    temp: float = 0.1596
    nepochs: int = 70
    batchsize: int = 256
    batchsteps: list[int] = field(default_factory=lambda: [25, 50])


@dataclass
class BinAvambOptions:
    general: GeneralOptions
    comp: CompositionOptions
    abundance: AbundanceOptions
    vae: VAEOptions
    aae: AAEOptions
    clustering: ClusterOptions
    output: BinOutputOptions


def run_bin_aae(opt: BinAvambOptions) -> None:
    """The `bin avamb` subcommand (reference __main__.py:1491-1539): train
    the AAE, write `aae_model.npz` and `aae_z_latent.npz`, cluster the z
    latent into `aae_z_clusters_*` (bins `z_<n>`) and export the y latent's
    argmax clusters as `aae_y_clusters_*` (bins `y_<n>`), as `vamb_tpu`
    does (the reference v5.0.2 promises the y export but never writes it)."""
    from .models.aae import AAE

    composition, abundance = load_composition_and_abundance(
        opt.general, opt.comp, opt.abundance, opt.output.binsplitter
    )
    dataset = make_dataset(
        abundance.matrix, composition.matrix, composition.metadata.lengths,
        destroy=True,
    )
    comp_metadata = composition.metadata
    del composition, abundance

    begintime = time.time()
    logger.info("Creating and training AAE")
    aae = AAE(
        dataset.nsamples,
        nhiddens=opt.aae.nhiddens,
        nlatent_z=opt.aae.nlatent_z,
        nlatent_y=opt.aae.nlatent_y,
        sl=opt.aae.sl,
        slr=opt.aae.slr,
        alpha=opt.vae.alpha,
        seed=opt.general.seed,
        device=opt.general.device,
    )
    logger.info(f"\tCreated AAE on {aae.device}")
    primary = process_info()[0] == 0  # only process 0 saves the model and latent
    aae.trainmodel(
        dataset,
        nepochs=opt.aae.nepochs,
        batchsize=opt.aae.batchsize,
        batchsteps=opt.aae.batchsteps,
        temperature=opt.aae.temp,
        modelfile=opt.general.outdir.joinpath("aae_model.npz") if primary else None,
        logger=logger.info,
        mesh=default_mesh(opt.general.device),
    )
    logger.info("\tEncoding to latent representation")
    encode_begin = time.time()
    # unsharded on every rank, as in vamb_tpu
    clusters_y_dict, latent_z = aae.get_latents(list(comp_metadata.identifiers), dataset)
    if primary:
        write_npz(opt.general.outdir.joinpath("aae_z_latent.npz"), latent_z)
    logger.info(f"\tEncoded the z latent and the y clusters in {round(time.time() - encode_begin, 2)} seconds.")
    elapsed = round(time.time() - begintime, 2)
    logger.info(f"\tTrained AAE and encoded in {elapsed} seconds.")
    del aae, dataset

    fasta_out, bins_dir = fasta_output_paths(opt)

    cluster_and_write_files(
        opt.clustering,
        opt.output.binsplitter,
        latent_z,
        list(comp_metadata.identifiers),
        comp_metadata.lengths,
        opt.general.seed,
        str(opt.general.outdir.joinpath("aae_z_clusters")),
        fasta_path=fasta_out,
        bins_dir=bins_dir,
        min_fasta_size=opt.output.min_fasta_output_size or 0,
        compress_fasta=opt.output.compress_fasta_output,
        bin_prefix="z_",
        device=opt.general.device,
    )

    y_clusters = [("y_" + k, sorted(v)) for k, v in clusters_y_dict.items()]
    export_clusters(
        opt.output.binsplitter,
        y_clusters,
        str(opt.general.outdir.joinpath("aae_y_clusters")),
        None
        if fasta_out is None
        else (
            fasta_out,
            bins_dir,
            opt.output.min_fasta_output_size or 0,
            opt.output.compress_fasta_output,
            list(comp_metadata.identifiers),
            comp_metadata.lengths,
        ),
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
    taxometer: Optional[TaxometerOptions] = None

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
        if _taxonomy_is_refined(opt.taxonomy_path):
            logger.info(f'Loading refined taxonomy from file "{opt.taxonomy_path}"')
            taxonomy = Taxonomy.from_refined_file(
                opt.taxonomy_path, composition.metadata, True
            )
        elif opt.no_predictor or opt.abundance is None:
            logger.info(f'Loading unrefined taxonomy from file "{opt.taxonomy_path}"')
            taxonomy = Taxonomy.from_file(
                opt.taxonomy_path, composition.metadata, True
            )
        else:
            abundance = calc_abundance(
                opt.abundance,
                opt.general.outdir,
                opt.general.refcheck,
                composition.metadata,
                opt.general.nthreads,
            )
            taxometer_opt = opt.taxometer or TaxometerOptions(
                taxonomy_path=opt.taxonomy_path
            )
            predicted = predict_taxonomy(
                composition.metadata,
                abundance.matrix,
                composition.matrix,
                composition.metadata.lengths,
                opt.general.outdir,
                taxometer_opt,
                seed=opt.general.seed,
                device=opt.general.device,
            )
            taxonomy = Taxonomy(
                [p.contig_taxonomy for p in predicted.contig_taxonomies],
                predicted.refhash,
                True,
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


# ----------------------------------------------------- taxonomy benchmark


def compare_taxonomies(
    pred_file: Path,
    true_file: Path,
    output_file: Path,
    comp_metadata,
) -> None:
    """Per-level accuracy of a predicted (refined) taxonomy against the
    given one (reference __main__.py:1645-1727)."""
    import csv

    from .taxonomy import Taxonomy

    pred_taxonomy = Taxonomy.from_refined_file(pred_file, comp_metadata, False)
    true_taxonomy = Taxonomy.from_file(true_file, comp_metadata, False)

    n_contigs = len(pred_taxonomy.contig_taxonomies)
    max_levels = max(
        max((len(t.ranks) if t is not None else 0) for t in pred_taxonomy.contig_taxonomies),
        max((len(t.ranks) if t is not None else 0) for t in true_taxonomy.contig_taxonomies),
        1,
    )
    correct = [0] * max_levels
    have_truth = [0] * max_levels
    for pred_t, true_t in zip(pred_taxonomy.contig_taxonomies, true_taxonomy.contig_taxonomies):
        pred_ranks = [] if pred_t is None else pred_t.ranks[:max_levels]
        true_ranks = [] if true_t is None else true_t.ranks[:max_levels]
        for i, t in enumerate(true_ranks):
            if t is None:
                continue
            have_truth[i] += 1
            if i < len(pred_ranks) and pred_ranks[i] == t:
                correct[i] += 1

    with open(output_file, "w", newline="") as f:
        w = csv.writer(f, delimiter="\t")
        w.writerow(["Level", "Correct", "Have_truth", "N_contigs", "Accuracy"])
        for i in range(max_levels):
            acc = correct[i] / n_contigs if n_contigs else 0.0
            w.writerow([f"Level_{i}", correct[i], have_truth[i], n_contigs, f"{acc:.6f}"])


def kfold_test_masks(n: int, n_splits: int, seed: int) -> list[np.ndarray]:
    """The test masks of scikit-learn's `KFold(n_splits, shuffle=True,
    random_state=seed).split(range(n))`: `RandomState(seed)` shuffles
    0..n-1, the first `n % n_splits` folds take one row more."""
    indices = np.arange(n)
    np.random.RandomState(seed).shuffle(indices)
    fold_sizes = np.full(n_splits, n // n_splits, dtype=int)
    fold_sizes[: n % n_splits] += 1
    masks, start = [], 0
    for size in fold_sizes:
        mask = np.zeros(n, dtype=bool)
        mask[indices[start : start + size]] = True
        masks.append(mask)
        start += size
    return masks


def cross_validate_taxonomy(
    comp_metadata,
    abundance_matrix: np.ndarray,
    tnfs: np.ndarray,
    lengths: np.ndarray,
    out_dir: Path,
    options: TaxometerOptions,
    seed: int,
    device="cuda",
) -> None:
    """5-fold cross-validation of Taxometer and its accuracy report
    (reference __main__.py:1822-1889): each fold trains a predictor on the
    other four and predicts its own rows, which are written back at their
    contigs' positions."""
    from .models.taxometer import Taxometer
    from .taxonomy import PredictedTaxonomy, Taxonomy

    logger.info("Running cross validation for the taxonomy")
    taxonomy = Taxonomy.from_file(options.taxonomy_path, comp_metadata, False)
    n_contigs = len(taxonomy.contig_taxonomies)
    nodes, ind_nodes, table_parent, targets = targets_from_taxonomy(
        taxonomy.contig_taxonomies
    )

    predictions: list = [None] * n_contigs
    test_masks = kfold_test_masks(n_contigs, 5, abs(seed) % 4294967295)
    for fold, test_mask in enumerate(test_masks):
        train_mask = ~test_mask
        logger.info(
            f"Fold {fold + 1}: Training on {int(train_mask.sum())} contigs, "
            f"testing on {int(test_mask.sum())} contigs"
        )
        model = Taxometer(
            abundance_matrix.shape[1],
            len(nodes),
            nodes,
            table_parent,
            nhiddens=[512, 512, 512, 512],
            hier_loss=options.ploss,
            seed=seed + fold,
            device=device,
        )
        train_ds = make_dataset(
            abundance_matrix[train_mask].copy(), tnfs[train_mask].copy(), lengths[train_mask]
        )
        model.trainmodel(
            train_ds,
            targets[train_mask],
            nepochs=options.nepochs,
            batchsize=options.batchsize,
            batchsteps=options.batchsteps,
            logger=logger.info,
        )
        test_ds = make_dataset(
            abundance_matrix[test_mask].copy(), tnfs[test_mask].copy(), lengths[test_mask]
        )
        fold_predictions = _predicted_lineages(
            model, test_ds, nodes, options.softmax_threshold
        )
        for position, prediction in zip(np.flatnonzero(test_mask), fold_predictions):
            predictions[position] = prediction

    assert all(p is not None for p in predictions)
    predicted_path = out_dir.joinpath("results_taxonomy_predicted_kfold.tsv")
    accuracy_file = out_dir.joinpath("accuracy_report.tsv")
    with open(predicted_path, "w") as file:
        PredictedTaxonomy(predictions, comp_metadata, False).write_as_tsv(file, comp_metadata)
    with open(out_dir.joinpath("file_tracking.tsv"), "w") as file:
        file.write(f"{options.taxonomy_path}\t{predicted_path}\n")
    logger.info(
        f"Wrote k-fold predicted taxonomy for {options.taxonomy_path} to {predicted_path}"
    )
    compare_taxonomies(predicted_path, options.taxonomy_path, accuracy_file, comp_metadata)


def run_taxonomy_cross_validation(opt: TaxometerRunOptions) -> None:
    "The `taxonomy_benchmark` subcommand (reference __main__.py:1919-1938)."
    composition, abundance = load_composition_and_abundance(
        opt.general, opt.comp, opt.abundance, BinSplitter.inert_splitter()
    )
    cross_validate_taxonomy(
        composition.metadata,
        abundance.matrix,
        composition.matrix,
        composition.metadata.lengths,
        opt.general.outdir,
        opt.taxometer,
        opt.general.seed,
        device=opt.general.device,
    )
