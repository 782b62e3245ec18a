"""Command-line interface of the PyTorch/CUDA port.

Mirrors `vamb_tpu`'s CLI (itself the reference's, vamb/__main__.py) with
the same subcommands, flag names and defaults: `bin default`, `bin
taxvamb`, `bin avamb`, `taxometer`, `taxonomy_benchmark`, `recluster` and
`avamb_ensemble`:

    python -m vamb_torch bin default --outdir out --fasta contigs.fna \\
        --bamfiles s1.bam s2.bam
    python -m vamb_torch taxometer --outdir tm --fasta contigs.fna \\
        --abundance_tsv ab.tsv --taxonomy taxonomy.tsv
    python -m vamb_torch bin taxvamb --outdir tv --fasta contigs.fna \\
        --abundance_tsv ab.tsv --taxonomy tm/results_taxometer.tsv
    python -m vamb_torch bin avamb --outdir av --fasta contigs.fna \\
        --abundance_tsv ab.tsv
    python -m vamb_torch avamb_ensemble --outdir ens --fasta contigs.fna \\
        --clusters av/aae_z_clusters_unsplit.tsv av/aae_y_clusters_unsplit.tsv \\
        --quality_report quality_report.tsv
    python -m vamb_torch recluster --outdir re --fasta contigs.fna \\
        --hmm_path markers.hmm --latent_path out/latent.npz \\
        --clusters_path out/vae_clusters_unsplit.tsv

It runs on the CUDA card. `main(argv, device="cpu")` runs the same path on
the CPU (the tests do). `--profile` writes a torch.profiler trace of the
run under `<outdir>/profile`.

Several processes, one a card (torch's idiom; `vamb_tpu` drives every
device of a host from one process): launch the same command in each with
`--coordinator host:port --nprocs N --procid i`, or under torchrun with
`--dist`. The processes join a `torch.distributed` group (NCCL on cards,
gloo on the CPU); `bin default`, `bin taxvamb`, `bin avamb` and
`taxometer` train their models data-parallel, the `bin` models cluster on
the row-sharded engine, and only process 0 writes into `--outdir`.
"""

import argparse
import os
import sys

# Cap threadpools before numpy/torch import (reference __main__.py:36-40)
for _var in ("MKL_NUM_THREADS", "NUMEXPR_NUM_THREADS", "OMP_NUM_THREADS"):
    os.environ.setdefault(_var, str(min(os.cpu_count() or 1, 8)))

import time  # noqa: E402
from functools import partial  # noqa: E402
from pathlib import Path  # noqa: E402

DEFAULT_THREADS = min(os.cpu_count() or 1, 8)


def add_help_arguments(parser):
    helpos = parser.add_argument_group(title="Help and version")
    helpos.add_argument("-h", "--help", help="Show this help and exit", action="help")

    from . import __version__

    helpos.add_argument(
        "--version", action="version", version=f"vamb_torch {__version__}"
    )


def add_general_arguments(subparser):
    add_help_arguments(subparser)
    reqos = subparser.add_argument_group(title="Output")
    reqos.add_argument(
        "--outdir",
        metavar="",
        type=Path,
        help="Directory to create and write results into",
        required=True,
    )
    general = subparser.add_argument_group(title="General optional arguments")
    general.add_argument(
        "-m",
        dest="minlength",
        metavar="",
        type=int,
        default=2000,
        help="Drop contigs below this length in bp [2000]",
    )
    general.add_argument(
        "-p",
        dest="nthreads",
        metavar="",
        type=int,
        default=DEFAULT_THREADS,
        help=f"Thread count for host-side parallel stages [{DEFAULT_THREADS}]",
    )
    general.add_argument(
        "--norefcheck",
        help="Do not verify that input files agree on contig identifiers [False]",
        action="store_true",
    )
    general.add_argument(
        "--cuda",
        help="Accepted for compatibility: the port always runs on the CUDA card",
        action="store_true",
    )
    general.add_argument(
        "--seed",
        metavar="",
        type=int,
        default=int.from_bytes(os.urandom(7), "little"),
        help="Seed for all random streams",
    )
    general.add_argument(
        "--profile", action="store_true",
        help="Write a torch.profiler trace of the run under <outdir>/profile",
    )
    dist = subparser.add_argument_group(title="Multi-process (several cards or hosts)")
    dist.add_argument(
        "--dist",
        help="Join torch.distributed from torchrun's environment (RANK, WORLD_SIZE, "
        "MASTER_ADDR, MASTER_PORT, LOCAL_RANK); launch with torchrun [False]",
        action="store_true",
    )
    dist.add_argument(
        "--coordinator",
        metavar="",
        type=str,
        default=None,
        help="Coordinator address host:port (explicit multi-process launch; "
        "requires --nprocs and --procid)",
    )
    dist.add_argument(
        "--nprocs",
        metavar="",
        type=int,
        default=None,
        help="Total number of processes in the explicit multi-process launch",
    )
    dist.add_argument(
        "--procid",
        metavar="",
        type=int,
        default=None,
        help="This process's id (0-based) in the explicit launch",
    )
    return subparser


def add_composition_arguments(subparser):
    tnfos = subparser.add_argument_group(title="Composition input")
    tnfos.add_argument("--fasta", metavar="", type=Path, help="Contig catalogue as FASTA (optionally gzip/bzip2/xz)")
    tnfos.add_argument(
        "--composition", metavar="", type=Path, help="Reuse a composition.npz from a previous run"
    )
    return subparser


def add_abundance_arguments(subparser):
    abundanceos = subparser.add_argument_group(title="Abundance input")
    abundanceos.add_argument(
        "--bamfiles", dest="bampaths", metavar="", type=Path,
        help=argparse.SUPPRESS, nargs="+",
    )
    abundanceos.add_argument(
        "--bamdir", metavar="", type=Path,
        help="Directory of BAM files mapped against the contig catalogue",
    )
    abundanceos.add_argument(
        "--abundance_tsv",
        metavar="",
        type=Path,
        help='Precomputed abundance TSV; header must read "contigname(\\t<samplename>)*"',
    )
    abundanceos.add_argument(
        "--abundance",
        metavar="",
        dest="abundancepath",
        type=Path,
        help="Reuse an abundance.npz from a previous run",
    )
    abundanceos.add_argument(
        "-z", dest="min_alignment_id", metavar="", type=float, default=None,
        help=argparse.SUPPRESS,
    )
    return subparser


def add_bin_output_arguments(subparser):
    bin_os = subparser.add_argument_group(title="Bin output options")
    bin_os.add_argument(
        "--minfasta",
        dest="min_fasta_output_size",
        metavar="",
        type=int,
        default=None,
        help="Write bins of at least this many bp as FASTA [None = skip FASTA output]",
    )
    bin_os.add_argument(
        "--compress",
        dest="compress_fasta_output",
        help="gzip the emitted bin FASTAs (.fna.gz)",
        action="store_true",
    )
    bin_os.add_argument(
        "-o",
        dest="binsplit_separator",
        metavar="",
        type=str,
        default=None,
        const="",
        nargs="?",
        help="Separator for splitting bins by sample of origin [C when present; '' disables]",
    )
    return subparser


def add_vae_arguments(subparser):
    vaeos = subparser.add_argument_group(title="VAE options")
    vaeos.add_argument("-n", dest="nhiddens", metavar="", type=int, nargs="+",
                       default=None, help=argparse.SUPPRESS)
    vaeos.add_argument("-l", dest="nlatent", metavar="", type=int, default=32,
                       help=argparse.SUPPRESS)
    vaeos.add_argument("-a", dest="alpha", metavar="", type=float, default=None,
                       help=argparse.SUPPRESS)
    vaeos.add_argument("-b", dest="beta", metavar="", type=float, default=200.0,
                       help=argparse.SUPPRESS)
    vaeos.add_argument("-d", dest="dropout", metavar="", type=float, default=None,
                       help=argparse.SUPPRESS)
    vaeos.add_argument("--precision", metavar="", type=str, default="f32",
                       choices=("f32", "bf16"), help=argparse.SUPPRESS)
    trainos = subparser.add_argument_group(title="Training options")
    trainos.add_argument("-e", dest="nepochs", metavar="", type=int, default=300,
                         help=argparse.SUPPRESS)
    trainos.add_argument("-t", dest="batchsize", metavar="", type=int, default=256,
                         help=argparse.SUPPRESS)
    trainos.add_argument("-q", dest="batchsteps", metavar="", type=int, nargs="*",
                         default=[25, 75, 150, 225], help=argparse.SUPPRESS)
    trainos.add_argument("-r", dest="lrate", metavar="", type=float, default=None,
                         help=argparse.SUPPRESS)
    return subparser


def add_clustering_arguments(subparser):
    clusto = subparser.add_argument_group(title="Clustering options")
    clusto.add_argument("-w", dest="window_size", metavar="", type=int, default=300,
                        help=argparse.SUPPRESS)
    clusto.add_argument("-u", dest="min_successes", metavar="", type=int, default=15,
                        help=argparse.SUPPRESS)
    clusto.add_argument("-c", dest="max_clusters", metavar="", type=int, default=None,
                        help=argparse.SUPPRESS)
    clusto.add_argument("--distance_dtype", metavar="", type=str, default="float32",
                        choices=["float32", "bfloat16"], help=argparse.SUPPRESS)
    clusto.add_argument("--wander_kernel", metavar="", type=str, default="auto",
                        choices=["auto", "pallas", "xla"], help=argparse.SUPPRESS)
    clusto.add_argument("--wander_scope", metavar="", type=str, default="auto",
                        choices=["auto", "subset", "full"], help=argparse.SUPPRESS)
    return subparser


def add_aae_arguments(subparser):
    "The AAE's flags (`bin avamb`)."
    aaeos = subparser.add_argument_group(title="AAE options")
    for flag, dest, kind, default in (
        ("--n_aae", "nhiddens_aae", int, 547),
        ("--z_aae", "nlatent_aae_z", int, 283),
        ("--y_aae", "nlatent_aae_y", int, 700),
        ("--sl_aae", "sl", float, 0.00964),
        ("--slr_aae", "slr", float, 0.5),
        ("--aae_temp", "temp", float, 0.1596),
        ("--e_aae", "nepochs_aae", int, 70),
        ("--t_aae", "batchsize_aae", int, 256),
    ):
        aaeos.add_argument(flag, dest=dest, metavar="", type=kind, default=default,
                           help=argparse.SUPPRESS)
    aaeos.add_argument("--q_aae", dest="batchsteps_aae", metavar="", type=int, nargs="*",
                       default=[25, 50], help=argparse.SUPPRESS)
    return subparser


def add_ensemble_arguments(ensemble_parser):
    "`avamb_ensemble`'s flags (vamb_tpu/__main__.py:699-770)."
    add_general_arguments(ensemble_parser)
    add_composition_arguments(ensemble_parser)
    ens = ensemble_parser.add_argument_group(title="Ensemble input/output")
    ens.add_argument(
        "--clusters", metavar="", type=Path, nargs="+",
        help="Paths to cluster TSV files (bin names must be unique across files)",
    )
    ens.add_argument(
        "--quality_report", metavar="", type=Path,
        help="CheckM2 quality_report.tsv covering every input bin",
    )
    ens.add_argument(
        "--markers", metavar="", type=Path,
        help="Marker .npz file for native bin scoring (alternative to --quality_report)",
    )
    ens.add_argument(
        "--hmm_path", metavar="", type=Path,
        help="Marker-gene .hmm profiles: predict markers from the FASTA input, "
        "then score bins natively",
    )
    ens.add_argument(
        "--write_bins", action="store_true",
        help="Also write per-sample FASTA files and a quality_report.tsv for the "
        "final bins (requires --fasta input)",
    )
    ens.add_argument(
        "--compress", dest="compress_fasta_output", action="store_true",
        help="Compress written bin FASTAs to .fna.gz",
    )
    ens.add_argument(
        "-o", dest="binsplit_separator", metavar="", type=str, default=None, const="",
        nargs="?",
        help="Sample separator for per-sample bin folders [C if present] "
        "(pass empty string to disable)",
    )
    ens.add_argument("--min_completeness", metavar="", type=float, default=0.9,
                     help="Min completeness (0-1) to keep a bin [0.9]")
    ens.add_argument("--max_contamination", metavar="", type=float, default=0.05,
                     help="Max contamination (0-) to keep a bin [0.05]")
    ens.add_argument("--min_cov", metavar="", type=float, default=0.75,
                     help="Overlap fraction of the smaller bin at which two bins are "
                     "duplicates [0.75]")
    ens.add_argument("--min_bin_size", metavar="", type=int, default=200_000,
                     help="Min bin size in bp to enter dereplication [200000]")
    return ensemble_parser


def _maybe_init_distributed(args, device="cuda") -> None:
    """Join the run's process group before any work (vamb_tpu/__main__.py:
    144-177): `--dist` from torchrun's environment, or the explicit triple
    `--coordinator/--nprocs/--procid`. A partial triple exits at once: a
    forgotten --nprocs would otherwise run N independent single-process
    pipelines that clobber each other's outputs in the shared --outdir.
    Every process then runs the same pipeline, `pipeline.default_mesh`
    spans them, and `run()` gates output writing on process 0."""
    nprocs = getattr(args, "nprocs", None)
    auto = getattr(args, "dist", False)
    procid = getattr(args, "procid", None)
    coordinator = getattr(args, "coordinator", None)
    if not auto and nprocs is None:
        if procid is not None or coordinator is not None:
            raise SystemExit(
                "--procid/--coordinator require --nprocs (explicit "
                "multi-process launch) or --dist (auto-detection)"
            )
        return
    if nprocs is not None and procid is None:
        raise SystemExit("--nprocs requires --procid (and usually --coordinator)")
    if nprocs is not None and nprocs > 1 and coordinator is None:
        raise SystemExit("--nprocs above 1 requires --coordinator")

    from .parallel import distributed_init

    distributed_init(
        coordinator_address=coordinator,
        num_processes=nprocs,
        process_id=procid,
        auto=auto and nprocs is None,
        device=device,
    )


def add_taxonomy_arguments(subparser, taxonomy_only=False):
    taxonomys = subparser.add_argument_group(title="Taxonomy input")
    taxonomys.add_argument(
        "--taxonomy", metavar="", type=Path, help="Taxonomy TSV (contigs + predictions[ + scores])"
    )
    if not taxonomy_only:
        taxonomys.add_argument(
            "--no_predictor",
            help="Use the taxonomy as given instead of refining it with Taxometer first [False]",
            action="store_true",
        )
    return subparser


def add_predictor_arguments(subparser):
    "Taxometer's training flags."
    pred_trainos = subparser.add_argument_group(
        title="Training options for the taxonomy predictor"
    )
    pred_trainos.add_argument("-pe", dest="pred_nepochs", metavar="", type=int, default=100,
                              help=argparse.SUPPRESS)
    pred_trainos.add_argument("-pt", dest="pred_batchsize", metavar="", type=int, default=1024,
                              help=argparse.SUPPRESS)
    pred_trainos.add_argument("-pthr", dest="pred_softmax_threshold", metavar="", type=float,
                              default=0.5, help=argparse.SUPPRESS)
    pred_trainos.add_argument("-ploss", dest="ploss", metavar="", type=str,
                              choices=["flat_softmax", "cond_softmax", "soft_margin"],
                              default="flat_softmax", help=argparse.SUPPRESS)
    return subparser


def add_recluster_arguments(recluster_parser):
    add_general_arguments(recluster_parser)
    add_composition_arguments(recluster_parser)
    add_abundance_arguments(recluster_parser)
    marker_s = recluster_parser.add_argument_group(title="Marker gene input")
    marker_s.add_argument(
        "--markers", metavar="", type=Path, help="Reuse a markers.npz from a previous run"
    )
    marker_s.add_argument(
        "--hmm_path", metavar="", type=Path,
        help="HMMER3 .hmm profile database of single-copy marker genes",
    )
    add_bin_output_arguments(recluster_parser)
    reclusters = recluster_parser.add_argument_group(title="K-means reclustering arguments")
    reclusters.add_argument(
        "--latent_path", metavar="", type=Path, help="latent.npz emitted by a previous bin run",
    )
    reclusters.add_argument(
        "--clusters_path", metavar="", type=Path, help="Cluster TSV emitted by a previous bin run",
    )
    reclusters.add_argument(
        "--algorithm", metavar="", type=str, default="kmeans", choices=["kmeans", "dbscan"],
        help="Refinement algorithm: 'kmeans' or 'dbscan' [kmeans]",
    )
    add_predictor_arguments(recluster_parser)
    add_taxonomy_arguments(recluster_parser)
    return recluster_parser


def _general_options_from_args(args, device):
    from .pipeline import GeneralOptions

    return GeneralOptions(
        outdir=args.outdir,
        min_contig_length=args.minlength,
        nthreads=args.nthreads,
        refcheck=not args.norefcheck,
        seed=args.seed,
        device=device,
        profile=args.profile,
    )


def _abundance_options_from_args(args):
    from .pipeline import AbundanceOptions

    bampaths = args.bampaths
    if args.bamdir is not None:
        if bampaths is not None:
            raise ValueError("Cannot pass both --bamfiles and --bamdir")
        bampaths = sorted(args.bamdir.glob("*.bam"))
        if not bampaths:
            raise ValueError(f"No .bam files found in {args.bamdir}")
    minid = args.min_alignment_id
    if minid is not None and bampaths is None:
        raise ValueError("If minid is set, abundance must be computed from bam files")
    return AbundanceOptions(
        bampaths=bampaths,
        abundance_tsv=args.abundance_tsv,
        abundancepath=args.abundancepath,
        min_alignment_id=0.0 if minid is None else minid,
    )


def _output_options_from_args(args):
    from .pipeline import BinOutputOptions
    from .utils import BinSplitter

    return BinOutputOptions(
        binsplitter=BinSplitter(args.binsplit_separator),
        min_fasta_output_size=args.min_fasta_output_size,
        compress_fasta_output=args.compress_fasta_output,
    )


def _taxometer_options_from_args(args):
    from .pipeline import TaxometerOptions

    return TaxometerOptions(
        taxonomy_path=args.taxonomy,
        nepochs=args.pred_nepochs,
        batchsize=args.pred_batchsize,
        softmax_threshold=args.pred_softmax_threshold,
        ploss=args.ploss,
    )


def _taxometer_run_options_from_args(args, device):
    from .pipeline import CompositionOptions, TaxometerRunOptions

    if args.taxonomy is None:
        raise ValueError(f"{args.subcommand} requires --taxonomy")
    return TaxometerRunOptions(
        general=_general_options_from_args(args, device),
        comp=CompositionOptions(fasta=args.fasta, composition=args.composition),
        abundance=_abundance_options_from_args(args),
        taxometer=_taxometer_options_from_args(args),
    )


def _recluster_options_from_args(args, device):
    from .pipeline import CompositionOptions, MarkerOptions, ReclusteringOptions

    abundance = None
    try:
        abundance = _abundance_options_from_args(args)
    except ValueError:
        pass  # abundance only needed for dbscan-with-predictor
    taxometer = None
    if args.taxonomy is not None and not args.no_predictor:
        taxometer = _taxometer_options_from_args(args)
    return ReclusteringOptions(
        general=_general_options_from_args(args, device),
        comp=CompositionOptions(fasta=args.fasta, composition=args.composition),
        markers=MarkerOptions(
            markers_path=args.markers, hmm_path=args.hmm_path, fasta_path=args.fasta
        ),
        output=_output_options_from_args(args),
        latent_path=args.latent_path,
        algorithm=args.algorithm,
        clusters_path=args.clusters_path,
        taxonomy_path=args.taxonomy,
        no_predictor=args.no_predictor,
        abundance=abundance,
        taxometer=taxometer,
    )


def _ensemble_runner(args, device):
    """`avamb_ensemble` (vamb_tpu/__main__.py:934-1005): the composition's
    contigs, bin qualities from a CheckM2 report or from marker genes, and
    the merged, disjoint bins in `ensemble_clusters.tsv`."""
    from .avamb_ensemble import run_ensemble_files
    from .pipeline import CompositionOptions, MarkerOptions, calc_tnf, load_markers
    from .utils import BinSplitter

    if not args.clusters:
        raise ValueError("avamb_ensemble requires --clusters")
    if args.quality_report is None and args.markers is None and args.hmm_path is None:
        raise ValueError(
            "avamb_ensemble requires a bin quality source: "
            "--quality_report, --markers, or --hmm_path"
        )
    general = _general_options_from_args(args, device)
    comp_options = CompositionOptions(fasta=args.fasta, composition=args.composition)

    def run_ensemble():
        composition = calc_tnf(
            comp_options, args.minlength, general.outdir, BinSplitter.inert_splitter()
        )
        identifiers = list(composition.metadata.identifiers)
        markers = None
        if args.quality_report is None:
            markers = load_markers(
                MarkerOptions(markers_path=args.markers, hmm_path=args.hmm_path,
                              fasta_path=comp_options.fasta),
                composition.metadata, general.outdir, general.nthreads, device=device,
            )
        nc_outdir = fasta_out = separator = None
        if args.write_bins:
            if comp_options.fasta is None:
                raise ValueError("--write_bins requires the composition to be given as --fasta")
            nc_outdir, fasta_out = general.outdir, comp_options.fasta
            splitter = BinSplitter(args.binsplit_separator)
            splitter.initialize(identifiers)
            separator = splitter.splitter
        run_ensemble_files(
            general.outdir.joinpath("ensemble_clusters.tsv"),
            args.clusters,
            args.quality_report,
            identifiers,
            composition.metadata.lengths,
            min_completeness=args.min_completeness,
            max_contamination=args.max_contamination,
            min_cov=args.min_cov,
            min_bin_size=args.min_bin_size,
            markers=markers,
            nc_outdir=nc_outdir,
            separator=separator,
            fasta_path=fasta_out,
            compress=args.compress_fasta_output,
        )

    return run_ensemble, general


def _options_from_args(args, device):
    "BinDefaultOptions; BinTaxVambOptions or BinAvambOptions for those models."
    from .pipeline import (
        AAEOptions,
        BinAvambOptions,
        BinDefaultOptions,
        BinTaxVambOptions,
        ClusterOptions,
        CompositionOptions,
        VAEOptions,
    )

    if args.lrate is not None:
        raise ValueError(
            "The -r/--lrate flag is accepted for compatibility but has no "
            "effect: training uses the learning-rate-free D-Adaptation Adam"
        )
    common = dict(
        general=_general_options_from_args(args, device),
        comp=CompositionOptions(fasta=args.fasta, composition=args.composition),
        abundance=_abundance_options_from_args(args),
        vae=VAEOptions(
            nhiddens=args.nhiddens,
            nlatent=args.nlatent,
            alpha=args.alpha,
            beta=args.beta,
            dropout=args.dropout,
            nepochs=args.nepochs,
            batchsize=args.batchsize,
            batchsteps=list(args.batchsteps),
            precision=args.precision,
        ),
        clustering=ClusterOptions(
            window_size=args.window_size,
            min_successes=args.min_successes,
            max_clusters=args.max_clusters,
            distance_dtype=args.distance_dtype,
            wander_kernel=args.wander_kernel,
            wander_scope=args.wander_scope,
        ),
        output=_output_options_from_args(args),
    )
    if args.model_subcommand == "avamb":
        return BinAvambOptions(
            **common,
            aae=AAEOptions(
                nhiddens=args.nhiddens_aae,
                nlatent_z=args.nlatent_aae_z,
                nlatent_y=args.nlatent_aae_y,
                sl=args.sl,
                slr=args.slr,
                temp=args.temp,
                nepochs=args.nepochs_aae,
                batchsize=args.batchsize_aae,
                batchsteps=list(args.batchsteps_aae),
            ),
        )
    if args.model_subcommand != "taxvamb":
        return BinDefaultOptions(**common)
    if args.taxonomy is None:
        raise ValueError("bin taxvamb requires --taxonomy")
    return BinTaxVambOptions(
        **common,
        taxonomy_path=args.taxonomy,
        no_predictor=args.no_predictor,
        taxometer=None if args.no_predictor else _taxometer_options_from_args(args),
        ploss=args.ploss,
    )


def run(runner, general) -> None:
    """Create outdir, set up logging, run with timing (reference :702-715).

    Multi-process runs are SPMD: every process runs the same pipeline (its
    collectives need every rank), so their outputs would be copies. Only
    process 0's land in the user's outdir; another process writes into
    `<outdir>/.proc<i>`, which is removed on success."""
    from . import __version__
    from .log import logger, setup_logging
    from .parallel import process_info

    begintime = time.time()
    proc_id, nprocs = process_info()
    scratch_outdir = None
    if proc_id != 0:
        scratch_outdir = general.outdir / f".proc{proc_id}"
        general.outdir = scratch_outdir
    general.outdir.mkdir(parents=True, exist_ok=True)
    setup_logging(general.outdir)
    logger.info(f"Starting vamb_torch version {__version__}")
    logger.info("Random seed is " + str(general.seed))
    logger.info(f"Invoked with CLI args: '{' '.join(sys.argv)}'")
    logger.info(f"Device: {general.device}")
    if nprocs > 1:
        logger.info(f"Multi-process: process {proc_id} of {nprocs}")
    if general.profile:
        from torch.profiler import ProfilerActivity, profile

        trace_dir = general.outdir / "profile"
        logger.info(f"Writing a torch.profiler trace to {trace_dir}")
        activities = [ProfilerActivity.CPU]
        if general.device.startswith("cuda"):
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            runner()
        trace_dir.mkdir(exist_ok=True)
        prof.export_chrome_trace(str(trace_dir / "trace.json"))
    else:
        runner()
    elapsed = round(time.time() - begintime, 2)
    logger.info(f"Completed vamb_torch in {elapsed} seconds.")
    if scratch_outdir is not None:
        import shutil

        shutil.rmtree(scratch_outdir, ignore_errors=True)


def main(argv=None, device="cuda") -> None:
    """Run the CLI on `argv` (default: sys.argv[1:]) on `device`."""
    doc = """vamb_torch — metagenomic binning on a CUDA GPU (PyTorch port of vamb_tpu).

    Default use, good for most datasets:
    vamb_torch bin default --outdir out --fasta my_contigs.fna --abundance_tsv abundance.tsv"""
    parser = argparse.ArgumentParser(
        prog="vamb_torch",
        description=doc,
        formatter_class=argparse.RawDescriptionHelpFormatter,
        add_help=False,
    )
    add_help_arguments(parser)

    args_in = sys.argv[1:] if argv is None else list(argv)
    if len(args_in) == 0:
        parser.print_help()
        sys.exit()

    subparsers = parser.add_subparsers(dest="subcommand")
    bin_parser = subparsers.add_parser(
        "bin", help="Train a model and cluster its latent space into bins", add_help=False
    )
    add_help_arguments(bin_parser)
    subparsers_model = bin_parser.add_subparsers(dest="model_subcommand")
    vae_parser = subparsers_model.add_parser(
        "default",
        formatter_class=argparse.RawDescriptionHelpFormatter,
        help="composition+abundance VAE binner (the flagship path)",
        add_help=False,
        usage="%(prog)s [options]",
        description="""The default binner: a VAE embeds each contig's TNF composition and
per-sample abundance into a latent space, which the medoid engine clusters into bins.

Requires --outdir, one composition input and one abundance input.""",
    )
    add_general_arguments(vae_parser)
    add_composition_arguments(vae_parser)
    add_abundance_arguments(vae_parser)
    add_bin_output_arguments(vae_parser)
    add_vae_arguments(vae_parser)
    add_clustering_arguments(vae_parser)
    recluster_parser = subparsers.add_parser(
        "recluster",
        formatter_class=argparse.RawDescriptionHelpFormatter,
        help="marker-gene-guided refinement of an existing binning",
        add_help=False,
        usage="%(prog)s [options]",
        description="""Refine an existing binning using single-copy marker genes: split bins with
duplicated markers via seeded K-means, or re-cluster per genus via DBSCAN.

Required arguments:
  K-means algorithm: Outdir, at least one composition input, at least one marker gene input,
    latent path and clusters path
  DBScan algorithm: also requires a taxonomy input""",
    )
    add_recluster_arguments(recluster_parser)
    vaevae_parser = subparsers_model.add_parser(
        "taxvamb",
        formatter_class=argparse.RawDescriptionHelpFormatter,
        help="semi-supervised bi-modal VAE binner guided by taxonomy",
        add_help=False,
        usage="%(prog)s [options]",
        description="""TaxVamb: a semi-supervised bi-modal VAE trained on composition, abundance
and (possibly Taxometer-refined) taxonomy labels; the joint latent space is clustered into bins.

Requires --outdir, --taxonomy, one composition input and one abundance input.""",
    )
    add_general_arguments(vaevae_parser)
    add_composition_arguments(vaevae_parser)
    add_abundance_arguments(vaevae_parser)
    add_taxonomy_arguments(vaevae_parser)
    add_bin_output_arguments(vaevae_parser)
    add_vae_arguments(vaevae_parser)
    add_clustering_arguments(vaevae_parser)
    add_predictor_arguments(vaevae_parser)
    aae_parser = subparsers_model.add_parser(
        "avamb",
        formatter_class=argparse.RawDescriptionHelpFormatter,
        help="adversarial autoencoder binner (Avamb)",
        add_help=False,
        usage="%(prog)s [options]",
        description="""Avamb: an adversarial autoencoder embeds each contig into a continuous z
latent, which the medoid engine clusters into bins (aae_z_clusters_*), and a
categorical y latent, whose argmax gives a second binning (aae_y_clusters_*).

Requires --outdir, one composition input and one abundance input.""",
    )
    add_general_arguments(aae_parser)
    add_composition_arguments(aae_parser)
    add_abundance_arguments(aae_parser)
    add_bin_output_arguments(aae_parser)
    add_vae_arguments(aae_parser)
    add_aae_arguments(aae_parser)
    add_clustering_arguments(aae_parser)
    ensemble_parser = subparsers.add_parser(
        "avamb_ensemble",
        formatter_class=argparse.RawDescriptionHelpFormatter,
        help="merge CheckM2-scored binnings into one non-overlapping bin set",
        add_help=False,
        usage="%(prog)s [options]",
        description="""Merge several binnings (e.g. Avamb's vae/z/y cluster files) into one
non-redundant, non-overlapping bin set: quality filtering, score-based
dereplication of near-duplicate bins, and overlap ripping. Bin qualities come
from a CheckM2 quality_report.tsv, or from single-copy marker genes
(--markers / --hmm_path).

Required arguments: outdir, a composition input, >=1 cluster TSVs, and one
quality source (--quality_report, --markers, or --hmm_path).""",
    )
    add_ensemble_arguments(ensemble_parser)
    for name, help_text, description in (
        (
            "taxometer",
            "refine classifier taxonomy with composition+abundance signal",
            "Taxometer: train a predictor on composition+abundance features to refine\n"
            "(and score) the taxonomy assigned by any upstream classifier.",
        ),
        (
            "taxonomy_benchmark",
            "k-fold benchmark of taxonomy prediction quality",
            "k-fold cross-validated benchmark of taxonomy prediction quality on this dataset.",
        ),
    ):
        tax_parser = subparsers.add_parser(
            name,
            formatter_class=argparse.RawDescriptionHelpFormatter,
            help=help_text,
            add_help=False,
            usage="%(prog)s [options]",
            description=description + "\n\nRequires --outdir, --taxonomy, one composition "
            "input and one abundance input.",
        )
        add_general_arguments(tax_parser)
        add_composition_arguments(tax_parser)
        add_abundance_arguments(tax_parser)
        add_taxonomy_arguments(tax_parser, taxonomy_only=True)
        add_predictor_arguments(tax_parser)
    args, extra = parser.parse_known_args(args_in)
    if args.subcommand == "bin" and args.model_subcommand is None:
        bin_parser.print_help()
        sys.exit(1)
    command = (args.subcommand,) if args.subcommand != "bin" else ("bin", args.model_subcommand)
    if extra:
        parser.error(f"unrecognized arguments: {' '.join(extra)}")

    from . import pipeline
    from .device import resolve_device

    device = str(resolve_device(device))
    had_group = _group_up()
    _maybe_init_distributed(args, device)
    joined = _group_up() and not had_group
    try:
        _dispatch(command, args, pipeline.process_device(device))
    finally:
        if joined:  # a group this call initialised goes with it, whatever its size
            from .parallel import distributed_close

            distributed_close()


def _group_up() -> bool:
    "Whether this process is in a torch.distributed process group."
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def _dispatch(command: tuple, args, device: str) -> None:
    "Run the subcommand `command` with its parsed `args` on `device`."
    from . import pipeline

    if command == ("recluster",):
        opt = _recluster_options_from_args(args, device)
        runner = pipeline.run_reclustering
    elif command == ("taxometer",):
        opt = _taxometer_run_options_from_args(args, device)
        runner = pipeline.run_taxonomy_predictor
    elif command == ("taxonomy_benchmark",):
        opt = _taxometer_run_options_from_args(args, device)
        runner = pipeline.run_taxonomy_cross_validation
    elif command == ("avamb_ensemble",):
        run(*_ensemble_runner(args, device))
        return
    else:
        opt = _options_from_args(args, device)
        runner = {("bin", "taxvamb"): pipeline.run_vaevae,
                  ("bin", "avamb"): pipeline.run_bin_aae}.get(command, pipeline.run_bin_default)
    run(partial(runner, opt), opt.general)


if __name__ == "__main__":
    main()
