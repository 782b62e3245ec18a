"""Command-line interface of the PyTorch/CUDA port.

Mirrors `vamb_tpu`'s CLI (itself the reference's, vamb/__main__.py) for the
subcommands this port runs so far, `bin default`, `bin taxvamb`,
`taxometer`, `taxonomy_benchmark` and `recluster`, with the same flag names
and defaults:

    python -m vamb_torch bin default --outdir out --fasta contigs.fna \\
        --bamfiles s1.bam s2.bam
    python -m vamb_torch taxometer --outdir tm --fasta contigs.fna \\
        --abundance_tsv ab.tsv --taxonomy taxonomy.tsv
    python -m vamb_torch bin taxvamb --outdir tv --fasta contigs.fna \\
        --abundance_tsv ab.tsv --taxonomy tm/results_taxometer.tsv
    python -m vamb_torch recluster --outdir re --fasta contigs.fna \\
        --hmm_path markers.hmm --latent_path out/latent.npz \\
        --clusters_path out/vae_clusters_unsplit.tsv

It runs on the CUDA card. `main(argv, device="cpu")` runs the same path on
the CPU (the tests do). The other subcommands and the flags of paths not
ported yet are accepted by the parser and fail with the ROADMAP item
that will port them.
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

# subcommands of vamb_tpu this port does not run yet -> their ROADMAP item
_UNPORTED = {
    ("bin", "avamb"): "ROADMAP queue 1, item 9 (bin avamb)",
    ("avamb_ensemble",): "ROADMAP queue 1, item 9 (avamb_ensemble)",
}


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
        "--profile", action="store_true", help=argparse.SUPPRESS,
    )
    for flag in ("--dist",):
        general.add_argument(flag, action="store_true", help=argparse.SUPPRESS)
    for flag in ("--coordinator", "--nprocs", "--procid"):
        general.add_argument(flag, metavar="", default=None, help=argparse.SUPPRESS)
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


def _reject_unported_general(args) -> None:
    if args.profile:
        raise NotImplementedError(
            "--profile is not ported yet (ROADMAP queue 1, item 5: --profile); "
            "chip_smoke.py times the card"
        )
    if args.dist or args.coordinator or args.nprocs or args.procid:
        raise NotImplementedError(
            "multi-process runs are not ported yet (ROADMAP queue 1, item 10: "
            "multi-device)"
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


def _options_from_args(args, device):
    "BinDefaultOptions, or BinTaxVambOptions for `bin taxvamb`."
    from .pipeline import (
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
    "Create outdir, set up logging, run with timing (reference :702-715)."
    from . import __version__
    from .log import logger, setup_logging

    begintime = time.time()
    general.outdir.mkdir(parents=True, exist_ok=True)
    setup_logging(general.outdir)
    logger.info(f"Starting vamb_torch version {__version__}")
    logger.info("Random seed is " + str(general.seed))
    logger.info(f"Invoked with CLI args: '{' '.join(sys.argv)}'")
    logger.info(f"Device: {general.device}")
    runner()
    elapsed = round(time.time() - begintime, 2)
    logger.info(f"Completed vamb_torch in {elapsed} seconds.")


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
    for names in _UNPORTED:
        sub = subparsers_model if names[0] == "bin" else subparsers
        sub.add_parser(names[-1], help="not ported yet", add_help=False)

    args, extra = parser.parse_known_args(args_in)
    if args.subcommand == "bin" and args.model_subcommand is None:
        bin_parser.print_help()
        sys.exit(1)
    command = (args.subcommand,) if args.subcommand != "bin" else ("bin", args.model_subcommand)
    if command in _UNPORTED:
        raise NotImplementedError(
            f"`{' '.join(command)}` is not ported to vamb_torch yet: {_UNPORTED[command]}"
        )
    if extra:
        parser.error(f"unrecognized arguments: {' '.join(extra)}")

    from . import pipeline
    from .device import resolve_device

    _reject_unported_general(args)
    device = str(resolve_device(device))
    if command == ("recluster",):
        opt = _recluster_options_from_args(args, device)
        runner = pipeline.run_reclustering
    elif command == ("taxometer",):
        opt = _taxometer_run_options_from_args(args, device)
        runner = pipeline.run_taxonomy_predictor
    elif command == ("taxonomy_benchmark",):
        opt = _taxometer_run_options_from_args(args, device)
        runner = pipeline.run_taxonomy_cross_validation
    else:
        opt = _options_from_args(args, device)
        runner = pipeline.run_vaevae if command == ("bin", "taxvamb") else pipeline.run_bin_default
    run(partial(runner, opt), opt.general)


if __name__ == "__main__":
    main()
