"""Execute the Avamb workflow's stage graph on vamb_torch, without Snakemake or JAX.

The counterpart of workflow_avamb/run_local.py for the PyTorch/CUDA port:
the same config file, the same stages in the same order and the same
outputs, each stage run in this process through the port's entry points,
so nothing of JAX is needed (a machine with a CUDA card and no JAX runs
the whole workflow). The mapping stage accepts a precomputed BAM directory
(`--bamdir`, what minimap2+samtools would have produced) or synthesizes
coverage-realistic BAMs from the concatenated catalogue (`--mock-mapping`,
run_local.py's own `mock_mapping`, for tests; real runs should map reads
properly).

Stages (mirroring avamb.smk rule order):
  1. concatenate  — vamb_torch.tools.concatenate -> contigs.flt.fna.gz
  2. mapping      — external BAMs, or mocked
  3. binning      — vamb_torch bin avamb (z + y ensembles)
  4. ensemble     — vamb_torch avamb_ensemble (drep/rip/NC bins +
                    quality_report.tsv; native marker scoring via
                    --hmm_path, or --quality_report from CheckM2)

Usage:
  python workflow_avamb/run_local_torch.py --config workflow_avamb/config.json \\
      [--outdir DIR] [--epochs N] [--mock-mapping] [--bamdir DIR] [--device cuda|cpu]
"""

import argparse
import json
import os
import shutil
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
_REPO = os.path.dirname(_HERE)
sys.path.insert(0, _REPO)
sys.path.insert(0, _HERE)

from run_local import mock_mapping  # noqa: E402


def stage(name, fn, argv):
    print(f"[workflow] {name}: {' '.join(map(str, argv))}", file=sys.stderr)
    try:
        fn(list(map(str, argv)))
    except SystemExit as e:
        if e.code not in (None, 0):
            raise SystemExit(f"stage '{name}' failed: {e.code}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--outdir", default=None)
    ap.add_argument("--epochs", type=int, default=None,
                    help="override AAE epochs (appends --e_aae/--q_aae)")
    ap.add_argument("--mock-mapping", action="store_true")
    ap.add_argument("--bamdir", default=None,
                    help="use existing BAMs instead of mapping")
    ap.add_argument("--device", default="cuda",
                    help="the device the port runs on: cuda (default) or cpu")
    args = ap.parse_args(argv)

    from vamb_torch.__main__ import main as vamb_main
    from vamb_torch.tools import concatenate

    def vamb(argv):
        vamb_main(argv, device=args.device)

    with open(args.config) as f:
        cfg = json.load(f)
    outdir = args.outdir or cfg.get("outdir", "avamb_outdir")
    os.makedirs(outdir, exist_ok=True)
    min_contig = int(cfg.get("min_contig_size", 2000))
    min_bin = int(cfg.get("min_bin_size", 200_000))
    min_id = float(cfg.get("min_identity", 0.95))
    scoring = cfg.get("scoring", "native")

    # 1. concatenate
    with open(cfg["contigs"]) as f:
        sample_fastas = [ln.strip() for ln in f if ln.strip()]
    concat = os.path.join(outdir, "contigs.flt.fna.gz")
    if not os.path.exists(concat):
        stage("concatenate", concatenate.main, [concat, *sample_fastas, "-m", min_contig])

    # 2. mapping
    mapped = args.bamdir or os.path.join(outdir, "mapped")
    if args.bamdir is None:
        if not args.mock_mapping:
            raise SystemExit(
                "No --bamdir given: map reads with minimap2+samtools into "
                f"{mapped}/ (see avamb.smk), or pass --mock-mapping")
        if not os.path.isdir(mapped) or not os.listdir(mapped):
            mock_mapping(concat, len(sample_fastas), mapped)

    # 3. binning (AAE z + y ensembles)
    avamb_out = os.path.join(outdir, "avamb")
    z_clusters = os.path.join(avamb_out, "aae_z_clusters_unsplit.tsv")
    y_clusters = os.path.join(avamb_out, "aae_y_clusters_unsplit.tsv")
    if not os.path.exists(z_clusters):
        binning = ["bin", "avamb", "--outdir", avamb_out, "--fasta", concat,
                   "--bamdir", mapped, "-m", min_contig, "-z", min_id,
                   *str(cfg.get("avamb_params", "-o C --seed 0")).split()]
        if args.epochs:
            steps = [s for s in (25, 50) if s < args.epochs]
            binning += ["--e_aae", str(args.epochs), "--q_aae", *map(str, steps)]
        stage("binning", vamb, binning)

    # 4. ensemble decision + final outputs
    final = os.path.join(outdir, "Final_bins")
    quality = (["--quality_report", os.path.join(outdir, "checkm2_all.tsv")]
               if scoring == "checkm2"
               else ["--hmm_path", cfg["hmm_path"]])
    shutil.rmtree(final, ignore_errors=True)
    stage("ensemble", vamb, ["avamb_ensemble", "--outdir", final, "--fasta", concat,
                             "--clusters", z_clusters, y_clusters, *quality,
                             "--min_completeness", cfg.get("min_comp", 0.9),
                             "--max_contamination", cfg.get("max_cont", 0.05),
                             "--min_bin_size", min_bin, "--write_bins"])
    report = os.path.join(final, "quality_report.tsv")
    assert os.path.exists(report), report
    print(f"[workflow] complete: {report}", file=sys.stderr)


if __name__ == "__main__":
    main()
