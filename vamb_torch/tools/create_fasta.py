"""Extract per-bin FASTA files from a cluster TSV + the contig catalogue.

Role parity: the reference's src/create_fasta.py (its workflow uses this to
materialize candidate bins for CheckM2); the arguments of this repo's
src/create_fasta.py. Bins whose total length falls under `minsize` are
skipped before any sequence data is held, so memory stays proportional to
the kept bins.

    python -m vamb_torch.tools.create_fasta contigs.fna clusters.tsv MINSIZE outdir [--compress]
"""

import argparse
import sys
from pathlib import Path

from vamb_torch.utils import Reader, byte_iterfasta, read_clusters, write_bins


def bin_sizes(fastapath: str) -> dict:
    "Identifier -> sequence length, from a streaming first pass."
    sizes: dict = {}
    with Reader(fastapath) as file:
        for record in byte_iterfasta(file, fastapath):
            sizes[record.identifier] = len(record)
    return sizes


def main(argv) -> None:
    p = argparse.ArgumentParser(
        prog="python -m vamb_torch.tools.create_fasta",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("fastapath", help="Path to FASTA file")
    p.add_argument("clusterspath", help="Path to clusters.tsv")
    p.add_argument("minsize", help="Minimum size of bin in bp", type=int, default=0)
    p.add_argument("outdir", help="Directory to create")
    p.add_argument("--compress", action="store_true")
    if not argv:
        p.print_help()
        sys.exit()
    args = p.parse_args(argv)

    sizes = bin_sizes(args.fastapath)
    with open(args.clusterspath) as file:
        big_enough = [
            item for item in read_clusters(file).items()
            if sum(sizes[c] for c in item[1]) >= args.minsize
        ]
    with Reader(args.fastapath) as file:
        write_bins(Path(args.outdir), big_enough, file, args.compress, maxbins=None)


if __name__ == "__main__":
    main(sys.argv[1:])
