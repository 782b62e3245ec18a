"""Build the multi-sample contig catalogue vamb_torch bins against.

Give it one assembly FASTA per sample; it writes a single (gzipped by
default) FASTA where each kept sequence is renamed `S{n}C{original}` so the
default binsplit separator 'C' recovers the sample of origin. Role parity:
the reference's src/concatenate.py; the arguments, defaults and errors of
this repo's src/concatenate.py.

    python -m vamb_torch.tools.concatenate out.fna.gz s1.fna s2.fna [-m 2000]
"""

import argparse
import gzip
import sys
from pathlib import Path

from vamb_torch.utils import concatenate_fasta


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m vamb_torch.tools.concatenate",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("outpath", help="Path to output FASTA file")
    p.add_argument("inpaths", help="Paths to input FASTA file(s)", nargs="+")
    p.add_argument(
        "-m", dest="minlength", metavar="", type=int, default=2000,
        help="Discard sequences below this length [2000]",
    )
    p.add_argument(
        "--keepnames", action="store_true",
        help="Do not rename sequences [False]",
    )
    p.add_argument(
        "--nozip", action="store_true", help="Do not gzip output [False]"
    )
    return p


def validated_output(raw: str) -> Path:
    out = Path(raw)
    if out.exists():
        raise FileExistsError(out)
    parent = out.resolve().parent
    if not parent.is_dir():
        raise NotADirectoryError(
            f"cannot create '{out}': '{parent}' is not an existing directory"
        )
    return out


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    missing = [p for p in args.inpaths if not Path(p).is_file()]
    if missing:
        raise FileNotFoundError(missing[0])
    out = validated_output(args.outpath)
    # level 1: DNA compresses easily, so this is nearly as small as level 9
    # at a fraction of the time
    opener = open(out, "w") if args.nozip else gzip.open(out, "wt", compresslevel=1)
    with opener as handle:
        concatenate_fasta(
            handle, args.inpaths,
            minlength=args.minlength,
            rename=not args.keepnames,
        )


if __name__ == "__main__":
    main(sys.argv[1:])
