"""Regenerate the 256->103 TNF projection kernel data asset.

See vamb_torch/ops/kernel.py for the method (Kislyuk et al., PMC2765972).
Note: a regenerated basis spans the same space as the vendored one but is
not bit-identical (null_space bases are unique only up to rotation), so
features projected with it are a rotation of the published tool's; the
shipped `vamb_torch/ops/tnf_kernel.npz` should only be replaced
deliberately.

    python -m vamb_torch.tools.create_kernel [OUTPATH]

OUTPATH defaults to the package's `vamb_torch/ops/tnf_kernel.npz`, as
src/create_kernel.py writes `vamb_tpu`'s.
"""

import argparse
import os
import sys

import numpy as np

from vamb_torch.ops.kernel import _KERNEL_PATH, create_dual_kernel


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        prog="python -m vamb_torch.tools.create_kernel",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("outpath", nargs="?", default=_KERNEL_PATH,
                   help="Path of the .npz to write [the package's tnf_kernel.npz]")
    args = p.parse_args(argv)
    path = os.path.abspath(args.outpath)
    np.savez_compressed(path, create_dual_kernel())
    print(f"Wrote kernel to {path}")


if __name__ == "__main__":
    main(sys.argv[1:])
