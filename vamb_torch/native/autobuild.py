"""Best-effort on-demand build of the native host-side 4-mer counter.

A fresh checkout has only the C++ source; the shared object is built by
`native/build.sh` with the system C++ compiler. `utils.kmers` calls
`ensure_built()` before giving up when the `.so` is missing, so tests and
the CLI work out of the box on any machine with a toolchain. The build is
attempted at most once per process and never raises: without it the
numpy counter is used.
"""

import os
import subprocess

_ATTEMPTED = False


def ensure_built() -> None:
    "Run native/build.sh once if libvambops.so is missing."
    global _ATTEMPTED
    if _ATTEMPTED:
        return
    _ATTEMPTED = True
    here = os.path.dirname(os.path.abspath(__file__))
    if os.path.exists(os.path.join(here, "libvambops.so")):
        return
    script = os.path.join(here, "build.sh")
    try:
        subprocess.run(
            ["sh", script],
            check=False,
            timeout=120,
            stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL,
        )
    except (OSError, subprocess.TimeoutExpired):
        pass
