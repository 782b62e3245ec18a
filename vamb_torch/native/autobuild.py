"""On-demand build of the native host-side libraries.

A fresh checkout has only the C++ sources; `native/build.sh` builds the
shared objects with the system C++ compiler.

* `ensure_built()` builds the 4-mer counter (`libvambops.so`) at most once
  a process and never raises: without it `utils.kmers` counts in numpy.
* `build_bamcov()` builds the BAM coverage reader (`libbamcov.so`) when it
  is missing and raises with the compiler's message when the build fails
  (a missing zlib header, say): BAM input has no other reader.
"""

import os
import subprocess

_HERE = os.path.dirname(os.path.abspath(__file__))
_SCRIPT = os.path.join(_HERE, "build.sh")
_ATTEMPTED = False


def ensure_built() -> None:
    "Run native/build.sh once if libvambops.so is missing."
    global _ATTEMPTED
    if _ATTEMPTED:
        return
    _ATTEMPTED = True
    if os.path.exists(os.path.join(_HERE, "libvambops.so")):
        return
    try:
        subprocess.run(
            ["sh", _SCRIPT, "vambops"],
            check=False,
            timeout=120,
            stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL,
        )
    except (OSError, subprocess.TimeoutExpired):
        pass


def build_bamcov() -> str:
    "Path of libbamcov.so, built first if it is missing; raises if the build fails."
    path = os.path.join(_HERE, "libbamcov.so")
    if os.path.exists(path):
        return path
    proc = subprocess.run(
        ["sh", _SCRIPT, "bamcov"], capture_output=True, text=True, timeout=300
    )
    if proc.returncode != 0 or not os.path.exists(path):
        raise RuntimeError(
            f"building {path} from bamcov.cpp failed ({proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}"
        )
    return path
