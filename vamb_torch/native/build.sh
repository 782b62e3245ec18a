#!/bin/sh
# Build the native host-side libraries next to this script: the 4-mer
# counter (libvambops.so) and the BAM coverage reader (libbamcov.so, needs
# zlib's header). `sh build.sh bamcov` builds only the latter.
set -e
cd "$(dirname "$0")"
targets="${*:-vambops bamcov}"
for target in $targets; do
    case "$target" in
        vambops) g++ -O3 -march=native -Wall -Wextra -shared -fPIC vambops.cpp -o "libvambops.so.$$" ;;
        bamcov) g++ -O3 -march=native -Wall -Wextra -shared -fPIC bamcov.cpp -lz -o "libbamcov.so.$$" ;;
        *) echo "unknown target $target" >&2; exit 2 ;;
    esac
    # renamed into place, so a process that loads it never sees half a file
    mv -f "lib$target.so.$$" "lib$target.so"
    echo "built $(pwd)/lib$target.so"
done
