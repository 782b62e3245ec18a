#!/bin/sh
# Build the native 4-mer counter next to this script.
set -e
cd "$(dirname "$0")"
g++ -O3 -march=native -Wall -Wextra -shared -fPIC vambops.cpp -o libvambops.so
echo "built $(pwd)/libvambops.so"
