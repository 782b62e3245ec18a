// Native host-side ops for vamb_tpu, exposed via a C ABI for ctypes.
//
// Role parity: the reference's compiled PyPI dependency `vambcore`
// (Rust/PyO3; used at reference vamb/vambtools.py:8,444-447) provides k-mer
// counting on the hot FASTA-ingest path. This is an original C++
// implementation of the same contract, plus a batched variant that lets the
// Python layer amortize one FFI call over many contigs.
//
// Build: native/build.sh (g++ -O3 -march=native -shared -fPIC).

#include <cstddef>
#include <cstdint>
#include <cstring>

namespace {

// byte -> 2-bit code (A=0 C=1 G=2 T=3, case-insensitive), 0xFF = invalid.
// Any window containing an invalid byte (N, IUPAC codes, U, ...) contributes
// no count; encoding restarts past it.
struct Lut {
    uint8_t v[256];
    constexpr Lut() : v() {
        for (int i = 0; i < 256; ++i) v[i] = 0xFF;
        v['A'] = v['a'] = 0;
        v['C'] = v['c'] = 1;
        v['G'] = v['g'] = 2;
        v['T'] = v['t'] = 3;
    }
};
constexpr Lut kLut;

}  // namespace

extern "C" {

// Count 4-mers of `seq` (length n) into counts[256] (uint32, caller-zeroed).
// Rolling 2-bit window; a window is counted only when 4 consecutive valid
// bases have been seen (reference vambcore.kmercounts semantics).
void kmercounts4(const char* seq, size_t n, uint32_t* counts) {
    uint32_t kmer = 0;
    int countdown = 3;  // valid bases still needed before the window is full
    const uint8_t* s = reinterpret_cast<const uint8_t*>(seq);
    for (size_t i = 0; i < n; ++i) {
        uint8_t code = kLut.v[s[i]];
        if (code == 0xFF) {
            countdown = 3;
            kmer = 0;
            continue;
        }
        kmer = ((kmer << 2) | code) & 0xFF;
        if (countdown == 0) {
            ++counts[kmer];
        } else {
            --countdown;
        }
    }
}

// Batched variant: `nseq` sequences concatenated in `seqs`, with
// offsets[i]..offsets[i+1] delimiting sequence i (offsets has nseq+1
// entries). Writes counts into out[i*256 ...]. out must be zeroed.
void kmercounts4_batch(const char* seqs, const uint64_t* offsets, size_t nseq,
                       uint32_t* out) {
    for (size_t i = 0; i < nseq; ++i) {
        kmercounts4(seqs + offsets[i], offsets[i + 1] - offsets[i],
                    out + i * 256);
    }
}

}  // extern "C"
