// BAM coverage reader: per-contig trimmed-mean depth with min-identity filter.
//
// Role parity: the reference's `pycoverm` dependency (Rust bindings over
// CoverM, used at reference vamb/parsebam.py:195-237). This is an original,
// from-scratch C++ implementation of the pieces vamb needs:
//
//   * BGZF/gzip decompression via zlib (multi-member inflate; works on BGZF
//     since every BGZF block is a valid gzip member),
//   * BAM binary parsing (header + alignment records),
//   * per-contig pileup from M/=/X/D cigar ops of primary alignments,
//   * CoverM-style "trimmed_mean" summary: exclude `end_exclusion` bases at
//     each contig end, sort per-position depths, drop the lowest
//     `trim_lower` and highest `trim_upper` fraction of positions, and
//     average the rest (CoverM's --trim-min 10 --trim-max 90 defaults map
//     to trim_lower = trim_upper = 0.1),
//   * min-identity read filter: identity = 1 - NM / aligned_length where
//     aligned_length counts M/I/D/=/X ops; reads without an NM tag pass.
//
// Exposed through a C ABI for ctypes (see vamb_torch/bam.py). Thread-safety:
// each handle must be used by one thread; different handles are independent
// (the Python layer parallelizes across files).

#include <zlib.h>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <algorithm>
#include <memory>
#include <string>
#include <vector>

namespace {

constexpr size_t kInChunk = 1 << 16;
constexpr size_t kOutChunk = 1 << 20;

struct BamReader {
    FILE* file = nullptr;
    z_stream strm{};
    bool stream_ended = false;   // current gzip member finished
    bool file_ended = false;
    std::vector<uint8_t> inbuf;
    size_t in_pos = 0, in_len = 0;
    std::vector<uint8_t> out;    // decompressed, unconsumed bytes
    size_t out_pos = 0;

    // header info
    std::vector<std::string> ref_names;
    std::vector<uint32_t> ref_lens;
    std::string error;

    ~BamReader() {
        if (file) fclose(file);
        inflateEnd(&strm);
    }

    bool fail(const std::string& msg) {
        error = msg;
        return false;
    }

    // Decompress until at least `need` unconsumed bytes are available.
    // Returns false on EOF-before-need or error.
    bool ensure(size_t need) {
        while (out.size() - out_pos < need) {
            if (out_pos > (1 << 22)) {  // compact
                out.erase(out.begin(), out.begin() + out_pos);
                out_pos = 0;
            }
            if (in_pos == in_len) {
                if (file_ended) return false;
                in_len = fread(inbuf.data(), 1, kInChunk, file);
                in_pos = 0;
                if (in_len == 0) {
                    file_ended = true;
                    return out.size() - out_pos >= need;
                }
            }
            if (stream_ended) {
                if (inflateReset2(&strm, 15 + 32) != Z_OK)
                    return fail("inflateReset failed");
                stream_ended = false;
            }
            size_t old_size = out.size();
            out.resize(old_size + kOutChunk);
            strm.next_in = inbuf.data() + in_pos;
            strm.avail_in = static_cast<uInt>(in_len - in_pos);
            strm.next_out = out.data() + old_size;
            strm.avail_out = kOutChunk;
            int ret = inflate(&strm, Z_NO_FLUSH);
            if (ret != Z_OK && ret != Z_STREAM_END)
                return fail("inflate error on BAM stream");
            in_pos = in_len - strm.avail_in;
            out.resize(old_size + (kOutChunk - strm.avail_out));
            if (ret == Z_STREAM_END) stream_ended = true;
        }
        return true;
    }

    bool read_bytes(void* dst, size_t n) {
        if (!ensure(n)) return false;
        memcpy(dst, out.data() + out_pos, n);
        out_pos += n;
        return true;
    }

    bool skip_bytes(size_t n) {
        if (!ensure(n)) return false;
        out_pos += n;
        return true;
    }

    bool read_u32(uint32_t* v) { return read_bytes(v, 4); }
    bool read_i32(int32_t* v) { return read_bytes(v, 4); }

    bool open(const char* path) {
        file = fopen(path, "rb");
        if (!file) return fail(std::string("cannot open file: ") + path);
        inbuf.resize(kInChunk);
        strm.zalloc = Z_NULL;
        strm.zfree = Z_NULL;
        strm.opaque = Z_NULL;
        if (inflateInit2(&strm, 15 + 32) != Z_OK)
            return fail("inflateInit failed");
        return parse_header();
    }

    bool parse_header() {
        char magic[4];
        if (!read_bytes(magic, 4) || memcmp(magic, "BAM\1", 4) != 0)
            return fail("not a BAM file (bad magic)");
        int32_t l_text;
        if (!read_i32(&l_text) || l_text < 0) return fail("bad l_text");
        if (!skip_bytes(static_cast<size_t>(l_text))) return fail("truncated header text");
        int32_t n_ref;
        if (!read_i32(&n_ref) || n_ref < 0) return fail("bad n_ref");
        ref_names.reserve(n_ref);
        ref_lens.reserve(n_ref);
        for (int32_t i = 0; i < n_ref; ++i) {
            int32_t l_name;
            if (!read_i32(&l_name) || l_name <= 0) return fail("bad ref name length");
            std::string name(static_cast<size_t>(l_name), '\0');
            if (!read_bytes(name.data(), l_name)) return fail("truncated ref name");
            name.resize(static_cast<size_t>(l_name) - 1);  // NUL-terminated
            uint32_t l_ref;
            if (!read_u32(&l_ref)) return fail("truncated ref length");
            ref_names.push_back(std::move(name));
            ref_lens.push_back(l_ref);
        }
        return true;
    }
};

// Find the value of an integer-valued tag (e.g. NM) in the aux data.
// Returns true + value if found.
bool find_int_tag(const uint8_t* aux, size_t len, const char tag[2], int64_t* value) {
    size_t i = 0;
    while (i + 3 <= len) {
        char t0 = aux[i], t1 = aux[i + 1], type = aux[i + 2];
        i += 3;
        size_t size = 0;
        bool is_int = false;
        int64_t v = 0;
        switch (type) {
            case 'A': case 'c':
                size = 1;
                is_int = (type == 'c');
                if (is_int) v = static_cast<int8_t>(aux[i]);
                break;
            case 'C': size = 1; is_int = true; v = aux[i]; break;
            case 's': size = 2; is_int = true;
                { int16_t x; memcpy(&x, aux + i, 2); v = x; } break;
            case 'S': size = 2; is_int = true;
                { uint16_t x; memcpy(&x, aux + i, 2); v = x; } break;
            case 'i': size = 4; is_int = true;
                { int32_t x; memcpy(&x, aux + i, 4); v = x; } break;
            case 'I': size = 4; is_int = true;
                { uint32_t x; memcpy(&x, aux + i, 4); v = x; } break;
            case 'f': size = 4; break;
            case 'd': size = 8; break;
            case 'Z': case 'H': {
                size_t j = i;
                while (j < len && aux[j] != 0) ++j;
                size = j - i + 1;
                break;
            }
            case 'B': {
                if (i + 5 > len) return false;
                char sub = static_cast<char>(aux[i]);
                uint32_t count;
                memcpy(&count, aux + i + 1, 4);
                size_t elt = (sub == 'c' || sub == 'C') ? 1
                             : (sub == 's' || sub == 'S') ? 2
                             : 4;
                size = 5 + static_cast<size_t>(count) * elt;
                break;
            }
            default:
                return false;  // unknown tag type; bail
        }
        if (i + size > len) return false;
        if (t0 == tag[0] && t1 == tag[1]) {
            if (!is_int) return false;
            *value = v;
            return true;
        }
        i += size;
    }
    return false;
}

struct CoverageAccum {
    // per contig: diff array of coverage starts/ends (ups and downs)
    std::vector<std::vector<int32_t>> diffs;

    explicit CoverageAccum(const std::vector<uint32_t>& ref_lens) {
        diffs.resize(ref_lens.size());
        for (size_t i = 0; i < ref_lens.size(); ++i)
            diffs[i].assign(ref_lens[i] + 1, 0);
    }
};

bool process_alignments(BamReader& r, double min_identity, CoverageAccum& accum) {
    std::vector<uint8_t> rec;
    uint32_t flag_skip = 0x4 /*unmapped*/ | 0x100 /*secondary*/ |
                         0x200 /*QC fail*/ | 0x400 /*duplicate*/ |
                         0x800 /*supplementary*/;
    while (true) {
        uint32_t block_size;
        if (!r.ensure(4)) return true;  // clean EOF
        if (!r.read_u32(&block_size)) return true;
        if (block_size < 32) return r.fail("alignment record too small");
        rec.resize(block_size);
        if (!r.read_bytes(rec.data(), block_size))
            return r.fail("truncated alignment record");

        int32_t ref_id, pos;
        memcpy(&ref_id, rec.data(), 4);
        memcpy(&pos, rec.data() + 4, 4);
        uint8_t l_read_name = rec[8];
        uint16_t n_cigar_op, flag;
        memcpy(&n_cigar_op, rec.data() + 12, 2);
        memcpy(&flag, rec.data() + 14, 2);
        int32_t l_seq;
        memcpy(&l_seq, rec.data() + 16, 4);

        if (flag & flag_skip) continue;
        if (ref_id < 0 || static_cast<size_t>(ref_id) >= accum.diffs.size())
            continue;

        size_t cigar_off = 32 + l_read_name;
        if (cigar_off + 4ull * n_cigar_op > block_size)
            return r.fail("cigar out of bounds");

        // walk cigar: ref span counts M/=/X/D; aligned length adds I
        int64_t ref_len = 0, aligned_len = 0;
        for (uint32_t c = 0; c < n_cigar_op; ++c) {
            uint32_t op_field;
            memcpy(&op_field, rec.data() + cigar_off + 4ull * c, 4);
            uint32_t op_len = op_field >> 4;
            uint32_t op = op_field & 0xF;
            switch (op) {
                case 0: /*M*/ case 7: /*=*/ case 8: /*X*/
                    ref_len += op_len;
                    aligned_len += op_len;
                    break;
                case 2: /*D*/
                    ref_len += op_len;
                    aligned_len += op_len;
                    break;
                case 1: /*I*/
                    aligned_len += op_len;
                    break;
                default:  // S,H,N,P: no ref coverage contribution
                    if (op == 3 /*N*/) ref_len += op_len;
                    break;
            }
        }
        if (ref_len == 0) continue;

        if (min_identity > 0.0) {
            size_t seq_bytes = (static_cast<size_t>(l_seq) + 1) / 2;
            size_t aux_off = cigar_off + 4ull * n_cigar_op + seq_bytes +
                             static_cast<size_t>(l_seq);
            if (aux_off <= block_size) {
                int64_t nm;
                if (find_int_tag(rec.data() + aux_off, block_size - aux_off,
                                 "NM", &nm) &&
                    aligned_len > 0) {
                    double identity =
                        1.0 - static_cast<double>(nm) / static_cast<double>(aligned_len);
                    if (identity < min_identity) continue;
                }
            }
        }

        auto& diff = accum.diffs[ref_id];
        int64_t start = pos;
        int64_t end = pos + ref_len;
        if (start < 0) start = 0;
        int64_t maxlen = static_cast<int64_t>(diff.size()) - 1;
        if (end > maxlen) end = maxlen;
        if (start >= end) continue;
        diff[start] += 1;
        diff[end] -= 1;
    }
}

float trimmed_mean(const std::vector<int32_t>& diff, uint32_t contig_len,
                   double trim_lower, double trim_upper,
                   uint32_t end_exclusion) {
    if (contig_len <= 2 * end_exclusion) return 0.0f;
    size_t lo = end_exclusion, hi = contig_len - end_exclusion;
    std::vector<int32_t> depth(hi - lo);
    int64_t running = 0;
    for (size_t i = 0; i < hi; ++i) {
        running += diff[i];
        if (i >= lo) depth[i - lo] = static_cast<int32_t>(running);
    }
    std::sort(depth.begin(), depth.end());
    size_t n = depth.size();
    size_t min_index = static_cast<size_t>(trim_lower * static_cast<double>(n));
    size_t max_index = n - static_cast<size_t>(trim_upper * static_cast<double>(n));
    if (min_index >= max_index) return 0.0f;
    double total = 0;
    for (size_t i = min_index; i < max_index; ++i) total += depth[i];
    return static_cast<float>(total / static_cast<double>(max_index - min_index));
}

}  // namespace

extern "C" {

// Opens a BAM file and parses its header. Returns an opaque handle or null
// (with an error message copied to errbuf).
void* bamcov_open(const char* path, char* errbuf, size_t errlen) {
    auto reader = std::make_unique<BamReader>();
    if (!reader->open(path)) {
        snprintf(errbuf, errlen, "%s", reader->error.c_str());
        return nullptr;
    }
    return reader.release();
}

uint64_t bamcov_n_refs(void* handle) {
    return static_cast<BamReader*>(handle)->ref_names.size();
}

const char* bamcov_ref_name(void* handle, uint64_t i) {
    return static_cast<BamReader*>(handle)->ref_names[i].c_str();
}

uint32_t bamcov_ref_len(void* handle, uint64_t i) {
    return static_cast<BamReader*>(handle)->ref_lens[i];
}

// Streams all alignments and fills out[n_refs] with trimmed-mean coverages.
// Returns 0 on success, 1 on error (message in errbuf). Consumes the handle's
// stream; call once per handle.
int bamcov_coverage(void* handle, double min_identity, double trim_lower,
                    double trim_upper, uint32_t end_exclusion, float* out,
                    char* errbuf, size_t errlen) {
    auto* r = static_cast<BamReader*>(handle);
    CoverageAccum accum(r->ref_lens);
    if (!process_alignments(*r, min_identity, accum)) {
        snprintf(errbuf, errlen, "%s", r->error.c_str());
        return 1;
    }
    for (size_t i = 0; i < r->ref_lens.size(); ++i) {
        out[i] = trimmed_mean(accum.diffs[i], r->ref_lens[i], trim_lower,
                              trim_upper, end_exclusion);
    }
    return 0;
}

void bamcov_close(void* handle) { delete static_cast<BamReader*>(handle); }

}  // extern "C"
