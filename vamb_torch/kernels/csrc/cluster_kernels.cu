// Hand-written Hopper (sm_90a) kernels for the clustering engine, exported
// through a plain C interface and loaded with ctypes
// (vamb_torch/kernels/cluster_kernels.py builds and binds them).
//
// Layout contract (the engine's): the normalized latent matrix is stored
// transposed, (F_pad, N_pad) row-major float32, so one latent's features
// sit N_pad floats apart and neighbouring columns sit next to each other.
// With the engine's `distance_dtype="bfloat16"` the matrix is bfloat16 in
// the same layout. The three kernels that read it on that path
// (medoid_sweep, spec_sweep, candidate_density_sweep) are templated on the
// element type T: a bf16 value is widened to the float with the same bits
// in its top half (exact) as it arrives, and from there every operation
// and its order are the float kernel's, on the same thread-to-column map.
// So a bf16 variant equals the float kernel on the widened matrix bit for
// bit; only the bytes read halve (the copies of a thread's columns are half
// as wide: 8 bytes where the float ring copies 16).
//
// The distance kernels accumulate the feature dot product in float32 in fixed
// feature order with separately rounded multiplies and adds (__fmul_rn /
// __fadd_rn, so nvcc does not contract them into FMAs). That is exactly
// the arithmetic of the plain PyTorch versions beside the wrappers, so a
// kernel's distances equal its plain version's bit for bit. Being FMA-free,
// their f32 work issues at half the card's FMA peak: 33.5e12 operations a
// second is the rate their bounds use.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kEngineF = 32;  // the engine's F_pad (latent width 32), compiled in
constexpr int kRowThreads = 64;  // row_sweep at F_pad 32: 64 threads x 4 columns
constexpr int kRowVec = 4;
constexpr int kRowAnyThreads = 256;  // row_sweep at other widths: a column a thread
constexpr int kDensThreads = 128;  // candidate_density_sweep: 4 warps a CTA
// kDensThreads, kDensVec and kDensMaxBlocks fix the density's summation
// order; candidate_density_plain reads them (vt_density_* below)
constexpr int kDensWarps = kDensThreads / 32;
constexpr int kDensVec = 2;  // neighbouring columns a thread owns in one tile
constexpr int kDensTileCols = kDensThreads * kDensVec;  // 256 columns a tile
constexpr int kDensMaxBlocks = 256;  // column CTAs; the last CTA's tree spans 256
constexpr int kDensTile = 16;  // most candidates in one CTA's register tile
// candidates a gumbel_topc round selects (a warp's list, one key a lane)
// and the density kernel's last CTA sums at a time; either takes any C
constexpr int kCandGroup = 32;
constexpr float kMedoidRadius = 0.05f;
constexpr int kGatherThreads = 256;
constexpr int kGatherCopies = 1;  // 16-byte copies a gather thread makes (measured against 4)
constexpr int kBlockCols = 128;  // the subset wander's block width
constexpr int kNbins = 60;
// kSweepThreads, kSweepVec and kSweepMaxBlocks fix medoid_sweep's summation
// order; medoid_sweep_plain reads them (vt_sweep_* below)
constexpr int kSweepThreads = 64;  // medoid_sweep: 64 threads x 4 columns
constexpr int kSweepVec = 4;
constexpr int kSweepTileCols = kSweepThreads * kSweepVec;  // 256 columns a tile
constexpr int kSweepMaxBlocks = 128;  // CTAs; the last CTA's tree spans 128
constexpr int kSweepRows = kNbins + 1;  // a thread's sums: 60 bins, the density
constexpr int kSweepSlots = 64;  // a CTA's partial row: its 61 sums, padded
constexpr float kDeltaX = 0.005f;
constexpr float kXmax = 0.3f;

// The launches each __global__ function below was given without an error,
// counted on the host by the C functions at the end (after each launch's
// cudaGetLastError()) and read through vt_launches: a count of a named
// kernel that does not depend on a profiler's device records.
enum LaunchId {
  kLaunchRowSweepF32, kLaunchRowSweepAny, kLaunchDensity, kLaunchGather, kLaunchMedoid,
  kLaunchSpec, kLaunchRowStats, kLaunchGumbel, kLaunchIds
};
const char* const kLaunchNames[kLaunchIds] = {
    "row_sweep_f32_kernel", "row_sweep_any_kernel", "candidate_density_kernel",
    "gather_blocks_kernel", "medoid_sweep_kernel", "spec_sweep_kernel", "row_stats_kernel",
    "gumbel_topc_kernel"};
std::atomic<unsigned long long> g_launches[kLaunchIds];  // zero before any call

// cudaGetLastError() right after a launch of kernel `id`: counts the
// launch where there was no error, and returns the error.
int counted(LaunchId id) {
  const cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess) g_launches[id].fetch_add(1, std::memory_order_relaxed);
  return (int)e;
}

// acc + a * b with the product and the sum rounded separately (no FMA):
// the plain versions' arithmetic, so distances agree bit for bit.
__device__ __forceinline__ float mul_add_rn(float acc, float a, float b) {
  return __fadd_rn(acc, __fmul_rn(a, b));
}

// The halving tree over a warp: lane l adds lane l + 16, then l + 8, ... 1,
// so lane 0 ends with ((v0 + v16) + (v8 + v24)) + ... . Returns lane 0's sum.
__device__ __forceinline__ float warp_tree(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
  }
  return v;
}

// cp.async: a 16-byte copy from device to shared memory that takes no
// registers, so a thread can have all its loads in flight at once; the
// copies of a thread commit in groups, and wait_group N waits until at
// most N of its groups are still in flight.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem)
               : "memory");
}

// A thread's V neighbouring columns as one vector (4, 8 or 16 bytes).
template <int V> struct VecOf;
template <> struct VecOf<1> { using T = float; };
template <> struct VecOf<2> { using T = float2; };
template <> struct VecOf<4> { using T = float4; };

template <class T, int N>
__device__ __forceinline__ void unpack(const T& a, float (&x)[N]) {
  static_assert(sizeof(T) == N * sizeof(float), "one float a column");
  const float* f = reinterpret_cast<const float*>(&a);
#pragma unroll
  for (int k = 0; k < N; ++k) x[k] = f[k];
}

// A bfloat16 matrix element: its 16 bits, the top half of a float's.
using bf16_t = uint16_t;

// An element as a float: bf16 widened exactly (its bits in the top half).
__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(bf16_t x) { return __uint_as_float((uint32_t)x << 16); }

// V neighbouring columns of a matrix of elements T as one vector.
template <class T, int V> struct ColsOf { using Vec = typename VecOf<V>::T; };
template <> struct ColsOf<bf16_t, 1> { using Vec = bf16_t; };
template <> struct ColsOf<bf16_t, 2> { using Vec = uint32_t; };
template <> struct ColsOf<bf16_t, 4> { using Vec = uint2; };

// A vector of N elements T, widened to N floats.
template <class T, class Vec, int N>
__device__ __forceinline__ void widen_cols(const Vec& a, float (&x)[N]) {
  static_assert(sizeof(Vec) == N * sizeof(T), "one element a column");
  const T* e = reinterpret_cast<const T*>(&a);
#pragma unroll
  for (int k = 0; k < N; ++k) x[k] = widen(e[k]);
}

// One vector from device to shared memory: cp.async for 4, 8 or 16 bytes;
// below that (a bf16 column alone) a plain copy.
template <class V>
__device__ __forceinline__ void cp_async_vec(V* smem, const void* gmem) {
  if constexpr (sizeof(V) == 16) {
    cp_async16(smem, gmem);
  } else if constexpr (sizeof(V) == 8) {
    cp_async8(smem, gmem);
  } else if constexpr (sizeof(V) == 4) {
    cp_async4(smem, gmem);
  } else {
    *smem = *static_cast<const V*>(gmem);
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Column CTAs of candidate_density_sweep at width n_pad: K = ceil(T/256)
// tiles each for T tiles of 256 columns, B = ceil(T/K) <= 256 CTAs.
__host__ __device__ inline int density_col_blocks(int n_pad) {
  const int tiles = (n_pad + kDensTileCols - 1) / kDensTileCols;
  const int k = (tiles + kDensMaxBlocks - 1) / kDensMaxBlocks;
  return (tiles + k - 1) / k;
}

// ---------------------------------------------------------------- row_sweep
// Replaces vamb_tpu/ops/pallas_cluster.py:row_sweep (_row_sweep_kernel):
// d[n] = 0.5 - sum_f M[f, n] * M[f, idx], with d[idx] = 0.0 exactly, the
// products added in feature order (bit-identical to row_sweep_plain and to
// medoid_sweep's row).
//
// Bound on the H100: bytes. It reads the matrix once (F_pad * N_pad * 4
// bytes) and writes one float per column; 2 FMA-free f32 operations per 4
// bytes read is far below the card's ratio of about 10 per byte. Design, for
// F_pad = 32 (the engine's only width) and N_pad % 4 == 0: a thread owns 4
// neighbouring columns and issues all 32 of its 16-byte feature loads as
// cp.async copies into shared memory before any add chain starts (512 bytes
// in flight a thread, and no registers held for them: loaded into registers,
// ptxas traded loads in flight for fewer registers), in 4 groups of 8
// features, so the adds of one group overlap the arrival of the next; 64
// threads a CTA, so 100,096 columns give 391 CTAs on 132 SMs. The medoid's
// features sit in shared memory, read as 16-byte broadcasts. Other widths
// take row_sweep_any_kernel, one thread per column, runtime feature loop.
__global__ void __launch_bounds__(kRowThreads)
row_sweep_f32_kernel(const float* __restrict__ m, int n_pad, int idx,
                     float* __restrict__ d) {
  static_assert(kRowThreads >= kEngineF, "one thread per medoid feature");
  __shared__ float4 col4[kEngineF / 4];
  __shared__ float4 stage[kEngineF][kRowThreads];  // 32 KB: a thread's 4 columns
  const int n0 = (blockIdx.x * kRowThreads + threadIdx.x) * kRowVec;
  const bool active = n0 < n_pad;
  // all 32 feature loads in flight first, in 4 groups of 8 features
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    if (active) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int f = 8 * g + k;
        cp_async16(&stage[f][threadIdx.x], m + (size_t)f * n_pad + n0);
      }
    }
    cp_async_commit();
  }
  if (threadIdx.x < kEngineF) {
    reinterpret_cast<float*>(col4)[threadIdx.x] =
        m[(size_t)threadIdx.x * n_pad + idx];
  }
  __syncthreads();
  if (!active) return;
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
  auto add_group = [&](int g) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int f = 8 * g + k;
      const float4 v = stage[f][threadIdx.x];
      const float4 c4 = col4[f / 4];
      const float c = (f % 4 == 0) ? c4.x : (f % 4 == 1) ? c4.y : (f % 4 == 2) ? c4.z : c4.w;
      a0 = mul_add_rn(a0, v.x, c);
      a1 = mul_add_rn(a1, v.y, c);
      a2 = mul_add_rn(a2, v.z, c);
      a3 = mul_add_rn(a3, v.w, c);
    }
  };
  cp_async_wait<3>();
  add_group(0);
  cp_async_wait<2>();
  add_group(1);
  cp_async_wait<1>();
  add_group(2);
  cp_async_wait<0>();
  add_group(3);
  float4 out;
  out.x = (n0 == idx) ? 0.0f : __fsub_rn(0.5f, a0);
  out.y = (n0 + 1 == idx) ? 0.0f : __fsub_rn(0.5f, a1);
  out.z = (n0 + 2 == idx) ? 0.0f : __fsub_rn(0.5f, a2);
  out.w = (n0 + 3 == idx) ? 0.0f : __fsub_rn(0.5f, a3);
  *reinterpret_cast<float4*>(d + n0) = out;
}

__global__ void row_sweep_any_kernel(const float* __restrict__ m, int f_pad,
                                     int n_pad, int idx, float* __restrict__ d) {
  extern __shared__ float col[];
  for (int f = threadIdx.x; f < f_pad; f += blockDim.x) {
    col[f] = m[(size_t)f * n_pad + idx];
  }
  __syncthreads();
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= n_pad) return;
  float acc = 0.0f;
  for (int f = 0; f < f_pad; ++f) {
    acc = mul_add_rn(acc, m[(size_t)f * n_pad + n], col[f]);
  }
  d[n] = (n == idx) ? 0.0f : __fsub_rn(0.5f, acc);
}

// -------------------------------------------------- candidate_density_sweep
// Replaces vamb_tpu/ops/pallas_cluster.py:candidate_density_sweep
// (_candidate_density_kernel): for C candidates (any C; Pallas pads C to 32),
//   dens[c] = sum_n [D[c,n] <= 0.05 and w[n] > 0] * w[n] * (0.05 - D[c,n]),
//   D[c,n] = 0.5 - M[:, cand[c]] . M[:, n], with D[c, cand[c]] = 0,
// D summed in feature order with separately rounded products and sums
// (row_sweep's arithmetic), with no (C, N) matrix in device memory.
//
// Bound on the H100: operations. Each (candidate, column) pair costs F_pad
// multiplies and F_pad adds, none fused, so 2*C*F*N f32 instructions at
// 33.5e12 a second (half the FMA peak); at C = 25, F = 32 that takes about
// 1.3x as long as reading the matrix once. Design:
// * Register tile. A thread owns 2 neighbouring columns and CT <= 16
//   candidates: per feature one 8-byte load of its columns and ceil(CT/4)
//   16-byte shared-memory broadcasts of the candidates' features (stored
//   feature-major, 16 slots a feature) feed 2*CT multiplies and 2*CT adds.
// * Columns through shared memory. At F_pad 32 each thread copies its own
//   columns with cp.async in chunks of 8 features into a ring of 4 chunk
//   buffers, a whole tile ahead of its adds, so loads wait on no register
//   (loaded straight into registers, ptxas kept one or two in flight). The
//   chunk loop is not unrolled: 16 CT variants of 32 unrolled features
//   thrashed the instruction cache. Other widths load columns directly.
// * Work follows C. The C candidates are split into G balanced groups of at
//   most 16 (25 -> 13, 12); each group is a row of CTAs (blockIdx.y) and
//   runs code compiled for its exact CT, so no slot computes a missing
//   candidate. Every group reads all columns again from L2, so G stays
//   small: the wrapper takes ceil(C/16) and raises it only while the column
//   CTAs alone are fewer than two an SM (8,192 columns: 32 CTAs, G = 9).
// * One launch. Each CTA writes its CT partial sums; the CTA that draws the
//   last ticket of an integer atomic counter adds the partial rows and
//   writes dens, 32 candidates at a time (a warp's 8 a lane of them, so
//   any C takes one launch: C 64 two rounds of the finish, C 100 four),
//   then resets the counter to 0 for the next call. Calls on
//   one stream are serialized, and the wrapper keeps one counter and one
//   partials buffer per stream. No float atomics: the engine's
//   `dens > density` decides on knife edges.
// * Summation order: a function of N_pad and the constants above alone (not
//   of C, G or the card). Columns form tiles of 256: tile t holds column
//   t*256 + 2*tid + v for thread tid < 128 and v < 2. With T tiles,
//   K = ceil(T/256) and B = ceil(T/K) column CTAs, CTA b takes tiles b,
//   b+B, b+2B, ... (the i-th is b + i*B). (1) Each thread adds its terms in
//   (i, v) order into a float that starts at 0; (2) a halving tree over a
//   warp's 32 lanes (lane l adds lane l+16, then l+8, ... l+1); (3) over the
//   4 warps, (w0 + w2) + (w1 + w3); (4) over the B column CTAs padded with
//   zeros to 256, the same halving tree (b adds b+128, then b+64, ... b+1).
//   Columns past N_pad and removed points add nothing, exactly so: every
//   term is >= +0. candidate_density_plain reproduces this order with
//   tensor ops, so the two agree bit for bit.
// Adds feature f of a thread's 2 columns (x) to its CT x 2 dot products;
// the candidates' features come as 16-byte broadcasts.
template <int CT>
__device__ __forceinline__ void dot_feature(float (&dot)[CT][kDensVec],
                                            const float* s_cand, int f,
                                            const float (&x)[kDensVec]) {
  constexpr int kQuads = (CT + 3) / 4;
  float cv[4 * kQuads];
  const float4* c4 = reinterpret_cast<const float4*>(s_cand + f * kDensTile);
#pragma unroll
  for (int k = 0; k < kQuads; ++k) {
    const float4 q = c4[k];
    cv[4 * k] = q.x;
    cv[4 * k + 1] = q.y;
    cv[4 * k + 2] = q.z;
    cv[4 * k + 3] = q.w;
  }
#pragma unroll
  for (int j = 0; j < CT; ++j) {
#pragma unroll
    for (int v = 0; v < kDensVec; ++v) dot[j][v] = mul_add_rn(dot[j][v], cv[j], x[v]);
  }
}

// The density terms of a thread's 2 columns n0, n0 + 1 added to its CT
// sums, in column order.
template <int CT>
__device__ __forceinline__ void add_terms(float (&acc)[CT],
                                          const float (&dot)[CT][kDensVec],
                                          const float (&wv)[kDensVec], int n0,
                                          const int* s_cid) {
#pragma unroll
  for (int v = 0; v < kDensVec; ++v) {
    if (wv[v] > 0.0f) {
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        const float dist = (n0 + v == s_cid[j]) ? 0.0f : __fsub_rn(0.5f, dot[j][v]);
        if (dist <= kMedoidRadius) {
          acc[j] = mul_add_rn(acc[j], wv[v], __fsub_rn(kMedoidRadius, dist));
        }
      }
    }
  }
}

// The CTA's CT sums (a halving tree over each warp's lanes, then over the
// warps: (w0 + w2) + (w1 + w3) for 4) into its column of the (C, 256)
// partials.
template <int CT>
__device__ __forceinline__ void cta_partials(const float (&acc)[CT], float* s_red,
                                             int c0, float* __restrict__ partials) {
  static_assert((kDensWarps & (kDensWarps - 1)) == 0, "a halving tree over the warps");
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < CT; ++j) {
    const float sum = warp_tree(acc[j]);
    if (lane == 0) s_red[warp * kDensTile + j] = sum;
  }
  __syncthreads();
  if (threadIdx.x < CT) {
    float r[kDensWarps];
#pragma unroll
    for (int k = 0; k < kDensWarps; ++k) r[k] = s_red[k * kDensTile + threadIdx.x];
#pragma unroll
    for (int h = kDensWarps / 2; h > 0; h >>= 1) {
#pragma unroll
      for (int k = 0; k < h; ++k) r[k] = __fadd_rn(r[k], r[k + h]);
    }
    partials[(size_t)(c0 + threadIdx.x) * kDensMaxBlocks + blockIdx.x] = r[0];
  }
}

// Any F_pad and N_pad: plain loads, a column a load.
template <class T, int CT>
__device__ __forceinline__ void density_tile_any(
    const T* __restrict__ m, int f_pad, int n_pad,
    const float* __restrict__ w, const float* s_cand, const int* s_cid,
    float* s_red, int c0, float* __restrict__ partials) {
  float acc[CT];
#pragma unroll
  for (int j = 0; j < CT; ++j) acc[j] = 0.0f;
  const int tiles = (n_pad + kDensTileCols - 1) / kDensTileCols;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int n0 = t * kDensTileCols + threadIdx.x * kDensVec;
    float wv[kDensVec];
#pragma unroll
    for (int v = 0; v < kDensVec; ++v) wv[v] = n0 + v < n_pad ? w[n0 + v] : 0.0f;
    bool any = false;
#pragma unroll
    for (int v = 0; v < kDensVec; ++v) any = any || wv[v] > 0.0f;
    if (!any) continue;
    float dot[CT][kDensVec];
#pragma unroll
    for (int j = 0; j < CT; ++j) {
#pragma unroll
      for (int v = 0; v < kDensVec; ++v) dot[j][v] = 0.0f;
    }
#pragma unroll 4
    for (int f = 0; f < f_pad; ++f) {
      float x[kDensVec];
#pragma unroll
      for (int v = 0; v < kDensVec; ++v) {
        x[v] = n0 + v < n_pad ? widen(m[(size_t)f * n_pad + n0 + v]) : 0.0f;
      }
      dot_feature<CT>(dot, s_cand, f, x);
    }
    add_terms<CT>(acc, dot, wv, n0, s_cid);
  }
  cta_partials<CT>(acc, s_red, c0, partials);
}

// F_pad 32, N_pad % 2 == 0: stage s = 4*i + q of a thread is chunk q (8
// features) of its i-th tile, copied by cp.async into ring buffer s % 4
// (chunk 0 also brings the tile's 2 weights, into weight buffer i % 2).
// Stage s + 4 is issued as soon as stage s is consumed, so a whole tile's
// copies (256 bytes a thread) are always in flight. Each thread reads back
// only what it copied, so the pipeline needs no barrier.
constexpr int kDensChunk = 8;
constexpr int kDensChunks = kEngineF / kDensChunk;
constexpr int kDensRing = kDensChunks;  // chunk buffers: one tile ahead
static_assert(kDensRing <= 2 * kDensChunks, "two weight buffers cover the ring");
using DensVec = VecOf<kDensVec>::T;  // a thread's weights of a tile
template <class T>
using DensCols = typename ColsOf<T, kDensVec>::Vec;  // a thread's columns of a feature

// The dynamic shared memory of the F_pad 32 path: the candidates' features,
// the ring of chunk buffers and the two weight buffers.
template <class T>
constexpr size_t density_smem() {
  return kEngineF * kDensTile * sizeof(float) +
         kDensRing * kDensChunk * kDensThreads * sizeof(DensCols<T>) +
         2 * kDensThreads * sizeof(DensVec);
}

template <class T>
__device__ __forceinline__ void density_issue(const T* __restrict__ m, int n_pad,
                                              const float* __restrict__ w, DensCols<T>* stage,
                                              DensVec* wstage, int tiles, int s) {
  const int i = s / kDensChunks;
  const int q = s % kDensChunks;
  const int t = blockIdx.x + i * gridDim.x;
  const int n0 = t * kDensTileCols + threadIdx.x * kDensVec;
  if (t < tiles && n0 < n_pad) {
    DensCols<T>* dst = stage + (s % kDensRing) * kDensChunk * kDensThreads + threadIdx.x;
    const T* src = m + (size_t)(q * kDensChunk) * n_pad + n0;
#pragma unroll
    for (int k = 0; k < kDensChunk; ++k) {
      cp_async_vec(dst + k * kDensThreads, src + (size_t)k * n_pad);
    }
    if (q == 0) cp_async_vec(wstage + (i % 2) * kDensThreads + threadIdx.x, w + n0);
  }
  cp_async_commit();
}

template <class T, int CT>
__device__ __forceinline__ void density_tile_f32(
    const T* __restrict__ m, int n_pad, const float* __restrict__ w,
    DensCols<T>* stage, DensVec* wstage, const float* s_cand, const int* s_cid,
    float* s_red, int c0, float* __restrict__ partials) {
  float acc[CT];
#pragma unroll
  for (int j = 0; j < CT; ++j) acc[j] = 0.0f;
  const int tiles = (n_pad + kDensTileCols - 1) / kDensTileCols;
  const int ntile = (tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;
  for (int i = 0; i < ntile; ++i) {
    const int n0 = (blockIdx.x + i * gridDim.x) * kDensTileCols + threadIdx.x * kDensVec;
    float wv[kDensVec];
    bool live = false;
    float dot[CT][kDensVec];
    // not unrolled: one chunk's code (8 features) is what the warps of an
    // SM share; all 32 features unrolled in each CT variant thrashed the
    // instruction cache
#pragma unroll 1
    for (int q = 0; q < kDensChunks; ++q) {
      cp_async_wait<kDensRing - 1>();  // stage 4i + q has landed
      if (q == 0) {
        live = false;
        if (n0 < n_pad) {
          unpack(wstage[(i % 2) * kDensThreads + threadIdx.x], wv);
#pragma unroll
          for (int v = 0; v < kDensVec; ++v) live = live || wv[v] > 0.0f;
        }
#pragma unroll
        for (int j = 0; j < CT; ++j) {
#pragma unroll
          for (int v = 0; v < kDensVec; ++v) dot[j][v] = 0.0f;
        }
      }
      if (live) {
        const DensCols<T>* src =
            stage + ((kDensChunks * i + q) % kDensRing) * kDensChunk * kDensThreads + threadIdx.x;
#pragma unroll
        for (int k = 0; k < kDensChunk; ++k) {
          float x[kDensVec];
          widen_cols<T>(src[k * kDensThreads], x);
          dot_feature<CT>(dot, s_cand, q * kDensChunk + k, x);
        }
      }
      density_issue(m, n_pad, w, stage, wstage, tiles, kDensChunks * i + q + kDensRing);
    }
    if (live) add_terms<CT>(acc, dot, wv, n0, s_cid);
  }
  cta_partials<CT>(acc, s_red, c0, partials);
}

template <class T, bool kF32>
__global__ void __launch_bounds__(kDensThreads)
candidate_density_kernel(const T* __restrict__ m, int f_pad, int n_pad,
                         const void* __restrict__ cand, int cand64, int n_cand,
                         const float* __restrict__ q, const float* __restrict__ w,
                         float* __restrict__ partials,
                         unsigned int* __restrict__ ticket,
                         float* __restrict__ dens) {
  // dynamic shared memory: F_pad x 16 candidate features (widened to
  // float), feature-major; with kF32 then the ring of chunk buffers and the
  // weights of the pipeline
  extern __shared__ float4 s_dyn[];
  float* s_cand = reinterpret_cast<float*>(s_dyn);
  DensCols<T>* stage = reinterpret_cast<DensCols<T>*>(s_dyn + kEngineF * kDensTile / 4);
  DensVec* wstage = reinterpret_cast<DensVec*>(stage + kDensRing * kDensChunk * kDensThreads);
  __shared__ int s_cid[kDensTile];
  __shared__ float s_red[kDensWarps * kDensTile];
  __shared__ bool s_last;
  const int tiles = (n_pad + kDensTileCols - 1) / kDensTileCols;
  if constexpr (kF32) {  // a tile's copies go out first and overlap the set-up
#pragma unroll
    for (int st = 0; st < kDensRing; ++st) {
      density_issue(m, n_pad, w, stage, wstage, tiles, st);
    }
  }
  // this CTA row's candidates: a balanced split of C over G groups
  const int groups = gridDim.y;
  const int g = blockIdx.y;
  const int base = n_cand / groups;
  const int rem = n_cand % groups;
  const int ct = base + (g < rem ? 1 : 0);
  const int c0 = g * base + min(g, rem);
  if (threadIdx.x < kDensTile) {
    const int j = threadIdx.x;
    int id = -1;
    if (j < ct) {
      id = cand64 ? (int)static_cast<const long long*>(cand)[c0 + j]
                  : static_cast<const int*>(cand)[c0 + j];
    }
    s_cid[j] = id;
  }
  __syncthreads();
  const int nf = kF32 ? kEngineF : f_pad;
  for (int i = threadIdx.x; i < nf * kDensTile; i += kDensThreads) {
    const int f = i / kDensTile;
    const int j = i - f * kDensTile;
    s_cand[i] = j >= ct     ? 0.0f
                : q != nullptr ? q[(size_t)f * n_cand + c0 + j]
                               : widen(m[(size_t)f * n_pad + s_cid[j]]);
  }
  __syncthreads();
  switch (ct) {
#define VT_DENSITY_TILE(K)                                                    \
  case K:                                                                     \
    if constexpr (kF32) {                                                     \
      density_tile_f32<T, K>(m, n_pad, w, stage, wstage, s_cand, s_cid,      \
                             s_red, c0, partials);                            \
    } else {                                                                  \
      density_tile_any<T, K>(m, f_pad, n_pad, w, s_cand, s_cid, s_red, c0,    \
                             partials);                                       \
    }                                                                         \
    break;
    VT_DENSITY_TILE(1)
    VT_DENSITY_TILE(2)
    VT_DENSITY_TILE(3)
    VT_DENSITY_TILE(4)
    VT_DENSITY_TILE(5)
    VT_DENSITY_TILE(6)
    VT_DENSITY_TILE(7)
    VT_DENSITY_TILE(8)
    VT_DENSITY_TILE(9)
    VT_DENSITY_TILE(10)
    VT_DENSITY_TILE(11)
    VT_DENSITY_TILE(12)
    VT_DENSITY_TILE(13)
    VT_DENSITY_TILE(14)
    VT_DENSITY_TILE(15)
    VT_DENSITY_TILE(16)
#undef VT_DENSITY_TILE
  }

  // the ticket: publish this CTA's partials, then count it as done
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    s_last = atomicAdd(ticket, 1u) == gridDim.x * gridDim.y - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // the last CTA, 32 candidates a round: warp w sums candidates g + w,
  // g + w + 4, ... of the round's group g over the column CTAs with the
  // 256-wide halving tree (lane l holds b = l + 32*k); all of a warp's
  // loads of a round are issued before any add. A candidate's sum is the
  // same in any round: the rounds only bound the registers.
  static_assert(kDensMaxBlocks == 8 * 32, "8 partials a lane");
  constexpr int kPerWarp = kCandGroup / kDensWarps;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int group = 0; group < n_cand; group += kCandGroup) {
    float v[kPerWarp][kDensMaxBlocks / 32];
#pragma unroll
    for (int r = 0; r < kPerWarp; ++r) {
      const int c = group + warp + r * kDensWarps;
#pragma unroll
      for (int k = 0; k < kDensMaxBlocks / 32; ++k) {
        const int b = lane + 32 * k;
        v[r][k] = (c < n_cand && b < (int)gridDim.x)
                      ? __ldcg(partials + (size_t)c * kDensMaxBlocks + b)
                      : 0.0f;
      }
    }
#pragma unroll
    for (int r = 0; r < kPerWarp; ++r) {
      const int c = group + warp + r * kDensWarps;
      if (c < n_cand) {
#pragma unroll
        for (int h = kDensMaxBlocks / 64; h > 0; h >>= 1) {
#pragma unroll
          for (int k = 0; k < h; ++k) v[r][k] = __fadd_rn(v[r][k], v[r][k + h]);
        }
        const float sum = warp_tree(v[r][0]);
        if (lane == 0) dens[c] = sum;
      }
    }
  }
  if (threadIdx.x == 0) *ticket = 0u;
}

// ------------------------------------------------------------ gather_blocks
// Replaces vamb_tpu/ops/pallas_cluster.py:gather_blocks (_block_gather_kernel):
// out[:, k*128:(k+1)*128] = m[:, bids[k]*128:(bids[k]+1)*128] for k < KB, the
// subset wander's ball gather. Pure data movement, so bit-exact, repeated ids
// included. In the same launch, when the side pointers are given, it gathers
// by the same ids the per-column vectors the wander takes next (vamb_tpu/
// cluster.py:604-606, 654-656): each slot's column id, and the weight, kept
// flag and seed distance of its column, masked past the first nb blocks
// (weight 0, not kept, distance inf). On a shard of the matrix (a row-sharded
// engine) the ids are the shard's own blocks and `col_offset` its first
// global column, so each slot's column id comes out global.
//
// Bound on the H100: bytes (F_pad * KB * 128 * 4 read and written once, 2 MB
// at F_pad 32, KB 64: 0.63 us), far below the ~5 us a launch takes to start
// and drain, so the design fills the card at once: a CTA per (block, group of
// 8 * kGatherCopies feature rows), 256 threads, a thread kGatherCopies 16-byte
// copies with all its loads issued before its first store (F_pad 32, KB 64:
// 256 CTAs; chip_smoke.py --gather-layouts times 4 copies a thread, 64 CTAs,
// against it). The block id is read on the card, so the caller never syncs on
// it. Ids must lie in [0, N_pad/128).
__global__ void __launch_bounds__(kGatherThreads)
gather_blocks_kernel(const float4* __restrict__ m, int f_pad, int n_pad4,
                     const int* __restrict__ bids, float4* __restrict__ out, int out_n4,
                     int nb, const float* __restrict__ w,
                     const unsigned char* __restrict__ kept, const float* __restrict__ d0,
                     int* __restrict__ cols, unsigned char* __restrict__ kept_out,
                     float* __restrict__ w_out, float* __restrict__ d0_out, int col_offset) {
  constexpr int kRow4 = kBlockCols / 4;  // float4s in a block's feature row
  constexpr int kRowsPerPass = kGatherThreads / kRow4;
  const int k = blockIdx.x;
  const int bid = bids[k];
  const int c = threadIdx.x % kRow4;
  const int f0 = blockIdx.y * kRowsPerPass * kGatherCopies + threadIdx.x / kRow4;
  float4 v[kGatherCopies];
#pragma unroll
  for (int j = 0; j < kGatherCopies; ++j) {
    const int f = f0 + j * kRowsPerPass;
    if (f < f_pad) v[j] = __ldg(m + (size_t)f * n_pad4 + (size_t)bid * kRow4 + c);
  }
#pragma unroll
  for (int j = 0; j < kGatherCopies; ++j) {
    const int f = f0 + j * kRowsPerPass;
    if (f < f_pad) out[(size_t)f * out_n4 + (size_t)k * kRow4 + c] = v[j];
  }
  if (cols != nullptr && blockIdx.y == 0 && threadIdx.x < kBlockCols) {
    const int slot = k * kBlockCols + threadIdx.x;
    const int col = bid * kBlockCols + threadIdx.x;
    const bool valid = k < nb;
    cols[slot] = col_offset + col;
    kept_out[slot] = valid && kept[col];
    w_out[slot] = valid ? w[col] : 0.0f;
    d0_out[slot] = valid ? d0[col] : __int_as_float(0x7f800000);
  }
}

// ------------------------------------------------------------- medoid_sweep
// Replaces vamb_tpu/ops/pallas_cluster.py:medoid_sweep (_medoid_sweep_kernel):
// one medoid's distance row d (d[idx] = 0 exactly), the 60-bin histogram of
// w over the columns with 0 <= d <= 0.3 and w > 0 (bin clip(int(d/0.005),
// 0, 59), an IEEE division), the density sum of w * (0.05 - d) over d <=
// 0.05, w > 0, and the count of columns with d < 0.05, w > 0: an attempt's
// whole payload in one launch.
//
// Bound on the H100: bytes, like row_sweep (the matrix and w read once, d
// written once). Design:
// * Loads. row_sweep's scheme at F_pad 32: a thread owns 4 neighbouring
//   columns, its 32 16-byte feature loads go out as cp.async copies, here
//   into a ring of 4 chunk buffers of 8 features that is refilled a whole
//   tile ahead (each thread reads back only what it copied, so no barrier),
//   and its 4 weights are loaded a tile ahead into registers. The row has
//   row_sweep's arithmetic, so d equals row_sweep's bit for bit. Other widths
//   take plain loads in the same order.
// * Histogram. Each thread keeps a private row per bin in shared memory,
//   laid out [bin][thread], so the lanes of a warp never meet on a bank
//   whatever their bins: a column costs one shared-memory add, with no warp
//   loop over bins and no float atomic. The density is a register; the close
//   count an integer.
// * One launch. Each CTA writes its 61 sums and its count; the CTA that draws
//   the last ticket of an integer atomic counter adds the CTAs' rows and
//   resets the counter (the density kernel's scheme; the wrapper keeps the
//   counter and the partial rows per stream).
// * Summation order: a function of N_pad alone. Tiles of 256 columns: tile t
//   holds column t*256 + 4*tid + v for thread tid < 64, v < 4. With T tiles,
//   K = ceil(T/128) and B = ceil(T/K) CTAs, CTA b takes tiles b, b+B, ...
//   (1) each thread adds its terms in (tile, v) order into a float that
//   starts at 0; (2) a halving tree over the 64 threads (t adds t+32, then
//   t+16, ... t+1); (3) the same halving tree over the B CTAs padded with
//   zeros to 128. A thread sums one row in registers at each of (2) and (3)
//   (`halving64`). Every term is >= +0, so skipped columns add nothing,
//   exactly. medoid_sweep_plain reproduces the order with tensor adds, so
//   the two agree bit for bit. The last CTA's sum is most of the kernel's
//   fixed cost (the "no last CTA" diagnostic of chip_smoke.py --layouts)
//   and grows with the CTAs it sums, hence at most 128 CTAs (10 tiles a CTA
//   at 300,032 columns): faster than 256 or 512 at every path width.
__host__ __device__ inline int sweep_col_blocks(int n_pad) {
  const int tiles = (n_pad + kSweepTileCols - 1) / kSweepTileCols;
  const int k = (tiles + kSweepMaxBlocks - 1) / kSweepMaxBlocks;
  return (tiles + k - 1) / k;
}

constexpr int kSweepChunk = 8;  // features a cp.async group brings
constexpr int kSweepChunks = kEngineF / kSweepChunk;  // = the ring's buffers

// One column's terms, added to the sums of thread `tid` (its histogram row
// in s_acc, its density, its close count).
__device__ __forceinline__ void sweep_column(float (*s_acc)[kSweepThreads], int tid, float d,
                                             float wv, float& dens, int& close) {
  if (wv > 0.0f) {
    if (d >= 0.0f && d <= kXmax) {
      const int bin = min(max((int)__fdiv_rn(d, kDeltaX), 0), kNbins - 1);
      s_acc[bin][tid] = __fadd_rn(s_acc[bin][tid], wv);
    }
    if (d <= kMedoidRadius) {
      dens = __fadd_rn(dens, __fmul_rn(wv, __fsub_rn(kMedoidRadius, d)));
      close += d < kMedoidRadius;
    }
  }
}

// The halving tree of 64 values held in registers rotated by some r,
// w[k] = v[(k + r) % 64]: a rotation keeps each level's pairs (t, t + h)
// together as (k, k + h), so the sum is v's own halving tree (t + (t + 32),
// then + 16, ... + 1), whatever r. A thread sums a row so: rotated loads
// keep the lanes of a warp on distinct banks, and the adds of a level are
// independent.
__device__ __forceinline__ float halving64(float (&w)[64]) {
#pragma unroll
  for (int h = 32; h > 0; h >>= 1) {
#pragma unroll
    for (int k = 0; k < h; ++k) w[k] = __fadd_rn(w[k], w[k + h]);
  }
  return w[0];
}

// A CTA's partial row: thread r < 61 of a group of 64 sums row r of the
// group's s_acc (60 bins, the density) over its 64 threads.
__device__ __forceinline__ void sweep_cta_row(float (*s_acc)[kSweepThreads], int r,
                                              float* __restrict__ partial) {
  static_assert(kSweepThreads == 64 && kSweepRows <= kSweepThreads, "a thread a row");
  if (r < kSweepRows) {
    float w[kSweepThreads];
#pragma unroll
    for (int k = 0; k < kSweepThreads; ++k) w[k] = s_acc[r][(k + r) & (kSweepThreads - 1)];
    partial[r] = halving64(w);
  }
}

// The last CTA's total of row r over the nb CTAs' partial rows (kSweepSlots
// apart): the halving tree over kSweepMaxBlocks rows (zeros past nb), rows t
// and t + 64 folded first, then the tree over t.
__device__ __forceinline__ float sweep_total(const float* __restrict__ partials, int nb, int r) {
  constexpr int kFold = kSweepMaxBlocks / kSweepThreads;  // partial rows a t
  static_assert(kFold * kSweepThreads == kSweepMaxBlocks && (kFold & (kFold - 1)) == 0,
                "a power-of-two number of partial rows a t");
  float y[kSweepThreads];
#pragma unroll
  for (int t = 0; t < kSweepThreads; ++t) {
    float x[kFold];
#pragma unroll
    for (int j = 0; j < kFold; ++j) {
      const int b = t + j * kSweepThreads;
      x[j] = b < nb ? __ldcg(partials + (size_t)b * kSweepSlots + r) : 0.0f;
    }
#pragma unroll
    for (int h = kFold / 2; h > 0; h >>= 1) {
#pragma unroll
      for (int j = 0; j < h; ++j) x[j] = __fadd_rn(x[j], x[j + h]);
    }
    y[t] = x[0];
  }
  return halving64(y);
}

// A thread's 4 columns of a feature: 16 bytes of float, 8 of bf16.
template <class T>
using SweepCols = typename ColsOf<T, kSweepVec>::Vec;

// F_pad 32: stage s = 4*i + q of a thread is chunk q of its i-th tile, in
// ring buffer q.
template <class T>
__device__ __forceinline__ void sweep_issue(const T* __restrict__ m, int n_pad,
                                            SweepCols<T>* stage, int ntile, int s) {
  const int i = s / kSweepChunks;
  const int q = s % kSweepChunks;
  const int n0 = ((blockIdx.x + i * gridDim.x) * kSweepThreads + threadIdx.x) * kSweepVec;
  if (i < ntile && n0 < n_pad) {
    SweepCols<T>* dst = stage + q * kSweepChunk * kSweepThreads + threadIdx.x;
    const T* src = m + (size_t)(q * kSweepChunk) * n_pad + n0;
#pragma unroll
    for (int k = 0; k < kSweepChunk; ++k) {
      cp_async_vec(dst + k * kSweepThreads, src + (size_t)k * n_pad);
    }
  }
  cp_async_commit();
}

template <class T, bool kF32>
__global__ void __launch_bounds__(kSweepThreads)
medoid_sweep_kernel(const T* __restrict__ m, int f_pad, int n_pad, int idx,
                    const float* __restrict__ q, const float* __restrict__ w, float* __restrict__ d_out,
                    float* __restrict__ partials, int* __restrict__ close_partials,
                    unsigned int* __restrict__ ticket, float* __restrict__ hist,
                    float* __restrict__ density, int* __restrict__ n_close) {
  __shared__ float s_acc[kSweepRows][kSweepThreads];  // 60 bins and the density
  __shared__ int s_close[kSweepThreads / 32];
  __shared__ bool s_last;
  // dynamic: with kF32 the ring (4 chunks of 8 features x 64 threads x 16
  // bytes, 8 for bf16), then the medoid's features (widened to float); else
  // the medoid's f_pad features
  extern __shared__ float4 s_dyn[];
  SweepCols<T>* stage = reinterpret_cast<SweepCols<T>*>(s_dyn);
  float* col = reinterpret_cast<float*>(kF32 ? stage + kSweepChunks * kSweepChunk * kSweepThreads
                                             : stage);
  const int tiles = (n_pad + kSweepTileCols - 1) / kSweepTileCols;
  const int ntile = (tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;
  auto first_col = [&](int i) {
    return ((blockIdx.x + i * gridDim.x) * kSweepThreads + threadIdx.x) * kSweepVec;
  };
  if constexpr (kF32) {  // a tile's copies go out first and overlap the set-up
#pragma unroll
    for (int st = 0; st < kSweepChunks; ++st) sweep_issue(m, n_pad, stage, ntile, st);
  }
  const int nf = kF32 ? kEngineF : f_pad;
  for (int f = threadIdx.x; f < nf; f += kSweepThreads) {
    col[f] = q != nullptr ? q[f] : widen(m[(size_t)f * n_pad + idx]);
  }
#pragma unroll 4
  for (int r = 0; r < kSweepRows; ++r) s_acc[r][threadIdx.x] = 0.0f;
  __syncthreads();

  float dens = 0.0f;
  int close = 0;
  float4 w_next = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if constexpr (kF32) {
    if (first_col(0) < n_pad) w_next = *reinterpret_cast<const float4*>(w + first_col(0));
  }
  for (int i = 0; i < ntile; ++i) {
    const int n0 = first_col(i);
    float a[kSweepVec] = {0.0f, 0.0f, 0.0f, 0.0f};
    float wv[kSweepVec];
    if constexpr (kF32) {
      const float4 w4 = w_next;  // this tile's weights, loaded a tile ahead
      if (i + 1 < ntile && first_col(i + 1) < n_pad) {
        w_next = *reinterpret_cast<const float4*>(w + first_col(i + 1));
      }
      wv[0] = w4.x;
      wv[1] = w4.y;
      wv[2] = w4.z;
      wv[3] = w4.w;
#pragma unroll
      for (int q = 0; q < kSweepChunks; ++q) {
        cp_async_wait<kSweepChunks - 1>();  // stage 4i + q has landed
        if (n0 < n_pad) {
          const SweepCols<T>* src = stage + q * kSweepChunk * kSweepThreads + threadIdx.x;
#pragma unroll
          for (int k = 0; k < kSweepChunk; ++k) {
            float v[kSweepVec];
            widen_cols<T>(src[k * kSweepThreads], v);
            const float c = col[q * kSweepChunk + k];
#pragma unroll
            for (int j = 0; j < kSweepVec; ++j) a[j] = mul_add_rn(a[j], v[j], c);
          }
        }
        sweep_issue(m, n_pad, stage, ntile, kSweepChunks * (i + 1) + q);
      }
    } else {
#pragma unroll
      for (int v = 0; v < kSweepVec; ++v) wv[v] = n0 + v < n_pad ? w[n0 + v] : 0.0f;
      for (int f = 0; f < f_pad; ++f) {
        const float c = col[f];
#pragma unroll
        for (int v = 0; v < kSweepVec; ++v) {
          if (n0 + v < n_pad) a[v] = mul_add_rn(a[v], widen(m[(size_t)f * n_pad + n0 + v]), c);
        }
      }
    }
    float dv[kSweepVec];
#pragma unroll
    for (int v = 0; v < kSweepVec; ++v) {
      dv[v] = (n0 + v == idx) ? 0.0f : __fsub_rn(0.5f, a[v]);
    }
    if (kF32 && n0 < n_pad) {
      *reinterpret_cast<float4*>(d_out + n0) = make_float4(dv[0], dv[1], dv[2], dv[3]);
    }
#pragma unroll
    for (int v = 0; v < kSweepVec; ++v) {
      if (n0 + v < n_pad) {
        if (!kF32) d_out[n0 + v] = dv[v];
        sweep_column(s_acc, threadIdx.x, dv[v], wv[v], dens, close);
      }
    }
  }

  // this CTA's sums: row kNbins is the density; thread r sums row r over
  // the 64 threads
  s_acc[kNbins][threadIdx.x] = dens;
  const int warp_close = __reduce_add_sync(0xffffffffu, close);
  if ((threadIdx.x & 31) == 0) s_close[threadIdx.x >> 5] = warp_close;
  __syncthreads();
  const int r = threadIdx.x;
  sweep_cta_row(s_acc, r, partials + (size_t)blockIdx.x * kSweepSlots);
  if (threadIdx.x == 0) close_partials[blockIdx.x] = s_close[0] + s_close[1];

  // the ticket: publish this CTA's partials, then count it as done
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // the last CTA: thread r sums row r over the CTAs (sweep_total)
  const int nb = gridDim.x;
  int c = 0;
  for (int b = threadIdx.x; b < nb; b += kSweepThreads) c += __ldcg(close_partials + b);
  c = __reduce_add_sync(0xffffffffu, c);
  if (r < kSweepRows) {
    const float total = sweep_total(partials, nb, r);
    if (r < kNbins) {
      hist[r] = total;
    } else {
      *density = total;
    }
  }
  if ((threadIdx.x & 31) == 0) s_close[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    *n_close = s_close[0] + s_close[1];
    *ticket = 0u;
  }
}

// ------------------------------------------------------ spec_sweep, row_stats
// `spec_sweep` replaces the speculative seed cache's batched rows in
// `vamb_tpu` (cluster.py:498-515, `spec_batch`, an XLA einsum outside
// Pallas, also the attempt lanes' final rows, :1446-1456): the distance rows
// of S <= 8 columns in one pass over the matrix, rows[s, cols[s]] = 0, with
// each row's 60-bin histogram, density, close count (d < 0.05) and near
// count (d <= 0.05) over the columns with w > 0. `row_stats` takes S given
// rows and computes the same sums: a cached row's sums under the current
// kept mask, and the loner flags of the burst (:1100, :1104-1112; near
// count 1). Contract: row s and its sums are bit for bit what medoid_sweep
// returns for column cols[s] (for row_stats, for a column whose row is
// rows[s]), so a cached row and a fresh sweep cannot be told apart.
//
// Bound on the H100: bytes. spec_sweep reads the matrix and w once and
// writes S rows; row_stats reads S rows and w. The sums keep medoid_sweep's
// order: its logical thread tid < 64 of logical CTA b < B owns the same
// columns and adds their terms in (tile, v) order into a private histogram
// row (`sweep_column`), then halving trees run over the 64 threads
// (`sweep_cta_row`) and over the B CTAs padded with zeros to 128. Which
// physical thread computes a distance is free. Design:
// * row_stats: a CTA of 64 threads per (logical CTA, row), S x B small CTAs
//   (15.6 KB of histogram each, several an SM). A thread issues the loads
//   of 8 of its tiles (its row and w) at once, then adds their terms in
//   order (`batch_chains`).
// * spec_sweep: a CTA of 512 threads per logical CTA, and a register tile:
//   a thread computes all S rows of kSpecVec = 2 of logical thread tid's 4
//   columns (two threads share them) in every fourth tile. Each matrix
//   value is read once and multiplied by the S seeds' features, read as
//   shared-memory broadcasts, in feature order with separately rounded
//   products and sums (row_sweep's arithmetic). The values come through a
//   ring of 128 KB, 4 stages of 8 features a thread, cp.async copies that
//   the thread alone reads back (no barrier in the stream): 96 KB an SM in
//   flight while a stage is read (loaded into registers 8 features ahead,
//   the stream reached ~12 GB/s an SM). After one barrier, group q of 64
//   threads runs logical thread tid's chains for row q, reading the rows
//   back (L2), into S private histograms (61 x 64 floats each) in the
//   ring's shared memory. The tile has 8 rows whatever S (rows past S
//   multiply zero features and are not written): at S 8 its arithmetic is
//   about a third of the bytes' time. 2 columns a thread against 1 and 4:
//   chip_smoke.py --layouts. Any F_pad: features past it stage as zeros,
//   which add +0 to sums that are never -0.
// * The trees. In a CTA (`batch_cta_rows`) a warp sums 8 or more trees at
//   once by shuffles, whose levels overlap; in the last CTA (`batch_total`),
//   4 lanes a tree keep its first five levels in registers and shuffle the
//   last two. A tree summed by one thread (`sweep_total`, whose 128 loads
//   issue in turn) or kept as an array indexed by a halving loop (which
//   nvcc leaves in local memory) costs microseconds a call; so do shuffles
//   in a loop whose count depends on the warp (they compile as collectives)
//   and 64-bit index arithmetic (chip_smoke.py --layouts, its phase stamps).
// * The cross-CTA finish: an integer ticket elects the last CTA (row_stats
//   has one a row, so its S last CTAs run at once), which copies the
//   partial sums ([s][r][CTA], a sum's CTAs side by side) into its shared
//   memory by 16-byte cp.async copies, all in flight at once, and sums each
//   tree from there with `sweep_total`'s additions, zeros past B. No float
//   atomics; the counts are integers.
constexpr int kSpecSeeds = 8;  // S at most: vamb_tpu's _SPEC_SEEDS
constexpr int kSpecThreads = 512;  // spec_sweep: 8 groups of 64 threads, a row's chains each
constexpr int kSpecChainRows = kSpecThreads / kSweepThreads;  // group q: row q's chains
constexpr int kSpecVec = 2;  // columns of a tile a thread computes, of its logical thread's 4
constexpr int kSpecParts = kSweepVec / kSpecVec;  // threads that share those 4 columns
constexpr int kSpecGroups = kSpecThreads / (kSweepThreads * kSpecParts);  // tiles at once
constexpr int kSpecChunk = 8;  // features of a tile a stage of the ring holds
constexpr int kSpecRingBytes = 128 * 1024;
// stages a thread has staged: all but one in flight while one is read; the
// ring's bytes are the same for both element types, so a bf16 ring holds
// twice the stages
template <class T>
__host__ __device__ constexpr int spec_ring() {
  return kSpecRingBytes / (kSpecChunk * kSpecThreads * kSpecVec * (int)sizeof(T));
}
constexpr int kChainTiles = 8;  // tiles whose loads a chain issues at once
constexpr int kBatchHist = kSweepRows * kSweepThreads;  // a row's histogram: 61 x 64 floats
constexpr int kRowStatsSmem = 16 * 1024;  // row_stats: the histogram, then 32 staged sums
static_assert(kSweepThreads == 64, "the CTA tree folds t and t + 32, then a warp's");
static_assert(kSweepMaxBlocks >= 8 && (kSweepMaxBlocks & (kSweepMaxBlocks - 1)) == 0,
              "the last CTA's trees: 4 lanes a tree, a power of two");
static_assert(kSpecSeeds == kSpecChainRows, "group q of 64 threads runs row q's chains");
static_assert(kBatchHist * sizeof(float) <= kRowStatsSmem, "row_stats' histogram fits");
static_assert(kSpecSeeds * kBatchHist * sizeof(float) <= kSpecRingBytes,
              "spec_sweep's histograms fit the ring's shared memory");

// Phase marks of the batch kernels: empty here. A diagnostic build of
// chip_smoke.py --layouts defines them to stamp each CTA's phases with the
// card's clock.
#define BATCH_PHASE(k)

// Publish this CTA's partials and draw a ticket out of n: true in the CTA
// that draws the last one, once every other CTA's partials are visible.
// One thread fences, after the barrier that orders the others' writes
// before its own (fences are cumulative).
__device__ __forceinline__ bool batch_ticket(unsigned int* ticket, unsigned int n) {
  __shared__ bool s_last;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    s_last = atomicAdd(ticket, 1u) == n - 1;
    if (s_last) __threadfence();
  }
  __syncthreads();
  return s_last;
}

// `warp_tree` of kN values at once, level by level, so their shuffles
// overlap: lane 0 of v[j] ends with warp_tree(v[j]).
template <int kN>
__device__ __forceinline__ void warp_trees(float (&v)[kN]) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int j = 0; j < kN; ++j) v[j] = __fadd_rn(v[j], __shfl_down_sync(0xffffffffu, v[j], off));
  }
}

// The CTA's partial rows: for each of its rows s < n_rows and sums r < 61, a warp sums the 64 threads' values hist_s[r][t] by
// halving64's tree, lane l adding t = l and t = l + 32 from shared memory,
// `warp_trees` the rest, and lane 0 writes partial [s][r][b] (b =
// blockIdx.x; the CTAs of a sum side by side, so the last CTA reads them
// in whole lines). Warp w takes the sums r = w, w + kWarps, ... of each
// row at once (r past 60 reads sum 0 and writes nothing): loops whose
// counts are the same in every warp, so the shuffles are under no branch
// and overlap.
template <int kWarps>
__device__ __forceinline__ void batch_cta_rows(const float* __restrict__ hist0, int n_rows,
                                               float* __restrict__ partials) {
  constexpr int kPer = (kSweepRows + kWarps - 1) / kWarps;  // a warp's sums of a row
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll 1
  for (int s = 0; s < n_rows; ++s) {
    float v[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int r = warp + j * kWarps;
      const float* row = hist0 + s * kBatchHist + (r < kSweepRows ? r : 0) * kSweepThreads;
      v[j] = __fadd_rn(row[lane], row[lane + 32]);
    }
    warp_trees(v);
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int r = warp + j * kWarps;
      if (lane == 0 && r < kSweepRows) {
        partials[(s * kSweepSlots + r) * kSweepMaxBlocks + blockIdx.x] = v[j];
      }
    }
  }
}

constexpr int kStagedStride = kSweepMaxBlocks + 4;  // a staged sum's floats: 4 mod 32

// x[m] += x[m + kH] for m < kH, then the same for kH / 2, ..., 1: levels
// written out by the template (a loop that halves its bound is not
// unrolled by nvcc, and the array then lives in local memory, as
// halving64's does).
template <int kH, int kN>
__device__ __forceinline__ void fold_levels(float (&x)[kN]) {
  if constexpr (kH >= 1) {
#pragma unroll
    for (int m = 0; m < kH; ++m) x[m] = __fadd_rn(x[m], x[m + kH]);
    fold_levels<kH / 2>(x);
  }
}

// The last CTA: the totals of rows s0 <= s < s1 over the nb CTAs' partials
// ([s][r][b]) into sums (S, 61), and of their counts into counts (S, 2).
// The (s, r) pairs go kRound at a time, as many as `stage` holds: each
// pair's kSweepMaxBlocks partials copied by 16-byte cp.async copies, all
// in flight at once (the first round's while a warp a (row, count) adds
// the counts), kStagedStride floats apart. Then 4 lanes a pair: lane q
// holds t = q, q + 4, ... (zeros past nb), and sweep_total's tree pairs t
// with t + 64, + 32, + 16, + 8 and + 4 (at 128 CTAs) within the lane, in
// registers; t + 2 and t + 1 are two shuffles. 8 pairs a warp at once,
// whose loads meet no bank twice.
template <int kWarps, int kRound>
__device__ void batch_total(const float* __restrict__ partials,
                            const int* __restrict__ count_partials, int nb, int s0, int s1,
                            float* __restrict__ stage, float* __restrict__ sums,
                            int* __restrict__ counts) {
  constexpr int kSumVecs = kSweepMaxBlocks / 4;  // float4 of a sum's partials
  constexpr int kGroups = (kRound + 8 * kWarps - 1) / (8 * kWarps);  // a warp's 8 pairs at once
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int total = (s1 - s0) * kSweepRows;  // pair e: row s0 + e / 61, sum e % 61
  const float4* src = reinterpret_cast<const float4*>(partials);
  float4* dst = reinterpret_cast<float4*>(stage);
  auto issue = [&](int e0) {
    for (int k = threadIdx.x; k < kRound * kSumVecs; k += blockDim.x) {
      const int e = e0 + k / kSumVecs;
      if (e < total) {
        const int sr = (s0 + e / kSweepRows) * kSweepSlots + e % kSweepRows;
        cp_async16(dst + k / kSumVecs * (kStagedStride / 4) + k % kSumVecs,
                   src + sr * kSumVecs + k % kSumVecs);
      }
    }
    cp_async_commit();
  };
  issue(0);
  for (int i = 0; i < (2 * kSpecSeeds + kWarps - 1) / kWarps; ++i) {
    const int e = warp + i * kWarps;  // (row s0 + e / 2, count e % 2)
    const int row = (s0 + e / 2) * kSweepMaxBlocks;
    int c = 0;
#pragma unroll
    for (int j = 0; j < kSweepMaxBlocks / 32; ++j) {
      const int b = lane + 32 * j;
      c += e < (s1 - s0) * 2 && b < nb ? __ldcg(count_partials + (row + b) * 2 + e % 2) : 0;
    }
    c = __reduce_add_sync(0xffffffffu, c);
    if (lane == 0 && e < (s1 - s0) * 2) counts[(s0 + e / 2) * 2 + e % 2] = c;
  }
  const int q = lane & 3;
  for (int e0 = 0; e0 < total; e0 += kRound) {
    if (e0 != 0) issue(e0);
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll 1
    for (int g = 0; g < kGroups; ++g) {
      const int i = (g * kWarps + warp) * 8 + (lane >> 2);  // this lane's staged pair
      const float* p = stage + (i < kRound ? i : 0) * kStagedStride + q;
      float x[kSweepMaxBlocks / 4];
#pragma unroll
      for (int m = 0; m < kSweepMaxBlocks / 4; ++m) x[m] = q + 4 * m < nb ? p[4 * m] : 0.0f;
      fold_levels<kSweepMaxBlocks / 8>(x);
      x[0] = __fadd_rn(x[0], __shfl_down_sync(0xffffffffu, x[0], 2));
      x[0] = __fadd_rn(x[0], __shfl_down_sync(0xffffffffu, x[0], 1));
      const int e = e0 + i;
      if (q == 0 && i < kRound && e < total) {
        sums[(s0 + e / kSweepRows) * kSweepRows + e % kSweepRows] = x[0];
      }
    }
    __syncthreads();
  }
}

// A column's terms for group g: medoid_sweep's, and the near count.
__device__ __forceinline__ void batch_column(float (*s_acc)[kSweepThreads], int tid, float d,
                                             float wv, float& dens, int& close, int& near) {
  sweep_column(s_acc, tid, d, wv, dens, close);
  near += wv > 0.0f && d <= kMedoidRadius;
}

// A thread's 4 columns from n0 (zeros past n_pad, or all of them where
// !live); kVec: one 16-byte load, made whatever `live` (from column 0 where
// not), so that a batch of them issues at once. kRO reads through the
// read-only cache; else plain loads, for rows this CTA wrote before a
// barrier.
template <bool kVec, bool kRO>
__device__ __forceinline__ void load_cols(const float* p, int n0, int n_pad, bool live,
                                          float (&x)[kSweepVec]) {
  if constexpr (kVec) {
    const float4* q = reinterpret_cast<const float4*>(p + (live ? n0 : 0));
    float4 v = kRO ? __ldg(q) : *q;
    if (!live) v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    unpack(v, x);
  } else {
#pragma unroll
    for (int v = 0; v < kSweepVec; ++v) {
      x[v] = live && n0 + v < n_pad ? (kRO ? __ldg(p + n0 + v) : p[n0 + v]) : 0.0f;
    }
  }
}

// Logical thread tid's chains of one row (its histogram at hist): the
// terms of its columns in (tile, v) order, as medoid_sweep's thread adds
// them, and the row's close and near counts. The row and w loads of
// kChainTiles tiles go out at once; the row's are plain loads (spec_sweep's
// were written by this CTA).
template <bool kVec>
__device__ __forceinline__ void batch_chains(const float* row, const float* __restrict__ w,
                                             int n_pad, int ntile, int tid, float* hist,
                                             int& close, int& near) {
  float (*s_acc)[kSweepThreads] = reinterpret_cast<float (*)[kSweepThreads]>(hist);
  float dens = 0.0f;
  close = 0;
  near = 0;
  auto first_col = [&](int i) {
    return ((blockIdx.x + i * gridDim.x) * kSweepThreads + tid) * kSweepVec;
  };
  for (int i0 = 0; i0 < ntile; i0 += kChainTiles) {
    float dv[kChainTiles][kSweepVec], wv[kChainTiles][kSweepVec];
#pragma unroll
    for (int k = 0; k < kChainTiles; ++k) {
      const int n0 = first_col(i0 + k);
      const bool live = i0 + k < ntile && n0 < n_pad;
      load_cols<kVec, true>(w, n0, n_pad, live, wv[k]);
      load_cols<kVec, false>(row, n0, n_pad, live, dv[k]);
    }
#pragma unroll
    for (int k = 0; k < kChainTiles; ++k) {
      const int n0 = first_col(i0 + k);
      if (i0 + k >= ntile || n0 >= n_pad) continue;
#pragma unroll
      for (int v = 0; v < kSweepVec; ++v) {
        if (n0 + v < n_pad) batch_column(s_acc, tid, dv[k][v], wv[k][v], dens, close, near);
      }
    }
  }
  hist[kNbins * kSweepThreads + tid] = dens;
}

// kVec: N_pad % 4 == 0 and m, w, rows 16-byte aligned (cp.async copies,
// float4 loads and stores); else scalar loads and stores, zeros past N_pad.
// The register tile has kSpecSeeds rows whatever S: those past S are
// computed on zero features and not written.
template <class T, bool kVec>
__global__ void __launch_bounds__(kSpecThreads, 1)
spec_sweep_kernel(const T* __restrict__ m, int f_pad, int n_pad, int c0, int c1, int c2,
                  int c3, int c4, int c5, int c6, int c7, int s_count,
                  const float* __restrict__ q, const float* __restrict__ w,
                  float* __restrict__ rows,
                  float* __restrict__ partials, int* __restrict__ count_partials,
                  unsigned int* __restrict__ tickets, float* __restrict__ sums,
                  int* __restrict__ counts) {
  // dynamic: the seeds' features, feature f's 8 at feat4[2f], feat4[2f + 1]
  // (zeros past f_pad and S), then one region that holds in turn the ring
  // of staged features, the S histograms and the last CTA's staged rows
  extern __shared__ float4 s_dyn[];
  __shared__ int s_cnt[kSpecSeeds][2][2];  // [row][its warp][close, near]
  constexpr int kSpecRing = spec_ring<T>();
  using Vec = typename ColsOf<T, kSpecVec>::Vec;  // a thread's columns of a feature
  using RowVec = typename VecOf<kSpecVec>::T;  // and of a row
  const int nq = (f_pad + kSpecChunk - 1) / kSpecChunk;
  const float4* feat4 = s_dyn;
  // [kSpecRing][kSpecChunk][kSpecThreads] vectors of kSpecVec columns
  auto ring = reinterpret_cast<Vec*>(s_dyn + (size_t)nq * kSpecChunk * 2);
  float* hist0 = reinterpret_cast<float*>(ring);
  auto col_of = [&](int s) {
    const int c[kSpecSeeds] = {c0, c1, c2, c3, c4, c5, c6, c7};
    int x = c0;
#pragma unroll
    for (int k = 1; k < kSpecSeeds; ++k) x = s == k ? c[k] : x;
    return x;
  };
  const int q0 = threadIdx.x / kSweepThreads;
  const int tid = threadIdx.x % kSweepThreads;
  const int part = q0 % kSpecParts;  // columns 4 tid + kSpecVec part, ... of a tile
  const int grp = q0 / kSpecParts;  // tiles grp, grp + kSpecGroups, ...
  const int tiles = (n_pad + kSweepTileCols - 1) / kSweepTileCols;
  const int ntile = (tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;
  const int mine = grp < ntile ? (ntile - 1 - grp) / kSpecGroups + 1 : 0;
  auto first_col = [&](int j) {  // of this thread's j-th tile
    return ((blockIdx.x + (grp + j * kSpecGroups) * gridDim.x) * kSweepThreads + tid) *
               kSweepVec + part * kSpecVec;
  };
  // the stages in order: features 8q.. of the thread's j-th tile, q < nq;
  // stage i goes to ring buffer i % kSpecRing, this thread's kSpecVec
  // columns of each of its 8 features, read back by this thread alone (no
  // barrier)
  int iss_j = 0, iss_q = 0, iss_buf = 0;  // the next stage to issue
  auto issue = [&]() {
    const int n0 = first_col(iss_j);
    if (iss_j < mine && n0 < n_pad) {
      Vec* dst = ring + iss_buf * kSpecChunk * kSpecThreads + threadIdx.x;
      const T* src = m + (size_t)(iss_q * kSpecChunk) * n_pad + n0;
#pragma unroll
      for (int k = 0; k < kSpecChunk; ++k) {
        const T* p = src + (size_t)k * n_pad;
        if (iss_q * kSpecChunk + k >= f_pad) {
          dst[k * kSpecThreads] = Vec{};
        } else if constexpr (kVec) {
          cp_async_vec(dst + k * kSpecThreads, p);
        } else {
          T* x = reinterpret_cast<T*>(dst + k * kSpecThreads);
#pragma unroll
          for (int v = 0; v < kSpecVec; ++v) x[v] = n0 + v < n_pad ? p[v] : T{};
        }
      }
    }
    cp_async_commit();
    iss_buf = iss_buf + 1 == kSpecRing ? 0 : iss_buf + 1;
    if (++iss_q == nq) {
      iss_q = 0;
      ++iss_j;
    }
  };
  float acc[kSpecSeeds][kSpecVec];
  // stage (j, q) from ring buffer `buf`
  auto compute = [&](int n0, int q, int buf) {
    const Vec* x = ring + buf * kSpecChunk * kSpecThreads + threadIdx.x;
#pragma unroll
    for (int k = 0; k < kSpecChunk; ++k) {
      float xv[kSpecVec];
      widen_cols<T>(x[k * kSpecThreads], xv);
      float c[kSpecSeeds];
      const float4 lo = feat4[(q * kSpecChunk + k) * 2];
      const float4 hi = feat4[(q * kSpecChunk + k) * 2 + 1];
      c[0] = lo.x;
      c[1] = lo.y;
      c[2] = lo.z;
      c[3] = lo.w;
      c[4] = hi.x;
      c[5] = hi.y;
      c[6] = hi.z;
      c[7] = hi.w;
#pragma unroll
      for (int s = 0; s < kSpecSeeds; ++s) {
#pragma unroll
        for (int v = 0; v < kSpecVec; ++v) acc[s][v] = mul_add_rn(acc[s][v], xv[v], c[s]);
      }
    }
  };
  // a tile's rows, once its last stage is in
  auto write_rows = [&](int n0) {
#pragma unroll
    for (int s = 0; s < kSpecSeeds; ++s) {
      if (s >= s_count) continue;
      RowVec out;  // the rows are float whatever the matrix's type
      float* dv = reinterpret_cast<float*>(&out);
#pragma unroll
      for (int v = 0; v < kSpecVec; ++v) {
        dv[v] = (n0 + v == col_of(s)) ? 0.0f : __fsub_rn(0.5f, acc[s][v]);
      }
      float* dst = rows + (size_t)s * n_pad + n0;
      if constexpr (kVec) {
        *reinterpret_cast<RowVec*>(dst) = out;
      } else {
#pragma unroll
        for (int v = 0; v < kSpecVec; ++v) {
          if (n0 + v < n_pad) dst[v] = dv[v];
        }
      }
    }
  };

  BATCH_PHASE(0);
#pragma unroll 1
  for (int st = 0; st < kSpecRing; ++st) issue();  // the copies overlap the set-up
  {
    float* feat = reinterpret_cast<float*>(s_dyn);
    for (int k = threadIdx.x; k < nq * kSpecChunk * kSpecSeeds; k += kSpecThreads) {
      const int f = k / kSpecSeeds;
      const int s = k % kSpecSeeds;
      feat[k] = !(f < f_pad && s < s_count) ? 0.0f
                : q != nullptr              ? q[(size_t)f * s_count + s]
                                            : widen(m[(size_t)f * n_pad + col_of(s)]);
    }
  }
  __syncthreads();
  int buf = 0;  // the ring buffer of the next stage to read
  for (int j = 0; j < mine; ++j) {
    const int n0 = first_col(j);
#pragma unroll
    for (int s = 0; s < kSpecSeeds; ++s) {
#pragma unroll
      for (int v = 0; v < kSpecVec; ++v) acc[s][v] = 0.0f;
    }
    for (int q = 0; q < nq; ++q) {
      cp_async_wait<kSpecRing - 1>();  // this stage has landed
      if (n0 < n_pad) compute(n0, q, buf);
      issue();  // into the buffer just read
      buf = buf + 1 == kSpecRing ? 0 : buf + 1;
    }
    if (n0 < n_pad) write_rows(n0);
  }
  BATCH_PHASE(1);
  cp_async_wait<0>();
  __syncthreads();  // the CTA's rows are written and the ring is free
  BATCH_PHASE(2);

  // thread (q0, tid) runs logical thread tid's chains of row q0
  int close = 0, near = 0;
  if (q0 < s_count) {
#pragma unroll 4
    for (int k = 0; k < kSweepRows; ++k) hist0[q0 * kBatchHist + k * kSweepThreads + tid] = 0.0f;
    batch_chains<kVec>(rows + (size_t)q0 * n_pad, w, n_pad, ntile, tid, hist0 + q0 * kBatchHist,
                       close, near);
  }
  BATCH_PHASE(3);
  const int wc = __reduce_add_sync(0xffffffffu, close);
  const int wn = __reduce_add_sync(0xffffffffu, near);
  if ((threadIdx.x & 31) == 0 && q0 < s_count) {
    s_cnt[q0][(threadIdx.x >> 5) & 1][0] = wc;
    s_cnt[q0][(threadIdx.x >> 5) & 1][1] = wn;
  }
  __syncthreads();
  // the CTA's partial rows
  BATCH_PHASE(4);
  batch_cta_rows<kSpecThreads / 32>(hist0, s_count, partials);
  BATCH_PHASE(5);
  if (threadIdx.x < s_count * 2) {
    const int s = threadIdx.x / 2;
    const int j = threadIdx.x % 2;
    count_partials[((size_t)s * kSweepMaxBlocks + blockIdx.x) * 2 + j] = s_cnt[s][0][j] + s_cnt[s][1][j];
  }
  const bool last = batch_ticket(tickets, gridDim.x);
  BATCH_PHASE(6);
  if (!last) return;
  batch_total<kSpecThreads / 32, kSpecRingBytes / 4 / kStagedStride>(
      partials, count_partials, gridDim.x, 0, s_count, hist0, sums, counts);
  if (threadIdx.x == 0) tickets[0] = 0u;
  BATCH_PHASE(7);
}

// A CTA of 64 threads per (logical CTA blockIdx.x, row blockIdx.y); the
// row's ticket elects its last CTA.
template <bool kVec>
__global__ void __launch_bounds__(kSweepThreads)
row_stats_kernel(const float* __restrict__ rows, int n_pad, const float* __restrict__ w,
                 float* __restrict__ partials, int* __restrict__ count_partials,
                 unsigned int* __restrict__ tickets, float* __restrict__ sums,
                 int* __restrict__ counts) {
  extern __shared__ float4 s_dyn[];  // the histogram, then the last CTA's staged rows
  __shared__ int s_cnt[2][2];  // [warp][close, near]
  float* hist = reinterpret_cast<float*>(s_dyn);
  const int s = blockIdx.y;
  const int tid = threadIdx.x;
  BATCH_PHASE(0);
#pragma unroll 4
  for (int r = 0; r < kSweepRows; ++r) hist[r * kSweepThreads + tid] = 0.0f;
  const int tiles = (n_pad + kSweepTileCols - 1) / kSweepTileCols;
  const int ntile = (tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;
  int close, near;
  batch_chains<kVec>(rows + (size_t)s * n_pad, w, n_pad, ntile, tid, hist, close, near);
  BATCH_PHASE(3);
  const int wc = __reduce_add_sync(0xffffffffu, close);
  const int wn = __reduce_add_sync(0xffffffffu, near);
  if ((tid & 31) == 0) {
    s_cnt[tid >> 5][0] = wc;
    s_cnt[tid >> 5][1] = wn;
  }
  __syncthreads();
  // the CTA's partial rows
  BATCH_PHASE(4);
  batch_cta_rows<kSweepThreads / 32>(hist, 1, partials + (size_t)s * kSweepSlots * kSweepMaxBlocks);
  BATCH_PHASE(5);
  if (tid < 2) count_partials[((size_t)s * kSweepMaxBlocks + blockIdx.x) * 2 + tid] = s_cnt[0][tid] + s_cnt[1][tid];
  const bool last = batch_ticket(tickets + s, gridDim.x);
  BATCH_PHASE(6);
  if (!last) return;
  batch_total<kSweepThreads / 32, kRowStatsSmem / 4 / kStagedStride>(
      partials, count_partials, gridDim.x, s, s + 1, hist, sums, counts);
  if (tid == 0) tickets[s] = 0u;
  BATCH_PHASE(7);
}

// The dynamic shared memory a batch kernel may take above 48 KB, raised
// once for each kernel to the most it has asked for.
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem, size_t& allowed) {
  if (smem <= allowed) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) allowed = smem;
  return e;
}

// -------------------------------------------------------------- gumbel_topc
//
// Replaces a wander step's draw and selection in `vamb_tpu` (cluster.py
// :674-681 and :775-782): the eager threefry uniform, the two `jnp.log`s and
// `jax.lax.top_k(score, C)`. Each column's Gumbel score is
// -log(-log(u + 1e-20) + 1e-20), u = jax.random.uniform(k1, (n,)), or -inf
// where the column is not eligible ((d <= 0.05) & kept & ~tried, not the
// medoid's slot); the step's candidates are the C columns that top_k
// returns: score descending, equal scores by index ascending (XLA's CPU
// TopK, which compares the scores' bits as integers, so -0.0 < +0.0 and
// -inf lowest; the -inf slots are the lowest-index ineligible columns). One
// launch a step, bit for bit what `gumbel_topc_plain` computes, which is
// `vamb_tpu`'s:
//   * the counter (0, i) hashed by Threefry-2x32 under the step's key, the
//     two output words xor-ed (`threefry.bits`);
//   * the unit float from the word's top 23 bits (`threefry._unit_floats`);
//   * both logs as XLA's CPU code computes them (`threefry._log_core`): the
//     denormal flush, the same constants and the three interleaved FMA
//     chains, each FMA an __fmaf_rn and every other step an __fadd_rn /
//     __fmul_rn, so the build's default -fmad=true contracts nothing.
// What bounds it on the H100: its integer operations. The hash is 20 rounds
// of an add, a rotate and a xor, with 5 key injections: about 75 int32
// operations a column at 64 a clock an SM (132 SMs, 1,980 MHz: 1.67e13 a
// second), against 6 bytes a column read (d, kept, tried) at 3.35 TB/s.
// The design keeps the scores out of device memory (they are written only
// when the caller asks, for checks) and selects in registers:
//   * One key a column: the score's bits mapped to an order-preserving
//     uint32 in the high word, the inverted index in the low word, so
//     (score desc, index asc) is one unsigned 64-bit compare, keys are
//     unique, and the top C of them are top_k's, ties and -inf slots
//     included, with no special case.
//   * A warp keeps the 32 largest keys it has seen, one a lane, descending.
//     A round of 32 new columns (a lane each) is sorted by a bitonic network
//     of shuffles and merged in (a max against the reversed list, then a
//     5-step bitonic merge), unless no new key beats the list's C-th.
//   * A CTA of 16 warps folds its lists pairwise through shared memory; the
//     grid is at most one CTA an SM with a grid-stride loop over the columns.
//     A CTA whose columns are all ineligible still yields its lowest
//     indices, which the -inf slots need.
//   * Each CTA writes its 32 keys; the CTA that draws the last ticket of an
//     integer atomic counter merges the CTAs' lists the same way (warp w
//     loads lists w, w + 16, ... at once, then merges them), writes the
//     first C and resets the counter. The top C of a total order is
//     unique, so the result does not depend on which CTA finishes last or
//     on the grid. No float atomics.
//   * C above 32 goes in rounds of 32, a launch each (C 40 and 64: two, C
//     100: four): round r takes the 32 largest keys strictly below round
//     r - 1's last, which it reads on the card from the keys round r - 1
//     wrote, so the host never waits. The keys are unique and totally
//     ordered, so the rounds' lists, one after another, are the top C in
//     top_k's order, -inf slots included. Each round hashes every column
//     again (the hash is the bound; the scores are written once, in round
//     0, where asked).
// With C = 0 it writes the scores alone (`gumbel_scores`).

constexpr int kTopcThreads = 512;  // gumbel_topc: 16 warps a CTA
constexpr int kTopcWarps = kTopcThreads / 32;
constexpr int kTopcListsPerWarp = 9;  // the last CTA's loads a warp
constexpr int kTopcMaxCtas = kTopcWarps * kTopcListsPerWarp;  // 144: one CTA an SM on 132
constexpr float kFltMin = 1.17549435e-38f;

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// Threefry-2x32, 20 rounds, of the counter pair (x0, x1) under (k0, k1):
// jax's `_threefry2x32_lowering`. Returns the xor of the two output words.
__device__ __forceinline__ uint32_t threefry_xor(uint32_t k0, uint32_t k1, uint32_t x0,
                                                uint32_t x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[8] = {13, 15, 26, 6, 17, 29, 16, 24};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl32(x1, rot[(i & 1) * 4 + j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
  return x0 ^ x1;
}

// XLA's float32 log on the CPU (`threefry.log_xla`), step by step.
__device__ __forceinline__ float log_xla(float x) {
  const float y = fabsf(x) < kFltMin ? __fmul_rn(x, 0.0f) : x;  // denormals flushed
  const int bits = __float_as_int(y > kFltMin ? y : kFltMin);
  const int e = bits >> 23;
  const float m = __int_as_float((bits & 0x7FFFFF) | 0x3F000000);
  const float ef = __fadd_rn(__int2float_rn(e - 127), 1.0f);
  const bool lt = m < 0.70710677f;
  const float t = lt ? m : 0.0f;
  const float xm = __fadd_rn(m, -1.0f);
  const float e2 = __fsub_rn(ef, lt ? 1.0f : 0.0f);
  const float v = __fadd_rn(xm, t);
  const float z = __fmul_rn(v, v);
  const float v3 = __fmul_rn(z, v);
  float a = __fmaf_rn(v, 0.070376836f, -0.1151461f);
  float b = __fmaf_rn(v, -0.12420141f, 0.14249323f);
  float c = __fmaf_rn(v, 0.20000714f, -0.24999994f);
  a = __fmaf_rn(a, v, 0.116769984f);
  b = __fmaf_rn(b, v, -0.16668057f);
  c = __fmaf_rn(c, v, 0.3333333f);
  float r = __fmaf_rn(a, v3, b);
  r = __fmaf_rn(r, v3, c);
  const float s2 = __fmaf_rn(r, v3, __fmul_rn(e2, -0.00021219444f));
  const float u = __fsub_rn(v, __fmul_rn(z, 0.5f));
  const float res = __fadd_rn(__fadd_rn(u, s2), __fmul_rn(e2, 0.6933594f));
  int out = !(y > 0.0f) ? -1 : __float_as_int(res);  // NaN (all bits set) at <= 0 or NaN
  if (y == CUDART_INF_F) out = 0x7F800000;
  if (y == 0.0f) out = (int)0xFF800000u;
  return __int_as_float(out);
}

// Column i's masked Gumbel score.
// Local column i is global column offset + i: its counter and its index.
__device__ __forceinline__ float gumbel_score(uint32_t k0, uint32_t k1, int i, int offset,
                                              const float* __restrict__ d,
                                              const unsigned char* __restrict__ kept,
                                              const unsigned char* __restrict__ tried, int medoid) {
  const uint32_t word = threefry_xor(k0, k1, 0u, (uint32_t)(offset + i));
  const float unit = fmaxf(__fsub_rn(__uint_as_float((word >> 9) | 0x3F800000u), 1.0f), 0.0f);
  const float g = -log_xla(__fadd_rn(-log_xla(__fadd_rn(unit, 1e-20f)), 1e-20f));
  const bool elig = (d[i] <= kMedoidRadius) && kept[i] && !tried[i] && offset + i != medoid;
  return elig ? g : -CUDART_INF_F;
}

using TopKey = unsigned long long;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr uint32_t kNegInfOrder = 0x007FFFFFu;  // the high word of -inf's key

// (score desc, index asc) as one unsigned compare. The high word maps the
// score's bits to an order-preserving uint32 (XLA's TopK integer order plus
// 2^31); key 0 is below every column's and stands for no column.
__device__ __forceinline__ TopKey topc_key(float s, int i) {
  const uint32_t b = __float_as_uint(s);
  const uint32_t o = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return ((TopKey)o << 32) | (TopKey)(0xFFFFFFFFu - (uint32_t)i);
}

__device__ __forceinline__ TopKey key_max(TopKey a, TopKey b) { return a > b ? a : b; }
__device__ __forceinline__ TopKey key_min(TopKey a, TopKey b) { return a < b ? a : b; }

// Sorts the warp's 32 keys (one a lane) ascending across the lanes: the
// bitonic network, stage k merging runs of k/2 sorted in turn up and down.
__device__ __forceinline__ TopKey warp_sort_ascending(TopKey x, int lane) {
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const TopKey y = __shfl_xor_sync(kFullMask, x, j);
      x = (((lane & k) == 0) != ((lane & j) == 0)) ? key_max(x, y) : key_min(x, y);
    }
  }
  return x;
}

// The 32 largest of a descending list `top` and an ascending list `up`
// (a lane each), descending: their lane-wise maxima form a bitonic
// sequence that holds those 32, and a bitonic merge sorts it.
__device__ __forceinline__ TopKey warp_top(TopKey top, TopKey up, int lane) {
  TopKey x = key_max(top, up);
#pragma unroll
  for (int j = 16; j > 0; j >>= 1) {
    const TopKey y = __shfl_xor_sync(kFullMask, x, j);
    x = (lane & j) == 0 ? key_max(x, y) : key_min(x, y);
  }
  return x;
}

// Folds the CTA's warp lists pairwise through shared memory; warp 0 ends
// with the CTA's 32 largest keys, descending.
__device__ __forceinline__ TopKey cta_top(TopKey top, TopKey (*s_top)[32], int warp, int lane) {
  s_top[warp][lane] = top;
  __syncthreads();
#pragma unroll
  for (int h = kTopcWarps / 2; h > 0; h >>= 1) {
    if (warp < h) {
      top = warp_top(top, s_top[warp + h][31 - lane], lane);
      s_top[warp][lane] = top;
    }
    __syncthreads();
  }
  return top;
}

__global__ void __launch_bounds__(kTopcThreads) gumbel_topc_kernel(
    uint32_t k0, uint32_t k1, int n, int offset, const float* __restrict__ d,
    const unsigned char* __restrict__ kept, const unsigned char* __restrict__ tried, int medoid,
    int c, float* __restrict__ score, TopKey* __restrict__ partials,
    unsigned int* __restrict__ ticket, long long* __restrict__ cand,
    unsigned char* __restrict__ valid, TopKey* __restrict__ keys,
    const TopKey* __restrict__ prev) {
  __shared__ TopKey s_top[kTopcWarps][32];
  __shared__ bool s_last;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // a later round's columns: those whose keys lie below the last key of the
  // round before, `prev` (stored with its sign bit flipped); all in round 0
  const TopKey below = prev == nullptr ? ~0ull : *prev ^ 0x8000000000000000ull;
  TopKey top = 0;  // the warp's 32 largest keys so far, descending across the lanes
  TopKey kth = 0;  // top's C-th: a key at or below it cannot enter the top C
  const int stride = gridDim.x * kTopcThreads;
  for (int base = blockIdx.x * kTopcThreads + warp * 32; base < n; base += stride) {
    const int i = base + lane;
    TopKey key = 0;
    if (i < n) {
      const float s = gumbel_score(k0, k1, i, offset, d, kept, tried, medoid);
      if (score != nullptr) score[i] = s;
      key = topc_key(s, offset + i);
      if (key >= below) key = 0;  // taken by an earlier round
    }
    if (c > 0 && __any_sync(kFullMask, key > kth)) {
      top = warp_top(top, warp_sort_ascending(key, lane), lane);
      kth = __shfl_sync(kFullMask, top, c - 1);
    }
  }
  if (c == 0) return;
  top = cta_top(top, s_top, warp, lane);
  if (warp == 0) partials[(size_t)blockIdx.x * 32 + lane] = top;
  // the ticket: publish this CTA's list, then count it as done
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // the last CTA: warp w merges the lists of CTAs w, w + 16, ..., read
  // reversed (ascending) and all loaded before the first merge, skipping a
  // list none of whose keys beats the C-th
  TopKey up[kTopcListsPerWarp];
#pragma unroll
  for (int r = 0; r < kTopcListsPerWarp; ++r) {
    const int b = warp + r * kTopcWarps;
    up[r] = b < (int)gridDim.x ? __ldcg(partials + (size_t)b * 32 + 31 - lane) : 0ull;
  }
  top = 0;
  kth = 0;
#pragma unroll
  for (int r = 0; r < kTopcListsPerWarp; ++r) {
    if (__any_sync(kFullMask, up[r] > kth)) {
      top = warp_top(top, up[r], lane);
      kth = __shfl_sync(kFullMask, top, c - 1);
    }
  }
  top = cta_top(top, s_top, warp, lane);
  if (warp == 0 && lane < c) {
    cand[lane] = (long long)(0xFFFFFFFFu - (uint32_t)top);
    valid[lane] = (uint32_t)(top >> 32) > kNegInfOrder;
    // the key with its sign bit flipped: as a signed 64-bit integer, the
    // plain version's `topc_keys` (the order word there is XLA's, 2^31 below)
    if (keys != nullptr) keys[lane] = top ^ 0x8000000000000000ull;
  }
  if (threadIdx.x == 0) *ticket = 0u;
}

// The launches of the three kernels that read the matrix, for either
// element type (the C functions below name the type).
template <class T>
int density_launch(const T* m, int f_pad, int n_pad, const void* cand, int cand64, int c,
                   const float* q, const float* w, int groups, float* partials, unsigned int* ticket,
                   float* dens, void* stream) {
  if (c < 1 || groups < 1 || groups > c || groups > 65535 ||
      (c + groups - 1) / groups > kDensTile || n_pad < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid(density_col_blocks(n_pad), groups);
  const bool f32 = f_pad == kEngineF && n_pad % kDensVec == 0 &&
                   (uintptr_t)m % sizeof(DensCols<T>) == 0 &&
                   (uintptr_t)w % sizeof(DensVec) == 0;
  if (f32) {
    static_assert(density_smem<T>() <= 48 * 1024,
                  "more than 48 KB of dynamic shared memory needs cudaFuncSetAttribute");
    candidate_density_kernel<T, true><<<grid, kDensThreads, density_smem<T>(),
                                        (cudaStream_t)stream>>>(
        m, f_pad, n_pad, cand, cand64, c, q, w, partials, ticket, dens);
  } else {
    const size_t smem = (size_t)f_pad * kDensTile * sizeof(float);
    candidate_density_kernel<T, false><<<grid, kDensThreads, smem, (cudaStream_t)stream>>>(
        m, f_pad, n_pad, cand, cand64, c, q, w, partials, ticket, dens);
  }
  return counted(kLaunchDensity);
}

template <class T>
int medoid_sweep_launch(const T* m, int f_pad, int n_pad, int idx, const float* q, const float* w,
                        float* d, float* partials, int* close_partials, unsigned int* ticket,
                        float* hist, float* density, int* n_close, void* stream) {
  if (n_pad < 1 || idx < (q != nullptr ? -1 : 0) || idx >= n_pad) {
    return (int)cudaErrorInvalidValue;
  }
  const int blocks = sweep_col_blocks(n_pad);
  const bool f32 = f_pad == kEngineF && n_pad % kSweepVec == 0 &&
                   (uintptr_t)m % sizeof(SweepCols<T>) == 0 && (uintptr_t)w % 16 == 0 &&
                   (uintptr_t)d % 16 == 0;
  if (f32) {
    constexpr size_t smem = kSweepChunks * kSweepChunk * kSweepThreads * sizeof(SweepCols<T>) +
                            kEngineF * sizeof(float);
    static_assert(smem + sizeof(float) * kSweepRows * (kSweepThreads + 1) + 64 <= 48 * 1024,
                  "more than 48 KB of shared memory needs cudaFuncSetAttribute");
    medoid_sweep_kernel<T, true><<<blocks, kSweepThreads, smem, (cudaStream_t)stream>>>(
        m, f_pad, n_pad, idx, q, w, d, partials, close_partials, ticket, hist, density, n_close);
  } else {
    medoid_sweep_kernel<T, false><<<blocks, kSweepThreads, f_pad * sizeof(float),
                                    (cudaStream_t)stream>>>(
        m, f_pad, n_pad, idx, q, w, d, partials, close_partials, ticket, hist, density, n_close);
  }
  return counted(kLaunchMedoid);
}

template <class T>
int spec_sweep_launch(const T* m, int f_pad, int n_pad, int c0, int c1, int c2, int c3, int c4,
                      int c5, int c6, int c7, int s_count, const float* q, const float* w,
                      float* rows, float* partials, int* count_partials, unsigned int* tickets,
                      float* sums, int* counts, void* stream) {
  const int cols[kSpecSeeds] = {c0, c1, c2, c3, c4, c5, c6, c7};
  if (n_pad < 1 || f_pad < 1 || s_count < 1 || s_count > kSpecSeeds) {
    return (int)cudaErrorInvalidValue;
  }
  for (int s = 0; s < s_count; ++s) {
    if (cols[s] < (q != nullptr ? -1 : 0) || cols[s] >= n_pad) return (int)cudaErrorInvalidValue;
  }
  // the features, then the ring, which later holds the histograms and the
  // staged rows
  const size_t nq = (f_pad + kSpecChunk - 1) / kSpecChunk;
  const size_t smem = nq * kSpecChunk * kSpecSeeds * sizeof(float) + kSpecRingBytes;
  const bool vec = n_pad % kSweepVec == 0 && (uintptr_t)m % 16 == 0 && (uintptr_t)w % 16 == 0 &&
                   (uintptr_t)rows % 16 == 0;
  const auto kernel = vec ? spec_sweep_kernel<T, true> : spec_sweep_kernel<T, false>;
  static size_t allowed[2] = {48 * 1024, 48 * 1024};
  const cudaError_t e = allow_smem(kernel, smem, allowed[vec]);
  if (e != cudaSuccess) return (int)e;
  kernel<<<sweep_col_blocks(n_pad), kSpecThreads, smem, (cudaStream_t)stream>>>(
      m, f_pad, n_pad, c0, c1, c2, c3, c4, c5, c6, c7, s_count, q, w, rows, partials,
      count_partials, tickets, sums, counts);
  return counted(kLaunchSpec);
}

int gather_launch(const float* m, int f_pad, int n_pad, const int* bids, int kb, float* out,
                  int nb, const float* w, const unsigned char* kept, const float* d0, int* cols,
                  unsigned char* kept_out, float* w_out, float* d0_out, int col_offset,
                  void* stream) {
  if (kb < 1 || n_pad % kBlockCols) return (int)cudaErrorInvalidValue;
  const int rows = (kGatherThreads / (kBlockCols / 4)) * kGatherCopies;
  const dim3 grid(kb, (f_pad + rows - 1) / rows);
  gather_blocks_kernel<<<grid, kGatherThreads, 0, (cudaStream_t)stream>>>(
      (const float4*)m, f_pad, n_pad / 4, bids, (float4*)out, kb * (kBlockCols / 4), nb, w, kept,
      d0, cols, kept_out, w_out, d0_out, col_offset);
  return counted(kLaunchGather);
}

}  // namespace

extern "C" {

int vt_row_sweep(const float* m, int f_pad, int n_pad, int idx, float* d,
                 void* stream) {
  if (f_pad == kEngineF && n_pad % kRowVec == 0 && (uintptr_t)m % 16 == 0 &&
      (uintptr_t)d % 16 == 0) {
    constexpr int cols = kRowThreads * kRowVec;
    row_sweep_f32_kernel<<<(n_pad + cols - 1) / cols, kRowThreads, 0,
                           (cudaStream_t)stream>>>(m, n_pad, idx, d);
    return counted(kLaunchRowSweepF32);
  }
  row_sweep_any_kernel<<<(n_pad + kRowAnyThreads - 1) / kRowAnyThreads,
                         kRowAnyThreads, f_pad * sizeof(float),
                         (cudaStream_t)stream>>>(m, f_pad, n_pad, idx, d);
  return counted(kLaunchRowSweepAny);
}

int vt_candidate_density(const float* m, int f_pad, int n_pad, const void* cand,
                         int cand64, int c, const float* w, int groups,
                         float* partials, unsigned int* ticket, float* dens,
                         void* stream) {
  return density_launch(m, f_pad, n_pad, cand, cand64, c, nullptr, w, groups, partials, ticket,
                        dens, stream);
}

int vt_candidate_density_bf16(const bf16_t* m, int f_pad, int n_pad, const void* cand,
                              int cand64, int c, const float* w, int groups, float* partials,
                              unsigned int* ticket, float* dens, void* stream) {
  return density_launch(m, f_pad, n_pad, cand, cand64, c, nullptr, w, groups, partials, ticket,
                        dens, stream);
}

int vt_gather_blocks(const float* m, int f_pad, int n_pad, const int* bids, int kb,
                     float* out, int nb, const float* w,
                     const unsigned char* kept, const float* d0, int* cols,
                     unsigned char* kept_out, float* w_out, float* d0_out, void* stream) {
  return gather_launch(m, f_pad, n_pad, bids, kb, out, nb, w, kept, d0, cols, kept_out, w_out,
                       d0_out, 0, stream);
}

// The ball's part on a shard: the shard's blocks by local id, each slot's
// column id global (col_offset, the shard's first global column, added).
int vt_gather_ball_shard(const float* m, int f_pad, int n_pad, const int* bids, int kb,
                         float* out, int nb, const float* w, const unsigned char* kept,
                         const float* d0, int* cols, unsigned char* kept_out, float* w_out,
                         float* d0_out, int col_offset, void* stream) {
  if (cols == nullptr || col_offset < 0) return (int)cudaErrorInvalidValue;
  return gather_launch(m, f_pad, n_pad, bids, kb, out, nb, w, kept, d0, cols, kept_out, w_out,
                       d0_out, col_offset, stream);
}

int vt_medoid_sweep(const float* m, int f_pad, int n_pad, int idx, const float* w, float* d,
                    float* partials, int* close_partials, unsigned int* ticket, float* hist,
                    float* density, int* n_close, void* stream) {
  return medoid_sweep_launch(m, f_pad, n_pad, idx, nullptr, w, d, partials, close_partials, ticket,
                             hist, density, n_close, stream);
}

int vt_medoid_sweep_bf16(const bf16_t* m, int f_pad, int n_pad, int idx, const float* w,
                         float* d, float* partials, int* close_partials, unsigned int* ticket,
                         float* hist, float* density, int* n_close, void* stream) {
  return medoid_sweep_launch(m, f_pad, n_pad, idx, nullptr, w, d, partials, close_partials, ticket,
                             hist, density, n_close, stream);
}

int vt_spec_sweep(const float* m, int f_pad, int n_pad, int c0, int c1, int c2, int c3, int c4,
                  int c5, int c6, int c7, int s_count, const float* w, float* rows,
                  float* partials, int* count_partials, unsigned int* tickets, float* sums,
                  int* counts, void* stream) {
  return spec_sweep_launch(m, f_pad, n_pad, c0, c1, c2, c3, c4, c5, c6, c7, s_count, nullptr, w,
                           rows, partials, count_partials, tickets, sums, counts, stream);
}

int vt_spec_sweep_bf16(const bf16_t* m, int f_pad, int n_pad, int c0, int c1, int c2, int c3,
                       int c4, int c5, int c6, int c7, int s_count, const float* w, float* rows,
                       float* partials, int* count_partials, unsigned int* tickets, float* sums,
                       int* counts, void* stream) {
  return spec_sweep_launch(m, f_pad, n_pad, c0, c1, c2, c3, c4, c5, c6, c7, s_count, nullptr, w,
                           rows, partials, count_partials, tickets, sums, counts, stream);
}

// The shard entry points (a row-sharded engine): the query features come
// from q, a small float32 tensor, where the index entry points read the
// query's column of the local matrix; `idx`, `cols[s]` and the candidate ids
// are the query's local column, or -1 where another rank holds it (no d set
// to 0 then). The staging source is all that changes: every sum keeps its
// order, so a shard entry point given the column's features and its index
// equals the index entry point bit for bit. The `_bf16` variants read a
// bfloat16 shard; their queries stay float32 (the owner's columns widened,
// which is exact), as the index entry points widen the query's column.
int vt_medoid_sweep_shard(const float* m, int f_pad, int n_pad, const float* q, int idx,
                          const float* w, float* d, float* partials, int* close_partials,
                          unsigned int* ticket, float* hist, float* density, int* n_close,
                          void* stream) {
  if (q == nullptr) return (int)cudaErrorInvalidValue;
  return medoid_sweep_launch(m, f_pad, n_pad, idx, q, w, d, partials, close_partials, ticket, hist,
                             density, n_close, stream);
}

int vt_medoid_sweep_shard_bf16(const bf16_t* m, int f_pad, int n_pad, const float* q, int idx,
                               const float* w, float* d, float* partials, int* close_partials,
                               unsigned int* ticket, float* hist, float* density, int* n_close,
                               void* stream) {
  if (q == nullptr) return (int)cudaErrorInvalidValue;
  return medoid_sweep_launch(m, f_pad, n_pad, idx, q, w, d, partials, close_partials, ticket, hist,
                             density, n_close, stream);
}

int vt_spec_sweep_shard(const float* m, int f_pad, int n_pad, const float* q, int c0, int c1,
                        int c2, int c3, int c4, int c5, int c6, int c7, int s_count,
                        const float* w, float* rows, float* partials, int* count_partials,
                        unsigned int* tickets, float* sums, int* counts, void* stream) {
  if (q == nullptr) return (int)cudaErrorInvalidValue;
  return spec_sweep_launch(m, f_pad, n_pad, c0, c1, c2, c3, c4, c5, c6, c7, s_count, q, w, rows,
                           partials, count_partials, tickets, sums, counts, stream);
}

int vt_spec_sweep_shard_bf16(const bf16_t* m, int f_pad, int n_pad, const float* q, int c0,
                             int c1, int c2, int c3, int c4, int c5, int c6, int c7, int s_count,
                             const float* w, float* rows, float* partials, int* count_partials,
                             unsigned int* tickets, float* sums, int* counts, void* stream) {
  if (q == nullptr) return (int)cudaErrorInvalidValue;
  return spec_sweep_launch(m, f_pad, n_pad, c0, c1, c2, c3, c4, c5, c6, c7, s_count, q, w, rows,
                           partials, count_partials, tickets, sums, counts, stream);
}

int vt_candidate_density_shard(const float* m, int f_pad, int n_pad, const float* q,
                               const void* cand, int cand64, int c, const float* w, int groups,
                               float* partials, unsigned int* ticket, float* dens, void* stream) {
  if (q == nullptr) return (int)cudaErrorInvalidValue;
  return density_launch(m, f_pad, n_pad, cand, cand64, c, q, w, groups, partials, ticket, dens,
                        stream);
}

int vt_candidate_density_shard_bf16(const bf16_t* m, int f_pad, int n_pad, const float* q,
                                    const void* cand, int cand64, int c, const float* w,
                                    int groups, float* partials, unsigned int* ticket, float* dens,
                                    void* stream) {
  if (q == nullptr) return (int)cudaErrorInvalidValue;
  return density_launch(m, f_pad, n_pad, cand, cand64, c, q, w, groups, partials, ticket, dens,
                        stream);
}

int vt_row_stats(const float* rows, int n_pad, int s_count, const float* w, float* partials,
                 int* count_partials, unsigned int* tickets, float* sums, int* counts,
                 void* stream) {
  if (n_pad < 1 || s_count < 1 || s_count > kSpecSeeds) return (int)cudaErrorInvalidValue;
  // the histogram, then the last CTA's staged sums: 16 KB, so the S x B
  // CTAs fit the card at once
  constexpr size_t smem = kRowStatsSmem;
  static_assert(smem <= 48 * 1024, "more than 48 KB of dynamic shared memory needs cudaFuncSetAttribute");
  const bool vec = n_pad % kSweepVec == 0 && (uintptr_t)rows % 16 == 0 && (uintptr_t)w % 16 == 0;
  const auto kernel = vec ? row_stats_kernel<true> : row_stats_kernel<false>;
  const dim3 grid(sweep_col_blocks(n_pad), s_count);
  kernel<<<grid, kSweepThreads, smem, (cudaStream_t)stream>>>(rows, n_pad, w, partials,
                                                              count_partials, tickets, sums, counts);
  return counted(kLaunchRowStats);
}

int vt_spec_seeds() { return kSpecSeeds; }

int vt_gumbel_topc(unsigned int k0, unsigned int k1, int n, int offset, const float* d,
                   const unsigned char* kept, const unsigned char* tried, int medoid, int c,
                   float* score, unsigned long long* partials, unsigned int* ticket,
                   long long* cand, unsigned char* valid, unsigned long long* keys, int max_ctas,
                   void* stream) {
  if (n < 1 || offset < 0 || c < 0 || c > n || max_ctas < 1 || (c == 0 && score == nullptr) ||
      (c > kCandGroup && keys == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  // scores alone: a thread a column; with the selection, at most
  // max_ctas CTAs (the partials' rows; kTopcMaxCtas, the last CTA's loads),
  // striding over the columns
  int ctas = (n + kTopcThreads - 1) / kTopcThreads;
  const int most = max_ctas < kTopcMaxCtas ? max_ctas : kTopcMaxCtas;
  if (c > 0 && ctas > most) ctas = most;
  // C in rounds of kCandGroup, a launch each; round r > 0 reads the last key
  // of round r - 1 from `keys`
  const int rounds = c == 0 ? 1 : (c + kCandGroup - 1) / kCandGroup;
  for (int r = 0; r < rounds; ++r) {
    const int lo = r * kCandGroup;
    const int cr = c - lo < kCandGroup ? c - lo : kCandGroup;
    gumbel_topc_kernel<<<ctas, kTopcThreads, 0, (cudaStream_t)stream>>>(
        k0, k1, n, offset, d, kept, tried, medoid, cr, r == 0 ? score : nullptr, partials,
        ticket, cand == nullptr ? nullptr : cand + lo, valid == nullptr ? nullptr : valid + lo,
        keys == nullptr ? nullptr : keys + lo, r == 0 ? nullptr : keys + lo - 1);
    const int e = counted(kLaunchGumbel);
    if (e != 0) return e;
  }
  return 0;
}

int vt_cand_group() { return kCandGroup; }

int vt_launch_ids() { return kLaunchIds; }

const char* vt_launch_name(int id) { return id >= 0 && id < kLaunchIds ? kLaunchNames[id] : nullptr; }

unsigned long long vt_launches(int id) {
  return id >= 0 && id < kLaunchIds ? g_launches[id].load(std::memory_order_relaxed) : 0ull;
}

int vt_density_threads() { return kDensThreads; }

int vt_density_tile_cols() { return kDensTileCols; }

int vt_density_max_blocks() { return kDensMaxBlocks; }

int vt_density_tile() { return kDensTile; }

int vt_sweep_threads() { return kSweepThreads; }

int vt_sweep_vec() { return kSweepVec; }

int vt_sweep_max_blocks() { return kSweepMaxBlocks; }

int vt_sweep_slots() { return kSweepSlots; }

int vt_block_cols() { return kBlockCols; }

}  // extern "C"
