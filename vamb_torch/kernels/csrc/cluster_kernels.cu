// Hand-written Hopper (sm_90a) kernels for the clustering engine, exported
// through a plain C interface and loaded with ctypes
// (vamb_torch/kernels/cluster_kernels.py builds and binds them).
//
// Layout contract (the engine's): the normalized latent matrix is stored
// transposed, (F_pad, N_pad) row-major float32, so one latent's features
// sit N_pad floats apart and neighbouring columns sit next to each other.
//
// The distance kernels accumulate the feature dot product in float32 in fixed
// feature order with separately rounded multiplies and adds (__fmul_rn /
// __fadd_rn, so nvcc does not contract them into FMAs). That is exactly
// the arithmetic of the plain PyTorch versions beside the wrappers, so a
// kernel's distances equal its plain version's bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowThreads = 256;
constexpr int kDensThreads = 256;
constexpr int kMaxCand = 32;
constexpr float kMedoidRadius = 0.05f;
constexpr int kGatherThreads = 256;
constexpr int kBlockCols = 128;  // the subset wander's block width
constexpr int kSweepThreads = 256;
constexpr int kNbins = 60;
constexpr int kSweepSlots = 64;  // per-block partials: 60 bins, density, pad
constexpr float kDeltaX = 0.005f;
constexpr float kXmax = 0.3f;

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// ---------------------------------------------------------------- row_sweep
// Replaces vamb_tpu/ops/pallas_cluster.py:row_sweep (_row_sweep_kernel):
// d[n] = 0.5 - sum_f M[f, n] * M[f, idx], with d[idx] = 0.0 exactly.
//
// Bound on the H100: bytes. It reads the matrix once (F_pad * N_pad * 4
// bytes) and writes one float per column; 2 flops per byte read is far
// below the card's ratio. Design: one thread per column, so a warp's loads
// of one feature row are 128 contiguous bytes; the medoid's F_pad features
// sit in shared memory and are broadcast to every thread.
__global__ void row_sweep_kernel(const float* __restrict__ m, int f_pad,
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
    acc = __fadd_rn(acc, __fmul_rn(m[(size_t)f * n_pad + n], col[f]));
  }
  d[n] = (n == idx) ? 0.0f : __fsub_rn(0.5f, acc);
}

// -------------------------------------------------- candidate_density_sweep
// Replaces vamb_tpu/ops/pallas_cluster.py:candidate_density_sweep
// (_candidate_density_kernel): for C <= 32 candidates,
//   dens[c] = sum_n [D[c,n] <= 0.05 and w[n] > 0] * w[n] * (0.05 - D[c,n]),
//   D[c,n] = 0.5 - M[:, cand[c]] . M[:, n], with D[c, cand[c]] = 0,
// without a (C, N) matrix in device memory.
//
// Bound on the H100: bytes. It streams the matrix once, like row_sweep;
// its 2*C*F*N flops run below the card's float32 rate at these widths.
// Design: pass 1 keeps the C x F_pad candidate features in shared memory
// (read as broadcasts), walks columns with a grid-stride loop and keeps
// the C partial sums of each thread in registers. A block reduces its
// threads' partials with warp shuffles and then across warps in a fixed
// order, and writes one row of a (nblocks, 32) scratch. Pass 2 sums the
// block rows in block order. There are no float atomics anywhere: the
// engine's `dens > density` decision sits on knife edges, and a sum whose
// order changed from run to run would make clusters unreproducible.
__global__ void candidate_density_pass1(const float* __restrict__ m, int f_pad,
                                        int n_pad, const int* __restrict__ cand,
                                        int c, const float* __restrict__ w,
                                        float* __restrict__ partials) {
  extern __shared__ float rows[];  // kMaxCand * f_pad, candidate-major
  __shared__ int cids[kMaxCand];
  __shared__ float warp_part[kDensThreads / 32][kMaxCand];

  for (int j = threadIdx.x; j < kMaxCand; j += blockDim.x) {
    cids[j] = j < c ? cand[j] : -1;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kMaxCand * f_pad; i += blockDim.x) {
    const int j = i / f_pad;
    const int f = i - j * f_pad;
    rows[i] = j < c ? m[(size_t)f * n_pad + cids[j]] : 0.0f;
  }
  __syncthreads();

  float acc[kMaxCand];
#pragma unroll
  for (int j = 0; j < kMaxCand; ++j) acc[j] = 0.0f;

  const int stride = gridDim.x * blockDim.x;
  for (int n = blockIdx.x * blockDim.x + threadIdx.x; n < n_pad; n += stride) {
    const float wn = w[n];
    if (!(wn > 0.0f)) continue;  // a removed point adds nothing
    float dot[kMaxCand];
#pragma unroll
    for (int j = 0; j < kMaxCand; ++j) dot[j] = 0.0f;
    for (int f = 0; f < f_pad; ++f) {
      const float x = m[(size_t)f * n_pad + n];
#pragma unroll
      for (int j = 0; j < kMaxCand; ++j) {
        dot[j] = __fadd_rn(dot[j], __fmul_rn(rows[j * f_pad + f], x));
      }
    }
#pragma unroll
    for (int j = 0; j < kMaxCand; ++j) {
      const float dist = (n == cids[j]) ? 0.0f : __fsub_rn(0.5f, dot[j]);
      if (j < c && dist <= kMedoidRadius) {
        acc[j] = __fadd_rn(acc[j], __fmul_rn(wn, __fsub_rn(kMedoidRadius, dist)));
      }
    }
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < kMaxCand; ++j) {
    float v = acc[j];
    for (int off = 16; off > 0; off >>= 1) {
      v += __shfl_down_sync(0xffffffffu, v, off);
    }
    if (lane == 0) warp_part[warp][j] = v;
  }
  __syncthreads();
  if (threadIdx.x < kMaxCand) {
    float s = 0.0f;
    for (int k = 0; k < kDensThreads / 32; ++k) s += warp_part[k][threadIdx.x];
    partials[(size_t)blockIdx.x * kMaxCand + threadIdx.x] = s;
  }
}

__global__ void candidate_density_pass2(const float* __restrict__ partials,
                                        int nblocks, int c,
                                        float* __restrict__ dens) {
  const int j = threadIdx.x;
  if (j >= c) return;
  float s = 0.0f;
  for (int b = 0; b < nblocks; ++b) s += partials[(size_t)b * kMaxCand + j];
  dens[j] = s;
}

// ------------------------------------------------------------ gather_blocks
// Replaces vamb_tpu/ops/pallas_cluster.py:gather_blocks (_block_gather_kernel):
// out[:, k*128:(k+1)*128] = m[:, bids[k]*128:(bids[k]+1)*128] for k < KB, the
// subset wander's ball gather. Pure data movement, so bit-exact, repeated ids
// included.
//
// Bound on the H100: bytes (F_pad * KB * 128 * 4 read and written once).
// Design: one CTA per gathered block; its threads copy the (F_pad, 128)
// block as 16-byte float4 loads and stores, 32 per feature row, so a warp
// moves one contiguous 512-byte row segment. The block ids are read on the
// card, so the caller never syncs on them. Ids must lie in [0, N_pad/128).
__global__ void gather_blocks_kernel(const float4* __restrict__ m, int f_pad,
                                     int n_pad4, const int* __restrict__ bids,
                                     float4* __restrict__ out, int out_n4) {
  constexpr int kRow4 = kBlockCols / 4;
  const int k = blockIdx.x;
  const size_t src = (size_t)bids[k] * kRow4;
  const size_t dst = (size_t)k * kRow4;
  for (int i = threadIdx.x; i < f_pad * kRow4; i += blockDim.x) {
    const int f = i / kRow4;
    const int c = i - f * kRow4;
    out[(size_t)f * out_n4 + dst + c] = m[(size_t)f * n_pad4 + src + c];
  }
}

// ------------------------------------------------------------- medoid_sweep
// Replaces vamb_tpu/ops/pallas_cluster.py:medoid_sweep (_medoid_sweep_kernel):
// one medoid's distance row d (d[idx] = 0 exactly), the 60-bin histogram of
// w over the columns with 0 <= d <= 0.3 and w > 0 (bin clip(int(d/0.005),
// 0, 59)), the density sum of w * (0.05 - d) over d <= 0.05, w > 0, and the
// count of columns with d < 0.05, w > 0.
//
// Bound on the H100: bytes, like row_sweep (the matrix and w read once, d
// written once). Design: row_sweep's arithmetic, one thread per column in a
// grid-stride loop over a grid that depends on N only, so d is bit-identical
// to row_sweep's. Sums take the density kernel's fixed-order two passes,
// with no float atomics anywhere (the engine's valley scan decides on knife
// edges): per loop step each warp sums every bin that any of its lanes hits
// with a shuffle tree, lane 0 adds that into the warp's own shared-memory
// row; the block then adds its warps' rows in warp order into one row of a
// (blocks, 64) scratch, and pass 2 adds the rows in block order. The close
// count is an integer sum.
__global__ void medoid_sweep_pass1(const float* __restrict__ m, int f_pad,
                                   int n_pad, int idx,
                                   const float* __restrict__ w,
                                   float* __restrict__ d_out,
                                   float* __restrict__ partials,
                                   int* __restrict__ close_partials) {
  extern __shared__ float col[];  // f_pad medoid features
  __shared__ float warp_acc[kSweepThreads / 32][kSweepSlots];
  __shared__ int warp_close[kSweepThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int f = threadIdx.x; f < f_pad; f += blockDim.x) {
    col[f] = m[(size_t)f * n_pad + idx];
  }
  for (int i = threadIdx.x; i < (kSweepThreads / 32) * kSweepSlots; i += blockDim.x) {
    (&warp_acc[0][0])[i] = 0.0f;
  }
  __syncthreads();

  float dens_acc = 0.0f;  // lane 0's running warp sums
  int close_acc = 0;
  const int stride = gridDim.x * blockDim.x;
  for (int base = blockIdx.x * blockDim.x; base < n_pad; base += stride) {
    const int n = base + threadIdx.x;
    float hv = 0.0f, dv = 0.0f;
    bool close = false;
    int bin = 0;
    if (n < n_pad) {
      float acc = 0.0f;
      for (int f = 0; f < f_pad; ++f) {
        acc = __fadd_rn(acc, __fmul_rn(m[(size_t)f * n_pad + n], col[f]));
      }
      const float d = (n == idx) ? 0.0f : __fsub_rn(0.5f, acc);
      d_out[n] = d;
      const float wn = w[n];
      if (wn > 0.0f) {
        if (d >= 0.0f && d <= kXmax) {
          hv = wn;
          bin = min(max((int)__fdiv_rn(d, kDeltaX), 0), kNbins - 1);
        }
        if (d <= kMedoidRadius) dv = __fmul_rn(wn, __fsub_rn(kMedoidRadius, d));
        close = d < kMedoidRadius;
      }
    }
    // histogram: one shuffle-tree sum per bin present in the warp
    unsigned todo = __ballot_sync(0xffffffffu, hv > 0.0f);
    while (todo) {
      const int kb = __shfl_sync(0xffffffffu, bin, __ffs(todo) - 1);
      const bool mine = hv > 0.0f && bin == kb;
      const float v = warp_sum(mine ? hv : 0.0f);
      if (lane == 0) warp_acc[warp][kb] += v;
      todo &= ~__ballot_sync(0xffffffffu, mine);
    }
    const float dsum = warp_sum(dv);
    const int csum = __popc(__ballot_sync(0xffffffffu, close));
    if (lane == 0) {
      dens_acc += dsum;
      close_acc += csum;
    }
  }
  if (lane == 0) {
    warp_acc[warp][kNbins] = dens_acc;
    warp_close[warp] = close_acc;
  }
  __syncthreads();
  if (threadIdx.x <= kNbins) {
    float s = 0.0f;
    for (int k = 0; k < kSweepThreads / 32; ++k) s += warp_acc[k][threadIdx.x];
    partials[(size_t)blockIdx.x * kSweepSlots + threadIdx.x] = s;
  } else if (threadIdx.x == kNbins + 1) {
    int c = 0;
    for (int k = 0; k < kSweepThreads / 32; ++k) c += warp_close[k];
    close_partials[blockIdx.x] = c;
  }
}

__global__ void medoid_sweep_pass2(const float* __restrict__ partials,
                                   const int* __restrict__ close_partials,
                                   int nblocks, float* __restrict__ hist,
                                   float* __restrict__ density,
                                   int* __restrict__ n_close) {
  const int j = threadIdx.x;
  if (j <= kNbins) {
    float s = 0.0f;
    for (int b = 0; b < nblocks; ++b) s += partials[(size_t)b * kSweepSlots + j];
    if (j < kNbins) {
      hist[j] = s;
    } else {
      *density = s;
    }
  } else if (j == kNbins + 1) {
    int c = 0;
    for (int b = 0; b < nblocks; ++b) c += close_partials[b];
    *n_close = c;
  }
}

}  // namespace

extern "C" {

int vt_row_sweep(const float* m, int f_pad, int n_pad, int idx, float* d,
                 void* stream) {
  const int blocks = (n_pad + kRowThreads - 1) / kRowThreads;
  row_sweep_kernel<<<blocks, kRowThreads, f_pad * sizeof(float),
                     (cudaStream_t)stream>>>(m, f_pad, n_pad, idx, d);
  return (int)cudaGetLastError();
}

int vt_candidate_density(const float* m, int f_pad, int n_pad, const int* cand,
                         int c, const float* w, float* partials, int nblocks,
                         float* dens, void* stream) {
  const size_t smem = (size_t)kMaxCand * f_pad * sizeof(float);
  candidate_density_pass1<<<nblocks, kDensThreads, smem,
                            (cudaStream_t)stream>>>(m, f_pad, n_pad, cand, c, w,
                                                    partials);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  candidate_density_pass2<<<1, kMaxCand, 0, (cudaStream_t)stream>>>(
      partials, nblocks, c, dens);
  return (int)cudaGetLastError();
}

int vt_gather_blocks(const float* m, int f_pad, int n_pad, const int* bids,
                     int kb, float* out, void* stream) {
  gather_blocks_kernel<<<kb, kGatherThreads, 0, (cudaStream_t)stream>>>(
      (const float4*)m, f_pad, n_pad / 4, bids, (float4*)out,
      kb * (kBlockCols / 4));
  return (int)cudaGetLastError();
}

int vt_medoid_sweep(const float* m, int f_pad, int n_pad, int idx,
                    const float* w, float* d, float* partials,
                    int* close_partials, int nblocks, float* hist,
                    float* density, int* n_close, void* stream) {
  medoid_sweep_pass1<<<nblocks, kSweepThreads, f_pad * sizeof(float),
                       (cudaStream_t)stream>>>(m, f_pad, n_pad, idx, w, d,
                                               partials, close_partials);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  medoid_sweep_pass2<<<1, kSweepSlots, 0, (cudaStream_t)stream>>>(
      partials, close_partials, nblocks, hist, density, n_close);
  return (int)cudaGetLastError();
}

int vt_max_candidates() { return kMaxCand; }

int vt_density_threads() { return kDensThreads; }

int vt_sweep_threads() { return kSweepThreads; }

int vt_sweep_slots() { return kSweepSlots; }

}  // extern "C"
