// Hand-written Hopper (sm_90a) kernels for the clustering engine's wander
// step, exported through a plain C interface and loaded with ctypes
// (vamb_torch/kernels/cluster_kernels.py builds and binds them).
//
// Layout contract (the engine's): the normalized latent matrix is stored
// transposed, (F_pad, N_pad) row-major float32, so one latent's features
// sit N_pad floats apart and neighbouring columns sit next to each other.
//
// Both kernels accumulate the feature dot product in float32 in fixed
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

int vt_max_candidates() { return kMaxCand; }

int vt_density_threads() { return kDensThreads; }

}  // extern "C"
