// The profile-HMM Forward scan of the port, CUDA C++ for sm_90a (H100).
//
// Replaces `vamb_tpu/ops/hmm.py` `_forward_batch` (:229-288), which JAX
// runs as one `lax.scan` over residues, vmapped over genes: it is not a
// Pallas kernel, and eager PyTorch would pay some 30 launches a residue.
// It computes HMMER3's multihit-local Forward bit score of each gene of a
// batch against one local profile: (c + move - null1) / ln 2.
//
// Contract (`hmm_forward_plain` in hmm_kernels.py is the same recurrence in
// torch, JAX's formulation):
//   * a null residue (code 20) leaves every state unchanged wherever it
//     sits; the length model still counts it (`lengths` is min(len, pad));
//   * the in-row delete chain is JAX's inclusive prefix log-sum-exp of
//     a - s, then + s, with s = [0, cumsum(tdd)] (given, computed once a
//     profile by the wrapper), not the sequential recurrence;
//   * -1e30 is the sentinel, in the initial rows and in the clamped
//     transitions; -inf appears only as the scans' identity.
//
// What bounds it on the H100: transcendentals. A DP cell (node, residue)
// takes 5 log-add-exps (3 for M, 1 for I, 1 for the delete chain's scan),
// each an expf and a log1pf, and one expf for E: 11 special-function
// results, against about 35 other f32 operations. The SFU returns 16
// results a clock an SM (the CUDA programming guide's throughput table for
// compute capability 9.0), 132 SMs at 1,980 MHz: 4.18e12 a second, so a
// cell needs at least 11 / 4.18e12 = 2.6 ps of SFU time against
// 35 / 33.5e12 = 1.0 ps of FMA-free f32 issue; the bytes (one int8 code a
// residue, the profile once) are negligible.
//
// Design (simple first): one CTA per gene and one launch per batch of
// genes and profile. A thread owns NPT <= 8 neighbouring nodes and keeps
// their M, I and D values and their transitions in registers; a CTA has
// at most 256 threads, so M <= 2,048. The profile's emission column of a
// residue is read through the read-only path (all CTAs share it in L2),
// not staged in shared memory, so occupancy is not cut by the profile's
// size. Per residue: the previous row's value left of a thread's first
// node comes from its neighbour thread through shared memory; the delete
// chain is a block-wide inclusive scan (in the thread, over the warp by
// shuffles, then over the warps by warp 0); E is a block-wide
// log-sum-exp (max, then the sum of exponentials in a fixed order); every
// thread then updates N, B, J and C itself, so B needs no broadcast. Four
// barriers a residue. Each CTA stops at its gene's last non-null residue;
// null residues are skipped by the whole CTA at once.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxNpt = 8;
constexpr int kMaxNodes = kMaxThreads * kMaxNpt;
constexpr int kNull = 20;
constexpr float kNeg = -1e30f;
constexpr float kLn2 = 0.69314718f;  // jnp.log(2.0) in float32

// jnp.logaddexp for the values the DP meets: finite, or -inf as an identity.
__device__ __forceinline__ float lae(float a, float b) {
  const float mx = fmaxf(a, b);
  if (mx == -CUDART_INF_F) return mx;
  return mx + log1pf(expf(-fabsf(a - b)));
}

template <int NPT>
__global__ void __launch_bounds__(kMaxThreads) hmm_forward_kernel(
    const float* __restrict__ lomT,    // (21, M): lomT[x * M + k]
    const float* __restrict__ t,       // (M + 1, 7), clamped at -1e30
    const float* __restrict__ tbm,     // (M,), clamped at -1e30
    const float* __restrict__ s,       // (M,): s[0] = 0, s[k] = sum t[1..k][6]
    const int8_t* __restrict__ codes,  // (B, L)
    const float* __restrict__ lengths, // (B,)
    const int* __restrict__ nres,      // (B,): 1 + the last non-null position
    int M, int L, float* __restrict__ out) {
  __shared__ float bM[2][kMaxThreads], bI[2][kMaxThreads], bD[2][kMaxThreads];
  __shared__ float wmax[kMaxWarps], wsum[kMaxWarps], wtot[kMaxWarps], wpre[kMaxWarps];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int gene = blockIdx.x;
  const int k0 = tid * NPT;

  // this thread's nodes: transitions into node k from node k - 1 (k >= 1),
  // out of node k towards I and the next D, and the delete chain's s
  float tmm[NPT], tim[NPT], tdm[NPT], tmd[NPT], tmi[NPT], tii[NPT], tb[NPT], sk[NPT];
  float m[NPT], iv[NPT], d[NPT];
#pragma unroll
  for (int j = 0; j < NPT; ++j) {
    const int k = k0 + j;
    const bool ok = k < M;
    tmm[j] = ok ? t[k * 7 + 0] : 0.f;
    tmd[j] = ok ? t[k * 7 + 2] : 0.f;
    tim[j] = ok ? t[k * 7 + 3] : 0.f;
    tdm[j] = ok ? t[k * 7 + 5] : 0.f;
    tmi[j] = ok ? t[(k + 1) * 7 + 1] : 0.f;
    tii[j] = ok ? t[(k + 1) * 7 + 4] : 0.f;
    tb[j] = ok ? tbm[k] : 0.f;
    sk[j] = ok ? s[k] : 0.f;
    m[j] = iv[j] = d[j] = kNeg;
  }
  bM[0][tid] = bI[0][tid] = bD[0][tid] = kNeg;

  // the length model, multihit (one expected J use), as JAX computes it
  const float len = lengths[gene];
  const float loop = logf(len / (len + 3.0f));
  const float move = logf(3.0f / (len + 3.0f));
  const float tej = logf(0.5f);
  const float null1 = len * logf(len / (len + 1.0f)) - logf(len + 1.0f);
  float n = 0.0f, b = move, jj = kNeg, c = kNeg;

  const int8_t* seq = codes + (size_t)gene * L;
  const int last = nres[gene];
  int p = 0;  // parity of the buffers that hold the previous row's boundaries
  __syncthreads();
  for (int pos = 0; pos < last; ++pos) {
    const int x = seq[pos];
    if (x >= kNull) continue;  // the same for the whole CTA
    float emit[NPT];
#pragma unroll
    for (int j = 0; j < NPT; ++j)
      emit[j] = (k0 + j < M) ? __ldg(&lomT[x * M + k0 + j]) : 0.f;
    const float bm = tid ? bM[p][tid - 1] : kNeg;
    const float bi = tid ? bI[p][tid - 1] : kNeg;
    const float bd = tid ? bD[p][tid - 1] : kNeg;

    // M and I from the previous row; descending, so node j - 1 is still old
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int j = NPT - 1; j >= 0; --j) {
      const int k = k0 + j;
      if (k < M) {
        float pm = kNeg, pi = kNeg, pd = kNeg;
        if (k > 0) {
          pm = (j ? m[j - 1] : bm) + tmm[j];
          pi = (j ? iv[j - 1] : bi) + tim[j];
          pd = (j ? d[j - 1] : bd) + tdm[j];
        }
        const float mn = emit[j] + lae(lae(pm, pi), lae(pd, b + tb[j]));
        iv[j] = lae(m[j] + tmi[j], iv[j] + tii[j]);
        m[j] = mn;
        mx = fmaxf(mx, mn);
      }
    }
    const int q = p ^ 1;
    bM[q][tid] = m[NPT - 1];
    bI[q][tid] = iv[NPT - 1];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    if (lane == 0) wmax[warp] = mx;
    __syncthreads();

    float amax = wmax[0];
    for (int w = 1; w < nwarps; ++w) amax = fmaxf(amax, wmax[w]);
    if (!isfinite(amax)) amax = 0.0f;  // as jax.scipy.special.logsumexp does
    // the delete chain's terms a - s, a[k] = m_new[k - 1] + tmd, a[0] = -1e30;
    // this thread's inclusive scan and exponential sum
    const float left = tid ? bM[q][tid - 1] : kNeg;
    float incl[NPT];
    float run = -CUDART_INF_F, es = 0.0f;
#pragma unroll
    for (int j = 0; j < NPT; ++j) {
      const int k = k0 + j;
      if (k < M) {
        const float a = k ? (j ? m[j - 1] : left) + tmd[j] : kNeg;
        run = lae(run, a - sk[j]);
        es += expf(m[j] - amax);
      }
      incl[j] = run;
    }
    // over the warp: inclusive scan of the threads' totals, and the sum
    float wv = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float v = __shfl_up_sync(0xffffffffu, wv, off);
      if (lane >= off) wv = lae(v, wv);
    }
    float ex = __shfl_up_sync(0xffffffffu, wv, 1);
    if (lane == 0) ex = -CUDART_INF_F;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) es += __shfl_xor_sync(0xffffffffu, es, off);
    if (lane == 31) wtot[warp] = wv;
    if (lane == 0) wsum[warp] = es;
    __syncthreads();

    if (warp == 0) {  // exclusive scan over the warps' totals
      float v = lane < nwarps ? wtot[lane] : -CUDART_INF_F;
#pragma unroll
      for (int off = 1; off < kMaxWarps; off <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v = lae(u, v);
      }
      const float e = __shfl_up_sync(0xffffffffu, v, 1);
      if (lane < nwarps) wpre[lane] = lane ? e : -CUDART_INF_F;
    }
    float total = wsum[0];
    for (int w = 1; w < nwarps; ++w) total += wsum[w];
    const float e = logf(total) + amax;
    __syncthreads();

    const float before = lae(wpre[warp], ex);
#pragma unroll
    for (int j = 0; j < NPT; ++j)
      if (k0 + j < M) d[j] = lae(before, incl[j]) + sk[j];
    bD[q][tid] = d[NPT - 1];

    const float n_new = n + loop;
    jj = lae(jj + loop, e + tej);
    c = lae(c + loop, e + tej);
    b = lae(n_new + move, jj + move);
    n = n_new;
    p = q;
    __syncthreads();
  }
  if (tid == 0) out[gene] = (c + move - null1) / kLn2;
}

template <int NPT>
cudaError_t launch(const float* lomT, const float* t, const float* tbm, const float* s,
                   const int8_t* codes, const float* lengths, const int* nres, int M, int B,
                   int L, float* out, cudaStream_t stream) {
  const int threads = ((M + NPT - 1) / NPT + 31) / 32 * 32;
  hmm_forward_kernel<NPT><<<B, threads, 0, stream>>>(lomT, t, tbm, s, codes, lengths, nres, M,
                                                     L, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int vt_hmm_max_nodes() { return kMaxNodes; }

// Forward bit scores of B genes (codes (B, L) int8, null residue 20)
// against one local profile of M nodes; launches on `stream`, allocates
// nothing, and returns the launch's cudaError_t.
int vt_hmm_forward(const float* lomT, const float* t, const float* tbm, const float* s,
                   const int8_t* codes, const float* lengths, const int* nres, int M, int B,
                   int L, float* out, cudaStream_t stream) {
  if (M < 1 || M > kMaxNodes || B < 1 || L < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (M <= kMaxThreads)
    err = launch<1>(lomT, t, tbm, s, codes, lengths, nres, M, B, L, out, stream);
  else if (M <= 2 * kMaxThreads)
    err = launch<2>(lomT, t, tbm, s, codes, lengths, nres, M, B, L, out, stream);
  else if (M <= 4 * kMaxThreads)
    err = launch<4>(lomT, t, tbm, s, codes, lengths, nres, M, B, L, out, stream);
  else
    err = launch<8>(lomT, t, tbm, s, codes, lengths, nres, M, B, L, out, stream);
  return (int)err;
}

}  // extern "C"
