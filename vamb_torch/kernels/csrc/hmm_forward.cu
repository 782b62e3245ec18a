// The profile-HMM Forward scan of the port, CUDA C++ for sm_90a (H100).
//
// Replaces `vamb_tpu/ops/hmm.py` `_forward_batch` (:229-288), which JAX
// runs as one `lax.scan` over residues, vmapped over genes: it is not a
// Pallas kernel, and eager PyTorch would pay some 30 launches a residue.
// It computes HMMER3's multihit-local Forward bit score of each gene of a
// batch against one local profile: (c + move - null1) / ln 2.
//
// Contract (`hmm_forward_plain` in hmm_kernels.py is the same recurrence in
// torch, JAX's formulation, in logarithms):
//   * a null residue (code 20) leaves every state unchanged wherever it
//     sits; the length model still counts it (`lengths` is min(len, pad));
//   * the in-row delete chain is JAX's inclusive prefix log-sum-exp of
//     a - s, then + s, with s = [0, cumsum(tdd)];
//   * -1e30 is the sentinel, in the initial rows and in the clamped
//     transitions; a gene without a residue scores (-1e30 + move - null1)
//     / ln 2.
// This kernel computes the same sums in probabilities rather than in
// logarithms, as HMMER3's own Forward filter does: every value of a row, and
// N, B, J and C, is kept as a probability times 2^-shift, and when E + N + J
// leaves [2^-32, 2^32] the whole state is multiplied by the exact power of
// two that brings it back and `shift` counts it. A sentinel is a 0. The
// delete chain's prefix log-sum-exp is the same sum as the recurrence D[k]
// = tdd[k] D[k-1] + M[k-1] tmd[k], taken as a scan of affine maps. Sums of
// positive terms and products lose no precision, and a value that falls
// 2^126 below its row's scale is dropped: with the multihit J state, any
// path can re-enter at a cost of a few bits, so it cannot matter to the
// score. Scores agree with the plain version within 1e-3 + 1e-5 |score|
// bits, the tolerance chip_smoke.py and the tests hold.
//
// What bounds it on the H100: f32 instructions. A DP cell (node, residue)
// takes 11: M's three FMAs and two multiplies (B x tbm, the emission), I's
// FMA and multiply, the delete chain's term multiply (M_new[k - 1] tmd[k]),
// the FMA that folds it into the lane's map and the FMA that applies the
// scan, and E's add; no transcendental (the logarithms are once a gene).
// The maps' slopes are products of tdd alone, the same for every residue,
// so they are formed once a CTA and only the offsets are scanned. The
// shuffle scan (five FMAs a lane) and E's butterfly are per lane, not per
// cell. At 128 a clock an SM, 132 SMs, 1,980 MHz: 3.35e13 a second, so the
// bound is cells x 11 / 3.35e13 s, cells being the batch's non-null
// residues x M; the bytes (one int8 code a residue, the profile once) are
// negligible.
//
// Design. A CTA a gene, with barriers and a dependent chain of expf/log1pf
// calls a residue, leaves the SMs waiting on latency. Here:
//   * A gene is held by a group of W = ceil(M / 256) warps; a lane owns NPT
//     (1, 2, 4 or 8) neighbouring nodes and keeps their M, I and D values and
//     their transition probabilities in registers. A CTA holds up to
//     max(1, 4 / W) groups (fewer when the batch has fewer genes than that a
//     SM, so that a small batch spreads over the card) and is persistent:
//     the grid is at most the SMs times the CTAs that fit on one (three of
//     4 warps, with the registers capped at 168), and group i of the grid
//     scores genes i, i + groups, ...; the batches come length-sorted, so
//     the groups' work stays balanced.
//   * The emission odds (20 x M) are staged in shared memory once a CTA,
//     lane-major (node k of lane q, slot j at [x][j][q]), so a residue's
//     loads are conflict-free and off the dependent chain.
//   * No __syncthreads in the residue loop. Within a warp the previous row's
//     left neighbour, E's sum (a butterfly, so every lane holds the same E)
//     and the delete chain's scan (a lane's sequential composition, a
//     shuffle scan of the lanes' maps' offsets, whose slopes are the
//     profile's and formed before the genes, one FMA to apply it to each
//     node) are shuffles only. With W > 1 the group's warps meet at one
//     named barrier a residue (bar.sync id, 32 W), with double-buffered
//     slots in shared memory: each warp publishes its last node's new M and I, its E, its
//     map and the delete-chain step of the next warp's first node (which it
//     alone can form before the barrier); after it, every warp folds the
//     earlier warps' values in the same order.
//   * Each lane updates N, B, J and C itself, so B needs no broadcast; the
//     residue's dependent chain is M, E's five shuffles, then J and B.
//   * The gene's codes are read 32 bytes a warp (a byte a lane) a chunk
//     ahead and passed along the warp by shuffles.
// Null residues are skipped by the whole group at once (they sit at the
// same positions for all its warps), and each group stops at its gene's
// last non-null residue.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxNodes = 2048;
constexpr int kMaxDevices = 64;  // the launch configuration is kept per device
constexpr int kNodesPerWarp = 256;  // W = ceil(M / 256) warps a gene
constexpr int kCtaWarps = 8;  // the most warps a CTA (a gene's W <= 8)
// the warps a CTA of several groups aims at: at 168 registers a thread (8
// nodes a lane) an SM's 65,536 registers hold 12 warps, three CTAs of 4
// warps where they hold only one CTA of 8
constexpr int kCtaTargetWarps = 4;
// the registers a thread may take: 65,536 / (12 x 32), rounded down to the
// allocation's 8. Without the cap ptxas takes 169 at 8 nodes a lane, and an
// SM holds two CTAs of 4 warps (chip_smoke.py times the batch shape).
constexpr int kMaxRegisters = 168;
constexpr int kAlphabet = 20;
constexpr int kNull = 20;
constexpr int kXch = 8;  // a warp's exchange slots a residue (7 used)
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLn2 = 0.69314718f;         // jnp.log(2.0) in float32
constexpr float kNegLog = -1e30f;             // the contract's sentinel (natural log)
constexpr float kScaleHi = 4294967296.0f;     // 2^32: rescale a row above this
constexpr float kScaleLo = 2.3283064e-10f;    // 2^-32: or below this

// The exponent e of a float v (v / 2^e lies in [1, 2) for a normal v)
__device__ __forceinline__ int exponent_of(float v) {
  return ((__float_as_int(v) >> 23) & 0xFF) - 127;
}

__device__ __forceinline__ float pow2(int e) { return __int_as_float((127 + e) << 23); }

__device__ __forceinline__ void group_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

template <int NPT>
__global__ void __maxnreg__(kMaxRegisters) hmm_forward_kernel(
    const float* __restrict__ lomT,    // (21, M): lomT[x * M + k], natural log
    const float* __restrict__ t,       // (M + 1, 7), clamped at -1e30
    const float* __restrict__ tbm,     // (M,), clamped at -1e30
    const int8_t* __restrict__ codes,  // (B, L)
    const float* __restrict__ lengths, // (B,)
    const int* __restrict__ nres,      // (B,): 1 + the last non-null position
    int M, int B, int L, int W, float* __restrict__ out) {
  extern __shared__ float smem[];
  const int lanes = W * 32;          // a group's lanes
  const int span = lanes * NPT;      // a group's nodes (>= M)
  float* odds_s = smem;              // (20, NPT, lanes): emission odds
  const int groups = blockDim.x / lanes;
  const int g = threadIdx.x / lanes;
  const int wg = (threadIdx.x >> 5) % W;
  const int lane = threadIdx.x & 31;
  const int q = wg * 32 + lane;
  const int k0 = q * NPT;
  float* xch = smem + kAlphabet * span + g * 2 * W * kXch;  // [parity][warp][kXch]

  for (int i = threadIdx.x; i < kAlphabet * span; i += blockDim.x) {
    const int x = i / span, r = i % span;
    const int k = (r % lanes) * NPT + r / lanes;
    odds_s[i] = k < M ? expf(lomT[x * M + k]) : 0.0f;
  }

  // this lane's nodes as probabilities: transitions into node k from node
  // k - 1 (k >= 1), out of node k towards I, and the delete chain's step
  // factor exp(s[k] - s[k - 1]) = exp(tdd into k)
  float tmm[NPT], tim[NPT], tdm[NPT], tmd[NPT], tdd[NPT], tmi[NPT], tii[NPT], tb[NPT];
#pragma unroll
  for (int j = 0; j < NPT; ++j) {
    const int k = k0 + j;
    const bool own = k < M, into = k > 0 && k < M;
    tmm[j] = into ? expf(t[k * 7 + 0]) : 0.f;
    tmd[j] = into ? expf(t[k * 7 + 2]) : 0.f;
    tim[j] = into ? expf(t[k * 7 + 3]) : 0.f;
    tdm[j] = into ? expf(t[k * 7 + 5]) : 0.f;
    tdd[j] = into ? expf(t[k * 7 + 6]) : 0.f;
    tmi[j] = own ? expf(t[(k + 1) * 7 + 1]) : 0.f;
    tii[j] = own ? expf(t[(k + 1) * 7 + 4]) : 0.f;
    tb[j] = own ? expf(tbm[k]) : 0.f;
  }
  // the next warp's first node, whose M -> D and D -> D terms lane 31 forms
  const int kn = k0 + NPT;
  const float tmd_next = kn < M ? expf(t[kn * 7 + 2]) : 0.f;
  const float tdd_next = kn < M ? expf(t[kn * 7 + 6]) : 0.f;

  // The delete chain as affine maps x -> f x + g composed along the row: node
  // j's map is (tdd[j], M_new[j - 1] tmd[j]), and `later` after `earlier` is
  // (later.f earlier.f, later.f earlier.g + later.g). The slopes f depend on
  // the profile alone: the lane's running products `lf`, the slope of the
  // warp's inclusive scan before each of its five steps `sf`, its total `wf`
  // and the exclusive product `pref`. Lane 0 of a warp past the first leaves
  // its first node to the fold after the barrier (slope 1, offset 0).
  const bool first_own = lane > 0 || wg == 0;
  float lf[NPT];
  float wf = 1.0f;
#pragma unroll
  for (int j = 0; j < NPT; ++j) {
    if (j > 0 || first_own) wf *= tdd[j];
    lf[j] = wf;
  }
  float sf[5];
#pragma unroll
  for (int s = 0, off = 1; off < 32; ++s, off <<= 1) {
    sf[s] = wf;
    const float v = __shfl_up_sync(kFull, wf, off);
    if (lane >= off) wf *= v;
  }
  float pref = __shfl_up_sync(kFull, wf, 1);
  if (lane == 0) pref = 1.0f;
  __syncthreads();

  // the parity of the exchange slots, alternating over every residue the
  // group scores, across genes too: a warp that starts the next gene must
  // not write the slots the others may still read
  int par = 0;
  for (int gene = blockIdx.x * groups + g; gene < B; gene += gridDim.x * groups) {
    // the length model, multihit (one expected J use), as JAX computes it
    const float len = lengths[gene];
    const float loop = len / (len + 3.0f);
    const float move = 3.0f / (len + 3.0f);
    const float move_log = logf(3.0f / (len + 3.0f));
    const float null1 = len * logf(len / (len + 1.0f)) - logf(len + 1.0f);
    // the row and N, B, J, C as probabilities times 2^-shift
    float n = 1.0f, b = move, jj = 0.0f, c = 0.0f;
    int shift = 0;
    float m[NPT], iv[NPT], d[NPT];
#pragma unroll
    for (int j = 0; j < NPT; ++j) m[j] = iv[j] = d[j] = 0.0f;
    float xm = 0.0f, xi = 0.0f, xd = 0.0f;  // the previous row left of the warp

    const int8_t* seq = codes + (size_t)gene * L;
    const int last = nres[gene];
    int ahead = lane < last ? seq[lane] : kNull;
    for (int pos0 = 0; pos0 < last; pos0 += 32) {
      const int chunk = ahead;
      ahead = pos0 + 32 + lane < last ? seq[pos0 + 32 + lane] : kNull;
      const int steps = min(32, last - pos0);
      for (int r = 0; r < steps; ++r) {
        const int x = __shfl_sync(kFull, chunk, r);
        if (x >= kNull) continue;  // the same for the whole group
        float em[NPT];
#pragma unroll
        for (int j = 0; j < NPT; ++j) em[j] = odds_s[(x * NPT + j) * lanes + q];
        float bm = __shfl_up_sync(kFull, m[NPT - 1], 1);
        float bi = __shfl_up_sync(kFull, iv[NPT - 1], 1);
        float bd = __shfl_up_sync(kFull, d[NPT - 1], 1);
        if (lane == 0) bm = xm, bi = xi, bd = xd;

        // M and I from the previous row (node 0's transitions in are 0)
        float mn[NPT], in[NPT];
        float es = 0.0f;
#pragma unroll
        for (int j = 0; j < NPT; ++j) {
          const float into = fmaf(j ? m[j - 1] : bm, tmm[j],
                                  fmaf(j ? iv[j - 1] : bi, tim[j],
                                       fmaf(j ? d[j - 1] : bd, tdm[j], b * tb[j])));
          mn[j] = em[j] * into;
          in[j] = fmaf(m[j], tmi[j], iv[j] * tii[j]);
          es += mn[j];  // 0 past M: em is 0 there
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) es += __shfl_xor_sync(kFull, es, off);

        // the delete chain: D[k] = tdd[k] D[k - 1] + M_new[k - 1] tmd[k], as
        // the maps' offsets composed along the row (their slopes are lf, sf,
        // wf and pref)
        const float left = __shfl_up_sync(kFull, mn[NPT - 1], 1);
        float lg[NPT];
        float run = 0.0f;
#pragma unroll
        for (int j = 0; j < NPT; ++j) {
          if (j > 0 || first_own) run = fmaf(tdd[j], run, (j ? mn[j - 1] : left) * tmd[j]);
          lg[j] = run;
        }
        float scan_g = run;  // inclusive scan of the lanes' maps' offsets
#pragma unroll
        for (int s = 0, off = 1; off < 32; ++s, off <<= 1) {
          const float v = __shfl_up_sync(kFull, scan_g, off);
          if (lane >= off) scan_g = fmaf(sf[s], v, scan_g);
        }
        float pre = __shfl_up_sync(kFull, scan_g, 1);
        if (lane == 0) pre = 0.0f;
        float start = 0.0f;  // D at the warp's first node (0 left of node 0)

        if (W > 1) {
          float* mine = xch + (par * W + wg) * kXch;
          if (lane == 31) {
            mine[0] = mn[NPT - 1];
            mine[1] = in[NPT - 1];
            mine[2] = wf;
            mine[3] = scan_g;
            mine[4] = mn[NPT - 1] * tmd_next;  // the next warp's first node:
            mine[5] = tdd_next;                // D = tdd D[k - 1] + M_new[k - 1] tmd
            mine[6] = es;
          }
          group_barrier(1 + g, lanes);
          const float* all = xch + par * W * kXch;
          float e = 0.0f, dstart = 0.0f, dend = 0.0f;
          for (int v = 0; v < W; ++v) {
            const float* o = all + v * kXch;
            e += o[6];
            if (v < wg) {
              dend = fmaf(o[2], dstart, o[3]);
              dstart = fmaf(o[5], dend, o[4]);
            }
          }
          es = e;
          if (wg > 0) {
            xm = all[(wg - 1) * kXch + 0];
            xi = all[(wg - 1) * kXch + 1];
            xd = dend;  // D_new at node k0 - 1
            start = dstart;
          }
          par ^= 1;
        }
        const float din = fmaf(pref, start, pre);
#pragma unroll
        for (int j = 0; j < NPT; ++j) {
          d[j] = fmaf(lf[j], din, lg[j]);
          m[j] = mn[j];
          iv[j] = in[j];
        }

        n *= loop;
        jj = fmaf(jj, loop, es * 0.5f);
        c = fmaf(c, loop, es * 0.5f);
        b = (n + jj) * move;
        // keep the row in range by an exact power of two, the same in every
        // lane of the group (every lane holds the same E, N and J)
        const float norm = es + n + jj;
        if (norm > kScaleHi || norm < kScaleLo) {
          const int e = exponent_of(norm);
          const float f = pow2(-e);
          shift += e;
#pragma unroll
          for (int j = 0; j < NPT; ++j) m[j] *= f, iv[j] *= f, d[j] *= f;
          xm *= f, xi *= f, xd *= f;
          n *= f, jj *= f, c *= f, b *= f;
        }
      }
    }
    if (wg == 0 && lane == 0)
      out[gene] = c > 0.0f ? log2f(c) + (float)shift + (move_log - null1) / kLn2
                           : (kNegLog + move_log - null1) / kLn2;  // no residue: C holds the sentinel
  }
}

template <int NPT>
cudaError_t launch(const float* lomT, const float* t, const float* tbm,
                   const int8_t* codes, const float* lengths, const int* nres, int M, int B,
                   int L, int W, float* out, cudaStream_t stream) {
  // found on a device's first launch and kept (0: not yet): its SMs, the
  // dynamic shared memory this kernel may take there, and the CTAs an SM
  // holds for each (W, groups)
  static int sms_of[kMaxDevices], smem_of[kMaxDevices];
  static int per_sm_of[kMaxDevices][kCtaWarps + 1][kCtaTargetWarps + 1];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int& sms = sms_of[dev];
  if (sms == 0 &&
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  // as many groups a CTA as fit, but no fewer CTAs than SMs while there are
  // genes for them: a small batch spreads over the card
  const int groups = max(1, min(kCtaTargetWarps / W, (B + sms - 1) / sms));
  const int threads = groups * W * 32;
  const int smem = (kAlphabet * W * 32 * NPT + groups * 2 * W * kXch) * (int)sizeof(float);
  if (smem > smem_of[dev]) {
    if ((err = cudaFuncSetAttribute(hmm_forward_kernel<NPT>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
        cudaSuccess)
      return err;
    smem_of[dev] = smem;
  }
  int& per_sm = per_sm_of[dev][W][groups];
  if (per_sm == 0) {
    int fit = 0;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, hmm_forward_kernel<NPT>, threads,
                                                             smem)) != cudaSuccess)
      return err;
    if (fit < 1) return cudaErrorInvalidConfiguration;
    per_sm = fit;
  }
  const int grid = min((B + groups - 1) / groups, per_sm * sms);
  hmm_forward_kernel<NPT><<<grid, threads, smem, stream>>>(lomT, t, tbm, codes, lengths, nres,
                                                           M, B, L, W, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int vt_hmm_max_nodes() { return kMaxNodes; }

// Forward bit scores of B genes (codes (B, L) int8, null residue 20)
// against one local profile of M nodes; launches on `stream`, allocates
// nothing, and returns the launch's cudaError_t.
int vt_hmm_forward(const float* lomT, const float* t, const float* tbm,
                   const int8_t* codes, const float* lengths, const int* nres, int M, int B,
                   int L, float* out, cudaStream_t stream) {
  if (M < 1 || M > kMaxNodes || B < 1 || L < 1) return (int)cudaErrorInvalidValue;
  const int W = (M + kNodesPerWarp - 1) / kNodesPerWarp;
  if (W > kCtaWarps) return (int)cudaErrorInvalidValue;
  const int per_lane = (M + 32 * W - 1) / (32 * W);
  cudaError_t err;
  if (per_lane <= 1)
    err = launch<1>(lomT, t, tbm, codes, lengths, nres, M, B, L, W, out, stream);
  else if (per_lane <= 2)
    err = launch<2>(lomT, t, tbm, codes, lengths, nres, M, B, L, W, out, stream);
  else if (per_lane <= 4)
    err = launch<4>(lomT, t, tbm, codes, lengths, nres, M, B, L, W, out, stream);
  else
    err = launch<8>(lomT, t, tbm, codes, lengths, nres, M, B, L, W, out, stream);
  return (int)err;
}

}  // extern "C"
