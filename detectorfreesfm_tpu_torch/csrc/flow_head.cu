// ASpan's flow expectation for Hopper (sm_90a), CUDA C++, fp32 on the CUDA
// cores.
//
// For q, k of shape (B, L, 64) on a grid of width w it computes
//   E[b, i] = sum_j softmax_j(q_i . k_j / 8) (j mod w, floor(j / w)),
// the expected (col, row) of each query's cell in the other image, over all
// L keys (padding cells included, with no mask, as models/aspan.py's
// FlowHead has always done). Nothing of size L x L reaches device memory:
// each query row keeps four running values over the keys it has seen, the
// max, the sum of exponentials and the two exponential-weighted coordinate
// sums, and only (B, L, 2) is written.
//
// Replaces no TPU kernel: the JAX package's FlowHead leaves the einsum, the
// softmax and the expectation to XLA. The port's dense version wrote the
// (B, L, L) fp32 similarity, divided it in place, wrote its softmax and read
// that again for the expectation, ~2.8 GB of device memory traffic per head
// at 832 px and B = 8 for an (L, 2) result (ops/flow_expectation.py keeps it
// as the plain version).
//
// Bound on an H100: operations. One head is 2 B L^2 64 fp32 flops (two to a
// multiply-add): 1.20e11 at 832 px, B = 8 (L = 10 816), ~1.8 ms at the
// ~67 TFLOP/s of fp32 FFMA without tensor cores. The configuration runs fp32
// with TF32 off, so the products are plain FFMAs: no TF32, bf16 or split
// products on the tensor cores. The softmax adds ~10% of FFMA-pipe work (a
// scale, a max, three sums a logit) and one ex2 a logit on the MUFU pipe.
//
// Design. A block of 256 threads (8 warps, 4 along the rows x 2 along the
// keys) owns BM = 128 query rows of one batch and sweeps a range of the
// keys in tiles of BN = 128, the SGEMM shape: each thread holds an 8 x 8
// register tile of logits (rows r..r+3 and r+16..r+19; keys c..c+3 and
// c+32..c+35), so the L x L block lives in registers only. q and k come
// d-major and padded to a multiple of 128 ((B, 64, Lp), transposed by the
// wrapper): the block's q tile (32 KB) stays in shared memory for the whole
// sweep, and key tiles (32 KB each) stream through a 3-stage ring of
// cp.async copies. A step over d reads two float4 of q and two of k from
// shared memory (one wavefront each, without conflicts) for 64 FFMAs.
//
// After each tile a thread folds its 8 x 8 logits into its own running
// (max, sum, x sum, y sum) of each of its 8 rows: one rescale a row and
// tile, no shuffle. The scale is the exact power of two 1/8 with log2(e)
// folded in, so the exponent is one FMA and one ex2.approx on the base-2
// logit (the logits equal the plain version's up to the dot's order of
// summation). Keys past L in the last tile are -inf. The coordinates come
// from the key index (row = floor((j + 0.5) / w), exact for the sizes the
// port runs), so no value tensor is read. At the end the 16 threads of a
// row merge their values (lane shuffles, then shared memory across the two
// key warps) and the block writes one partial (max, sum, x sum, y sum) per
// row and key range; a small kernel merges the ranges in order and divides.
// No float atomics: a result does not depend on the order blocks ran in.
//
// Grid. ceil(L / 128) x splits x B blocks, one block an SM (130 KB of shared
// memory, 183 registers a thread), where the key tiles are cut into
// `splits` (1 to 4) contiguous ranges, chosen for the fewest waves times
// tiles a block: at 832 px, 85 row tiles x 8 pairs is 680 blocks, 5.2 waves
// on 132 SMs; 4 splits make 2 720 blocks of 21-22 tiles, 20.6 waves (3.26,
// 2.99, 2.97, 2.88 ms for 1 to 4 splits on an H100 at 700 W).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int D = 64;          // the projections' width
constexpr int BM = 128;        // query rows per block
constexpr int BN = 128;        // keys per tile
constexpr int THREADS = 256;   // 8 warps: 4 along the rows x 2 along the keys
constexpr int STAGES = 3;      // key tiles in the cp.async ring
constexpr int MAX_SPLITS = 4;
constexpr int TM = 8;          // rows a thread
constexpr int TN = 8;          // keys a thread
constexpr int Q_FLOATS = D * BM;
constexpr int K_FLOATS = D * BN;
constexpr int RED_FLOATS = BM * 4;
constexpr size_t SMEM =
    sizeof(float) * (Q_FLOATS + STAGES * K_FLOATS + RED_FLOATS);
constexpr int COMBINE_THREADS = 256;
// 1/8 with the change of base: exp(s / 8) = 2^(s * SCALE_LOG2).
constexpr float SCALE_LOG2 = 0.125f * 1.4426950408889634f;

static_assert(BM == BN, "q and k share one padded length");
static_assert((D * BM / 4) % THREADS == 0, "whole copies a thread");

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Columns col0..col0+127 of every d row of a d-major (64, lp) array into
// shared [64][128]: 2048 copies of 16 bytes, 8 a thread, a warp per
// 512-byte row segment.
__device__ __forceinline__ void load_slab(float* dst, const float* src,
                                          int lp, int col0) {
#pragma unroll
  for (int it = 0; it < (D * BM / 4) / THREADS; ++it) {
    const int c = it * THREADS + threadIdx.x;
    const int d = c / (BM / 4), x = (c % (BM / 4)) * 4;
    cp_async16(dst + d * BM + x, src + static_cast<size_t>(d) * lp + col0 + x);
  }
}

// Merge (m2, s2, x2, y2) into (m, s, x, y): running values of two key sets
// with base-2 maxima; an empty set has m = -inf and zero sums.
__device__ __forceinline__ void merge(float& m, float& s, float& x, float& y,
                                      float m2, float s2, float x2,
                                      float y2) {
  const float mn = fmaxf(m, m2);
  const float ms = mn == -INFINITY ? 0.f : mn;
  const float f = ex2(m - ms), f2 = ex2(m2 - ms);
  s = fmaf(s, f, s2 * f2);
  x = fmaf(x, f, x2 * f2);
  y = fmaf(y, f, y2 * f2);
  m = mn;
}

__global__ void __launch_bounds__(THREADS, 1)
    sweep_kernel(const float* __restrict__ qt, const float* __restrict__ kt,
                 float4* __restrict__ part, int batch, int l, int lp, int w,
                 int splits) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ks = smem + Q_FLOATS;
  float* red = ks + STAGES * K_FLOATS;

  const int split = blockIdx.y, b = blockIdx.z;
  const int nt = lp / BN;
  const int t0 = split * nt / splits, t1 = (split + 1) * nt / splits;
  const float* qb = qt + static_cast<size_t>(b) * D * lp;
  const float* kb = kt + static_cast<size_t>(b) * D * lp;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = (warp % 4) * 32 + (lane / 8) * 4;
  const int key0 = (warp / 4) * 64 + (lane % 8) * 4;

  // The q tile rides in the first group with key tile t0.
  load_slab(qs, qb, lp, blockIdx.x * BM);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (t0 + s < t1) load_slab(ks + s * K_FLOATS, kb, lp, (t0 + s) * BN);
    cp_async_commit();
  }

  float m[TM], sum[TM], sx[TM], sy[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = -INFINITY;
    sum[i] = sx[i] = sy[i] = 0.f;
  }
  const float wf = static_cast<float>(w), inv_w = 1.0f / wf;

  for (int t = t0; t < t1; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile t landed; every thread is done with t - 1
    const int next = t + STAGES - 1;
    if (next < t1)
      load_slab(ks + ((next - t0) % STAGES) * K_FLOATS, kb, lp, next * BN);
    cp_async_commit();
    const float* kst = ks + ((t - t0) % STAGES) * K_FLOATS;

    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a0 = *reinterpret_cast<const float4*>(qs + d * BM + row0);
      const float4 a1 =
          *reinterpret_cast<const float4*>(qs + d * BM + row0 + 16);
      const float4 b0 = *reinterpret_cast<const float4*>(kst + d * BN + key0);
      const float4 b1 =
          *reinterpret_cast<const float4*>(kst + d * BN + key0 + 32);
      const float a[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float k[TN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], k[j], acc[i][j]);
    }

    // The (col, row) of this thread's keys; keys past L weigh nothing.
    float cx[TN], cy[TN];
    const bool tail = (t + 1) * BN > l;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int key = t * BN + key0 + (j < 4 ? j : 28 + j);
      const float kf = static_cast<float>(key);
      cy[j] = floorf((kf + 0.5f) * inv_w);
      cx[j] = fmaf(-cy[j], wf, kf);
      if (tail && key >= l) {
#pragma unroll
        for (int i = 0; i < TM; ++i) acc[i][j] = -INFINITY;
      }
    }

    // Fold the tile into each row's running values.
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      float mt = acc[i][0];
#pragma unroll
      for (int j = 1; j < TN; ++j) mt = fmaxf(mt, acc[i][j]);
      const float mn = fmaxf(m[i], mt * SCALE_LOG2);
      const float ms = mn == -INFINITY ? 0.f : mn;
      const float alpha = ex2(m[i] - ms);
      float ps = 0.f, px = 0.f, py = 0.f;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float p = ex2(fmaf(acc[i][j], SCALE_LOG2, -ms));
        ps += p;
        px = fmaf(p, cx[j], px);
        py = fmaf(p, cy[j], py);
      }
      sum[i] = fmaf(sum[i], alpha, ps);
      sx[i] = fmaf(sx[i], alpha, px);
      sy[i] = fmaf(sy[i], alpha, py);
      m[i] = mn;
    }
  }
  cp_async_wait<0>();  // only empty groups are left

  // The 8 lanes of a row within the warp, then the two key warps.
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int off = 1; off < 8; off <<= 1)
      merge(m[i], sum[i], sx[i], sy[i],
            __shfl_xor_sync(0xffffffffu, m[i], off),
            __shfl_xor_sync(0xffffffffu, sum[i], off),
            __shfl_xor_sync(0xffffffffu, sx[i], off),
            __shfl_xor_sync(0xffffffffu, sy[i], off));
  }
  const bool writer = (lane % 8) == 0;
  if (writer && warp >= 4) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = row0 + (i < 4 ? i : 12 + i);
      reinterpret_cast<float4*>(red)[r] =
          make_float4(m[i], sum[i], sx[i], sy[i]);
    }
  }
  __syncthreads();
  if (writer && warp < 4) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = row0 + (i < 4 ? i : 12 + i);
      const float4 o = reinterpret_cast<const float4*>(red)[r];
      merge(m[i], sum[i], sx[i], sy[i], o.x, o.y, o.z, o.w);
      const int row = blockIdx.x * BM + r;
      if (row < l)
        part[(static_cast<size_t>(split) * batch + b) * l + row] =
            make_float4(m[i], sum[i], sx[i], sy[i]);
    }
  }
}

// One thread a (batch, row): the key ranges merged in order, then divided.
__global__ void combine_kernel(const float4* __restrict__ part,
                               float2* __restrict__ out, int n, int splits) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  float4 a = part[idx];
  for (int s = 1; s < splits; ++s) {
    const float4 o = part[static_cast<size_t>(s) * n + idx];
    merge(a.x, a.y, a.z, a.w, o.x, o.y, o.z, o.w);
  }
  out[idx] = make_float2(a.z / a.y, a.w / a.y);
}

int prepare() {
  return static_cast<int>(cudaFuncSetAttribute(
      sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMEM)));
}

}  // namespace

extern "C" int flow_tile() { return BN; }

// How many ranges the key tiles are cut into: of 1..MAX_SPLITS (at most one
// per tile), the one with the fewest waves of blocks on the card's SMs
// times the tiles a block sweeps, the smallest on a tie.
extern "C" int flow_splits(int batch, int l) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      prepare() != 0 ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, sweep_kernel, THREADS, SMEM) != cudaSuccess ||
      sms * per_sm < 1)
    return 1;
  const long slots = static_cast<long>(sms) * per_sm;
  const int nt = (l + BN - 1) / BN;
  const long blocks = static_cast<long>(nt) * batch;
  int best = 1;
  long best_cost = -1;
  for (int k = 1; k <= MAX_SPLITS && k <= nt; ++k) {
    const long waves = (blocks * k + slots - 1) / slots;
    const long cost = waves * ((nt + k - 1) / k);
    if (best_cost < 0 || cost < best_cost) {
      best = k;
      best_cost = cost;
    }
  }
  return best;
}

// qt, kt: (batch, 64, lp) fp32, d-major, lp a multiple of flow_tile() and
// >= l, columns past l finite; part: (splits, batch, l) float4 scratch;
// out: (batch, l) float2. Returns the launches' CUDA error code.
extern "C" int flow_expectation(const float* qt, const float* kt, void* part,
                                void* out, int batch, int l, int lp, int w,
                                int splits, void* stream) {
  if (batch < 1 || l < 1 || lp < l || lp % BN || w < 1 || splits < 1 ||
      splits > MAX_SPLITS || splits > lp / BN)
    return static_cast<int>(cudaErrorInvalidValue);
  int rc;
  if ((rc = prepare())) return rc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(lp / BM, splits, batch);
  auto* p = static_cast<float4*>(part);
  sweep_kernel<<<grid, THREADS, SMEM, st>>>(qt, kt, p, batch, l, lp, w,
                                            splits);
  if ((rc = static_cast<int>(cudaGetLastError()))) return rc;
  const int n = batch * l;
  combine_kernel<<<(n + COMBINE_THREADS - 1) / COMBINE_THREADS,
                   COMBINE_THREADS, 0, st>>>(p, static_cast<float2*>(out), n,
                                             splits);
  return static_cast<int>(cudaGetLastError());
}
