// Dual-softmax match statistics for Hopper (sm_90a), CUDA C++.
//
// Replaces the two Pallas TPU kernels of the JAX package's
// ops/pallas_dsm.py:
//   dsm_pass1  <- `_pass1_kernel`: row and column logsumexp of z;
//   dsm_pass2  <- `_pass2_kernel`: row max/argmax of 2z - lse_c and column
//                 max/argmax of 2z - lse_r, ties to the first index;
// with, as in the TPU kernels' `_sim_tile`,
//   z[r, s] = hi0.hi1 + hi0.lo1 + lo0.hi1 + (m0_r - 1) 1e9 + (m1_s - 1) 1e9,
// where f0 * scale = hi0 + lo0 and f1 = hi1 + lo1 are bf16 halves split
// once per batch outside the kernels. Each bf16 x bf16 product is exact in
// fp32, so the three-pass product keeps the logits to ~1e-5 (one pass
// flips argmaxes at 1/T = 10).
//
// Product. A block of two warpgroups (256 threads) owns BM = 128 rows of
// f0, 64 per warpgroup, and sweeps a range of f1 in BN = 64-row tiles that
// both warpgroups share. Each runs the three products of a tile on
// `wgmma.mma_async.m64n64k16.f32.bf16.bf16`, 48 at C = 256: hi0 is held in
// registers for the whole sweep (64 a thread), lo0 and the f1 tiles are
// read from shared memory, all K-major as they lie in device memory ((n, C),
// C contiguous). With hi0 in registers a k step reads 8 KB of shared memory
// a warpgroup, less than its three wgmmas take on the tensor cores.
//
// Loads. One thread issues every copy with TMA (3-D tensor maps over
// (pair, row, channel), boxes of 64 channels x 64 rows, rows past the edge
// read as zeros), in the 128-byte swizzle that the wgmma descriptors name:
// C is cut into 64-channel atoms of 64 rows x 128 bytes. Each stage has an
// mbarrier that its copies complete. The maps are encoded on the host with
// the driver's cuTensorMapEncodeTiled, reached through
// cudaGetDriverEntryPoint, so the library needs no -lcuda.
//
// Shared memory at C = 256: lo0 for 128 rows is 64 KB and stays resident;
// each f1 stage (hi and lo, 64 rows) is 64 KB, and two stages make 192 KB
// (+1 KB alignment, +2 KB epilogue scratch) of the 227 KB a block may
// have, so one block of 8 warps runs per SM. Tile j + 1's wgmmas run on the
// tensor cores while the warpgroups reduce tile j, and tile j + 2's copy is
// in flight meanwhile. 128 rows a block halve the f1 bytes that blocks
// stream from L2 against 64 (B ceil(L/128) S C 4 bytes, 1.9 GB a pass at
// 832 px).
//
// Grid. ceil(L / 128) x splits x B blocks, where f1's tiles are cut into
// `splits` (1 to 4) contiguous ranges, chosen for the fullest last wave on
// the card's SMs: at 832 px, 85 row tiles x 2 pairs is 170 blocks, 1.3
// waves on 132 SMs; 3 splits make 510 blocks, 3.9 waves.
//
// Columns and rows. GPU blocks run in no order, so the TPU kernels' column
// scratch, carried across the grid, cannot be kept. Each block reduces
// every tile over its 128 rows (lane shuffles within a warp, shared memory
// across the eight warps) and writes one partial per (row tile, column), and
// one per (split, row) at the end: (max, sum) in pass 1, (max, first arg)
// in pass 2. Small kernels combine the partials in index order, taking a
// larger value only when it is strictly larger, so ties go to the first
// index and nothing depends on the order in which blocks ran (no float
// atomics).
//
// Exps. Pass 1 needs two per logit, because the row and the column shifts
// differ (a shared shift underflows whole columns). Each is one FMA and
// one ex2.approx on the base-2 logit, or Schraudolph's bit trick with
// fast_exp; every rescale of a running sum uses the exact expf. Rows and
// columns past the edges get a -inf bias, so they need no test per logit.
//
// Bound on an H100: operations. A pass does 3 x 2 B L S C bf16 tensor-core
// flops on (L + S) C x 4 bytes of features, far above the card's ~295
// flop/byte balance; at L = S = 10816, C = 256, B = 2 the product alone
// takes 0.363 ms at 989 TFLOP/s.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WGS = 2;             // consumer warpgroups per block
constexpr int WG_M = 64;           // f0 rows per warpgroup (the wgmma M)
constexpr int BM = WGS * WG_M;     // f0 rows per block
constexpr int BN = 64;             // f1 rows per tile (the wgmma N)
constexpr int ACC = BN / 2;        // fp32 accumulators a thread holds
constexpr int WARPS = 4 * WGS;
constexpr int STAGES = 2;          // f1 tiles in shared memory
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_SPLITS = 4;
constexpr int COMBINE_THREADS = 256;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float NEG = -1e9f;
constexpr float MASK_BIAS = 1e9f;

// Schraudolph exp, bit for bit as the JAX package's `_fast_exp`: clamp,
// x * A + B in f32 without contraction, truncate to int32, reinterpret.
__device__ __forceinline__ float fast_exp(float x) {
  x = fminf(fmaxf(x, -87.0f), 87.0f);
  return __int_as_float(
      __float2int_rz(__fadd_rn(__fmul_rn(x, 12102203.0f), 1064866805.0f)));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// (m, s) <- the logsumexp pair of (m, s) and (mo, so), rescaled exactly.
__device__ __forceinline__ void combine_lse(float& m, float& s, float mo,
                                            float so) {
  const float mn = fmaxf(m, mo);
  s = mn == -INFINITY ? 0.f : s * expf(m - mn) + so * expf(mo - mn);
  m = mn;
}

// (v, a) <- the larger of (v, a) and (vo, ao); on equal values the
// smaller index.
__device__ __forceinline__ void combine_first(float& v, int& a, float vo,
                                              int ao) {
  if (vo > v || (vo == v && ao < a)) {
    v = vo;
    a = ao;
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// mbarrier in shared memory at `bar`: init, arm with the bytes to expect
// (this thread's arrival), and wait for the phase of the given parity.
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One TMA box of `map` at coordinates (channel, row, pair) into shared
// memory at dst, completing on the mbarrier `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap& map,
                                         int c0, int c1, int c2,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins registers in program order around the asynchronous wgmmas, so the
// compiler moves no read or write of them across a fence or a wait.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor: K-major, 128-byte swizzle, 8-row groups
// 1024 bytes apart (SBO); the leading offset is unused in this layout.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  uint64_t d = static_cast<uint64_t>((addr & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>(16 >> 4) << 16;
  d |= static_cast<uint64_t>(1024 >> 4) << 32;
  d |= 1ull << 62;
  return d;
}

#define DSM_ACC_OUT                                                         \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])

// d (+)= A(64 x 16) . B(64 x 16)^T, A and B in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[ACC], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : DSM_ACC_OUT
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (+)= A(64 x 16) . B(64 x 16)^T, A in registers (4 x 2 bf16 a thread,
// the layout of mma.m16n8k16's A in each warp's 16 rows).
__device__ __forceinline__ void wgmma_rs(float (&d)[ACC], const uint32_t* a,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : DSM_ACC_OUT
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

#undef DSM_ACC_OUT

// Issues z = hi0.hi1 + hi0.lo1 + lo0.hi1 over all C channels for one
// warpgroup's 64 x 64 part of a tile (3 C / 16 wgmmas, one commit group).
// hi0 is this thread's register fragment, 4 words per k step; a_lo, b_hi,
// b_lo are descriptors of the shared operands. A k step moves 32 bytes
// within a 128-byte row; four steps make one atom of rows x 128 bytes.
template <int C>
__device__ __forceinline__ void issue_tile(float (&d)[ACC],
                                           const uint32_t (&hi0)[C / 4],
                                           uint64_t a_lo, uint64_t b_hi,
                                           uint64_t b_lo) {
  fence_acc(d);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < C / 16; ++kk) {
    const uint64_t ka = ((kk >> 2) * WG_M * 128 + (kk & 3) * 32) >> 4;
    const uint64_t kb = ((kk >> 2) * BN * 128 + (kk & 3) * 32) >> 4;
    wgmma_rs(d, &hi0[4 * kk], b_hi + kb, kk > 0);
    wgmma_rs(d, &hi0[4 * kk], b_lo + kb, 1);
    wgmma_ss(d, a_lo + ka, b_hi + kb, 1);
  }
  wgmma_commit();
}

// x, redefined here for the compiler, so that nothing computed from it is
// hoisted out of the loop and held in registers.
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

// Masked logit, rounded as the plain version rounds it: (product + row
// bias) + column bias, no contraction. Rows and columns past the edge get
// a -inf bias, so they drop out of every max and sum without a test.
__device__ __forceinline__ float logit(float dot, float rb, float cb) {
  return __fadd_rn(__fadd_rn(dot, rb), cb);
}

__device__ __forceinline__ float edge_bias(const float* __restrict__ mask,
                                           int i, int n) {
  return i < n ? (__ldg(mask + i) - 1.f) * MASK_BIAS : -INFINITY;
}

// Accumulator layout of m64nNk16 (fp32): thread (warp w of warpgroup wg,
// lane l) holds rows 64 wg + 16 w + l/4 + 8i of the block and columns
// 8j + 2(l%4) + c of the tile in d[4j + 2i + c].
struct Lane {
  int wg, w, g, q;
  __device__ explicit Lane(int tid)
      : wg(tid >> 7), w((tid >> 5) & 3), g((tid & 31) >> 2), q(tid & 3) {}
  __device__ int row(int i) const { return WG_M * wg + 16 * w + g + 8 * i; }
  __device__ int col(int k) const { return 8 * (k >> 1) + 2 * q + (k & 1); }
  __device__ int warp() const { return 4 * wg + w; }  // ascending rows
};

struct Pass1Smem {
  float cmax[WARPS][BN];
  float csum[WARPS][BN];
};

struct Pass2Smem {
  float cval[WARPS][BN];
  int carg[WARPS][BN];
};

// This thread's hi0 fragment of its warpgroup's 64 rows, all C channels:
// word 4 kk + h holds channels 16 kk + 2q + 8 (h / 2), +1, of row
// g + 8 (h % 2) of its warp's 16.
template <int C>
__device__ __forceinline__ void load_hi0(uint32_t (&a)[C / 4],
                                         const __nv_bfloat16* __restrict__ hi0,
                                         int a0, int na, const Lane& ln) {
  const int r0 = a0 + WG_M * ln.wg + 16 * ln.w + ln.g;
#pragma unroll
  for (int kk = 0; kk < C / 16; ++kk)
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int r = r0 + 8 * (h & 1);
      const int k = 16 * kk + 2 * ln.q + 8 * (h >> 1);
      a[4 * kk + h] =
          r < na ? __ldg(reinterpret_cast<const uint32_t*>(
                       hi0 + static_cast<size_t>(r) * C + k))
                 : 0u;
    }
}

// The exp of one tile term: Schraudolph's with FAST, else ex2.approx on
// the base-2 logit (z log2 e - m log2 e, one FMA).
template <bool FAST>
__device__ __forceinline__ float tile_exp(float z, float m, float m_log2) {
  return FAST ? fast_exp(z - m) : ex2(fmaf(z, LOG2E, -m_log2));
}

// Pass 1 epilogue of one tile: running row (max, sum), and the block's
// column partial (max over its 128 rows, sum of exp(z - max)).
template <bool FAST>
__device__ __forceinline__ void epilogue1(
    const float (&d)[ACC], int b0, int nb, const float* __restrict__ m1,
    const float (&rb)[2], float (&m)[2], float (&s)[2], Pass1Smem& sm,
    float2* __restrict__ part, const Lane& ln, int tid) {
  float z[ACC];
#pragma unroll
  for (int k = 0; k < ACC / 2; ++k) {
    const float cb = edge_bias(m1, b0 + ln.col(k), nb);
    const int j = k >> 1, c = k & 1;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      z[4 * j + 2 * i + c] = logit(d[4 * j + 2 * i + c], rb[i], cb);
  }
  // Rows: the rescale is exact; only the tile's own exp terms may be fast.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float tmax = -INFINITY;
#pragma unroll
    for (int k = 0; k < ACC / 2; ++k)
      tmax = fmaxf(tmax, z[4 * (k >> 1) + 2 * i + (k & 1)]);
    if (tmax == -INFINITY) continue;  // no live column for this thread
    if (tmax > m[i]) {
      s[i] *= expf(m[i] - tmax);
      m[i] = tmax;
    }
    const float ml = m[i] * LOG2E;
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < ACC / 2; ++k)
      acc += tile_exp<FAST>(z[4 * (k >> 1) + 2 * i + (k & 1)], m[i], ml);
    s[i] += acc;
  }
  // Columns: each warp shifts by its own 16-row max (lanes 4, 8, 16
  // apart share a column); the 8 warps are combined exactly below.
#pragma unroll
  for (int k = 0; k < ACC / 2; ++k) {
    const int j = k >> 1, c = k & 1;
    const float z0 = z[4 * j + c], z1 = z[4 * j + 2 + c];
    float mw = fmaxf(z0, z1);
#pragma unroll
    for (int off = 4; off < 32; off <<= 1)
      mw = fmaxf(mw, __shfl_xor_sync(0xffffffffu, mw, off));
    const float ml = mw * LOG2E;
    float e = tile_exp<FAST>(z0, mw, ml) + tile_exp<FAST>(z1, mw, ml);
#pragma unroll
    for (int off = 4; off < 32; off <<= 1)
      e += __shfl_xor_sync(0xffffffffu, e, off);
    if (ln.g == 0) {
      sm.cmax[ln.warp()][ln.col(k)] = mw;
      sm.csum[ln.warp()][ln.col(k)] = mw == -INFINITY ? 0.f : e;
    }
  }
  __syncthreads();
  if (tid < BN && b0 + tid < nb) {
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, sm.cmax[w][tid]);
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w)
      sum += sm.csum[w][tid] * expf(sm.cmax[w][tid] - mx);
    part[b0 + tid] = make_float2(mx, sum);
  }
}

// Pass 2 epilogue of one tile: running row (max, first arg) of 2z - lse_c,
// and the block's column partial (max, first row) of 2z - lse_r.
__device__ __forceinline__ void epilogue2(
    const float (&d)[ACC], int b0, int nb, const float* __restrict__ m1,
    const float* __restrict__ lse_c, const float (&rb)[2],
    const float (&lr)[2], const int (&row)[2], float (&best)[2],
    int (&arg)[2], Pass2Smem& sm, float2* __restrict__ part, const Lane& ln,
    int tid) {
  // k ascending is this thread's columns in increasing order, so a
  // strictly greater value keeps the first index.
#pragma unroll
  for (int k = 0; k < ACC / 2; ++k) {
    const int j = k >> 1, c = k & 1, col = b0 + ln.col(k);
    const float cb = edge_bias(m1, col, nb);
    const float lc = col < nb ? __ldg(lse_c + col) : 0.f;
    float u[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float z2 = 2.f * logit(d[4 * j + 2 * i + c], rb[i], cb);
      const float t = __fsub_rn(z2, lc);
      if (t > best[i]) {
        best[i] = t;
        arg[i] = col;
      }
      u[i] = __fsub_rn(z2, lr[i]);
    }
    // The column over this thread's two rows, then its 8 lanes.
    float v = u[0];
    int a = row[0];
    if (u[1] > v) {
      v = u[1];
      a = row[1];
    }
#pragma unroll
    for (int off = 4; off < 32; off <<= 1)
      combine_first(v, a, __shfl_xor_sync(0xffffffffu, v, off),
                    __shfl_xor_sync(0xffffffffu, a, off));
    if (ln.g == 0) {
      sm.cval[ln.warp()][ln.col(k)] = v;
      sm.carg[ln.warp()][ln.col(k)] = a;
    }
  }
  __syncthreads();
  if (tid < BN && b0 + tid < nb) {
    float v = sm.cval[0][tid];
    int a = sm.carg[0][tid];
#pragma unroll
    for (int w = 1; w < WARPS; ++w)  // warps hold ascending rows
      if (sm.cval[w][tid] > v) {
        v = sm.cval[w][tid];
        a = sm.carg[w][tid];
      }
    part[b0 + tid] = make_float2(v, __int_as_float(a));
  }
}

// The block's sweep over f1 tiles [t0, t1), shared by both passes: loads,
// the wgmma pipeline, and one epilogue call per tile. One thread issues
// every copy with TMA (a box is 64 channels x 64 rows, written in the
// 128-byte swizzle that the descriptors name, rows past the edge as
// zeros), completing on one mbarrier per stage. As in FlashAttention-3,
// step t issues tile t + 1's wgmmas, reduces tile t (finished at the end of
// step t - 1) while they run, and waits for them at its end, so no wgmma is
// in flight across the loop's back edge and none sits on a conditional path
// (past the last tile it is a dummy whose result is never read); otherwise
// ptxas serializes the wgmmas.
template <int C, typename Epilogue>
__device__ __forceinline__ void sweep(uint8_t* smem_raw,
                                      const uint32_t (&hi0)[C / 4],
                                      const CUtensorMap& map_lo0,
                                      const CUtensorMap& map_hi1,
                                      const CUtensorMap& map_lo1, int bz,
                                      int a0, int t0, int t1, Epilogue epi) {
  __shared__ __align__(8) uint64_t bars[STAGES + 1];  // stages, then lo0
  const int tid = threadIdx.x;
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  constexpr uint32_t a_bytes = WG_M * C * 2;  // one warpgroup's lo0
  constexpr uint32_t b_bytes = BN * C * 2;    // one half of an f1 tile
  constexpr int ATOMS = C / 64;               // boxes per row range
  auto bar = [&](int k) { return smem_addr(&bars[k]); };
  // lo0 of warpgroups 0 and 1, then stage k's f1 hi and lo.
  auto stage_of = [&](int t) { return (t - t0) % STAGES; };
  auto stage_hi = [&](int t) {
    return base + 2 * a_bytes + 2 * stage_of(t) * b_bytes;
  };
  auto load_tile = [&](int t) {  // thread 0
    if (t >= t1) return;
    const uint32_t b = bar(stage_of(t)), dst = stage_hi(t);
    mbar_expect(b, 2 * b_bytes);
#pragma unroll
    for (int a = 0; a < ATOMS; ++a) {
      tma_load(dst + a * BN * 128, map_hi1, 64 * a, t * BN, bz, b);
      tma_load(dst + b_bytes + a * BN * 128, map_lo1, 64 * a, t * BN, bz, b);
    }
  };
  auto wait_tile = [&](int t) {
    if (t < t1) mbar_wait(bar(stage_of(t)), ((t - t0) / STAGES) & 1);
  };
  auto issue = [&](float(&d)[ACC], int t) {
    const uint32_t at = opaque(base);
    const uint32_t bt = at - base + stage_hi(t);
    issue_tile<C>(d, hi0, smem_desc(at + (tid >> 7) * a_bytes),
                  smem_desc(bt), smem_desc(bt + b_bytes));
  };

  if (tid == 0) {
    for (int k = 0; k <= STAGES; ++k) mbar_init(bar(k), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect(bar(STAGES), 2 * a_bytes);
#pragma unroll
    for (int w = 0; w < WGS; ++w)
#pragma unroll
      for (int a = 0; a < ATOMS; ++a)
        tma_load(base + w * a_bytes + a * WG_M * 128, map_lo0, 64 * a,
                 a0 + WG_M * w, bz, bar(STAGES));
    for (int t = t0; t < t0 + STAGES; ++t) load_tile(t);
  }
  mbar_wait(bar(STAGES), 0);
  wait_tile(t0);
  float acc[2][ACC];
  issue(acc[0], t0);
  wgmma_wait<0>();
  fence_acc(acc[0]);

  // Step t: `cur` holds tile t's product; tiles t + 1 .. t + STAGES - 1
  // are loaded or in flight.
  auto step = [&](int t, float(&cur)[ACC], float(&nxt)[ACC]) {
    wait_tile(t + 1);
    // Every warp is past tile t's wgmmas and the previous epilogue, so
    // tile t's stage and the scratch are free.
    __syncthreads();
    if (tid == 0) load_tile(t + STAGES);
    issue(nxt, t + 1);
    if (t < t1) epi(cur, t * BN);
    wgmma_wait<0>();
    fence_acc(nxt);
  };
  for (int t = t0; t < t1; t += 2) {
    step(t, acc[0], acc[1]);
    step(t + 1, acc[1], acc[0]);
  }
}

// This block's place: pair bz, rows [a0, a0 + BM) of row tile `row_tile`,
// and f1 tiles [t0, t1) of split `split`.
struct Block {
  int bz, row_tile, split, a0, t0, t1;
  __device__ Block(int nb, int splits)
      : bz(blockIdx.z), row_tile(blockIdx.x), split(blockIdx.y) {
    a0 = row_tile * BM;
    const int nt = (nb + BN - 1) / BN;
    t0 = split * nt / splits;
    t1 = (split + 1) * nt / splits;
  }
};

template <int C, bool FAST>
__global__ void __launch_bounds__(THREADS, 1)
    pass1_kernel(const __nv_bfloat16* __restrict__ hi0,
                 const __grid_constant__ CUtensorMap map_lo0,
                 const __grid_constant__ CUtensorMap map_hi1,
                 const __grid_constant__ CUtensorMap map_lo1,
                 const float* __restrict__ m0, const float* __restrict__ m1,
                 float2* __restrict__ row_part, float2* __restrict__ col_part,
                 int na, int nb, int splits) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ Pass1Smem sm;
  const Block blk(nb, splits);
  const size_t bz = blk.bz;
  hi0 += bz * na * C;
  m0 += bz * na;
  m1 += bz * nb;
  row_part += (bz * splits + blk.split) * na;
  col_part += (bz * gridDim.x + blk.row_tile) * nb;

  const int tid = threadIdx.x;
  const Lane ln(tid);
  uint32_t a[C / 4];
  load_hi0<C>(a, hi0, blk.a0, na, ln);
  float rb[2], m[2] = {-INFINITY, -INFINITY}, s[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) rb[i] = edge_bias(m0, blk.a0 + ln.row(i), na);
  sweep<C>(smem_raw, a, map_lo0, map_hi1, map_lo1, blk.bz, blk.a0, blk.t0,
           blk.t1,
           [&](const float(&d)[ACC], int b0) {
             epilogue1<FAST>(d, b0, nb, m1, rb, m, s, sm, col_part, ln, tid);
           });
  // Combine the 4 lanes that share each row; one partial per split.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1)
      combine_lse(m[i], s[i], __shfl_xor_sync(0xffffffffu, m[i], off),
                  __shfl_xor_sync(0xffffffffu, s[i], off));
    const int r = blk.a0 + ln.row(i);
    if (ln.q == 0 && r < na) row_part[r] = make_float2(m[i], s[i]);
  }
}

template <int C>
__global__ void __launch_bounds__(THREADS, 1)
    pass2_kernel(const __nv_bfloat16* __restrict__ hi0,
                 const __grid_constant__ CUtensorMap map_lo0,
                 const __grid_constant__ CUtensorMap map_hi1,
                 const __grid_constant__ CUtensorMap map_lo1,
                 const float* __restrict__ m0, const float* __restrict__ m1,
                 const float* __restrict__ lse_r,
                 const float* __restrict__ lse_c,
                 float2* __restrict__ row_part, float2* __restrict__ col_part,
                 int na, int nb, int splits) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ Pass2Smem sm;
  const Block blk(nb, splits);
  const size_t bz = blk.bz;
  hi0 += bz * na * C;
  m0 += bz * na;
  m1 += bz * nb;
  lse_r += bz * na;
  lse_c += bz * nb;
  row_part += (bz * splits + blk.split) * na;
  col_part += (bz * gridDim.x + blk.row_tile) * nb;

  const int tid = threadIdx.x;
  const Lane ln(tid);
  uint32_t a[C / 4];
  load_hi0<C>(a, hi0, blk.a0, na, ln);
  float rb[2], lr[2], best[2] = {NEG, NEG};
  int row[2], arg[2] = {0, 0};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row[i] = blk.a0 + ln.row(i);
    rb[i] = edge_bias(m0, row[i], na);
    lr[i] = row[i] < na ? lse_r[row[i]] : 0.f;
  }
  sweep<C>(smem_raw, a, map_lo0, map_hi1, map_lo1, blk.bz, blk.a0, blk.t0,
           blk.t1,
           [&](const float(&d)[ACC], int b0) {
             epilogue2(d, b0, nb, m1, lse_c, rb, lr, row, best, arg, sm,
                       col_part, ln, tid);
           });
  // Combine the 4 lanes that share each row (on equal values the smaller
  // column wins); one partial per split.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1)
      combine_first(best[i], arg[i],
                    __shfl_xor_sync(0xffffffffu, best[i], off),
                    __shfl_xor_sync(0xffffffffu, arg[i], off));
    if (ln.q == 0 && row[i] < na)
      row_part[row[i]] = make_float2(best[i], __int_as_float(arg[i]));
  }
}

// out[b, i] = logsumexp over the parts p < np of the (max, sum) partials
// part[b, p, i], combined in order.
__global__ void combine1_kernel(const float2* __restrict__ part,
                                float* __restrict__ out, int np, int n) {
  const int i = blockIdx.x * COMBINE_THREADS + threadIdx.x;
  if (i >= n) return;
  part += static_cast<size_t>(blockIdx.y) * np * n + i;
  float m = -INFINITY, s = 0.f;
  for (int p = 0; p < np; ++p) {
    const float2 v = part[static_cast<size_t>(p) * n];
    combine_lse(m, s, v.x, v.y);
  }
  out[static_cast<size_t>(blockIdx.y) * n + i] = m + logf(fmaxf(s, 1e-30f));
}

// (out_max, out_arg)[b, i] from the (max, first arg) partials in order:
// starts from (NEG, 0), as the TPU kernel does, and takes only a strictly
// larger value, so ties keep the first part's index.
__global__ void combine2_kernel(const float2* __restrict__ part,
                                float* __restrict__ out_max,
                                int* __restrict__ out_arg, int np, int n) {
  const int i = blockIdx.x * COMBINE_THREADS + threadIdx.x;
  if (i >= n) return;
  part += static_cast<size_t>(blockIdx.y) * np * n + i;
  float v = NEG;
  int a = 0;
  for (int p = 0; p < np; ++p) {
    const float2 x = part[static_cast<size_t>(p) * n];
    if (x.x > v) {
      v = x.x;
      a = __float_as_int(x.y);
    }
  }
  const size_t o = static_cast<size_t>(blockIdx.y) * n + i;
  out_max[o] = v;
  out_arg[o] = a;
}

// The channel count the kernels are built for: the coarse width of every
// matcher the port runs. Another width is one more instantiation.
constexpr int KC = 256;

// Alignment slack, lo0 of both warpgroups and the f1 stages (hi and lo).
constexpr size_t SWEEP_SMEM =
    1024 + (static_cast<size_t>(BM) + 2 * STAGES * BN) * KC * 2;

template <typename Kernel>
int prepare(Kernel kernel) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SWEEP_SMEM)));
}

// cuTensorMapEncodeTiled, from the driver through the runtime, so that the
// library needs no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// TMA map of a (batch, n, KC) bf16 tensor: boxes of 64 channels (128
// bytes, the swizzle span) x 64 rows x 1 pair; rows past n read as zeros.
int make_map(CUtensorMap* map, const void* ptr, int batch, int n) {
  static_assert(WG_M == 64 && BN == 64, "one box is one atom of a tile");
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[3] = {KC, static_cast<cuuint64_t>(n),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[2] = {KC * 2, static_cast<cuuint64_t>(n) * KC * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

dim3 combine_grid(int n, int batch) {
  return dim3((n + COMBINE_THREADS - 1) / COMBINE_THREADS, batch);
}

}  // namespace

// Plain C entry points, loaded with ctypes. The wrapper sizes the scratch
// with the first two: `col_part` holds batch * dsm_row_tiles(na) * nb and
// `row_part` batch * splits * na float2 partials, with splits from
// dsm_splits. Each pass launches its sweep and its row and column combines
// on the given stream, does not synchronise, and returns the first CUDA
// error. C must be 256 (checked by the wrapper as well).
extern "C" int dsm_row_tiles(int na) { return (na + BM - 1) / BM; }

// How many ranges f1's tiles are cut into: the count of 1..MAX_SPLITS (at
// most one per tile) whose blocks fill the last wave on the card's SMs
// best, the smallest on a tie.
extern "C" int dsm_splits(int batch, int na, int nb) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      sms < 1)
    return 1;
  const int nt = (nb + BN - 1) / BN;
  int best = 1;
  double best_fill = 0.0;
  for (int k = 1; k <= MAX_SPLITS && k <= nt; ++k) {
    const long blocks = static_cast<long>(dsm_row_tiles(na)) * k * batch;
    const long waves = (blocks + sms - 1) / sms;
    const double fill = static_cast<double>(blocks) / (waves * sms);
    if (fill > best_fill + 1e-9) {
      best = k;
      best_fill = fill;
    }
  }
  return best;
}

extern "C" int dsm_pass1(const void* hi0, const void* lo0, const void* hi1,
                         const void* lo1, const float* m0, const float* m1,
                         float* lse_r, float* lse_c, void* row_part,
                         void* col_part, int batch, int na, int nb, int C,
                         int splits, int fast_exp, void* stream) {
  if (C != KC || splits < 1 || splits > MAX_SPLITS)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_lo0, map_hi1, map_lo1;
  int rc;
  if ((rc = make_map(&map_lo0, lo0, batch, na)) ||
      (rc = make_map(&map_hi1, hi1, batch, nb)) ||
      (rc = make_map(&map_lo1, lo1, batch, nb)))
    return rc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nt = dsm_row_tiles(na);
  const dim3 grid(nt, splits, batch);
  auto* h0 = static_cast<const __nv_bfloat16*>(hi0);
  auto* rp = static_cast<float2*>(row_part);
  auto* cp = static_cast<float2*>(col_part);
  if (fast_exp) {
    if ((rc = prepare(pass1_kernel<KC, true>))) return rc;
    pass1_kernel<KC, true><<<grid, THREADS, SWEEP_SMEM, st>>>(
        h0, map_lo0, map_hi1, map_lo1, m0, m1, rp, cp, na, nb, splits);
  } else {
    if ((rc = prepare(pass1_kernel<KC, false>))) return rc;
    pass1_kernel<KC, false><<<grid, THREADS, SWEEP_SMEM, st>>>(
        h0, map_lo0, map_hi1, map_lo1, m0, m1, rp, cp, na, nb, splits);
  }
  if ((rc = static_cast<int>(cudaGetLastError()))) return rc;
  combine1_kernel<<<combine_grid(na, batch), COMBINE_THREADS, 0, st>>>(
      rp, lse_r, splits, na);
  combine1_kernel<<<combine_grid(nb, batch), COMBINE_THREADS, 0, st>>>(
      cp, lse_c, nt, nb);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dsm_pass2(const void* hi0, const void* lo0, const void* hi1,
                         const void* lo1, const float* m0, const float* m1,
                         const float* lse_r, const float* lse_c,
                         float* row_max, int* row_arg, float* col_max,
                         int* col_arg, void* row_part, void* col_part,
                         int batch, int na, int nb, int C, int splits,
                         void* stream) {
  if (C != KC || splits < 1 || splits > MAX_SPLITS)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_lo0, map_hi1, map_lo1;
  int rc;
  if ((rc = make_map(&map_lo0, lo0, batch, na)) ||
      (rc = make_map(&map_hi1, hi1, batch, nb)) ||
      (rc = make_map(&map_lo1, lo1, batch, nb)))
    return rc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nt = dsm_row_tiles(na);
  const dim3 grid(nt, splits, batch);
  auto* rp = static_cast<float2*>(row_part);
  auto* cp = static_cast<float2*>(col_part);
  if ((rc = prepare(pass2_kernel<KC>))) return rc;
  pass2_kernel<KC><<<grid, THREADS, SWEEP_SMEM, st>>>(
      static_cast<const __nv_bfloat16*>(hi0), map_lo0, map_hi1, map_lo1, m0,
      m1, lse_r, lse_c, rp, cp, na, nb, splits);
  if ((rc = static_cast<int>(cudaGetLastError()))) return rc;
  combine2_kernel<<<combine_grid(na, batch), COMBINE_THREADS, 0, st>>>(
      rp, row_max, row_arg, splits, na);
  combine2_kernel<<<combine_grid(nb, batch), COMBINE_THREADS, 0, st>>>(
      cp, col_max, col_arg, nt, nb);
  return static_cast<int>(cudaGetLastError());
}
