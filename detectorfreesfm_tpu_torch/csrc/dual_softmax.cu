// Dual-softmax match statistics for Hopper (sm_90a), CUDA C++.
//
// Replaces the two Pallas TPU kernels of the JAX package's
// ops/pallas_dsm.py: `_pass1_kernel` (row and column logsumexp) and
// `_pass2_kernel` (row and column max/argmax of 2z - lse), with
//   z[r, s] = scale * <A_r, B_s> + (mA_r - 1) * 1e9 + (mB_s - 1) * 1e9.
//
// The TPU kernels carry column statistics from one grid step to the next,
// which relies on the TPU grid running in order. GPU blocks run in no
// order, so both statistics here are row reductions: one block owns TILE
// rows of A and loops over all of B, and the column statistics come from a
// second launch with A and B swapped (z is symmetric under the swap). That
// forms the product four times where the TPU forms it twice.
//
// Bound on an H100: operations. Each launch does 2 * batch * na * nb * C
// fp32 flops against ~(na + nb) * C * 4 bytes per pair, so at the main
// path's shape (na = nb = 10816, C = 256) it is far above the card's
// flop/byte balance; the least time is the fp32 product at the non-tensor
// fp32 peak (67 TFLOP/s). The design keeps the (na, nb) logits out of
// device memory entirely, and register-blocks the product (4x4 outputs a
// thread, float4 shared-memory reads) so that shared memory is not the
// limit. It runs in exact fp32 FMAs (no TF32, no bf16), so the logits are
// at least as exact as the TPU's 3-pass bf16 hi/lo product. Tensor cores
// and fusing the four products into two are later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TILE = 64;      // rows of A per block, rows of B per step
constexpr int BK = 16;        // channels per shared-memory stage
constexpr int TM = 4;         // rows a thread owns
constexpr int TN = 4;         // columns a thread owns in each B tile
constexpr int TX = TILE / TN; // 16 threads share a row
constexpr int THREADS = (TILE / TM) * TX;  // 256
constexpr float NEG = -1e9f;
constexpr float MASK_BIAS = 1e9f;

struct Smem {
  float a[BK][TILE + 4];
  float b[BK][TILE + 4];
};

// Schraudolph exp, bit for bit as the JAX package's `_fast_exp`: clamp,
// x * A + B in f32 without contraction, truncate to int32, reinterpret.
__device__ __forceinline__ float fast_exp(float x) {
  x = fminf(fmaxf(x, -87.0f), 87.0f);
  return __int_as_float(
      __float2int_rz(__fadd_rn(__fmul_rn(x, 12102203.0f), 1064866805.0f)));
}

// Rows [row0, row0 + TILE) and channels [k0, k0 + BK) of X (n x C,
// row-major) into dst[k][r], transposed; zeros outside. One float4 a
// thread; C % 4 == 0 and 16-byte alignment are checked by the wrapper.
__device__ __forceinline__ void load_tile(float (*dst)[TILE + 4],
                                          const float* __restrict__ X, int n,
                                          int C, int row0, int k0, int tid) {
  const int r = tid >> 2;
  const int kq = (tid & 3) * 4;
  const int row = row0 + r;
  const int k = k0 + kq;
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (row < n && k < C)
    v = *reinterpret_cast<const float4*>(X + (size_t)row * C + k);
  dst[kq + 0][r] = v.x;
  dst[kq + 1][r] = v.y;
  dst[kq + 2][r] = v.z;
  dst[kq + 3][r] = v.w;
}

// acc[i][j] = <A_{a0 + ty*TM + i}, B_{b0 + tx*TN + j}> over all C channels.
__device__ __forceinline__ void tile_product(float acc[TM][TN], Smem& sm,
                                             const float* __restrict__ A,
                                             const float* __restrict__ B,
                                             int na, int nb, int C, int a0,
                                             int b0, int tid, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < C; k0 += BK) {
    load_tile(sm.a, A, na, C, a0, k0, tid);
    load_tile(sm.b, B, nb, C, b0, k0, tid);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&sm.a[k][ty * TM]);
      const float4 b = *reinterpret_cast<const float4*>(&sm.b[k][tx * TN]);
      const float av[TM] = {a.x, a.y, a.z, a.w};
      const float bv[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// Masked logit, rounded as the plain version rounds it:
// ((dot * scale) + row bias) + column bias, no contraction.
__device__ __forceinline__ float logit(float dot, float scale, float rb,
                                       float cb) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dot, scale), rb), cb);
}

// Counterpart of _pass1_kernel: out[r] = logsumexp_s z[r, s].
template <bool FAST>
__global__ void __launch_bounds__(THREADS)
    row_lse_kernel(const float* __restrict__ A, const float* __restrict__ B,
                   const float* __restrict__ mA, const float* __restrict__ mB,
                   float* __restrict__ out, int na, int nb, int C,
                   float scale) {
  __shared__ __align__(16) Smem sm;
  const int bz = blockIdx.y;
  A += (size_t)bz * na * C;
  B += (size_t)bz * nb * C;
  mA += (size_t)bz * na;
  mB += (size_t)bz * nb;
  out += (size_t)bz * na;
  const int tid = threadIdx.x;
  const int ty = tid / TX;
  const int tx = tid % TX;
  const int a0 = blockIdx.x * TILE;

  float rb[TM], m[TM], s[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = a0 + ty * TM + i;
    rb[i] = r < na ? (mA[r] - 1.f) * MASK_BIAS : 0.f;
    m[i] = -INFINITY;
    s[i] = 0.f;
  }
  float acc[TM][TN];
  for (int b0 = 0; b0 < nb; b0 += TILE) {
    tile_product(acc, sm, A, B, na, nb, C, a0, b0, tid, ty, tx);
    float cb[TN];
    bool ok[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = b0 + tx * TN + j;
      ok[j] = c < nb;
      cb[j] = ok[j] ? (mB[c] - 1.f) * MASK_BIAS : 0.f;
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      float z[TN];
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        z[j] = logit(acc[i][j], scale, rb[i], cb[j]);
        if (ok[j]) tmax = fmaxf(tmax, z[j]);
      }
      // The rescale is exact; only the tile's own exp terms may be fast.
      if (tmax > m[i]) {
        s[i] *= expf(m[i] - tmax);
        m[i] = tmax;
      }
#pragma unroll
      for (int j = 0; j < TN; ++j)
        if (ok[j]) s[i] += FAST ? fast_exp(z[j] - m[i]) : expf(z[j] - m[i]);
    }
  }
  // Combine the TX threads that share each row (lanes of one half-warp).
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float mm = m[i], ss = s[i];
#pragma unroll
    for (int off = TX / 2; off > 0; off >>= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, mm, off);
      const float so = __shfl_xor_sync(0xffffffffu, ss, off);
      const float mn = fmaxf(mm, mo);
      ss = mn == -INFINITY ? 0.f : ss * expf(mm - mn) + so * expf(mo - mn);
      mm = mn;
    }
    const int r = a0 + ty * TM + i;
    if (tx == 0 && r < na) out[r] = mm + logf(fmaxf(ss, 1e-30f));
  }
}

// Counterpart of _pass2_kernel: out_max[r], out_arg[r] = max, argmax over s
// of 2 z[r, s] - bias[s]. Starts from (NEG, 0) and replaces only on a
// strictly greater value, walking s upwards, so ties go to the first index
// exactly as in the TPU kernel.
__global__ void __launch_bounds__(THREADS)
    row_argmax_kernel(const float* __restrict__ A, const float* __restrict__ B,
                      const float* __restrict__ mA,
                      const float* __restrict__ mB,
                      const float* __restrict__ bias,
                      float* __restrict__ out_max, int* __restrict__ out_arg,
                      int na, int nb, int C, float scale) {
  __shared__ __align__(16) Smem sm;
  const int bz = blockIdx.y;
  A += (size_t)bz * na * C;
  B += (size_t)bz * nb * C;
  mA += (size_t)bz * na;
  mB += (size_t)bz * nb;
  bias += (size_t)bz * nb;
  out_max += (size_t)bz * na;
  out_arg += (size_t)bz * na;
  const int tid = threadIdx.x;
  const int ty = tid / TX;
  const int tx = tid % TX;
  const int a0 = blockIdx.x * TILE;

  float rb[TM], best[TM];
  int arg[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = a0 + ty * TM + i;
    rb[i] = r < na ? (mA[r] - 1.f) * MASK_BIAS : 0.f;
    best[i] = NEG;
    arg[i] = 0;
  }
  float acc[TM][TN];
  for (int b0 = 0; b0 < nb; b0 += TILE) {
    tile_product(acc, sm, A, B, na, nb, C, a0, b0, tid, ty, tx);
    float cb[TN], bb[TN];
    bool ok[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = b0 + tx * TN + j;
      ok[j] = c < nb;
      cb[j] = ok[j] ? (mB[c] - 1.f) * MASK_BIAS : 0.f;
      bb[j] = ok[j] ? bias[c] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float t = __fsub_rn(2.f * logit(acc[i][j], scale, rb[i], cb[j]),
                                  bb[j]);
        if (ok[j] && t > best[i]) {
          best[i] = t;
          arg[i] = b0 + tx * TN + j;
        }
      }
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float bm = best[i];
    int ba = arg[i];
#pragma unroll
    for (int off = TX / 2; off > 0; off >>= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, bm, off);
      const int ao = __shfl_xor_sync(0xffffffffu, ba, off);
      if (mo > bm || (mo == bm && ao < ba)) {
        bm = mo;
        ba = ao;
      }
    }
    const int r = a0 + ty * TM + i;
    if (tx == 0 && r < na) {
      out_max[r] = bm;
      out_arg[r] = ba;
    }
  }
}

}  // namespace

// Plain C entry points, loaded with ctypes. Each launches on the given
// stream, does not synchronise, and returns cudaGetLastError().
extern "C" int dsm_row_lse(const float* A, const float* B, const float* mA,
                           const float* mB, float* out, int batch, int na,
                           int nb, int C, float scale, int fast_exp,
                           void* stream) {
  const dim3 grid((na + TILE - 1) / TILE, batch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fast_exp)
    row_lse_kernel<true><<<grid, THREADS, 0, st>>>(A, B, mA, mB, out, na, nb,
                                                   C, scale);
  else
    row_lse_kernel<false><<<grid, THREADS, 0, st>>>(A, B, mA, mB, out, na, nb,
                                                    C, scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dsm_row_argmax(const float* A, const float* B, const float* mA,
                              const float* mB, const float* bias,
                              float* out_max, int* out_arg, int batch, int na,
                              int nb, int C, float scale, void* stream) {
  const dim3 grid((na + TILE - 1) / TILE, batch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  row_argmax_kernel<<<grid, THREADS, 0, st>>>(A, B, mA, mB, bias, out_max,
                                              out_arg, na, nb, C, scale);
  return static_cast<int>(cudaGetLastError());
}
