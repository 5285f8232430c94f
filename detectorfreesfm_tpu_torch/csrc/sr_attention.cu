// MatchFormer's spatially-reduced attention core for Hopper (sm_90a), CUDA
// C++, fp32 on the CUDA cores.
//
// For q of shape (F, N, C) and the pooled keys and values k, v of shape
// (F, M, C), `heads` heads of DH = C / heads channels each (head h is the
// channels h DH .. h DH + DH - 1 of a row), it computes
//   out[f, i, h] = sum_j softmax_j(q[f, i, h] . k[f, j, h] * scale) v[f, j, h],
// heads side by side in (F, N, C), the layout the output projection reads.
// Nothing of size N x M reaches device memory: each query keeps a running
// max and sum of exponentials per head over the keys it has seen, and its
// DH output sums in registers, and only the result is written.
//
// Replaces no TPU kernel: the JAX package's SRAttention leaves the logits,
// the softmax and the values to XLA. The port's chain (kept as
// ops/sr_attention.py's sr_attention_plain) wrote fp32 logits per chunk of
// 4 096 queries, scaled them, wrote their softmax and read it again for the
// values: 97 GB of logits a pair at 832 px, each passed over about six
// times, for a result the size of q.
//
// Bound on an H100: operations. A layer is 4 N M C fp32 flops a frame (QK
// and AV, two to a multiply-add): 1.20e12 a pair at 832 px over the three
// stages, ~17.9 ms at the ~67 TFLOP/s of fp32 FFMA. The configuration runs
// fp32 with TF32 off, so the products are plain FFMAs: no TF32, bf16 or
// split products on the tensor cores.
//
// Design. A block of 128 threads owns THREADS x R queries of one (frame,
// head); each thread holds R whole queries (R x DH values) and their R x DH
// output sums in registers. The head's keys and values stream through
// shared memory in stages of 128 rows (a 3-stage cp.async ring, rows past M
// zero-filled), and every thread reads the same key or value row, so each
// read is a broadcast that feeds R x DH FFMAs. Keys are taken in tiles of
// TK: the R x TK logits of a tile stay in registers, each query's tile
// maximum sets its running max, and the output sums and the sum of
// exponentials are rescaled once per tile, not once per key.
//
// The exponent is one FMA and one ex2.approx on the MUFU pipe: scale and
// log2(e) are folded into one factor, as csrc/flow_head.cu does. At DH = 8
// (stride 2, 40% of the flops) a logit is 8 FFMAs of QK and 8 of AV against
// that FMA, a max, an add and the ex2, whose pipe runs 1/8 of the FFMA rate;
// so that pipe is about half as busy as the FFMA pipe, and the
// tile's rescale costs R x DH multiplies per TK keys. The tile sizes follow
// the head width the call has (8, 16 or 32): R x DH values of q and of the
// output a thread, R = 4, 4, 2.
//
// Keys past M in the last stage are -inf; queries past N read zeros and
// write nothing. Each block writes its own queries: no float atomics, no
// order between blocks.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 128;
constexpr int TS = 128;      // key rows a stage
constexpr int STAGES = 3;    // stages in the cp.async ring

// Queries a thread (R) and keys a register tile (TK) by head width.
template <int DH>
struct Tiles;
template <>
struct Tiles<8> {
  static constexpr int R = 4, TK = 16;
};
template <>
struct Tiles<16> {
  static constexpr int R = 4, TK = 16;
};
template <>
struct Tiles<32> {
  static constexpr int R = 2, TK = 16;
};

template <int DH>
constexpr size_t smem_bytes() {
  return sizeof(float) * STAGES * 2 * TS * DH;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 16 bytes from src, or zeros where !ok (src is then not read).
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int DH>
__device__ __forceinline__ void load_row(const float* p, float (&x)[DH]) {
#pragma unroll
  for (int e = 0; e < DH; e += 4) {
    const float4 a = *reinterpret_cast<const float4*>(p + e);
    x[e] = a.x, x[e + 1] = a.y, x[e + 2] = a.z, x[e + 3] = a.w;
  }
}

// Key and value rows t TS .. t TS + TS - 1 of the head (rows of DH floats
// at stride c) into shared [TS][DH] each; rows past m are zeros.
template <int DH>
__device__ __forceinline__ void load_stage(float* ks, float* vs,
                                           const float* kb, const float* vb,
                                           int t, int m, int c) {
  constexpr int V4 = DH / 4;
#pragma unroll
  for (int it = 0; it < TS * V4 / THREADS; ++it) {
    const int i = it * THREADS + threadIdx.x;
    const int row = i / V4, col = (i % V4) * 4;
    const int key = t * TS + row;
    const bool ok = key < m;
    const size_t off = static_cast<size_t>(ok ? key : 0) * c + col;
    cp_async16(ks + row * DH + col, kb + off, ok);
    cp_async16(vs + row * DH + col, vb + off, ok);
  }
}

template <int DH>
__global__ void __launch_bounds__(THREADS)
    sr_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ out, int n,
              int m, int c, float scale_log2) {
  constexpr int R = Tiles<DH>::R, TK = Tiles<DH>::TK;
  static_assert(TS % TK == 0 && (TS * DH / 4) % THREADS == 0, "tiles");
  extern __shared__ __align__(16) float smem[];

  const int h = blockIdx.y, f = blockIdx.z;
  const float* kb = k + static_cast<size_t>(f) * m * c + h * DH;
  const float* vb = v + static_cast<size_t>(f) * m * c + h * DH;
  const size_t qf = static_cast<size_t>(f) * n * c + h * DH;
  const int tiles = (m + TS - 1) / TS;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < tiles)
      load_stage<DH>(smem + s * 2 * TS * DH, smem + (s * 2 + 1) * TS * DH,
                     kb, vb, s, m, c);
    cp_async_commit();
  }

  int qi[R];
  float qr[R][DH], acc[R][DH], mx[R], sum[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    qi[r] = (blockIdx.x * R + r) * THREADS + threadIdx.x;
    if (qi[r] < n) {
      load_row<DH>(q + qf + static_cast<size_t>(qi[r]) * c, qr[r]);
    } else {
#pragma unroll
      for (int e = 0; e < DH; ++e) qr[r][e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < DH; ++e) acc[r][e] = 0.f;
    mx[r] = -INFINITY;
    sum[r] = 0.f;
  }

  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage t landed; every thread is done with t - 1
    const int next = t + STAGES - 1;
    if (next < tiles) {
      const int slot = next % STAGES;
      load_stage<DH>(smem + slot * 2 * TS * DH,
                     smem + (slot * 2 + 1) * TS * DH, kb, vb, next, m, c);
    }
    cp_async_commit();
    const float* ks = smem + (t % STAGES) * 2 * TS * DH;
    const float* vs = ks + TS * DH;
    const int valid = min(TS, m - t * TS);

    for (int j0 = 0; j0 < valid; j0 += TK) {
      float s[R][TK];
#pragma unroll
      for (int j = 0; j < TK; ++j) {
        float kr[DH];
        load_row<DH>(ks + (j0 + j) * DH, kr);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float d = 0.f;
#pragma unroll
          for (int e = 0; e < DH; ++e) d = fmaf(qr[r][e], kr[e], d);
          s[r][j] = d;
        }
      }
      if (j0 + TK > valid) {  // the last tile of keys: rows past M
#pragma unroll
        for (int j = 0; j < TK; ++j)
          if (j0 + j >= valid) {
#pragma unroll
            for (int r = 0; r < R; ++r) s[r][j] = -INFINITY;
          }
      }
      // Each query's running max, then the tile's exponentials (in place
      // of its logits) and one rescale of the sums. The tile holds a key
      // below M, so the new max is finite and alpha is 0 on the first
      // tile.
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float mt = s[r][0];
#pragma unroll
        for (int j = 1; j < TK; ++j) mt = fmaxf(mt, s[r][j]);
        const float mn = fmaxf(mx[r], mt * scale_log2);
        const float alpha = ex2(mx[r] - mn);
        mx[r] = mn;
        float ps = 0.f;
#pragma unroll
        for (int j = 0; j < TK; ++j) {
          s[r][j] = ex2(fmaf(s[r][j], scale_log2, -mn));
          ps += s[r][j];
        }
        sum[r] = fmaf(sum[r], alpha, ps);
#pragma unroll
        for (int e = 0; e < DH; ++e) acc[r][e] *= alpha;
      }
#pragma unroll
      for (int j = 0; j < TK; ++j) {
        float vr[DH];
        load_row<DH>(vs + (j0 + j) * DH, vr);
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int e = 0; e < DH; ++e)
            acc[r][e] = fmaf(s[r][j], vr[e], acc[r][e]);
      }
    }
  }
  cp_async_wait<0>();  // only empty groups are left

#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (qi[r] >= n) continue;
    float* o = out + qf + static_cast<size_t>(qi[r]) * c;
#pragma unroll
    for (int e = 0; e < DH; e += 4)
      *reinterpret_cast<float4*>(o + e) =
          make_float4(acc[r][e] / sum[r], acc[r][e + 1] / sum[r],
                      acc[r][e + 2] / sum[r], acc[r][e + 3] / sum[r]);
  }
}

template <int DH>
int launch(const float* q, const float* k, const float* v, float* out,
           int frames, int n, int m, int heads, float scale,
           cudaStream_t stream) {
  constexpr size_t SMEM = smem_bytes<DH>();
  int rc = static_cast<int>(cudaFuncSetAttribute(
      sr_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMEM)));
  if (rc) return rc;
  const int per_block = THREADS * Tiles<DH>::R;
  const dim3 grid((n + per_block - 1) / per_block, heads, frames);
  // exp(x * scale) = 2^(x * scale * log2(e)).
  const float scale_log2 = scale * 1.4426950408889634f;
  sr_kernel<DH><<<grid, THREADS, SMEM, stream>>>(q, k, v, out, n, m,
                                                  heads * DH, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, out: (frames, n, heads x dh) fp32; k, v: (frames, m, heads x dh) fp32;
// all contiguous and 16-byte aligned; dh is 8, 16 or 32. Returns the
// launch's CUDA error code.
extern "C" int sr_attention(const float* q, const float* k, const float* v,
                            float* out, int frames, int n, int m, int heads,
                            int dh, float scale, void* stream) {
  if (frames < 1 || frames > 65535 || n < 1 || m < 1 || heads < 1 ||
      heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 8:
      return launch<8>(q, k, v, out, frames, n, m, heads, scale, st);
    case 16:
      return launch<16>(q, k, v, out, frames, n, m, heads, scale, st);
    case 32:
      return launch<32>(q, k, v, out, frames, n, m, heads, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
