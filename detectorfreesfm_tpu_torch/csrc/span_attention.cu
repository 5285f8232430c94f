// ASpan's window attention for Hopper (sm_90a), CUDA C++ on the CUDA cores.
//
// For q, k, v of shape (B, L, 256), 8 heads of 32 channels, and cells of
// shape (B, L, 25), the flat cells of each query's 5 x 5 window in the other
// grid (models/aspan.py's window_cells, clamped to the grid), it computes
//   out[b, i, h] = sum_j p_ij v[b, c_ij, h],
//   p_ij = softmax_j(q[b, i, h] . k[b, c_ij, h] / sqrt(32)),
// the message of FlowCrossAttention, heads side by side in (B, L, 256). Each
// query's 25 window rows of k and v are read in place, by their cells: no
// gathered, permuted or (B, L, 25)-shaped key or value tensor is written.
// Clamped windows repeat cells, and attend each repeat, as the plain chain
// does.
//
// Replaces no TPU kernel: the JAX package's FlowCrossAttention leaves the
// gather and the einsums to XLA. The port's plain chain (kept as
// ops/span_attention.py's span_attention_plain) gathered the window rows of
// k and v into (B, L x 25, 256), permuted each for two batched cuBLAS gemvs
// over B x L x 8 heads and read each again: ~17.6 GB of device memory traffic
// a call at 832 px and B = 8 for a (B, L, 256) result.
//
// Numerics, as the chain: the element type T is float or bf16. Logits, the
// softmax and the weighted sum are fp32: each logit an fp32 dot over the
// head's 32 channels times 1/sqrt(32); the softmax as exp(s - max) over
// their sum; with bf16 values the probabilities are rounded to bf16 before
// they weight the values; the message is written in T. Only the order of
// the sums differs from cuBLAS's.
//
// Bound on an H100: memory. A call needs q, k, v and the message (88.6 MB
// each in fp32 at 832 px, B = 8, L = 10 816) and the cells (17.3 MB of
// int64) once from device memory, ~0.37 GB, 0.111 ms at 3.35 TB/s; the
// arithmetic (2 x 25 x 256 multiply-adds a query, 2.2 GFLOP a call) is
// ~0.03 ms of fp32 FFMA. The window's rows repeat from query to query, so
// what a kernel can do is serve those repeats from L1 and L2.
//
// Design. A warp a query: lane t holds channels 8t..8t+7, so the four lanes
// 4h..4h+3 are head h. Lanes 0..24 load the query's 25 cells (one 200-byte
// read) and broadcast each by a shuffle. For each cell the warp reads the
// key row as 16-byte vectors (1 KB in fp32, 512 B in bf16, coalesced), each
// lane dots its 8 channels with its q, and two xor shuffles sum the head's
// four lanes, so every lane of a head holds its head's 25 logits in
// registers through the softmax. A second sweep over the same cells reads
// the value rows and sums them in registers; each lane writes its 8
// channels. A block holds WARPS consecutive queries of one grid row, whose
// windows overlap in the other grid (neighbouring cells flow to
// neighbouring cells), so their rows come from L1 and L2.
//
// Measured on an H100 at 700 W, 832 px, B = 8, the bundled weights' cells:
// 0.48-0.51 ms a call in fp32 (23% of the bound; the rows pass through L1
// ~25 times each), 0.28 ms in bf16; 0.33 ms where every flow is 0 and 0.60
// ms on random cells, so the windows' locality sets the time. Blocks of 4,
// 8, 16 and 32 queries took 0.481, 0.483, 0.524 and 0.491 ms (fp32) and
// 0.280, 0.299, 0.410 and 0.318 ms (bf16).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int C = 256;             // channels: HEADS x 32
constexpr int HEADS = 8;
constexpr int K2 = 25;             // cells of a 5 x 5 window
constexpr int CH = C / 32;         // channels a lane
constexpr int WARPS = 4;           // queries a block, one a warp
constexpr int THREADS = WARPS * 32;
constexpr unsigned FULL = 0xffffffffu;
// 1/sqrt(32) in fp32, the nearest float (that of 1.0f / sqrtf(32.0f) too).
constexpr float SCALE = 0.17677669529663687f;

static_assert(C / HEADS == 4 * CH, "four lanes a head");
static_assert(K2 <= 32, "a lane a window cell");

__device__ __forceinline__ void load8(const float* p, float (&x)[CH]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
  x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&x)[CH]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < CH / 2; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float (&x)[CH]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(x[4], x[5], x[6], x[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p,
                                       const float (&x)[CH]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < CH / 2; ++i)
    h[i] = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// A probability as it weights the values: rounded to T.
__device__ __forceinline__ float as_weight(float p, float) { return p; }
__device__ __forceinline__ float as_weight(float p, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(p));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    window_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v,
                  const long long* __restrict__ cells, T* __restrict__ out,
                  int n, int l) {
  const int lane = threadIdx.x % 32;
  const int query = blockIdx.x * WARPS + threadIdx.x / 32;
  if (query >= n) return;  // the whole warp
  const size_t first = static_cast<size_t>(query / l) * l;  // its batch's
  const size_t ch = static_cast<size_t>(lane) * CH;
  int cell = 0;
  if (lane < K2)
    cell = static_cast<int>(cells[static_cast<size_t>(query) * K2 + lane]);

  float qv[CH];
  load8(q + static_cast<size_t>(query) * C + ch, qv);
  float s[K2];
#pragma unroll
  for (int j = 0; j < K2; ++j) {
    const size_t row = first + __shfl_sync(FULL, cell, j);
    float kv[CH];
    load8(k + row * C + ch, kv);
    float d = 0.f;
#pragma unroll
    for (int i = 0; i < CH; ++i) d = fmaf(qv[i], kv[i], d);
    d += __shfl_xor_sync(FULL, d, 1);
    d += __shfl_xor_sync(FULL, d, 2);
    s[j] = d * SCALE;
  }

  float m = s[0];
#pragma unroll
  for (int j = 1; j < K2; ++j) m = fmaxf(m, s[j]);
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < K2; ++j) {
    s[j] = expf(s[j] - m);
    sum += s[j];
  }

  float acc[CH];
#pragma unroll
  for (int i = 0; i < CH; ++i) acc[i] = 0.f;
#pragma unroll
  for (int j = 0; j < K2; ++j) {
    const size_t row = first + __shfl_sync(FULL, cell, j);
    float vv[CH];
    load8(v + row * C + ch, vv);
    const float p = as_weight(s[j] / sum, T());
#pragma unroll
    for (int i = 0; i < CH; ++i) acc[i] = fmaf(p, vv[i], acc[i]);
  }
  store8(out + static_cast<size_t>(query) * C + ch, acc);
}

template <typename T>
int launch(const void* q, const void* k, const void* v,
           const long long* cells, void* out, int batch, int l,
           void* stream) {
  if (batch < 1 || l < 1 ||
      static_cast<long long>(batch) * l >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n = batch * l;
  window_kernel<T><<<(n + WARPS - 1) / WARPS, THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), cells, static_cast<T*>(out), n, l);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, out: (batch, l, 256) contiguous, of the function's element type;
// cells: (batch, l, 25) int64, contiguous, each in [0, l). Returns the
// launch's CUDA error code.
extern "C" int span_attention_f32(const void* q, const void* k,
                                  const void* v, const long long* cells,
                                  void* out, int batch, int l,
                                  void* stream) {
  return launch<float>(q, k, v, cells, out, batch, l, stream);
}

extern "C" int span_attention_bf16(const void* q, const void* k,
                                   const void* v, const long long* cells,
                                   void* out, int batch, int l,
                                   void* stream) {
  return launch<__nv_bfloat16>(q, k, v, cells, out, batch, l, stream);
}
