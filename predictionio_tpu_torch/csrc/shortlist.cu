// Two-stage scorer, stage 1: per item tile, dequantize int8 factors,
// score them against each query row in f32 and emit the tile's local
// top-c. Hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel `kernel` inside `build_pallas_shortlist`
// (predictionio_tpu/ops/scoring.py:885) and computes what the reference
// actually serves with, `_shortlist_scan` (ops/scoring.py:237): the
// Pallas kernel takes no exclusion mask, this one does.
//
//   u      [B, R]      f32   query rows, already rotated and truncated
//   tiles  [nt, T, R]  int8  quantized item factors, item-major
//   scales [nt, T]     f32   per-item dequantization scale
//   mask   [B, nt*T]   u8    optional, nonzero = excluded
//   vals   [B, nt*c]   f32   out: tile t's candidates at [t*c, (t+1)*c)
//   ids    [B, nt*c]   i32   out: global item ids
//
// Score of item i of tile t for row b: (sum_r u[b,r] * q[t,i,r]) * s[t,i];
// -inf when t*T+i >= n_items or the item is masked. Candidates come out
// value descending, ties by ascending id (the rule of lax.top_k and of
// ops/topk.merge_topk). Slots beyond a tile's finite scores carry -inf.
//
// Bound on the card: the kernel must read every tile byte once,
// nt*T*R + nt*T*4 bytes (+ B*nt*T for a mask). At 10M items, scan rank
// 32 and T = 16384 that is about 360 MB, so at 3.35 TB/s it can take no
// less than about 0.11 ms per batch; at large B the 2*B*nt*T*R f32
// operations (67 TFLOP/s outside the tensor cores) bound it instead.
//
// Design (simple and right first): one block per (row b, tile t), b
// varying fastest so the B blocks reading one tile run close together
// and share it through L2. The simple design gives up against the bound
// in three places: it reads each tile B times (from L2 at best), it
// scores in scalar f32 FMAs instead of int8 tensor-core products, and
// it stages the whole [T] score row in shared memory, which caps
// residency at three blocks per SM. Reading a tile once for all B rows,
// wgmma products and TMA loads are later work.
//
// Selection: every thread keeps the best (value, id) among the items it
// owns (i = tid + k*THREADS). Each of the c rounds reduces those over
// the block (warp shuffles, then one warp over the per-warp winners),
// writes the winner, and the owning thread knocks it out (NaN, which
// never compares better) and rescans only its own items.

#include <cuda_runtime.h>
#include <climits>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ bool better(float v1, int i1, float v2, int i2) {
  return v1 > v2 || (v1 == v2 && i1 < i2);
}

// sign-extended byte j (0..3) of a 32-bit word, as float
__device__ __forceinline__ float sbyte(int w, int j) {
  return static_cast<float>((w << (24 - 8 * j)) >> 24);
}

__device__ __forceinline__ float dot_word(int w, const float* su) {
  float a = 0.f;
  a = fmaf(su[0], sbyte(w, 0), a);
  a = fmaf(su[1], sbyte(w, 1), a);
  a = fmaf(su[2], sbyte(w, 2), a);
  a = fmaf(su[3], sbyte(w, 3), a);
  return a;
}

// dot product of one int8 row with u (in shared memory); VEC is the
// load width in bytes, chosen by the host so every row start is aligned
template <int VEC>
__device__ __forceinline__ float dot_row(const int8_t* __restrict__ row,
                                         const float* su, int R) {
  float acc = 0.f;
  if constexpr (VEC == 16) {
    const int4* p = reinterpret_cast<const int4*>(row);
    for (int k = 0; k < R / 16; ++k) {
      const int4 w = __ldg(p + k);
      const float* s = su + 16 * k;
      acc += dot_word(w.x, s);
      acc += dot_word(w.y, s + 4);
      acc += dot_word(w.z, s + 8);
      acc += dot_word(w.w, s + 12);
    }
  } else if constexpr (VEC == 8) {
    const int2* p = reinterpret_cast<const int2*>(row);
    for (int k = 0; k < R / 8; ++k) {
      const int2 w = __ldg(p + k);
      const float* s = su + 8 * k;
      acc += dot_word(w.x, s);
      acc += dot_word(w.y, s + 4);
    }
  } else if constexpr (VEC == 4) {
    const int* p = reinterpret_cast<const int*>(row);
    for (int k = 0; k < R / 4; ++k) acc += dot_word(__ldg(p + k), su + 4 * k);
  } else {
    for (int r = 0; r < R; ++r)
      acc = fmaf(su[r], static_cast<float>(row[r]), acc);
  }
  return acc;
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
shortlist_topc_kernel(const float* __restrict__ u,
                      const int8_t* __restrict__ tiles,
                      const float* __restrict__ scales,
                      const uint8_t* __restrict__ mask,
                      float* __restrict__ vals, int32_t* __restrict__ ids,
                      int B, int nt, int T, int R, int n_items, int cand) {
  extern __shared__ float smem[];
  float* sc = smem;            // [T] sentineled scores of this tile
  float* su = smem + T;        // [R] query row
  __shared__ float warp_v[kWarps];
  __shared__ int warp_i[kWarps];
  __shared__ int winner;

  const int b = blockIdx.x % B;
  const int t = blockIdx.x / B;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long n_pad = static_cast<long long>(nt) * T;
  const long long base = static_cast<long long>(t) * T;

  for (int r = tid; r < R; r += kThreads) su[r] = u[static_cast<long long>(b) * R + r];
  __syncthreads();

  const int8_t* tile = tiles + base * R;
  const float* tscale = scales + base;
  const uint8_t* mrow = mask ? mask + static_cast<long long>(b) * n_pad + base : nullptr;

  float best_v = -INFINITY;
  int best_i = INT_MAX;
  for (int i = tid; i < T; i += kThreads) {
    float s = dot_row<VEC>(tile + static_cast<long long>(i) * R, su, R) * tscale[i];
    if (base + i >= n_items || (mrow && mrow[i])) s = -INFINITY;
    sc[i] = s;
    if (better(s, i, best_v, best_i)) { best_v = s; best_i = i; }
  }

  float* out_v = vals + static_cast<long long>(b) * nt * cand + static_cast<long long>(t) * cand;
  int32_t* out_i = ids + static_cast<long long>(b) * nt * cand + static_cast<long long>(t) * cand;
  for (int j = 0; j < cand; ++j) {
    float v = best_v;
    int i = best_i;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float v2 = __shfl_down_sync(0xffffffffu, v, off);
      const int i2 = __shfl_down_sync(0xffffffffu, i, off);
      if (better(v2, i2, v, i)) { v = v2; i = i2; }
    }
    if (lane == 0) { warp_v[warp] = v; warp_i[warp] = i; }
    __syncthreads();
    if (warp == 0) {
      v = lane < kWarps ? warp_v[lane] : -INFINITY;
      i = lane < kWarps ? warp_i[lane] : INT_MAX;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float v2 = __shfl_down_sync(0xffffffffu, v, off);
        const int i2 = __shfl_down_sync(0xffffffffu, i, off);
        if (better(v2, i2, v, i)) { v = v2; i = i2; }
      }
      if (lane == 0) {
        out_v[j] = v;
        out_i[j] = static_cast<int32_t>(base + i);
        winner = i;
      }
    }
    __syncthreads();
    const int w = winner;
    if (w % kThreads == tid) {
      sc[w] = NAN;   // knocked out: NaN is never better than anything
      best_v = -INFINITY;
      best_i = INT_MAX;
      for (int k = tid; k < T; k += kThreads) {
        const float s = sc[k];
        if (better(s, k, best_v, best_i)) { best_v = s; best_i = k; }
      }
    }
  }
}

template <int VEC>
cudaError_t launch(const float* u, const int8_t* tiles, const float* scales,
                   const uint8_t* mask, float* vals, int32_t* ids, int B,
                   int nt, int T, int R, int n_items, int cand,
                   cudaStream_t stream) {
  const size_t smem = (static_cast<size_t>(T) + R) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      shortlist_topc_kernel<VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long blocks = static_cast<long long>(B) * nt;
  shortlist_topc_kernel<VEC><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      u, tiles, scales, mask, vals, ids, B, nt, T, R, n_items, cand);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). Shapes are validated by the
// Python wrapper (ops/kernels.py); returns the launch's cudaError_t.
extern "C" int pio_shortlist_topc(const void* u, const void* tiles,
                                  const void* scales, const void* mask,
                                  void* vals, void* ids, int B, int nt,
                                  int T, int R, int n_items, int cand,
                                  void* stream) {
  const float* pu = static_cast<const float*>(u);
  const int8_t* pt = static_cast<const int8_t*>(tiles);
  const float* ps = static_cast<const float*>(scales);
  const uint8_t* pm = static_cast<const uint8_t*>(mask);
  float* pv = static_cast<float*>(vals);
  int32_t* pi = static_cast<int32_t*>(ids);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (R % 16 == 0)
    err = launch<16>(pu, pt, ps, pm, pv, pi, B, nt, T, R, n_items, cand, s);
  else if (R % 8 == 0)
    err = launch<8>(pu, pt, ps, pm, pv, pi, B, nt, T, R, n_items, cand, s);
  else if (R % 4 == 0)
    err = launch<4>(pu, pt, ps, pm, pv, pi, B, nt, T, R, n_items, cand, s);
  else
    err = launch<1>(pu, pt, ps, pm, pv, pi, B, nt, T, R, n_items, cand, s);
  return static_cast<int>(err);
}

// Name of an error code, for the wrapper's exception message.
extern "C" const char* pio_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
