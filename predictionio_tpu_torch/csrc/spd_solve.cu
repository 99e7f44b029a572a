// Batched SPD solve x[s] = (A[s] + diag[s] I + jitter I)^-1 b[s] for the
// normal equations of ALS: a right-looking Cholesky of each K x K system,
// then forward and back substitution. Hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel `_spd_solve_kernel` (predictionio_tpu/ops/
// linalg.py:106), launched by `cholesky_solve_pallas` (:155).
//
//   A    [S, K, K] f32   symmetric, row-major; only the lower triangle is
//                        read, and A is never written
//   b    [S, K]    f32   right-hand sides
//   diag [S]       f32   per-system ridge term, or null for none
//   x    [S, K]    f32   out
//
// Arithmetic: each diagonal entry is loaded as (A[i][i] + diag[s]) +
// jitter, the order in which the reference forms gram + lam I and then
// adds the jitter, so no pass over [S, K, K] runs before the kernel. Step
// j takes d = rsqrt(max(A[j][j], 1e-30)), scales column j by d (so
// L[j][j] = A[j][j] d) and subtracts col col^T from the trailing lower
// triangle, as the TPU kernel and ops/linalg.cholesky_solve_vec do.
// Substitution multiplies by 1/L[j][j], one IEEE reciprocal per row, which
// is the plain version's division to within a rounding. (Multiplying by
// the stored d instead would also stay inside the smoke's 1e-4 tolerance
// for SPD inputs, but departs from the plain version by orders of
// magnitude at a pivot that hits the 1e-30 floor, so it is not taken.)
// An empty segment (A = 0, diag = lambda, b = 0) gives x = 0 exactly. A
// ragged last block is a bounds guard; nothing is padded in memory.
//
// Bound on the card: the function reads A, b and diag once and writes x
// once, S*(K^2 + 2K + 1)*4 bytes, and does about S*(K^3/3 + 2K^2) f32
// multiply-adds. Bytes bound it at every shape the smoke runs: at
// S = 138,000 and K = 10, 67 MB, 0.020 ms at 3.35 TB/s, against 0.004 ms
// of f32 operations at 67 TFLOP/s; at K = 64, 2.33 GB, 0.70 ms, against
// 0.39 ms. So the design is about moving A once, in wide coalesced loads,
// with enough systems in flight to cover the recurrence's latency.
//
// Regime A, K <= 16: one system per thread (the TPU kernel's batch-in-
// lanes layout carried to threads). K is a template parameter, so every
// loop unrolls and each thread keeps its lower triangle, K(K+1)/2 floats,
// in registers. A block of T systems reads one contiguous span of T*K*K
// floats with 16-byte loads into shared memory, where each system takes
// an odd stride (K*K | 1) so the threads' reads of their own triangles
// hit 32 different banks. b is staged the same way, and x goes back
// through shared memory so its store is coalesced too. T = 128 for
// K <= 8 and 64 above, so that three or more blocks fit on an SM.
//
// Regime B, 17 <= K <= 64: one warp per system, with every loop over
// rows unrolled to a compile-time ceiling (32 or 64) and guarded by
// k < K, so no index is divided at run time and each register index is
// static. Lane l owns column l (and, above K = 32, column l + 32) of L
// in registers: 96 floats at the ceiling of 64. Step j: the owner of
// column j has scaled it and published it, K floats in a double buffer
// in shared memory, behind one __syncwarp(); every lane subtracts
// L[i][j] L[k][j] from its own columns k > j, eight rows per uniform
// branch that skips spans of rows <= j (no per-element branch), while a
// column that is done is left alone (once j passes 31, all of the
// lanes' first columns are done and the warp skips them); then the
// owner of column j + 1 scales and publishes it. Columns, not rows: with lane l
// holding rows l and K-1-l (tried first), publishing the next column
// needs each row's entry j+1, a runtime register index, and the update
// needs a guard and a branch per element, which left it latency-bound
// at several times this design's time at K = 64. Forward
// substitution reduces each row's dot product over the lanes with five
// shuffles; back substitution broadcasts each x_i with one and every
// earlier column subtracts L[i][k] x_i. A is staged 16 rows at a time
// with coalesced loads into 4.2 KB of shared memory a warp, so registers
// (128 a thread at K = 64), not shared memory, bound the warps an SM holds.
//
// The design it replaces (one warp per system at every K, A staged as K
// rows of K+1 floats, a flattened (i, k) loop with a runtime division
// per element, three barriers a step) took, on an NVIDIA H100 80GB HBM3
// at 700 W: 0.390 ms at K = 10, S = 138,000; 0.789 ms at K = 16,
// S = 138,000; 29.03 ms at K = 64, S = 138,000; 0.284 ms at K = 64,
// S = 1 (PERF.md, B1's earlier times).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kMaxK = 64;
constexpr int kThreadMaxK = 16;  // regime A up to this K, regime B above
constexpr float kFloor = 1e-30f;
constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------------------
// Regime A: one system per thread
// ---------------------------------------------------------------------------

template <int K>
struct ThreadShape {
  static constexpr int KK = K * K;
  static constexpr int P = KK | 1;            // odd stride of a staged A
  static constexpr int Q = K | 1;             // odd stride of a staged b/x
  static constexpr int T = K <= 8 ? 128 : 64; // systems (threads) a block
  static constexpr size_t smem = sizeof(float) * T * (P + Q);
};

__host__ __device__ constexpr int tri(int i, int k) { return i * (i + 1) / 2 + k; }

template <int K>
__global__ void __launch_bounds__(ThreadShape<K>::T)
spd_thread_kernel(const float* __restrict__ A, const float* __restrict__ b,
                  const float* __restrict__ diag, float* __restrict__ x,
                  int S, float jitter) {
  using Sh = ThreadShape<K>;
  constexpr int KK = Sh::KK, P = Sh::P, Q = Sh::Q, T = Sh::T;
  extern __shared__ float smem[];
  float* sa = smem;               // [T][P]
  float* sb = smem + T * P;       // [T][Q]: b, then x
  const int tid = threadIdx.x;
  const long long s0 = static_cast<long long>(blockIdx.x) * T;
  const int nsys = static_cast<int>(min(static_cast<long long>(T), S - s0));

  // stage A: one contiguous span of nsys*K*K floats, 16 bytes a load
  const float* ga = A + s0 * KK;
  const int n = nsys * KK;
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(ga) & 15) == 0) {
    const float4* ga4 = reinterpret_cast<const float4*>(ga);
    const int n4 = n >> 2;
#pragma unroll 4
    for (int i = tid; i < n4; i += T) {
      const float4 v = __ldg(ga4 + i);
      const int g = i << 2;
      sa[(g / KK) * P + g % KK] = v.x;
      sa[((g + 1) / KK) * P + (g + 1) % KK] = v.y;
      sa[((g + 2) / KK) * P + (g + 2) % KK] = v.z;
      sa[((g + 3) / KK) * P + (g + 3) % KK] = v.w;
    }
    done = n4 << 2;
  }
  for (int g = done + tid; g < n; g += T) sa[(g / KK) * P + g % KK] = __ldg(ga + g);
  const float* gb = b + s0 * K;
  for (int g = tid; g < nsys * K; g += T) sb[(g / K) * Q + g % K] = __ldg(gb + g);
  __syncthreads();

  float y[K];
  if (tid < nsys) {
    // lower triangle; after step j the diagonal slot holds 1/L[j][j],
    // which only the substitutions read
    float L[K * (K + 1) / 2];
    const float* mine = sa + tid * P;
    const float dg = diag != nullptr ? __ldg(diag + s0 + tid) : 0.0f;
#pragma unroll
    for (int i = 0; i < K; ++i) {
#pragma unroll
      for (int k = 0; k <= i; ++k) L[tri(i, k)] = mine[i * K + k];
      L[tri(i, i)] = (L[tri(i, i)] + dg) + jitter;
      y[i] = sb[tid * Q + i];
    }
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const float d = rsqrtf(fmaxf(L[tri(j, j)], kFloor));
#pragma unroll
      for (int i = j; i < K; ++i) L[tri(i, j)] *= d;
#pragma unroll
      for (int i = j + 1; i < K; ++i) {
#pragma unroll
        for (int k = j + 1; k <= i; ++k) L[tri(i, k)] -= L[tri(i, j)] * L[tri(k, j)];
      }
      L[tri(j, j)] = 1.0f / L[tri(j, j)];
    }
#pragma unroll
    for (int j = 0; j < K; ++j) {              // L y = b
      float acc = y[j];
#pragma unroll
      for (int k = 0; k < j; ++k) acc -= L[tri(j, k)] * y[k];
      y[j] = acc * L[tri(j, j)];
    }
#pragma unroll
    for (int j = K - 1; j >= 0; --j) {         // L^T x = y
      float acc = y[j];
#pragma unroll
      for (int i = j + 1; i < K; ++i) acc -= L[tri(i, j)] * y[i];
      y[j] = acc * L[tri(j, j)];
    }
  }
  __syncthreads();                             // every b read is done
  if (tid < nsys) {
#pragma unroll
    for (int i = 0; i < K; ++i) sb[tid * Q + i] = y[i];
  }
  __syncthreads();
  float* gx = x + s0 * K;
  for (int g = tid; g < nsys * K; g += T) gx[g] = sb[(g / K) * Q + g % K];
}

// ---------------------------------------------------------------------------
// Regime B: one warp per system, columns in registers
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;        // systems a block
constexpr int kChunk = 16;       // rows of A staged at a time
constexpr int kLd = 65;          // odd row stride of the staging buffer
constexpr int kSpan = 8;         // rows a step touches per uniform branch

// Column k of L sits in a lane's registers as c[i - OFF] = L[i][k] for
// OFF <= i < OFF + N. Scale the rows i >= from by d and publish them to
// the shared column buffer, 8 rows (two 16-byte stores) at a time; the
// rows above from in its span go along (see the update).
template <int N, int OFF>
__device__ __forceinline__ void scale_publish(float (&c)[N], float d,
                                              int from, int K, float* nxt) {
#pragma unroll
  for (int t0 = 0; t0 < N; t0 += kSpan) {
    if (OFF + t0 + kSpan > from && OFF + t0 < K) {
#pragma unroll
      for (int t = 0; t < kSpan; ++t) c[t0 + t] *= d;
      float4* dst = reinterpret_cast<float4*>(nxt + OFF + t0);
      dst[0] = make_float4(c[t0], c[t0 + 1], c[t0 + 2], c[t0 + 3]);
      dst[1] = make_float4(c[t0 + 4], c[t0 + 5], c[t0 + 6], c[t0 + 7]);
    }
  }
}

template <int KMAX>
__global__ void __launch_bounds__(kWarps * 32)
spd_warp_kernel(const float* __restrict__ A, const float* __restrict__ b,
                const float* __restrict__ diag, float* __restrict__ x,
                int S, int K, float jitter) {
  constexpr bool kTwo = KMAX > 32;           // lane l owns l and l + 32
  constexpr int NB = kTwo ? KMAX - 32 : kSpan;
  __shared__ float stage[kWarps][kChunk * kLd];
  __shared__ __align__(16) float colbuf[kWarps][2][KMAX];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long s = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (s >= S) return;                        // the whole warp leaves

  const int kA = lane, kB = lane + 32;       // the lane's columns
  const bool hasA = kA < K, hasB = kTwo && kB < K;
  const float dg = diag != nullptr ? __ldg(diag + s) : 0.0f;
  // cA[i] = row i of column kA, cB[i - 32] = row i of column kB. Rows
  // past K stay 0. Rows above the diagonal start at 0; the update's 8-row
  // spans leave partial sums in them, which no result reads and which
  // reach only rows above the diagonal of columns still being updated
  float cA[KMAX];
  float cB[NB];
  float diagA = 0.0f, diagB = 0.0f;          // running A[k][k] of each

  const float* a = A + s * K * K;
  float* st = stage[warp];
#pragma unroll
  for (int base = 0; base < KMAX; base += kChunk) {
    if (base < K) {
      const int nr = min(kChunk, K - base);
      __syncwarp();                          // the last chunk is read
      for (int q = 0; q < nr; ++q) {
#pragma unroll
        for (int c = 0; c < KMAX; c += 32) {
          if (c + lane < K) st[q * kLd + c + lane] = __ldg(a + (base + q) * K + c + lane);
        }
      }
      __syncwarp();
#pragma unroll
      for (int t = 0; t < kChunk; ++t) {
        const int i = base + t;
        float v = st[t * kLd + lane];
        if (i == kA) {
          v = (v + dg) + jitter;
          diagA = v;
        }
        cA[i] = (i >= kA && i < K) ? v : 0.0f;
        if constexpr (kTwo) {
          if (i >= 32) {
            float w = st[t * kLd + 32 + lane];
            if (i == kB) {
              w = (w + dg) + jitter;
              diagB = w;
            }
            cB[i - 32] = (i >= kB && i < K) ? w : 0.0f;
          }
        }
      }
    }
  }
  float yA = hasA ? __ldg(b + s * K + kA) : 0.0f;
  float yB = hasB ? __ldg(b + s * K + kB) : 0.0f;

  // Cholesky. Column j is published, scaled, by its owner; then every
  // lane folds it into its own later columns, and the owner of column
  // j + 1 scales and publishes that one. One __syncwarp a step.
  float invA = 0.0f, invB = 0.0f;            // 1 / L[k][k]
  if (lane == 0) {
    const float d = rsqrtf(fmaxf(diagA, kFloor));
    invA = 1.0f / (diagA * d);
    scale_publish<KMAX, 0>(cA, d, 0, K, colbuf[warp][0]);
  }
  __syncwarp();
  for (int j = 0; j + 1 < K; ++j) {
    const float* col = colbuf[warp][j & 1];
    float* nxt = colbuf[warp][(j + 1) & 1];
    // L[k][j] for the lane's columns k > j. A column that is done (k <= j)
    // is not updated again: the rows of column j above its diagonal, in
    // the span holding j, went out with it and carry such partial sums,
    // which must not reach L
    const bool liveA = kA > j && kA < K;
    const bool liveB = kTwo && kB > j && kB < K;
    const float LA = liveA ? col[kA] : 0.0f;
    const float LB = liveB ? col[kB] : 0.0f;
    diagA = fmaf(-LA, LA, diagA);
    diagB = fmaf(-LB, LB, diagB);
    if (liveA) {
#pragma unroll
      for (int i0 = 0; i0 < KMAX; i0 += kSpan) {
        if (i0 + kSpan > j + 1 && i0 < K) {  // rows i > j, uniform
          const float4 u = reinterpret_cast<const float4*>(col + i0)[0];
          const float4 v = reinterpret_cast<const float4*>(col + i0)[1];
          const float ci[kSpan] = {u.x, u.y, u.z, u.w, v.x, v.y, v.z, v.w};
#pragma unroll
          for (int t = 0; t < kSpan; ++t) cA[i0 + t] = fmaf(-ci[t], LA, cA[i0 + t]);
        }
      }
    }
    if constexpr (kTwo) {
      if (liveB) {
#pragma unroll
        for (int i0 = 32; i0 < KMAX; i0 += kSpan) {
          if (i0 + kSpan > j + 1 && i0 < K) {
            const float4 u = reinterpret_cast<const float4*>(col + i0)[0];
            const float4 v = reinterpret_cast<const float4*>(col + i0)[1];
            const float ci[kSpan] = {u.x, u.y, u.z, u.w, v.x, v.y, v.z, v.w};
#pragma unroll
            for (int t = 0; t < kSpan; ++t)
              cB[i0 - 32 + t] = fmaf(-ci[t], LB, cB[i0 - 32 + t]);
          }
        }
      }
    }
    const int kn = j + 1;                    // the next column's owner
    if (lane == (kn & 31)) {
      if (kn < 32) {
        const float d = rsqrtf(fmaxf(diagA, kFloor));
        invA = 1.0f / (diagA * d);
        scale_publish<KMAX, 0>(cA, d, kn, K, nxt);
      } else if constexpr (kTwo) {
        const float d = rsqrtf(fmaxf(diagB, kFloor));
        invB = 1.0f / (diagB * d);
        scale_publish<NB, 32>(cB, d, kn, K, nxt);
      }
    }
    __syncwarp();
  }

  // forward, L y = b: y_j = (b_j - sum_{k<j} L[j][k] y_k) / L[j][j], the
  // sum over the lanes' columns by a warp reduction
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    if (j < K) {
      float p = kA < j ? cA[j] * yA : 0.0f;
      if constexpr (kTwo) {
        if (j >= 32) p += kB < j ? cB[j - 32] * yB : 0.0f;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) p += __shfl_xor_sync(kFull, p, o);
      if (kA == j) yA = (yA - p) * invA;
      if constexpr (kTwo) {
        if (kB == j) yB = (yB - p) * invB;
      }
    }
  }
  // back, L^T x = y: x_i from its column's lane, broadcast, then every
  // earlier column subtracts L[i][k] x_i
#pragma unroll
  for (int i = KMAX - 1; i >= 0; --i) {
    if (i < K) {
      const float t = i < 32 ? yA * invA : yB * invB;
      const float xi = __shfl_sync(kFull, t, i & 31);
      if (i < 32) {
        if (kA == i) yA = xi;
      } else {
        if (kB == i) yB = xi;
      }
      if (kA < i) yA = fmaf(-cA[i], xi, yA);
      if constexpr (kTwo) {
        if (i >= 32 && kB < i) yB = fmaf(-cB[i - 32], xi, yB);
      }
    }
  }
  if (hasA) x[s * K + kA] = yA;
  if (hasB) x[s * K + kB] = yB;
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <int K>
cudaError_t launch_thread(const float* A, const float* b, const float* diag,
                          float* x, int S, float jitter, cudaStream_t stream) {
  using Sh = ThreadShape<K>;
  if (Sh::smem > 48 * 1024) {
    // the opt-in above 48 KB of dynamic shared memory lasts as long as
    // the device's context: raise it once per device, not per launch
    static std::atomic<unsigned long long> raised{0};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    const unsigned long long bit = 1ull << (dev & 63);
    if ((raised.load(std::memory_order_relaxed) & bit) == 0) {
      err = cudaFuncSetAttribute(
          spd_thread_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(Sh::smem));
      if (err != cudaSuccess) return err;
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
      raised.fetch_or(bit, std::memory_order_relaxed);
    }
  }
  const int blocks = (S + Sh::T - 1) / Sh::T;
  spd_thread_kernel<K><<<blocks, Sh::T, Sh::smem, stream>>>(A, b, diag, x, S,
                                                           jitter);
  return cudaGetLastError();
}

template <int KMAX>
cudaError_t launch_warp(const float* A, const float* b, const float* diag,
                        float* x, int S, int K, float jitter,
                        cudaStream_t stream) {
  const int blocks = (S + kWarps - 1) / kWarps;
  spd_warp_kernel<KMAX><<<blocks, kWarps * 32, 0, stream>>>(A, b, diag, x, S,
                                                           K, jitter);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). diag may be null. Returns
// cudaGetLastError() after the launch; 0 is success.
extern "C" int pio_spd_solve(const void* A, const void* b, const void* diag,
                             void* x, int S, int K, float jitter,
                             void* stream) {
  if (S < 1 || K < 1 || K > kMaxK)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* a = static_cast<const float*>(A);
  const float* rhs = static_cast<const float*>(b);
  const float* dg = static_cast<const float*>(diag);
  float* out = static_cast<float*>(x);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K > kThreadMaxK) {
    const cudaError_t err =
        K <= 32 ? launch_warp<32>(a, rhs, dg, out, S, K, jitter, st)
                : launch_warp<64>(a, rhs, dg, out, S, K, jitter, st);
    return static_cast<int>(err);
  }
  static_assert(kThreadMaxK == 16, "regime A is instantiated for K = 1..16");
  cudaError_t err = cudaErrorInvalidValue;
  switch (K) {
#define PIO_THREAD_CASE(k) \
    case k: err = launch_thread<k>(a, rhs, dg, out, S, jitter, st); break;
    PIO_THREAD_CASE(1) PIO_THREAD_CASE(2) PIO_THREAD_CASE(3)
    PIO_THREAD_CASE(4) PIO_THREAD_CASE(5) PIO_THREAD_CASE(6)
    PIO_THREAD_CASE(7) PIO_THREAD_CASE(8) PIO_THREAD_CASE(9)
    PIO_THREAD_CASE(10) PIO_THREAD_CASE(11) PIO_THREAD_CASE(12)
    PIO_THREAD_CASE(13) PIO_THREAD_CASE(14) PIO_THREAD_CASE(15)
    PIO_THREAD_CASE(16)
#undef PIO_THREAD_CASE
  }
  return static_cast<int>(err);
}

// Largest K that pio_spd_solve solves one system per thread (regime A);
// larger K take one warp per system (regime B).
extern "C" int pio_spd_solve_thread_max_k() { return kThreadMaxK; }

// Name of an error code, for the wrapper's exception message.
extern "C" const char* pio_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
