// Batched SPD solve x[s] = A[s]^-1 b[s] for the normal equations of ALS:
// a right-looking Cholesky of each K x K system, then forward and back
// substitution. Hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel `_spd_solve_kernel` (predictionio_tpu/ops/
// linalg.py:106), launched by `cholesky_solve_pallas` (:155).
//
//   A [S, K, K] f32   SPD systems, row-major, jitter already added
//   b [S, K]    f32   right-hand sides
//   x [S, K]    f32   out
//
// Same arithmetic as the TPU kernel and the plain version
// (ops/linalg.cholesky_solve_vec): step j takes d = rsqrt(max(A[j][j],
// 1e-30)), scales column j by d, and subtracts col col^T from the
// trailing lower triangle; substitution divides by the factor's
// diagonal. An empty segment (A = lambda*I, b = 0) gives x = 0 exactly.
// The TPU wrapper pads S to its tile with identity systems; here a ragged
// last block is a bounds guard and the answers are the same.
//
// Bound on the card: the kernel must read A and b once and write x once,
// S*(K^2 + 2K)*4 bytes, and do about S*(K^3/3 + 2K^2) f32 multiply-adds.
// At S = 138,000 and K = 10 that is 66 MB, at least 0.020 ms at
// 3.35 TB/s; the f32 operations (about 0.9 GFLOP over 67 TFLOP/s) take
// less, so bytes bound it. At K = 64 it is 2.33 GB, about 0.70 ms.
//
// Design (simple and right first): one warp per system, a few warps per
// block. The warp stages A[s] in shared memory as K rows of K+1 floats
// (the pad keeps a column walk off one bank), at most 16.6 KB at K = 64,
// plus its right-hand side. In step j every lane reads the pivot, lanes
// stride over rows i >= j to scale column j, then over the trailing
// (i, k) square, updating its lower triangle; __syncwarp() separates
// reads from writes. Substitution is column-oriented: lanes over rows
// update the remaining right-hand sides after each solved entry, so no
// step needs a reduction. What this gives up against the bound: at
// K = 10, 22 of 32 lanes idle in the row loops, and every step pays two
// warp barriers. The TPU kernel's batch-in-lanes layout (one system per
// lane) is the redesign a later change may take.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 4;          // systems per block
constexpr int kMaxK = 64;

__global__ void spd_solve_kernel(const float* __restrict__ A,
                                 const float* __restrict__ b,
                                 float* __restrict__ x, int S, int K) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long s = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (s >= S) return;                      // ragged last block
  const int ld = K + 1;
  float* L = smem + warp * (K * ld + K);   // [K][K+1]
  float* r = L + K * ld;                   // [K] rhs, then y, then x

  const float* a = A + s * K * K;
  for (int e = lane; e < K * K; e += 32) L[(e / K) * ld + e % K] = a[e];
  for (int e = lane; e < K; e += 32) r[e] = b[s * K + e];
  __syncwarp();

  // Cholesky: column j, then the trailing lower triangle
  for (int j = 0; j < K; ++j) {
    const float d = rsqrtf(fmaxf(L[j * ld + j], 1e-30f));
    __syncwarp();                          // everyone has read the pivot
    for (int i = j + lane; i < K; i += 32) L[i * ld + j] *= d;
    __syncwarp();
    const int m = K - 1 - j;
    for (int e = lane; e < m * m; e += 32) {
      const int i = j + 1 + e / m;
      const int k = j + 1 + e % m;
      if (k <= i) L[i * ld + k] -= L[i * ld + j] * L[k * ld + j];
    }
    __syncwarp();
  }

  // forward: L y = b, y kept in r
  for (int j = 0; j < K; ++j) {
    const float yj = r[j] / L[j * ld + j];
    __syncwarp();
    for (int i = j + 1 + lane; i < K; i += 32) r[i] -= L[i * ld + j] * yj;
    if (lane == 0) r[j] = yj;
    __syncwarp();
  }
  // back: L^T x = y, x kept in r (row j of L^T is column j of L)
  for (int j = K - 1; j >= 0; --j) {
    const float xj = r[j] / L[j * ld + j];
    __syncwarp();
    for (int i = lane; i < j; i += 32) r[i] -= L[j * ld + i] * xj;
    if (lane == 0) r[j] = xj;
    __syncwarp();
  }
  for (int e = lane; e < K; e += 32) x[s * K + e] = r[e];
}

}  // namespace

// Plain C entry point (bound with ctypes). Returns cudaGetLastError()
// after the launch; 0 is success.
extern "C" int pio_spd_solve(const void* A, const void* b, void* x, int S,
                             int K, void* stream) {
  if (S < 1 || K < 1 || K > kMaxK)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * kWarps * (K * (K + 1) + K);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        spd_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (S + kWarps - 1) / kWarps;
  spd_solve_kernel<<<blocks, kWarps * 32, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(A), static_cast<const float*>(b),
      static_cast<float*>(x), S, K);
  return static_cast<int>(cudaGetLastError());
}

// Name of an error code, for the wrapper's exception message.
extern "C" const char* pio_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
