// Hand-written Hopper (sm_90a) kernels for the rotation-hash count
// sketch (commefficient_tpu_torch/ops/sketch.py CSVec). Plain C entry
// points, loaded with ctypes by ops/kernels/sketch_cuda.py.
//
// Hash family (ops/sketch.py module docstring): the [d] vector is cut
// into B = ceil(d / c) chunks of length c; row j of the [r, c] table
// rotates chunk b by off[j, b] and signs element s of it by
// eps[j, s] * delta[j, b].
//
// K1 cct_sketch_encode replaces commefficient_tpu/ops/kernels/
// sketch_pallas.py _encode_kernel / pallas_encode. On the TPU a row's
// [c] accumulator stays resident in VMEM across a sequential (r, B)
// grid; a 500k-column row is 2 MB, far above a Hopper block's 227 KB
// of shared memory, and Hopper blocks run in no order. So the design
// turns the grid around: one thread owns one output cell (j, p) and
// loops b = 0..B-1 in ascending order, gathering the source element
// s = (p - off[j, b]) mod c of each chunk. No atomics, no shared
// memory, and the summation order is the JAX static path's
// (ops/sketch.py encode), so the result is bitwise the plain version's.
// Reads of x are coalesced except at the one wrap point per (j, b);
// the zero-padded tail is a masked read at >= d, so no padded copy of
// x is ever made. Bound: bytes (x once, eps once, table once: about
// 46 MB at d = 6.57M, r = 5, c = 500k), roughly 14 us at 3.35 TB/s.
// This simple design re-reads eps and x per row (r passes over x,
// B passes over eps), which the 50 MB L2 absorbs in part.
//
// K2 cct_sketch_estimate_all replaces sketch_pallas.py
// _estimate_kernel / pallas_estimate_all (with its helpers
// _chunk_estimate_rows, _masked_est and _median_rows). One thread owns
// one estimate (b, p): it gathers the r signed values
// table[j, (p + off[j, b]) mod c] * eps[j, p] * delta[j, b] into
// registers, sorts them with a compare-exchange network unrolled for
// the compile-time row count R (1 <= R <= 16), and writes the middle
// value, or 0.5f * (a + b) of the two middles for even R, exactly as
// _median_rows does; cells at global index >= d are written as 0.
// Bound: bytes (table once, eps once, the [B, c] estimate once: about
// 48 MB at the main-path shapes), roughly 14 us at 3.35 TB/s.
//
// K3 (K3a cct_sketch_threshold_sample + K3b cct_sketch_threshold_mask)
// replaces sketch_pallas.py pallas_threshold_decode's two kernels,
// _sample_kernel and _mask_kernel: the large-d decode (d > 32M) that
// selects every estimate whose square reaches a threshold priced from a
// strided sample, without materializing the [B, c] estimate. Both
// reuse K2's per-cell device code (estimate_at), so each estimate is
// bitwise K2's. K3a: one thread per (chunk b, sample s) at chunk
// position p = s * stride, the tail (b * c + p >= d) written as 0.
// Bound: bytes, about 24 MB at d = 124.4M (r = 5, c = 500k: the table,
// eps and the [B, ns] sample), some 7 us; the gathers are strided, so
// the sectors fetched are several times the bytes used and the bound
// is optimistic. K3b: one thread per (b, p) with b * c + p < d; it
// reads the threshold from device memory (no host round trip) and
// writes est if est * est >= thr else 0 (>= keeps ties, as _mask_kernel
// does) straight into the [d] output: no [B, c] buffer, no padded copy
// to cut. Bound: bytes, the 498 MB output write (the table and eps,
// 20 MB, stay in the 50 MB L2 across chunks), some 0.155 ms.
//
// Arithmetic is written with __fmul_rn / __fadd_rn so nvcc cannot
// contract it into FMAs (the build passes -fmad=false as well): the
// product order is (eps * x) * delta for K1 and (table * eps) * delta
// for K2 and K3, the same as the plain versions.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void encode_kernel(const float* __restrict__ x, long long d,
                              const int* __restrict__ off,
                              const float* __restrict__ delta,
                              const float* __restrict__ eps,
                              float* __restrict__ table, int c, int B) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y;
  if (p >= c) return;
  const int* off_j = off + (long long)j * B;
  const float* delta_j = delta + (long long)j * B;
  const float* eps_j = eps + (long long)j * c;
  float acc = 0.0f;
  for (int b = 0; b < B; ++b) {
    int s = p - off_j[b];
    if (s < 0) s += c;
    const long long gi = (long long)b * c + s;
    const float xv = gi < d ? x[gi] : 0.0f;
    acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(eps_j[s], xv), delta_j[b]));
  }
  table[(long long)j * c + p] = acc;
}

// median-of-rows estimate of cell (b, p): the r signed values
// table[j, (p + off[j, b]) mod c] * eps[j, p] * delta[j, b], sorted by
// the bubble compare-exchange network _median_rows traces, then the
// middle (odd R) or 0.5f * (a + b) of the two middles (even R)
template <int R>
__device__ __forceinline__ float estimate_at(const float* __restrict__ table,
                                             const int* __restrict__ off,
                                             const float* __restrict__ delta,
                                             const float* __restrict__ eps,
                                             int c, int B, int b, int p) {
  float v[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    int q = p + off[(long long)j * B + b];
    if (q >= c) q -= c;
    v[j] = __fmul_rn(__fmul_rn(table[(long long)j * c + q],
                               eps[(long long)j * c + p]),
                     delta[(long long)j * B + b]);
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int k = 0; k < R - 1 - i; ++k) {
      const float lo = fminf(v[k], v[k + 1]);
      const float hi = fmaxf(v[k], v[k + 1]);
      v[k] = lo;
      v[k + 1] = hi;
    }
  }
  return (R % 2) ? v[R / 2]
                 : __fmul_rn(0.5f, __fadd_rn(v[R / 2 - 1], v[R / 2]));
}

template <int R>
__global__ void estimate_kernel(const float* __restrict__ table,
                                const int* __restrict__ off,
                                const float* __restrict__ delta,
                                const float* __restrict__ eps,
                                float* __restrict__ est, int c, int B,
                                long long d) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (p >= c) return;
  const long long gi = (long long)b * c + p;
  est[gi] = gi < d ? estimate_at<R>(table, off, delta, eps, c, B, b, p)
                   : 0.0f;
}

// K3a: the estimate at chunk positions 0, stride, ..., (ns - 1) * stride
template <int R>
__global__ void threshold_sample_kernel(const float* __restrict__ table,
                                        const int* __restrict__ off,
                                        const float* __restrict__ delta,
                                        const float* __restrict__ eps,
                                        float* __restrict__ sample, int c,
                                        int B, long long d, int stride,
                                        int ns) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (s >= ns) return;
  const int p = s * stride;
  const long long gi = (long long)b * c + p;
  sample[(long long)b * ns + s] =
      gi < d ? estimate_at<R>(table, off, delta, eps, c, B, b, p) : 0.0f;
}

// K3b: est if est * est >= *thr else 0, written at global index b*c + p
template <int R>
__global__ void threshold_mask_kernel(const float* __restrict__ table,
                                      const int* __restrict__ off,
                                      const float* __restrict__ delta,
                                      const float* __restrict__ eps,
                                      const float* __restrict__ thr,
                                      float* __restrict__ out, int c, int B,
                                      long long d) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (p >= c) return;
  const long long gi = (long long)b * c + p;
  if (gi >= d) return;
  const float e = estimate_at<R>(table, off, delta, eps, c, B, b, p);
  out[gi] = __fmul_rn(e, e) >= __ldg(thr) ? e : 0.0f;
}

template <int R>
void launch_estimate(const float* table, const int* off, const float* delta,
                     const float* eps, float* est, int c, int B, long long d,
                     cudaStream_t stream) {
  dim3 grid((c + kThreads - 1) / kThreads, B);
  estimate_kernel<R><<<grid, kThreads, 0, stream>>>(table, off, delta, eps,
                                                    est, c, B, d);
}

template <int R>
void launch_sample(const float* table, const int* off, const float* delta,
                   const float* eps, float* sample, int c, int B,
                   long long d, int stride, int ns, cudaStream_t stream) {
  dim3 grid((ns + kThreads - 1) / kThreads, B);
  threshold_sample_kernel<R><<<grid, kThreads, 0, stream>>>(
      table, off, delta, eps, sample, c, B, d, stride, ns);
}

template <int R>
void launch_mask(const float* table, const int* off, const float* delta,
                 const float* eps, const float* thr, float* out, int c, int B,
                 long long d, cudaStream_t stream) {
  dim3 grid((c + kThreads - 1) / kThreads, B);
  threshold_mask_kernel<R><<<grid, kThreads, 0, stream>>>(
      table, off, delta, eps, thr, out, c, B, d);
}

}  // namespace

// one case per compile-time row count 1..16; any other r is refused
#define CCT_ROWS_CASE(R, LAUNCH) \
  case R:                        \
    LAUNCH(R);                   \
    break;
#define CCT_ROWS_SWITCH(r, LAUNCH)                                     \
  switch (r) {                                                         \
    CCT_ROWS_CASE(1, LAUNCH) CCT_ROWS_CASE(2, LAUNCH)                  \
    CCT_ROWS_CASE(3, LAUNCH) CCT_ROWS_CASE(4, LAUNCH)                  \
    CCT_ROWS_CASE(5, LAUNCH) CCT_ROWS_CASE(6, LAUNCH)                  \
    CCT_ROWS_CASE(7, LAUNCH) CCT_ROWS_CASE(8, LAUNCH)                  \
    CCT_ROWS_CASE(9, LAUNCH) CCT_ROWS_CASE(10, LAUNCH)                 \
    CCT_ROWS_CASE(11, LAUNCH) CCT_ROWS_CASE(12, LAUNCH)                \
    CCT_ROWS_CASE(13, LAUNCH) CCT_ROWS_CASE(14, LAUNCH)                \
    CCT_ROWS_CASE(15, LAUNCH) CCT_ROWS_CASE(16, LAUNCH)                \
    default:                                                           \
      return (int)cudaErrorInvalidValue;                               \
  }

#define LAUNCH_ESTIMATE(R) \
  launch_estimate<R>(table, off, delta, eps, est, c, B, d, (cudaStream_t)stream)
#define LAUNCH_SAMPLE(R)                                         \
  launch_sample<R>(table, off, delta, eps, sample, c, B, d, stride, ns, \
                   (cudaStream_t)stream)
#define LAUNCH_MASK(R) \
  launch_mask<R>(table, off, delta, eps, thr, out, c, B, d, (cudaStream_t)stream)

extern "C" {

// table[r, c] <- sketch of x[d]. Returns cudaGetLastError() after the
// launch (0 = launched).
int cct_sketch_encode(const float* x, long long d, const int* off,
                      const float* delta, const float* eps, float* table,
                      int r, int c, int B, void* stream) {
  if (r < 1 || c < 1 || B < 1 || r > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid((c + kThreads - 1) / kThreads, r);
  encode_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      x, d, off, delta, eps, table, c, B);
  return (int)cudaGetLastError();
}

// est[B, c] <- median-of-rows estimate of every coordinate of the
// sketched vector, the tail at >= d zeroed. Returns cudaGetLastError().
int cct_sketch_estimate_all(const float* table, const int* off,
                            const float* delta, const float* eps, float* est,
                            int r, int c, int B, long long d, void* stream) {
  if (c < 1 || B < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  CCT_ROWS_SWITCH(r, LAUNCH_ESTIMATE)
  return (int)cudaGetLastError();
}

// sample[B, ns] <- the estimates at chunk positions s * stride (K3a).
// Returns cudaGetLastError().
int cct_sketch_threshold_sample(const float* table, const int* off,
                                const float* delta, const float* eps,
                                float* sample, int r, int c, int B,
                                long long d, int stride, int ns,
                                void* stream) {
  if (c < 1 || B < 1 || B > 65535 || stride < 1 || ns < 1 ||
      (long long)(ns - 1) * stride >= c)
    return (int)cudaErrorInvalidValue;
  CCT_ROWS_SWITCH(r, LAUNCH_SAMPLE)
  return (int)cudaGetLastError();
}

// out[d] <- est where est * est >= *thr, else 0 (K3b). `thr` is one
// float in device memory. Returns cudaGetLastError().
int cct_sketch_threshold_mask(const float* table, const int* off,
                              const float* delta, const float* eps,
                              const float* thr, float* out, int r, int c,
                              int B, long long d, void* stream) {
  if (c < 1 || B < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  CCT_ROWS_SWITCH(r, LAUNCH_MASK)
  return (int)cudaGetLastError();
}

const char* cct_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
