// Hand-written Hopper (sm_90a) causal flash-attention forward (K4) for
// commefficient_tpu_torch/ops/attention.py. Plain C entry point, loaded
// with ctypes by ops/kernels/attention_cuda.py.
//
// K4 cct_flash_fwd replaces commefficient_tpu/ops/attention.py
// _flash_fwd_kernel / _flash_fwd_pallas. On the TPU the grid (B*H,
// q-block, k-block) runs in order and carries the online-softmax state
// (running max m, denominator l, accumulator acc) in VMEM scratch from
// one k step to the next. Hopper blocks run in no order, so the k steps
// become a loop inside the block: one block owns one (batch*head,
// 64-query tile); each of its 64 threads owns one query row and keeps
// that row's scaled q, its m, l and acc in registers. The block walks
// the 64-key tiles up to the causal diagonal only (tiles above it are
// never loaded, where the TPU grid still streams them), staging each
// K and V tile in shared memory (2 x 64 x Dh f32 = 32 KB at Dh = 64),
// where every thread reads the same key at once (a broadcast, no bank
// conflicts). Per tile the fold is attention.py:113-132's: scores into
// registers, masked to NEG_INF above the diagonal, the tile max, m_new,
// p = exp(s - m_new), rescale = exp(m - m_new), l = l * rescale +
// sum p, acc = acc * rescale + p V; the end is :134-138's: l_safe =
// max(l, 1e-30), o = acc / l_safe, lse = m + log(l_safe). The ragged
// last tile is masked here (rows >= L are neither read nor written;
// keys >= L load as 0 and sit above the diagonal of every real row),
// so the wrapper makes no padded copy.
//
// The score and PV products are the kernel's own f32 FMAs: no tensor
// cores (TF32 or bf16 would break parity with the float32 reference).
// Bound: operations, about 2.1 GFLOP per launch at [192, 294, 64]
// causal, ~32 us at 67 TFLOP/s f32 (58 MB of q, k, v, o, lse move in
// ~17 us). This simple design issues one shared-memory load per FMA
// and runs 64 threads a block; register tiles of several rows per
// thread, wgmma and TMA are later work. The wrapper takes [B, H, L, Dh]
// and makes q, k, v contiguous (three copies a layer); passing strides
// instead is later work too.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;   // query rows per block (one per thread)
constexpr int kBK = 64;   // keys per staged tile
constexpr float kNegInf = -1e30f;

template <int DH>
__global__ void __launch_bounds__(kBQ)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int L, float sm_scale) {
  constexpr int V4 = DH / 4;
  __shared__ float4 ks[kBK * V4];
  __shared__ float4 vs[kBK * V4];

  const int t = threadIdx.x;
  const int q0 = blockIdx.x * kBQ;
  const int row = q0 + t;
  const long long base = (long long)blockIdx.y * L * DH;
  const bool live = row < L;

  float qr[DH];
  float acc[DH];
  if (live) {
    const float4* q4 = reinterpret_cast<const float4*>(q + base +
                                                       (long long)row * DH);
#pragma unroll
    for (int c = 0; c < V4; ++c) {
      const float4 x = q4[c];
      qr[4 * c] = x.x * sm_scale;
      qr[4 * c + 1] = x.y * sm_scale;
      qr[4 * c + 2] = x.z * sm_scale;
      qr[4 * c + 3] = x.w * sm_scale;
    }
  } else {
#pragma unroll
    for (int d = 0; d < DH; ++d) qr[d] = 0.0f;
  }
#pragma unroll
  for (int d = 0; d < DH; ++d) acc[d] = 0.0f;
  float m = kNegInf;
  float l = 0.0f;

  const int last = min(q0 + kBQ, L) - 1;      // last real query row
  const int n_tiles = last / kBK + 1;         // tiles up to the diagonal
  const float4* k4 = reinterpret_cast<const float4*>(k + base);
  const float4* v4 = reinterpret_cast<const float4*>(v + base);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();   // the previous tile is no longer read
    for (int i = t; i < kBK * V4; i += kBQ) {
      const int key = k0 + i / V4;
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      ks[i] = key < L ? k4[(long long)k0 * V4 + i] : zero;
      vs[i] = key < L ? v4[(long long)k0 * V4 + i] : zero;
    }
    __syncthreads();
    if (!live) continue;

    float s[kBK];
    float smax = kNegInf;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      float dot = 0.0f;
#pragma unroll
      for (int c = 0; c < V4; ++c) {
        const float4 kv = ks[j * V4 + c];
        dot = fmaf(qr[4 * c], kv.x, dot);
        dot = fmaf(qr[4 * c + 1], kv.y, dot);
        dot = fmaf(qr[4 * c + 2], kv.z, dot);
        dot = fmaf(qr[4 * c + 3], kv.w, dot);
      }
      s[j] = (k0 + j <= row) ? dot : kNegInf;
      smax = fmaxf(smax, s[j]);
    }
    const float m_new = fmaxf(m, smax);
    const float rescale = expf(m - m_new);
    float psum = 0.0f;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      s[j] = expf(s[j] - m_new);
      psum += s[j];
    }
    l = l * rescale + psum;
    m = m_new;
#pragma unroll
    for (int d = 0; d < DH; ++d) acc[d] *= rescale;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      const float p = s[j];
#pragma unroll
      for (int c = 0; c < V4; ++c) {
        const float4 vv = vs[j * V4 + c];
        acc[4 * c] = fmaf(p, vv.x, acc[4 * c]);
        acc[4 * c + 1] = fmaf(p, vv.y, acc[4 * c + 1]);
        acc[4 * c + 2] = fmaf(p, vv.z, acc[4 * c + 2]);
        acc[4 * c + 3] = fmaf(p, vv.w, acc[4 * c + 3]);
      }
    }
  }
  if (!live) return;
  const float l_safe = fmaxf(l, 1e-30f);
  float4* o4 = reinterpret_cast<float4*>(o + base + (long long)row * DH);
#pragma unroll
  for (int c = 0; c < V4; ++c)
    o4[c] = make_float4(acc[4 * c] / l_safe, acc[4 * c + 1] / l_safe,
                        acc[4 * c + 2] / l_safe, acc[4 * c + 3] / l_safe);
  lse[(long long)blockIdx.y * L + row] = m + logf(l_safe);
}

template <int DH>
void launch(const float* q, const float* k, const float* v, float* o,
            float* lse, int BH, int L, float sm_scale, cudaStream_t stream) {
  dim3 grid((L + kBQ - 1) / kBQ, BH);
  flash_fwd_kernel<DH><<<grid, kBQ, 0, stream>>>(q, k, v, o, lse, L,
                                                 sm_scale);
}

}  // namespace

extern "C" {

// o[BH, L, Dh], lse[BH, L] <- causal attention of q, k, v [BH, L, Dh]
// (contiguous, 16-byte aligned), Dh in {16, 32, 64}. Returns
// cudaGetLastError() after the launch (0 = launched).
int cct_flash_fwd(const float* q, const float* k, const float* v, float* o,
                  float* lse, int BH, int L, int dh, float sm_scale,
                  void* stream) {
  if (BH < 1 || BH > 65535 || L < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dh) {
    case 16: launch<16>(q, k, v, o, lse, BH, L, sm_scale, s); break;
    case 32: launch<32>(q, k, v, o, lse, BH, L, sm_scale, s); break;
    case 64: launch<64>(q, k, v, o, lse, BH, L, sm_scale, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* cct_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
