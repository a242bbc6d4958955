// Hand-written Hopper (sm_90a) causal flash-attention forward (K4) for
// commefficient_tpu_torch/ops/attention.py. Plain C entry point, loaded
// with ctypes by ops/kernels/attention_cuda.py.
//
// K4 cct_flash_fwd replaces commefficient_tpu/ops/attention.py
// _flash_fwd_kernel / _flash_fwd_pallas. On the TPU the grid (B*H,
// q-block, k-block) runs in order and carries the online-softmax state
// (running max m, denominator l, accumulator acc) in VMEM scratch from
// one k step to the next. Hopper blocks run in no order, so the k steps
// become a loop inside the block (FlashAttention-2's forward).
//
// What bounds it. At the GPT2-small main path ([16, 12, 299, 64]
// causal) a launch moves 59.0 MB (q, k, v read once, o and lse written
// once: 17.6 us at 3.35 TB/s) and does 2.2 GFLOP of f32-accurate
// products. On the SIMT f32 pipe (67 TFLOP/s) those products alone
// take 33 us; on the TF32 tensor cores in three passes (3 x 2.2 GFLOP
// at 495 TFLOP/s) 13 us. So the least time is the bytes', and the
// design puts the products on the tensor cores:
//
// * Layout. A block has 4 warps and owns 64 query rows of one
//   (batch, head), 16 rows (one m16 fragment) per warp, and walks the
//   64-key tiles up to the causal diagonal (tiles above it are never
//   loaded). The grid (query tiles, B*H) is issued heaviest query tile
//   first: the last tile has the most keys.
// * Products. mma.sync m16n8k8 TF32 with f32 accumulators, in three
//   passes (CUTLASS's OpMultiplyAddFastF32): each operand is split once
//   into big = cvt.rna.tf32(x) and small = cvt.rna.tf32(x - big), and
//   each product is small*big + big*small, then big*big, into the
//   accumulator. The dropped small*small term and the rounding of small
//   leave about 2^-22 of each product: f32 accuracy, where one TF32
//   pass is ~1e-3 off. q is split once when loaded; each warp splits
//   the K and V fragments it reads once per tile, and P once.
// * P as an operand. The m16n8k8 C fragment (thread (g, t) holds
//   columns 2t, 2t + 1 of rows g, g + 8) is not the A fragment (columns
//   t, t + 4). Rather than move P between lanes, the P.V product
//   relabels its reduction index inside each group of 8 keys: A column
//   t is key 2t and column t + 4 is key 2t + 1, and V's B fragment is
//   read from the same keys. The sum is over the same keys, so P stays
//   in the registers the score product wrote.
// * Staging. K and V tiles go to shared memory with cp.async (16 bytes
//   a thread), three stages deep, so tiles j + 1 and j + 2 load while
//   tile j computes (the head views' rows lie 3E floats apart, and the
//   scattered reads want the latency hidden); q is staged once through
//   the last stage's buffer. Rows are padded to Dh + 4 floats, so every
//   fragment load (K's rows g, V's keys 2t and 2t + 1) hits 32 distinct
//   banks. At Dh = 64 that is 102 KB of dynamic shared memory a block;
//   the registers (about 200 a thread) allow 2 blocks an SM, and two
//   such blocks fit in the SM's shared memory.
// * Softmax fold. attention.py:113-132's, on the accumulator fragments:
//   the row max and row sum across the 4 lanes that share a row
//   (__shfl_xor_sync), m_new = max(m, tile max), p = expf(s - m_new),
//   rescale = expf(m - m_new), l = l * rescale + sum p, acc = acc *
//   rescale + P V; the end is :134-138's: l_safe = max(l, 1e-30),
//   o = acc / l_safe, lse = m + log(l_safe).
// * Masking. The causal mask is applied on the diagonal tile only.
//   Rows and keys at or past L load as 0 (cp.async zero fill): keys
//   past L sit above the diagonal of every real row, and rows past L
//   are never written. No padded copy is made.
// * Strides. q, k and v each come with their own strides for B, H and
//   L (unit stride in Dh, rows 16-byte aligned), so the head views of
//   GPT2's fused QKV projection reach the kernel as they are. o is
//   written head-merged, [B, L, H, Dh], which the model's head merge
//   then reshapes without a copy; lse is [B, H, L].
//
// bfloat16 operands (GPT2 under --bf16). JAX's kernel upcasts each
// bf16 tile to f32, takes q * sm_scale, the logits, the online softmax
// and P.V in f32, writes o in q's type and lse in f32. Here the same
// body runs on f32 tiles: K and V tiles come in as raw bf16 with
// cp.async, three stages deep (half the bytes of the f32 stages), and
// each tile is widened once into one f32 K and one f32 V tile in the
// padded layout above, from which the unchanged 3xTF32 body reads; q is
// widened when it is split. o is rounded to bf16 (round to nearest
// even, __float2bfloat16_rn) as it is stored; lse stays f32. bf16
// values are exact in TF32, so the small parts of K, V and q are zero
// and a later version may drop their passes (or use bf16 mma with f32
// accumulation); the body is kept as it is here.
//
// Left for later: wgmma. For TF32 it takes both operands K-major, so V
// would have to be transposed in shared memory first; with TMA and a
// producer warp it is the route to the tensor cores' full rate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBQ = 64;              // query rows per block
constexpr int kBK = 64;              // keys per staged tile
constexpr int kWarps = kBQ / 16;     // one m16 fragment of rows a warp
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 3;           // K/V tiles in flight
constexpr float kNegInf = -1e30f;

template <int DH>
struct Tile {
  static constexpr int kStride = DH + 4;          // padded row, floats
  static constexpr int kFloats = kBK * kStride;   // one K or V tile
  static constexpr int kBytes = 4 * 2 * kStages * kFloats;  // K, V
  // bf16 operands: raw (unpadded) K and V tiles in kStages stages, then
  // one widened f32 K and one f32 V tile
  static constexpr int kRawElems = kBK * DH;      // one raw K or V tile
  static constexpr int kBytesBf16 =
      2 * 2 * kStages * kRawElems + 4 * 2 * kFloats;
};

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small (+ what TF32 cannot hold of the remainder)
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a * b in three TF32 passes: small*big + big*small, then big*big
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&a_big)[4],
                                           const uint32_t (&a_small)[4],
                                           const uint32_t (&b_big)[2],
                                           const uint32_t (&b_small)[2]) {
  mma_tf32(c, a_small, b_big);
  mma_tf32(c, a_big, b_small);
  mma_tf32(c, a_big, b_big);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;   // 0: nothing read, 16 bytes of zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// rows r0 .. r0 + 63 of a [L, DH] head (row stride sl floats) into a
// padded shared tile; rows at or past L are zero-filled
template <int DH>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long sl, int r0, int L) {
  constexpr int kVec = DH / 4;
  for (int i = threadIdx.x; i < kBK * kVec; i += kThreads) {
    const int r = i / kVec;
    const int c4 = i - r * kVec;
    const bool ok = r0 + r < L;
    const float* g = ok ? src + (long long)(r0 + r) * sl + 4 * c4 : src;
    cp_async16(dst + r * Tile<DH>::kStride + 4 * c4, g, ok);
  }
}

// rows r0 .. r0 + 63 of a bf16 [L, DH] head into an unpadded raw tile,
// 8 values a 16-byte copy; rows at or past L are zero-filled
template <int DH>
__device__ __forceinline__ void load_raw_tile(__nv_bfloat16* dst,
                                              const __nv_bfloat16* src,
                                              long long sl, int r0, int L) {
  constexpr int kVec = DH / 8;
  for (int i = threadIdx.x; i < kBK * kVec; i += kThreads) {
    const int r = i / kVec;
    const int c8 = i - r * kVec;
    const bool ok = r0 + r < L;
    const __nv_bfloat16* g = ok ? src + (long long)(r0 + r) * sl + 8 * c8
                                : src;
    cp_async16(reinterpret_cast<float*>(dst + r * DH + 8 * c8),
               reinterpret_cast<const float*>(g), ok);
  }
}

// a raw bf16 tile widened into the padded f32 layout the body reads
template <int DH>
__device__ __forceinline__ void widen_tile(float* dst,
                                           const __nv_bfloat16* src) {
  constexpr int kVec = DH / 8;
  for (int i = threadIdx.x; i < kBK * kVec; i += kThreads) {
    const int r = i / kVec;
    const int c8 = i - r * kVec;
    const uint4 raw = *reinterpret_cast<const uint4*>(src + r * DH + 8 * c8);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float2 a = __bfloat1622float2(h[0]);
    const float2 b = __bfloat1622float2(h[1]);
    const float2 c = __bfloat1622float2(h[2]);
    const float2 d = __bfloat1622float2(h[3]);
    float* o = dst + r * Tile<DH>::kStride + 8 * c8;
    *reinterpret_cast<float4*>(o) = make_float4(a.x, a.y, b.x, b.y);
    *reinterpret_cast<float4*>(o + 4) = make_float4(c.x, c.y, d.x, d.y);
  }
}

// two adjacent o values in the output's type
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// The staging steps of the two operand types, chosen by overload on the
// operand pointer. smem holds, for f32, [stage][K | V] padded f32
// tiles; for bf16, [stage][K | V] raw bf16 tiles followed by the widened
// f32 K and V tiles. q is staged through the last stage's K buffer.

// K and V tile `tile` into stage `st`
template <int DH>
__device__ __forceinline__ void load_kv(float* smem, const float* kp,
                                        const float* vp, long long ksl,
                                        long long vsl, int st, int tile,
                                        int L) {
  constexpr int TF = Tile<DH>::kFloats;
  load_tile<DH>(smem + st * 2 * TF, kp, ksl, tile * kBK, L);
  load_tile<DH>(smem + st * 2 * TF + TF, vp, vsl, tile * kBK, L);
}
template <int DH>
__device__ __forceinline__ void load_kv(float* smem, const __nv_bfloat16* kp,
                                        const __nv_bfloat16* vp,
                                        long long ksl, long long vsl, int st,
                                        int tile, int L) {
  constexpr int RE = Tile<DH>::kRawElems;
  __nv_bfloat16* raw = reinterpret_cast<__nv_bfloat16*>(smem);
  load_raw_tile<DH>(raw + st * 2 * RE, kp, ksl, tile * kBK, L);
  load_raw_tile<DH>(raw + st * 2 * RE + RE, vp, vsl, tile * kBK, L);
}

// q's rows q0 .. q0 + 63 into the last stage
template <int DH>
__device__ __forceinline__ void load_q(float* smem, const float* qp,
                                       long long qsl, int q0, int L) {
  load_tile<DH>(smem + (kStages - 1) * 2 * Tile<DH>::kFloats, qp, qsl, q0,
                L);
}
template <int DH>
__device__ __forceinline__ void load_q(float* smem, const __nv_bfloat16* qp,
                                       long long qsl, int q0, int L) {
  load_raw_tile<DH>(reinterpret_cast<__nv_bfloat16*>(smem)
                        + (kStages - 1) * 2 * Tile<DH>::kRawElems,
                    qp, qsl, q0, L);
}

// staged q at row r, column c of the block, as f32
template <int DH>
__device__ __forceinline__ float q_at(const float* smem, const float*, int r,
                                      int c) {
  return smem[(kStages - 1) * 2 * Tile<DH>::kFloats
              + r * Tile<DH>::kStride + c];
}
template <int DH>
__device__ __forceinline__ float q_at(const float* smem,
                                      const __nv_bfloat16*, int r, int c) {
  return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(smem)
                              [(kStages - 1) * 2 * Tile<DH>::kRawElems
                               + r * DH + c]);
}

// the f32 K tile of key tile kt (its V tile follows it); bf16 widens the
// landed raw tiles first, once for all warps
template <int DH>
__device__ __forceinline__ const float* kv_tile(float* smem, const float*,
                                                int kt) {
  return smem + (kt % kStages) * 2 * Tile<DH>::kFloats;
}
template <int DH>
__device__ __forceinline__ const float* kv_tile(float* smem,
                                                const __nv_bfloat16*,
                                                int kt) {
  constexpr int RE = Tile<DH>::kRawElems;
  const __nv_bfloat16* raw =
      reinterpret_cast<const __nv_bfloat16*>(smem) + (kt % kStages) * 2 * RE;
  float* wide = smem + kStages * RE;   // after the raw stages
  widen_tile<DH>(wide, raw);
  widen_tile<DH>(wide + Tile<DH>::kFloats, raw + RE);
  __syncthreads();
  return wide;
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads, 2) flash_fwd_mma_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, long long qsb, long long qsh,
    long long qsl, long long ksb, long long ksh, long long ksl,
    long long vsb, long long vsh, long long vsl, T* __restrict__ o,
    float* __restrict__ lse, int H, int L, int n_bh, float sm_scale) {
  constexpr int S = Tile<DH>::kStride;
  constexpr int TF = Tile<DH>::kFloats;
  constexpr int KS = DH / 8;   // k steps of the score product
  constexpr int ND = DH / 8;   // n tiles of the PV product
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);   // see load_kv

  // heaviest query tiles first, across all heads
  const int lin = blockIdx.y * gridDim.x + blockIdx.x;
  const int qt = gridDim.x - 1 - lin / n_bh;
  const int bh = lin - (lin / n_bh) * n_bh;
  const int b = bh / H;
  const int h = bh - b * H;
  const T* qp = q + b * qsb + h * qsh;
  const T* kp = k + b * ksb + h * ksh;
  const T* vp = v + b * vsb + h * vsh;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;   // fragment row (and B column) of this lane
  const int t = lane & 3;    // fragment column group of this lane
  const int q0 = qt * kBQ;
  const int n_kt = qt + 1;   // key tiles up to the diagonal

  // q through the last stage's K buffer, tiles 0 and 1 into stages 0
  // and 1; one commit group each, empty past the last tile, so that
  // wait_group<kStages - 1> always means "q, or tile kt, has landed"
  load_q<DH>(smem, qp, qsl, q0, L);
  cp_async_commit();
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_kt) load_kv<DH>(smem, kp, vp, ksl, vsl, st, st, L);
    cp_async_commit();
  }
  cp_async_wait<kStages - 1>();
  __syncthreads();

  uint32_t qb[KS][4], qs[KS][4];
  {
    // this warp's q rows, as f32, scaled in f32
    const int r0 = warp * 16 + g;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      split(q_at<DH>(smem, qp, r0, 8 * kk + t) * sm_scale, qb[kk][0],
            qs[kk][0]);
      split(q_at<DH>(smem, qp, r0 + 8, 8 * kk + t) * sm_scale, qb[kk][1],
            qs[kk][1]);
      split(q_at<DH>(smem, qp, r0, 8 * kk + t + 4) * sm_scale, qb[kk][2],
            qs[kk][2]);
      split(q_at<DH>(smem, qp, r0 + 8, 8 * kk + t + 4) * sm_scale,
            qb[kk][3], qs[kk][3]);
    }
  }
  __syncthreads();   // the last stage is free for tile kStages - 1

  float acc[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
    acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.0f;
  float m0 = kNegInf, m1 = kNegInf;   // rows g and g + 8 of the warp
  float l0 = 0.0f, l1 = 0.0f;
  const int row0 = q0 + warp * 16 + g;
  const int row1 = row0 + 8;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int ahead = kt + kStages - 1;
    if (ahead < n_kt)
      load_kv<DH>(smem, kp, vp, ksl, vsl, ahead % kStages, ahead, L);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const float* ks = kv_tile<DH>(smem, kp, kt);
    const float* vs = ks + TF;

    // s = (q * sm_scale) k^T over this tile: 8 n-tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        uint32_t bb[2], bs[2];
        const float* kr = ks + (8 * nt + g) * S + 8 * kk + t;
        split(kr[0], bb[0], bs[0]);
        split(kr[4], bb[1], bs[1]);
        mma_3xtf32(s[nt], qb[kk], qs[kk], bb, bs);
      }
    }
    if (kt == qt) {   // the diagonal tile: keys after the row masked
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int key = kt * kBK + 8 * nt + 2 * t;
        if (key > row0) s[nt][0] = kNegInf;
        if (key + 1 > row0) s[nt][1] = kNegInf;
        if (key > row1) s[nt][2] = kNegInf;
        if (key + 1 > row1) s[nt][3] = kNegInf;
      }
    }

    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int w = 1; w < 4; w <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, w));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, w));
    }
    const float r0 = expf(m0 - mx0);
    const float r1 = expf(m1 - mx1);
    float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = expf(s[nt][0] - mx0);
      s[nt][1] = expf(s[nt][1] - mx0);
      s[nt][2] = expf(s[nt][2] - mx1);
      s[nt][3] = expf(s[nt][3] - mx1);
      ps0 += s[nt][0] + s[nt][1];
      ps1 += s[nt][2] + s[nt][3];
    }
#pragma unroll
    for (int w = 1; w < 4; w <<= 1) {
      ps0 += __shfl_xor_sync(0xffffffffu, ps0, w);
      ps1 += __shfl_xor_sync(0xffffffffu, ps1, w);
    }
    l0 = l0 * r0 + ps0;
    l1 = l1 * r1 + ps1;
    m0 = mx0;
    m1 = mx1;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      acc[nd][0] *= r0;
      acc[nd][1] *= r0;
      acc[nd][2] *= r1;
      acc[nd][3] *= r1;
    }

    // acc += P V, the reduction index relabelled inside each group of 8
    // keys (A column t = key 2t, column t + 4 = key 2t + 1), so the
    // score fragment is P's A fragment as it stands
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      uint32_t pb[4], psm[4];
      split(s[kk][0], pb[0], psm[0]);   // row g,     key 2t
      split(s[kk][2], pb[1], psm[1]);   // row g + 8, key 2t
      split(s[kk][1], pb[2], psm[2]);   // row g,     key 2t + 1
      split(s[kk][3], pb[3], psm[3]);   // row g + 8, key 2t + 1
      const float* vr = vs + (8 * kk + 2 * t) * S + g;
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        uint32_t bb[2], bs[2];
        split(vr[8 * nd], bb[0], bs[0]);
        split(vr[S + 8 * nd], bb[1], bs[1]);
        mma_3xtf32(acc[nd], pb, psm, bb, bs);
      }
    }
    __syncthreads();   // this stage is refilled on the next tile
  }

  const float ls0 = fmaxf(l0, 1e-30f);
  const float ls1 = fmaxf(l1, 1e-30f);
  if (row0 < L) {
    T* orow = o + ((long long)(b * L + row0) * H + h) * DH + 2 * t;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
      store2(orow + 8 * nd, acc[nd][0] / ls0, acc[nd][1] / ls0);
    if (t == 0) lse[(long long)bh * L + row0] = m0 + logf(ls0);
  }
  if (row1 < L) {
    T* orow = o + ((long long)(b * L + row1) * H + h) * DH + 2 * t;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
      store2(orow + 8 * nd, acc[nd][2] / ls1, acc[nd][3] / ls1);
    if (t == 0) lse[(long long)bh * L + row1] = m1 + logf(ls1);
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v,
           const long long* st, void* o, float* lse, int B, int H, int L,
           float sm_scale, cudaStream_t stream) {
  const int bytes = std::is_same<T, float>::value ? Tile<DH>::kBytes
                                                  : Tile<DH>::kBytesBf16;
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_mma_kernel<T, DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((L + kBQ - 1) / kBQ, B * H);
  flash_fwd_mma_kernel<T, DH><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], static_cast<T*>(o), lse, H, L, B * H, sm_scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dh(const void* q, const void* k, const void* v,
              const long long* st, void* o, float* lse, int B, int H, int L,
              int dh, float sm_scale, cudaStream_t s) {
  switch (dh) {
    case 16: return launch<T, 16>(q, k, v, st, o, lse, B, H, L, sm_scale, s);
    case 32: return launch<T, 32>(q, k, v, st, o, lse, B, H, L, sm_scale, s);
    case 64: return launch<T, 64>(q, k, v, st, o, lse, B, H, L, sm_scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// o [B, L, H, Dh] (head-merged, contiguous), lse [B, H, L] <- causal
// attention of q, k, v [B, H, L, Dh] given by their element strides
// `strides` = (q's B, H, L; k's B, H, L; v's B, H, L), unit stride in
// Dh, every row 16-byte aligned; Dh in {16, 32, 64}. q, k, v and o are
// float32 (cct_flash_fwd) or bfloat16 (cct_flash_fwd_bf16); lse is
// float32. Returns cudaGetLastError() after the launch (0 = launched).
int cct_flash_fwd(const float* q, const float* k, const float* v,
                  const long long* strides, float* o, float* lse, int B,
                  int H, int L, int dh, float sm_scale, void* stream) {
  if (B < 1 || H < 1 || (long long)B * H > 65535 || L < 1)
    return (int)cudaErrorInvalidValue;
  return launch_dh<float>(q, k, v, strides, o, lse, B, H, L, dh, sm_scale,
                          (cudaStream_t)stream);
}

int cct_flash_fwd_bf16(const void* q, const void* k, const void* v,
                       const long long* strides, void* o, float* lse, int B,
                       int H, int L, int dh, float sm_scale, void* stream) {
  if (B < 1 || H < 1 || (long long)B * H > 65535 || L < 1)
    return (int)cudaErrorInvalidValue;
  return launch_dh<__nv_bfloat16>(q, k, v, strides, o, lse, B, H, L, dh,
                                  sm_scale, (cudaStream_t)stream);
}

const char* cct_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
