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
// of shared memory, and Hopper blocks run in no order. So one thread
// owns output position p for all r rows (r accumulators in registers,
// the row count a template parameter 1..16 as in K2) and walks the
// chunks b = 0..B-1 in ascending order, adding for each row j the
// source element s = (p - off[j, b]) mod c of chunk b. No atomics, and
// the summation order is the JAX static path's (ops/sketch.py encode),
// so the table is bitwise the plain version's.
//
// What bounds it: bytes. x is read once (498 MB at d = 124.4M), the
// sign bits and off once (0.3 MB), the table written once (10 MB):
// 0.152 ms at the data sheet's 3.35 TB/s. The design keeps x to one
// pass from HBM: every thread takes kEncPositions = 4 consecutive
// positions, so the whole [0, c) is resident at once (489 blocks of
// 256 threads at c = 500k; at most 64 registers a thread for r <= 6
// gives 4 blocks an SM, 528 slots), and every resident thread walks the
// chunks in the same order. Chunk b (2 MB) then comes from HBM once and
// its r re-reads hit the 50 MB L2, which holds ~25 chunks, so blocks
// that drift a few chunks apart cost nothing. That budget leaves about
// 17 registers a position, r of them accumulators, so the work per term
// is cut instead: as c % 4 == 0 makes the rotation's offset mod 4 the
// same in every thread, a thread reads its 4 source values of a row as
// one aligned float4 load, a second behind a branch that every thread
// of the block takes alike (offset 0 needs none), picks them by that
// offset, and takes their 4 eps signs from one funnel-shifted 32-bit
// window. eps and delta are +-1, so they are read as packed sign bits
// (bit j * c + s of eps, j * B + b of delta; ops/sketch.py packs them
// once per CSVec and device): the term is x with its sign bit XORed by
// eps's and delta's, which for +-1 factors is bitwise
// __fmul_rn(__fmul_rn(eps, x), delta), signed zeros and subnormals
// included (no -ftz). off and the delta bits are staged in shared
// memory kEncWindow chunks at a time. Where the 4 values wrap at c, meet
// the zero-padded tail (a masked read at >= d: no padded copy of x), or
// c % 4 != 0, the thread takes them element by element.
//
// Left for later: the r-fold re-read of x from L2 (2.49 GB at
// d = 124.4M, r = 5). Every (row, element) pair travels from L2 to an
// SM once, so the L2's rate, not the HBM's, is this design's floor; any
// design that keeps one thread's additions in chunk order pays it.
//
// K2 cct_sketch_estimate_all replaces sketch_pallas.py
// _estimate_kernel / pallas_estimate_all (with its helpers
// _chunk_estimate_rows, _masked_est and _median_rows): the estimate
// median_j(table[j, (p + off[j, b]) mod c] * eps[j, p] * delta[j, b])
// of every coordinate b * c + p as a [B, c] array, 0 at or past d. It
// is K3b's estimate without the select, and it runs K3b's body
// (estimate_run, below): a thread owns kMaskPositions = 8 consecutive
// positions of one chunk, a block 128 threads, eps and delta come as
// packed sign bits, and the r signed values of each position are sorted
// by a compare-exchange network unrolled for the compile-time row count
// R (1 <= R <= 16); the middle value, or 0.5f * (a + b) of the two
// middles for even R, is written, exactly as _median_rows takes it. The
// 8 results leave as two 16-byte stores; a thread whose 8 positions all
// lie at or past d writes zeros and gathers nothing, and the positions
// of a ragged last chunk at or past d are written as 0. Its byte bound
// counts the table, off and the sign bits once and the [B, c] estimate
// once (38.3 MB at the ResNet9 geometry, 0.0114 ms at 3.35 TB/s); as
// for K3b, its floor is the r-fold gather of the table from L2 (r * B *
// c * 4 B = 140 MB there) with the output.
// Its stores are plain write-back stores, not K3b's streaming __stcs:
// the 28 MB output and the 10 MB table fit in the 50 MB L2 together, so
// the output need not leave it early, and the server step reads it at
// once (flat * flat before the top-k). The two were timed against each
// other on an H100 80GB HBM3 (700 W) at the ResNet9 geometry, L2
// flushed: the plain stores were faster, alone and followed by that
// square. Timed there too and not kept: a register cap for 6 blocks an
// SM (barely faster at r = 5, spills at r = 16), chunk-major block
// order (no faster), warp-coalesced stores by shuffles and 4 positions
// a thread (both slower).
// The blockwise top-k decode (ops/sketch.py, a padded d past 256M or
// r * B > 2048) launches the same kernel on a window of nb chunks from
// chunk b0 at a time, written as [nb, c], so the [B, c] estimate is
// never held at once; the whole-table launch is the window (0, B).
//
// K3 (K3a cct_sketch_threshold_sample + K3b cct_sketch_threshold_mask)
// replaces sketch_pallas.py pallas_threshold_decode's two kernels,
// _sample_kernel (K3a) and _mask_kernel (K3b): the large-d decode
// (d > 32M) that keeps every estimate whose square reaches a threshold
// priced from a strided sample, without materializing the [B, c]
// estimate. Both read eps and delta as K1 does, as packed sign bits: a
// row's value is the table cell with its sign bit XORed by eps's and
// delta's, which for +-1 factors and any non-NaN cell is bitwise
// __fmul_rn(__fmul_rn(t, eps), delta), the plain versions' product
// (signed zeros, infinities and subnormals included: no -ftz). Both
// take the median with K2's network (median_of), so every estimate is
// bitwise K2's; K3b runs K2's whole body (estimate_run).
//
// K3a: a thread owns one sample position p = s * stride for kSmpRun
// chunks. It loads its r eps bits once, the block stages off and the
// delta bits of its chunks in shared memory, and the r gathers of
// kSmpFlight chunks are in flight before any is used; sample[b, s] is
// written coalesced across s, 0 at or past d. What bounds it: the
// gathered sectors. Every sample reads r table cells, each in a 32-byte
// sector of its own (one chunk's positions lie stride floats apart and
// the rotations are random): r * B * ns sectors, 169 MB at d = 124.4M
// (r = 5, ns = 4237), against a byte bound that counts the 10 MB table
// once.
//
// K3b: a thread owns kMaskPositions = 8 consecutive positions of one
// chunk, a block 1024. As in K1, c % 4 == 0 makes the rotation's offset
// mod 4 the same in every thread of a (row, chunk), so a row's 8 values
// come from three aligned float4 loads picked by that offset, and their
// eps bits from one funnel-shifted word; off and the delta bit are
// loaded once a row for 8 estimates, and every row's loads are issued
// before any value is used. The wrap at c (each float4 at its own place
// mod c), the ragged tail at d and c % 4 != 0 (element by element) are
// handled in the kernel, with no padded copy. The threshold is read from
// device memory (no host round trip); est is kept where est * est >= thr
// (>= keeps ties, as _mask_kernel does), and the 8 results leave as two
// 16-byte streaming stores (__stcs), so that the 498 MB output, nearly
// all zeros, does not push the table out of the L2. Its byte bound is
// the output write (0.152 ms at 3.35 TB/s), but any design that keeps
// the function exact gathers each table row once per chunk: r * d * 4 B
// = 2.49 GB from L2 at d = 124.4M, r = 5. That L2 rate, not the HBM's,
// is its floor. An early-out was tried and not kept: gather the first
// r / 2 + 1 rows and write 0 where all of their squares fall under the
// threshold (exact, since those values then hold the median; it saves
// nothing at r <= 2). It ran slower: a warp takes the long path whenever
// one of its lanes needs it, so only the loads of lanes that leave are
// saved (at the main path's threshold, about 27% of 8-position sectors
// pass: chip_smoke.py prints the share), while the test and a second
// round trip to the L2 cost every thread.
//
// Left for later: K3b's r-fold gather from L2, as K1's r-fold re-read
// of x; K3a's sector-per-cell gathers.
//
// Arithmetic is written with __fmul_rn / __fadd_rn so nvcc cannot
// contract it into FMAs (the build passes -fmad=false as well): the sign
// flips of K1, K2 and K3 are exact, K1's sums __fadd_rn, and the even-R
// median's mean is __fadd_rn then __fmul_rn by 0.5f, as in the plain
// versions.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kEncThreads = 256;
constexpr int kEncPositions = 4;   // consecutive positions a K1 thread owns
constexpr int kEncWindow = 64;     // chunks of off / delta staged at once

constexpr int kSmpThreads = 256;
constexpr int kSmpRun = 8;         // chunks a K3a thread walks
constexpr int kSmpFlight = 2;      // chunks whose K3a gathers fly together

constexpr int kMaskThreads = 128;
constexpr int kMaskPositions = 8;  // positions a K2 / K3b thread owns
static_assert(kMaskPositions % 4 == 0 && kMaskPositions <= 28,
              "K2 and K3b store float4s and read eps bits from one window");

// x[s], or 0 at or past lim (the zero-padded tail)
__device__ __forceinline__ float x_at(const float* __restrict__ xb, int s,
                                      int lim) {
  return s < lim ? __ldg(xb + s) : 0.0f;
}

// +-x as a bit pattern: x's sign bit XORed with the sign bits es and ds
__device__ __forceinline__ float flip(float x, uint32_t es, uint32_t ds) {
  return __uint_as_float(__float_as_uint(x) ^ (es & 0x80000000u) ^ ds);
}

// K1: table[j, p] = sum over b ascending of +-x[b * c + s], s = (p -
// off[j, b]) mod c, the sign eps[j, s] * delta[j, b] from the bits.
// Needs r * c < 2^31 (checked by the entry point). `vec`: c % 4 == 0
// and x 16-byte aligned, so that the rotation's offset mod 4 is the
// same for every thread and x can be read as aligned float4s.
template <int R>
__global__ void __launch_bounds__(kEncThreads, (R <= 6) ? 4 : 2)
    encode_rows_kernel(const float* __restrict__ x, long long d,
                       const int* __restrict__ off,
                       const uint32_t* __restrict__ delta_bits,
                       const uint32_t* __restrict__ eps_bits,
                       float* __restrict__ table, int c, int B, int vec) {
  constexpr int NP = kEncPositions;
  constexpr int NQ = NP / 4 + 1;   // float4s that hold NP values at any s mod 4
  __shared__ int s_off[R][kEncWindow];
  __shared__ uint32_t s_dsign[R][kEncWindow];   // delta's sign bit
  const int p = (blockIdx.x * kEncThreads + threadIdx.x) * NP;
  const int pc = p < c ? p : 0;   // threads past c walk along, write nothing
  const int last_word = (R * c - 1) >> 5;
  float acc[R][NP];
#pragma unroll
  for (int j = 0; j < R; ++j)
#pragma unroll
    for (int k = 0; k < NP; ++k) acc[j][k] = 0.0f;

  for (int w0 = 0; w0 < B; w0 += kEncWindow) {
    const int nw = min(kEncWindow, B - w0);
    __syncthreads();   // the previous window is no longer read
    for (int i = threadIdx.x; i < R * nw; i += kEncThreads) {
      const int j = i / nw;
      const int w = i - j * nw;
      const long long e = (long long)j * B + w0 + w;
      s_off[j][w] = off[e];
      s_dsign[j][w] = (delta_bits[e >> 5] >> (e & 31)) << 31;
    }
    __syncthreads();
    for (int w = 0; w < nw; ++w) {
      const long long chunk = (long long)(w0 + w) * c;
      const float* xb = x + chunk;
      const int lim = (int)min((long long)c, d - chunk);   // tail: 0 past d
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const uint32_t ds = s_dsign[j][w];
        int s = pc - s_off[j][w];
        if (s < 0) s += c;
        const int a = s & ~3;
        if (vec && a + 4 * NQ <= lim) {
          // s .. s + NP - 1 in one chunk, before the tail: NQ aligned
          // float4 loads (the last skipped at offset 0 mod 4), the values
          // picked by s mod 4 (the same in every thread), the NP eps bits
          // from one 32-bit window
          const int e = j * c + s;
          const uint32_t win = __funnelshift_r(
              __ldg(eps_bits + (e >> 5)),
              __ldg(eps_bits + min((e >> 5) + 1, last_word)), e);
          float q[4 * NQ];
#pragma unroll
          for (int i = 0; i < NQ; ++i) {
            if (i == NQ - 1 && (s & 3) == 0) break;
            const float4 t =
                __ldg(reinterpret_cast<const float4*>(xb + a + 4 * i));
            q[4 * i] = t.x;
            q[4 * i + 1] = t.y;
            q[4 * i + 2] = t.z;
            q[4 * i + 3] = t.w;
          }
          float xs[NP];
          switch (s & 3) {
#define CCT_PICK(K0)                                       \
  case K0:                                                 \
    _Pragma("unroll") for (int k = 0; k < NP; ++k) xs[k] = \
        q[K0 + k];                                         \
    break;
            CCT_PICK(0) CCT_PICK(1) CCT_PICK(2) CCT_PICK(3)
#undef CCT_PICK
          }
#pragma unroll
          for (int k = 0; k < NP; ++k)
            acc[j][k] = __fadd_rn(acc[j][k], flip(xs[k], win << (31 - k), ds));
        } else {
          // the general case: element by element, with the wrap at c
#pragma unroll
          for (int k = 0; k < NP; ++k) {
            int sk = s + k;
            if (sk >= c) sk -= c;
            const int e = j * c + sk;
            const uint32_t es = __ldg(eps_bits + (e >> 5)) << (31 - (e & 31));
            acc[j][k] = __fadd_rn(acc[j][k], flip(x_at(xb, sk, lim), es, ds));
          }
        }
      }
    }
  }
  if (p >= c) return;
#pragma unroll
  for (int j = 0; j < R; ++j)
#pragma unroll
    for (int k = 0; k < NP; ++k)
      if (p + k < c) table[(long long)j * c + p + k] = acc[j][k];
}

// the median of v[0..R) as _median_rows takes it: sorted by its bubble
// compare-exchange network, then the middle (odd R) or 0.5f * (a + b)
// of the two middles (even R). v is sorted in place.
template <int R>
__device__ __forceinline__ float median_of(float (&v)[R]) {
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

// K3a: the estimates at chunk positions p = s * stride. A thread owns
// one sample s for kSmpRun chunks: its r eps bits are loaded once, the
// block stages off and the delta bits of its chunks in shared memory,
// and the r gathers of kSmpFlight chunks are issued before any is used.
template <int R>
__global__ void __launch_bounds__(kSmpThreads)
    threshold_sample_kernel(const float* __restrict__ table,
                            const int* __restrict__ off,
                            const uint32_t* __restrict__ delta_bits,
                            const uint32_t* __restrict__ eps_bits,
                            float* __restrict__ sample, int c, int B,
                            long long d, int stride, int ns) {
  __shared__ int s_off[R][kSmpRun];
  __shared__ uint32_t s_dsign[R][kSmpRun];   // delta's sign bit
  const int b0 = blockIdx.y * kSmpRun;
  const int nb = min(kSmpRun, B - b0);
  for (int i = threadIdx.x; i < R * nb; i += kSmpThreads) {
    const int j = i / nb;
    const int w = i - j * nb;
    const long long e = (long long)j * B + b0 + w;
    s_off[j][w] = off[e];
    s_dsign[j][w] = (delta_bits[e >> 5] >> (e & 31)) << 31;
  }
  __syncthreads();
  const int s = blockIdx.x * kSmpThreads + threadIdx.x;
  if (s >= ns) return;
  const int p = s * stride;
  uint32_t es[R];   // eps[j, p]'s sign in bit 31
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int e = j * c + p;
    es[j] = __ldg(eps_bits + (e >> 5)) << (31 - (e & 31));
  }
  for (int w0 = 0; w0 < nb; w0 += kSmpFlight) {
    float t[kSmpFlight][R];
#pragma unroll
    for (int g = 0; g < kSmpFlight; ++g) {
      const int w = min(w0 + g, nb - 1);   // past the run: loaded, unused
#pragma unroll
      for (int j = 0; j < R; ++j) {
        int q = p + s_off[j][w];
        if (q >= c) q -= c;
        t[g][j] = __ldg(table + (long long)j * c + q);
      }
    }
#pragma unroll
    for (int g = 0; g < kSmpFlight; ++g) {
      const int w = w0 + g;
      if (w >= nb) break;
      float v[R];
#pragma unroll
      for (int j = 0; j < R; ++j) v[j] = flip(t[g][j], es[j], s_dsign[j][w]);
      const float e = median_of<R>(v);
      const long long gi = (long long)(b0 + w) * c + p;
      sample[(long long)(b0 + w) * ns + s] = gi < d ? e : 0.0f;
    }
  }
}

// K2's and K3b's body: the estimates of chunk positions p .. p + NP - 1
// of chunk b into est[0..NP): the signed values of rows 0 .. R - 1 are
// gathered, every row's loads issued before any value is used, then
// median_of takes each position's. `vec`: c % 4 == 0, c >= 16 and the
// table 16-byte aligned, so q = (p + off[j, b]) mod c has the same value
// mod 4 in every thread of the block (p % 4 == 0) and the NP values lie
// in NQ = NP / 4 + 1 aligned float4s of row j, each at its own place mod
// c (the last one at the first's where q % 4 == 0: a second read of the
// same line, in place of a branch), picked by q mod 4, their eps bits
// from one funnel-shifted 32-bit window. Otherwise element by element.
// The estimates at or past c are not defined.
template <int R, int NP>
__device__ __forceinline__ void estimate_run(
    const float* __restrict__ table, const int* __restrict__ off,
    const uint32_t* __restrict__ delta_bits,
    const uint32_t* __restrict__ eps_bits, int c, int B, int b, int p,
    int vec, float (&est)[NP]) {
  constexpr int NQ = NP / 4 + 1;
  float v[R][NP];
  int q[R];
  uint32_t ds[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int db = j * B + b;
    ds[j] = (__ldg(delta_bits + (db >> 5)) >> (db & 31)) << 31;
    q[j] = p + __ldg(off + db);
    if (q[j] >= c) q[j] -= c;
  }
  if (!vec) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const float* row = table + (long long)j * c;
#pragma unroll
      for (int k = 0; k < NP; ++k) {
        const int pk = p + k;
        if (pk >= c) break;
        int qk = q[j] + k;
        if (qk >= c) qk -= c;
        const int e = j * c + pk;
        const uint32_t es = __ldg(eps_bits + (e >> 5)) << (31 - (e & 31));
        v[j][k] = flip(__ldg(row + qk), es, ds[j]);
      }
    }
  } else {
    const int last_word = (R * c - 1) >> 5;
    float4 t[R][NQ];
    uint32_t win[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const float* row = table + (long long)j * c;
      const int a = q[j] & ~3;
#pragma unroll
      for (int i = 0; i < NQ; ++i) {
        int ai = a + 4 * i;
        if (ai >= c) ai -= c;
        if (i == NQ - 1 && (q[j] & 3) == 0) ai = a;
        t[j][i] = __ldg(reinterpret_cast<const float4*>(row + ai));
      }
      const int e = j * c + p;
      const uint32_t lo = __ldg(eps_bits + (e >> 5));
      // e % 4 == 0, so 4 bits never cross a word; 8 may
      const uint32_t hi =
          NP > 4 ? __ldg(eps_bits + min((e >> 5) + 1, last_word)) : 0u;
      win[j] = __funnelshift_r(lo, hi, e);
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
      float w[4 * NQ];
#pragma unroll
      for (int i = 0; i < NQ; ++i) {
        w[4 * i] = t[j][i].x;
        w[4 * i + 1] = t[j][i].y;
        w[4 * i + 2] = t[j][i].z;
        w[4 * i + 3] = t[j][i].w;
      }
      switch (q[j] & 3) {   // the same case in every thread of the block
#define CCT_PICK(K0)                                                        \
  case K0:                                                                  \
    _Pragma("unroll") for (int k = 0; k < NP; ++k) v[j][k] =                \
        flip(w[K0 + k], win[j] << (31 - k), ds[j]);                         \
    break;
        CCT_PICK(0) CCT_PICK(1) CCT_PICK(2) CCT_PICK(3)
#undef CCT_PICK
      }
    }
  }
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    float col[R];
#pragma unroll
    for (int j = 0; j < R; ++j) col[j] = v[j][k];
    est[k] = median_of<R>(col);
  }
}

// K2: est[(b - b0) * c + p + k] for the kMaskPositions positions p + k
// of chunk b = b0 + blockIdx.y a thread owns, 0 where the global index
// b * c + p + k is at or past d. The whole table is the window (0, B).
template <int R>
__global__ void __launch_bounds__(kMaskThreads)
    estimate_all_kernel(const float* __restrict__ table,
                        const int* __restrict__ off,
                        const uint32_t* __restrict__ delta_bits,
                        const uint32_t* __restrict__ eps_bits,
                        float* __restrict__ est, int c, int B, long long d,
                        int b0, int vec) {
  constexpr int NP = kMaskPositions;
  const int p = (blockIdx.x * kMaskThreads + threadIdx.x) * NP;
  const int b = b0 + blockIdx.y;
  if (p >= c) return;
  const long long gi = (long long)b * c + p;
  est += (long long)blockIdx.y * c + p;
  float res[NP];
  if (gi < d)   // else all NP positions lie in the tail: nothing to gather
    estimate_run<R, NP>(table, off, delta_bits, eps_bits, c, B, b, p, vec,
                        res);
#pragma unroll
  for (int k = 0; k < NP; ++k)
    if (gi + k >= d) res[k] = 0.0f;
#pragma unroll
  for (int i = 0; i < NP; i += 4) {
    if (vec && p + i + 4 <= c) {
      *reinterpret_cast<float4*>(est + i) =
          make_float4(res[i], res[i + 1], res[i + 2], res[i + 3]);
    } else {
#pragma unroll
      for (int k = i; k < i + 4; ++k)
        if (p + k < c) est[k] = res[k];
    }
  }
}

// K3b: out[b * c + p + k] = est if est * est >= *thr else 0, for the
// kMaskPositions positions p + k of chunk b a thread owns.
template <int R>
__global__ void __launch_bounds__(kMaskThreads)
    threshold_mask_kernel(const float* __restrict__ table,
                          const int* __restrict__ off,
                          const uint32_t* __restrict__ delta_bits,
                          const uint32_t* __restrict__ eps_bits,
                          const float* __restrict__ thr,
                          float* __restrict__ out, int c, int B, long long d,
                          int vec) {
  constexpr int NP = kMaskPositions;
  const int p = (blockIdx.x * kMaskThreads + threadIdx.x) * NP;
  const int b = blockIdx.y;
  if (p >= c) return;
  const long long gi = (long long)b * c + p;
  if (gi >= d) return;
  const float th = __ldg(thr);
  float res[NP];
  estimate_run<R, NP>(table, off, delta_bits, eps_bits, c, B, b, p, vec,
                      res);
#pragma unroll
  for (int k = 0; k < NP; ++k)   // a NaN estimate is not kept
    res[k] = __fmul_rn(res[k], res[k]) >= th ? res[k] : 0.0f;
#pragma unroll
  for (int i = 0; i < NP; i += 4) {
    if (vec && p + i + 4 <= c && gi + i + 4 <= d) {
      __stcs(reinterpret_cast<float4*>(out + gi + i),
             make_float4(res[i], res[i + 1], res[i + 2], res[i + 3]));
    } else {
#pragma unroll
      for (int k = i; k < i + 4; ++k)
        if (p + k < c && gi + k < d) out[gi + k] = res[k];
    }
  }
}

template <int R>
void launch_encode(const float* x, long long d, const int* off,
                   const uint32_t* delta_bits, const uint32_t* eps_bits,
                   float* table, int c, int B, cudaStream_t stream) {
  const int per_block = kEncThreads * kEncPositions;
  const int vec = c % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  encode_rows_kernel<R><<<(c + per_block - 1) / per_block, kEncThreads, 0,
                          stream>>>(x, d, off, delta_bits, eps_bits, table,
                                    c, B, vec);
}

template <int R>
void launch_sample(const float* table, const int* off,
                   const uint32_t* delta_bits, const uint32_t* eps_bits,
                   float* sample, int c, int B, long long d, int stride,
                   int ns, cudaStream_t stream) {
  dim3 grid((ns + kSmpThreads - 1) / kSmpThreads,
            (B + kSmpRun - 1) / kSmpRun);
  threshold_sample_kernel<R><<<grid, kSmpThreads, 0, stream>>>(
      table, off, delta_bits, eps_bits, sample, c, B, d, stride, ns);
}

// K2's and K3b's grid.x: one block for kMaskThreads * kMaskPositions
// positions of a chunk
int run_blocks(int c) {
  const int per_block = kMaskThreads * kMaskPositions;
  return (c + per_block - 1) / per_block;
}

// estimate_run's `vec`, with the output 16-byte aligned for the float4
// stores at b * c + p (p % 8 == 0)
int run_vec(const float* table, const float* out, int c) {
  return c % 4 == 0 && c >= 16 &&
         reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(out) % 16 == 0;
}

template <int R>
void launch_mask(const float* table, const int* off,
                 const uint32_t* delta_bits, const uint32_t* eps_bits,
                 const float* thr, float* out, int c, int B, long long d,
                 cudaStream_t stream) {
  dim3 grid(run_blocks(c), B);
  threshold_mask_kernel<R><<<grid, kMaskThreads, 0, stream>>>(
      table, off, delta_bits, eps_bits, thr, out, c, B, d,
      run_vec(table, out, c));
}

template <int R>
void launch_estimate_all(const float* table, const int* off,
                         const uint32_t* delta_bits,
                         const uint32_t* eps_bits, float* est, int c, int B,
                         long long d, int b0, int nb, cudaStream_t stream) {
  dim3 grid(run_blocks(c), nb);
  estimate_all_kernel<R><<<grid, kMaskThreads, 0, stream>>>(
      table, off, delta_bits, eps_bits, est, c, B, d, b0,
      run_vec(table, est, c));
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

#define LAUNCH_ENCODE(R)                                              \
  launch_encode<R>(x, d, off, delta_bits, eps_bits, table, c, B,       \
                   (cudaStream_t)stream)
#define LAUNCH_ESTIMATE(R)                                                \
  launch_estimate_all<R>(table, off, delta_bits, eps_bits, est, c, B, d,  \
                         b0, nb, (cudaStream_t)stream)
#define LAUNCH_SAMPLE(R)                                                  \
  launch_sample<R>(table, off, delta_bits, eps_bits, sample, c, B, d,    \
                   stride, ns, (cudaStream_t)stream)
#define LAUNCH_MASK(R)                                                    \
  launch_mask<R>(table, off, delta_bits, eps_bits, thr, out, c, B, d,    \
                 (cudaStream_t)stream)

extern "C" {

// table[r, c] <- sketch of x[d]; eps and delta as packed sign bits
// (bit j * c + s set iff eps[j, s] < 0, bit j * B + b iff delta[j, b]
// < 0), 1 <= r <= 16. Returns cudaGetLastError() after the launch
// (0 = launched).
int cct_sketch_encode(const float* x, long long d, const int* off,
                      const uint32_t* delta_bits, const uint32_t* eps_bits,
                      float* table, int r, int c, int B, void* stream) {
  if (c < 1 || B < 1 || (long long)r * c >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  CCT_ROWS_SWITCH(r, LAUNCH_ENCODE)
  return (int)cudaGetLastError();
}

// est[nb, c] <- median-of-rows estimate of every coordinate of chunks
// b0 .. b0 + nb - 1 of the sketched vector, those at >= d zeroed (K2;
// the whole [B, c] estimate is b0 = 0, nb = B), eps and delta as packed
// sign bits. Returns cudaGetLastError().
int cct_sketch_estimate_all(const float* table, const int* off,
                            const uint32_t* delta_bits,
                            const uint32_t* eps_bits, float* est, int r,
                            int c, int B, long long d, int b0, int nb,
                            void* stream) {
  if (c < 1 || B < 1 || b0 < 0 || nb < 1 || nb > 65535 ||
      (long long)b0 + nb > B || (long long)r * c >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  CCT_ROWS_SWITCH(r, LAUNCH_ESTIMATE)
  return (int)cudaGetLastError();
}

// sample[B, ns] <- the estimates at chunk positions s * stride (K3a),
// eps and delta as packed sign bits (as for cct_sketch_encode). Returns
// cudaGetLastError().
int cct_sketch_threshold_sample(const float* table, const int* off,
                                const uint32_t* delta_bits,
                                const uint32_t* eps_bits, float* sample,
                                int r, int c, int B, long long d, int stride,
                                int ns, void* stream) {
  if (c < 1 || B < 1 || B > 65535 || stride < 1 || ns < 1 ||
      (long long)(ns - 1) * stride >= c || (long long)r * c >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  CCT_ROWS_SWITCH(r, LAUNCH_SAMPLE)
  return (int)cudaGetLastError();
}

// out[d] <- est where est * est >= *thr, else 0 (K3b), eps and delta as
// packed sign bits. `thr` is one float in device memory. Returns
// cudaGetLastError().
int cct_sketch_threshold_mask(const float* table, const int* off,
                              const uint32_t* delta_bits,
                              const uint32_t* eps_bits, const float* thr,
                              float* out, int r, int c, int B, long long d,
                              void* stream) {
  if (c < 1 || B < 1 || B > 65535 || (long long)r * c >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  CCT_ROWS_SWITCH(r, LAUNCH_MASK)
  return (int)cudaGetLastError();
}

const char* cct_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
