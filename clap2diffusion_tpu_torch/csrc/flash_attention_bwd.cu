// Flash-attention backward for Hopper (sm_90a), bf16 and fp32.
//
// Replaces the TPU kernel clap2diffusion_tpu/ops/flash_attention.py::_bwd_kernel
// (launched by _flash_bwd through the custom VJP): given q, k, v, the forward's
// output o and its row log-sum-exp lse, and dO, it computes
//   P  = exp(q k^T * scale - lse)            (recomputed, never stored)
//   dV = P^T dO
//   dP = dO V^T,  delta = rowsum(dO * O)
//   dS = P * (dP - delta) * scale
//   dQ = dS K,    dK = dS^T Q
// for each (batch, head), with fp32 logits, softmax and accumulation.
//
// What bounds it on an H100: the work is 5 products of 2*Sq*Sk*d operations
// against q, k, v, o, dO, dq, dk, dv moved once. At the UNet's training shapes
// ([4,8,4096,40], [4,8,1024,80]) that is operations; at [4,8,256,160] bytes.
// The TPU kernel kept all of K and V of a head in VMEM and accumulated dK/dV
// in its output buffer across the sequential q-block grid. Here K+V of one
// head at [4096,160] bf16 is 2.6 MB against 227 KB of shared memory, and
// blocks run in no order, so the work is split in three launches with no
// atomics (every output element is written by exactly one thread, so the
// result is bit-identical from run to run):
//   1. delta = rowsum(dO * O) in fp32, one warp per query row;
//   2. dK/dV: one block of 4 warps per (batch*head, 64-key tile, column
//      chunk). Each warp owns 16 keys and keeps their dK and dV rows in fp32
//      registers while the block streams every 64-query tile of Q and dO
//      through shared memory; S^T = K Q^T and dP^T = V dO^T run on
//      mma.sync.m16n8k16 (bf16 in, fp32 accumulate), P^T and dS^T go from
//      the accumulators to the A operand in registers, rounded to bf16.
//      For d > 80 the dK/dV columns are split in two chunks across grid.z
//      (each recomputes S^T and dP^T), which keeps the accumulators at 80
//      registers per thread;
//   3. dQ: one block per (batch*head, 64-query tile), streaming K and V in
//      64-key tiles, dQ in fp32 registers.
// Head dims are zero-padded to a multiple of 16 in shared memory only (d=40
// -> 48). P and dS are rounded to bf16 before dV = P^T dO, dK = dS^T Q and
// dQ = dS K; the TPU kernel did those products in fp32.
// fp32 inputs take a plain FMA kernel (16 queries x 32 keys per step, all
// operands in shared memory), exact to fp32 rounding.
//
// Every entry returns cudaGetLastError() after its launches; the Python
// wrapper raises when it is not cudaSuccess.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* g;  // dO
  const float* lse;
  float* delta;
  void* dq;
  void* dk;
  void* dv;
  int B, H, Sq, Sk, D;
  // strides in elements: [b, h, s] of q, k, v, o, dO, dq, dk, dv
  long long qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss, gsb, gsh, gss;
  long long dqsb, dqsh, dqss, dksb, dksh, dkss, dvsb, dvsh, dvss;
  float scale;
};

constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// ------------------------------------------------------- 1. delta (any type)

template <typename T>
__global__ void __launch_bounds__(128) bwd_delta(const BwdParams p) {
  const long long row = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= (long long)p.B * p.H * p.Sq) return;
  const int bh = (int)(row / p.Sq), i = (int)(row % p.Sq);
  const int b = bh / p.H, h = bh % p.H;
  const T* og = reinterpret_cast<const T*>(p.o) + b * p.osb + h * p.osh + i * p.oss;
  const T* gg = reinterpret_cast<const T*>(p.g) + b * p.gsb + h * p.gsh + i * p.gss;
  float acc = 0.f;
  for (int c = lane; c < p.D; c += 32) acc = fmaf(to_f(og[c]), to_f(gg[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) p.delta[row] = acc;
}

// ---------------------------------------------------------------- bf16 path

constexpr int BQ = 64;  // query rows per tile
constexpr int BK = 64;  // key rows per tile
constexpr int PAD = 8;  // row padding in elements: conflict-free fragment reads
constexpr int TS = 64 + PAD;  // row stride of a transposed [d][64] tile

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Copy rows [r0, r0+64) of a [S, D] bf16 matrix (row stride rs) into a
// row-major [64][DP+PAD] tile, zero-filling rows >= S and columns >= D. With
// TR, columns [c0, c0+TC) also go transposed into a [TC][TS] tile.
template <int DP, int TC, bool TR>
__device__ __forceinline__ void load_tile(const __nv_bfloat16* src, long long rs, int r0, int S,
                                          int D, __nv_bfloat16* dst, __nv_bfloat16* dst_t,
                                          int c0) {
  constexpr int QS = DP + PAD, CH = DP / 8;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int i = threadIdx.x; i < 64 * CH; i += 128) {
    const int r = i % 64, c = (i / 64) * 8;
    uint4 val = zero;
    if (r0 + r < S && c < D) val = *reinterpret_cast<const uint4*>(src + (r0 + r) * rs + c);
    *reinterpret_cast<uint4*>(dst + r * QS + c) = val;
    if (TR && c >= c0 && c < c0 + TC) {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int j = 0; j < 8; ++j) dst_t[(c - c0 + j) * TS + r] = e[j];
    }
  }
}

// 2. dK and dV for 64 keys x DVC columns.
template <int DP, int DVC>
__global__ void __launch_bounds__(128) flash_bwd_dkdv_bf16(const BwdParams p) {
  constexpr int QS = DP + PAD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BK][QS]
  __nv_bfloat16* v_s = k_s + BK * QS;                                 // [BK][QS]
  __nv_bfloat16* q_s = v_s + BK * QS;                                 // [BQ][QS]
  __nv_bfloat16* g_s = q_s + BQ * QS;                                 // [BQ][QS] dO
  __nv_bfloat16* qt_s = g_s + BQ * QS;                                // [DVC][TS] Q^T
  __nv_bfloat16* gt_s = qt_s + DVC * TS;                              // [DVC][TS] dO^T
  float* l2_s = reinterpret_cast<float*>(gt_s + DVC * TS);            // [BQ] lse*log2(e)
  float* dl_s = l2_s + BQ;                                            // [BQ] delta

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * BK, kr = warp * 16;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int c0 = blockIdx.z * DVC;
  const __nv_bfloat16* qg = reinterpret_cast<const __nv_bfloat16*>(p.q) + b * p.qsb + h * p.qsh;
  const __nv_bfloat16* kg = reinterpret_cast<const __nv_bfloat16*>(p.k) + b * p.ksb + h * p.ksh;
  const __nv_bfloat16* vg = reinterpret_cast<const __nv_bfloat16*>(p.v) + b * p.vsb + h * p.vsh;
  const __nv_bfloat16* gg = reinterpret_cast<const __nv_bfloat16*>(p.g) + b * p.gsb + h * p.gsh;
  const float* lse = p.lse + (long long)bh * p.Sq;
  const float* delta = p.delta + (long long)bh * p.Sq;
  const float sl2 = p.scale * LOG2E;

  load_tile<DP, DVC, false>(kg, p.kss, k0, p.Sk, p.D, k_s, nullptr, 0);
  load_tile<DP, DVC, false>(vg, p.vss, k0, p.Sk, p.D, v_s, nullptr, 0);

  float dk[DVC / 8][4], dv[DVC / 8][4];
#pragma unroll
  for (int j = 0; j < DVC / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  for (int q0 = 0; q0 < p.Sq; q0 += BQ) {
    __syncthreads();  // the previous Q/dO tile is consumed
    load_tile<DP, DVC, true>(qg, p.qss, q0, p.Sq, p.D, q_s, qt_s, c0);
    load_tile<DP, DVC, true>(gg, p.gss, q0, p.Sq, p.D, g_s, gt_s, c0);
    if (tid < BQ) {
      const bool ok = q0 + tid < p.Sq;
      l2_s[tid] = ok ? lse[q0 + tid] * LOG2E : INFINITY;  // exp2(-inf) = 0: no row
      dl_s[tid] = ok ? delta[q0 + tid] : 0.f;
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x BQ queries.
    float st[BQ / 8][4], dpt[BQ / 8][4];
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks) {
      const __nv_bfloat16* ka = k_s + (kr + g) * QS + ks * 16 + 2 * t;
      const __nv_bfloat16* va = v_s + (kr + g) * QS + ks * 16 + 2 * t;
      const uint32_t ak[4] = {lds32(ka), lds32(ka + 8 * QS), lds32(ka + 8),
                              lds32(ka + 8 * QS + 8)};
      const uint32_t av[4] = {lds32(va), lds32(va + 8 * QS), lds32(va + 8),
                              lds32(va + 8 * QS + 8)};
#pragma unroll
      for (int n = 0; n < BQ / 8; ++n) {
        const __nv_bfloat16* qb = q_s + (n * 8 + g) * QS + ks * 16 + 2 * t;
        const __nv_bfloat16* gb = g_s + (n * 8 + g) * QS + ks * 16 + 2 * t;
        mma_bf16(st[n], ak, lds32(qb), lds32(qb + 8));
        mma_bf16(dpt[n], av, lds32(gb), lds32(gb + 8));
      }
    }

    // P^T and dS^T; a thread holds query columns n*8 + 2t + (e & 1).
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = n * 8 + 2 * t + (e & 1);
        const float pe = exp2f(st[n][e] * sl2 - l2_s[qc]);
        st[n][e] = pe;
        dpt[n][e] = pe * (dpt[n][e] - dl_s[qc]) * p.scale;
      }
    }

    // dV += P^T dO and dK += dS^T Q, P and dS rounded to bf16.
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      const uint32_t ap[4] = {pack_bf16(st[2 * kk][0], st[2 * kk][1]),
                              pack_bf16(st[2 * kk][2], st[2 * kk][3]),
                              pack_bf16(st[2 * kk + 1][0], st[2 * kk + 1][1]),
                              pack_bf16(st[2 * kk + 1][2], st[2 * kk + 1][3])};
      const uint32_t as[4] = {pack_bf16(dpt[2 * kk][0], dpt[2 * kk][1]),
                              pack_bf16(dpt[2 * kk][2], dpt[2 * kk][3]),
                              pack_bf16(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]),
                              pack_bf16(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < DVC / 8; ++j) {
        const __nv_bfloat16* gb = gt_s + (j * 8 + g) * TS + kk * 16 + 2 * t;
        const __nv_bfloat16* qb = qt_s + (j * 8 + g) * TS + kk * 16 + 2 * t;
        mma_bf16(dv[j], ap, lds32(gb), lds32(gb + 8));
        mma_bf16(dk[j], as, lds32(qb), lds32(qb + 8));
      }
    }
  }

  __nv_bfloat16* dkg = reinterpret_cast<__nv_bfloat16*>(p.dk) + b * p.dksb + h * p.dksh;
  __nv_bfloat16* dvg = reinterpret_cast<__nv_bfloat16*>(p.dv) + b * p.dvsb + h * p.dvsh;
  const int r0 = k0 + kr + g, r1 = r0 + 8;
#pragma unroll
  for (int j = 0; j < DVC / 8; ++j) {
    const int col = c0 + j * 8 + 2 * t;  // even; D % 8 == 0 keeps col+1 < D
    if (col >= p.D) continue;
    if (r0 < p.Sk) {
      *reinterpret_cast<uint32_t*>(dkg + r0 * p.dkss + col) = pack_bf16(dk[j][0], dk[j][1]);
      *reinterpret_cast<uint32_t*>(dvg + r0 * p.dvss + col) = pack_bf16(dv[j][0], dv[j][1]);
    }
    if (r1 < p.Sk) {
      *reinterpret_cast<uint32_t*>(dkg + r1 * p.dkss + col) = pack_bf16(dk[j][2], dk[j][3]);
      *reinterpret_cast<uint32_t*>(dvg + r1 * p.dvss + col) = pack_bf16(dv[j][2], dv[j][3]);
    }
  }
}

// 3. dQ for 64 queries.
template <int DP>
__global__ void __launch_bounds__(128) flash_bwd_dq_bf16(const BwdParams p) {
  constexpr int QS = DP + PAD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BQ][QS]
  __nv_bfloat16* g_s = q_s + BQ * QS;                                 // [BQ][QS] dO
  __nv_bfloat16* k_s = g_s + BQ * QS;                                 // [BK][QS]
  __nv_bfloat16* v_s = k_s + BK * QS;                                 // [BK][QS]
  __nv_bfloat16* kt_s = v_s + BK * QS;                                // [DP][TS] K^T

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ, qr = warp * 16;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const __nv_bfloat16* qg = reinterpret_cast<const __nv_bfloat16*>(p.q) + b * p.qsb + h * p.qsh;
  const __nv_bfloat16* kg = reinterpret_cast<const __nv_bfloat16*>(p.k) + b * p.ksb + h * p.ksh;
  const __nv_bfloat16* vg = reinterpret_cast<const __nv_bfloat16*>(p.v) + b * p.vsb + h * p.vsh;
  const __nv_bfloat16* gg = reinterpret_cast<const __nv_bfloat16*>(p.g) + b * p.gsb + h * p.gsh;
  const float sl2 = p.scale * LOG2E;

  load_tile<DP, DP, false>(qg, p.qss, q0, p.Sq, p.D, q_s, nullptr, 0);
  load_tile<DP, DP, false>(gg, p.gss, q0, p.Sq, p.D, g_s, nullptr, 0);
  const int r0 = q0 + qr + g, r1 = r0 + 8;
  const long long base = (long long)bh * p.Sq;
  const float l20 = r0 < p.Sq ? p.lse[base + r0] * LOG2E : 0.f;
  const float l21 = r1 < p.Sq ? p.lse[base + r1] * LOG2E : 0.f;
  const float d0 = r0 < p.Sq ? p.delta[base + r0] : 0.f;
  const float d1 = r1 < p.Sq ? p.delta[base + r1] : 0.f;

  float acc[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int k0 = 0; k0 < p.Sk; k0 += BK) {
    __syncthreads();  // the previous K/V tile is consumed (and Q/dO are stored)
    load_tile<DP, DP, true>(kg, p.kss, k0, p.Sk, p.D, k_s, kt_s, 0);
    load_tile<DP, DP, false>(vg, p.vss, k0, p.Sk, p.D, v_s, nullptr, 0);
    __syncthreads();

    // S = Q K^T and dP = dO V^T: this warp's 16 queries x BK keys.
    float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks) {
      const __nv_bfloat16* qa = q_s + (qr + g) * QS + ks * 16 + 2 * t;
      const __nv_bfloat16* ga = g_s + (qr + g) * QS + ks * 16 + 2 * t;
      const uint32_t aq[4] = {lds32(qa), lds32(qa + 8 * QS), lds32(qa + 8),
                              lds32(qa + 8 * QS + 8)};
      const uint32_t ag[4] = {lds32(ga), lds32(ga + 8 * QS), lds32(ga + 8),
                              lds32(ga + 8 * QS + 8)};
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        const __nv_bfloat16* kb = k_s + (n * 8 + g) * QS + ks * 16 + 2 * t;
        const __nv_bfloat16* vb = v_s + (n * 8 + g) * QS + ks * 16 + 2 * t;
        mma_bf16(s[n], aq, lds32(kb), lds32(kb + 8));
        mma_bf16(dp[n], ag, lds32(vb), lds32(vb + 8));
      }
    }

    // dS, in place of S; a thread holds rows g (e < 2) and g + 8.
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + n * 8 + 2 * t + (e & 1);
        const float pe = key < p.Sk ? exp2f(s[n][e] * sl2 - (e < 2 ? l20 : l21)) : 0.f;
        s[n][e] = pe * (dp[n][e] - (e < 2 ? d0 : d1)) * p.scale;
      }
    }

    // dQ += dS K, dS rounded to bf16.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const __nv_bfloat16* kb = kt_s + (j * 8 + g) * TS + kk * 16 + 2 * t;
        mma_bf16(acc[j], a, lds32(kb), lds32(kb + 8));
      }
    }
  }

  __nv_bfloat16* dqg = reinterpret_cast<__nv_bfloat16*>(p.dq) + b * p.dqsb + h * p.dqsh;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    const int col = j * 8 + 2 * t;
    if (col >= p.D) continue;
    if (r0 < p.Sq)
      *reinterpret_cast<uint32_t*>(dqg + r0 * p.dqss + col) = pack_bf16(acc[j][0], acc[j][1]);
    if (r1 < p.Sq)
      *reinterpret_cast<uint32_t*>(dqg + r1 * p.dqss + col) = pack_bf16(acc[j][2], acc[j][3]);
  }
}

cudaError_t set_smem(const void* fn, size_t bytes) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int DP, int DVC>
cudaError_t launch_bf16(const BwdParams& p, cudaStream_t stream) {
  constexpr int QS = DP + PAD;
  constexpr size_t smem_kv =
      (size_t)(2 * BK * QS + 2 * BQ * QS + 2 * DVC * TS) * sizeof(__nv_bfloat16) +
      2 * BQ * sizeof(float);
  constexpr size_t smem_q = (size_t)(2 * BQ * QS + 2 * BK * QS + DP * TS) * sizeof(__nv_bfloat16);
  cudaError_t e = set_smem((const void*)flash_bwd_dkdv_bf16<DP, DVC>, smem_kv);
  if (e != cudaSuccess) return e;
  e = set_smem((const void*)flash_bwd_dq_bf16<DP>, smem_q);
  if (e != cudaSuccess) return e;
  const dim3 grid_kv((p.Sk + BK - 1) / BK, p.B * p.H, (p.D + DVC - 1) / DVC);
  flash_bwd_dkdv_bf16<DP, DVC><<<grid_kv, 128, smem_kv, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 grid_q((p.Sq + BQ - 1) / BQ, p.B * p.H, 1);
  flash_bwd_dq_bf16<DP><<<grid_q, 128, smem_q, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- fp32 path

constexpr int FQ = 16;  // query rows per step
constexpr int FK = 32;  // keys per step

__device__ __forceinline__ float dot_row(const float* a, const float* b, int D) {
  float acc = 0.f;
  for (int c = 0; c < D; ++c) acc = fmaf(a[c], b[c], acc);
  return acc;
}

// rows [r0, r0+n) of a [S, D] fp32 matrix into a [n][KS] tile, zero past S
__device__ __forceinline__ void load_rows_f32(const float* src, long long rs, int r0, int n,
                                              int S, int D, int KS, float* dst) {
  for (int i = threadIdx.x; i < n * D; i += 128) {
    const int r = i / D, c = i % D;
    dst[r * KS + c] = r0 + r < S ? src[(r0 + r) * rs + c] : 0.f;
  }
}

__global__ void __launch_bounds__(128) flash_bwd_dkdv_f32(const BwdParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int D = p.D, KS = D + 1;  // odd stride: conflict-free row dot products
  float* k_s = reinterpret_cast<float*>(smem_raw);  // [FK][KS]
  float* v_s = k_s + FK * KS;                        // [FK][KS]
  float* q_s = v_s + FK * KS;                        // [FQ][KS]
  float* g_s = q_s + FQ * KS;                        // [FQ][KS] dO
  float* dk_s = g_s + FQ * KS;                       // [FK][D]
  float* dv_s = dk_s + FK * D;                       // [FK][D]
  float* p_s = dv_s + FK * D;                        // [FQ][FK]
  float* ds_s = p_s + FQ * FK;                       // [FQ][FK]
  float* l_s = ds_s + FQ * FK;                       // [FQ]
  float* d_s = l_s + FQ;                             // [FQ]

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * FK;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const float* qg = reinterpret_cast<const float*>(p.q) + b * p.qsb + h * p.qsh;
  const float* kg = reinterpret_cast<const float*>(p.k) + b * p.ksb + h * p.ksh;
  const float* vg = reinterpret_cast<const float*>(p.v) + b * p.vsb + h * p.vsh;
  const float* gg = reinterpret_cast<const float*>(p.g) + b * p.gsb + h * p.gsh;
  const float* lse = p.lse + (long long)bh * p.Sq;
  const float* delta = p.delta + (long long)bh * p.Sq;

  load_rows_f32(kg, p.kss, k0, FK, p.Sk, D, KS, k_s);
  load_rows_f32(vg, p.vss, k0, FK, p.Sk, D, KS, v_s);
  for (int i = tid; i < FK * D; i += 128) dk_s[i] = dv_s[i] = 0.f;

  for (int q0 = 0; q0 < p.Sq; q0 += FQ) {
    __syncthreads();
    load_rows_f32(qg, p.qss, q0, FQ, p.Sq, D, KS, q_s);
    load_rows_f32(gg, p.gss, q0, FQ, p.Sq, D, KS, g_s);
    if (tid < FQ) {
      const bool ok = q0 + tid < p.Sq;
      l_s[tid] = ok ? lse[q0 + tid] : INFINITY;  // exp(-inf) = 0: no row
      d_s[tid] = ok ? delta[q0 + tid] : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < FQ * FK; i += 128) {
      const int r = i / FK, j = i % FK;
      const float s = dot_row(q_s + r * KS, k_s + j * KS, D);
      const float dp = dot_row(g_s + r * KS, v_s + j * KS, D);
      const float pe = expf(s * p.scale - l_s[r]);
      p_s[i] = pe;
      ds_s[i] = pe * (dp - d_s[r]) * p.scale;
    }
    __syncthreads();
    for (int i = tid; i < FK * D; i += 128) {
      const int j = i / D, c = i % D;
      float av = dv_s[i], ak = dk_s[i];
      for (int r = 0; r < FQ; ++r) {
        av = fmaf(p_s[r * FK + j], g_s[r * KS + c], av);
        ak = fmaf(ds_s[r * FK + j], q_s[r * KS + c], ak);
      }
      dv_s[i] = av;
      dk_s[i] = ak;
    }
  }
  __syncthreads();
  float* dkg = reinterpret_cast<float*>(p.dk) + b * p.dksb + h * p.dksh;
  float* dvg = reinterpret_cast<float*>(p.dv) + b * p.dvsb + h * p.dvsh;
  for (int i = tid; i < FK * D; i += 128) {
    const int j = i / D, c = i % D;
    if (k0 + j < p.Sk) {
      dkg[(k0 + j) * p.dkss + c] = dk_s[i];
      dvg[(k0 + j) * p.dvss + c] = dv_s[i];
    }
  }
}

__global__ void __launch_bounds__(128) flash_bwd_dq_f32(const BwdParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int D = p.D, KS = D + 1;
  float* q_s = reinterpret_cast<float*>(smem_raw);  // [FQ][KS]
  float* g_s = q_s + FQ * KS;                        // [FQ][KS] dO
  float* k_s = g_s + FQ * KS;                        // [FK][KS]
  float* v_s = k_s + FK * KS;                        // [FK][KS]
  float* dq_s = v_s + FK * KS;                       // [FQ][D]
  float* ds_s = dq_s + FQ * D;                       // [FQ][FK]
  float* l_s = ds_s + FQ * FK;                       // [FQ]
  float* d_s = l_s + FQ;                             // [FQ]

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * FQ;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const float* qg = reinterpret_cast<const float*>(p.q) + b * p.qsb + h * p.qsh;
  const float* kg = reinterpret_cast<const float*>(p.k) + b * p.ksb + h * p.ksh;
  const float* vg = reinterpret_cast<const float*>(p.v) + b * p.vsb + h * p.vsh;
  const float* gg = reinterpret_cast<const float*>(p.g) + b * p.gsb + h * p.gsh;

  load_rows_f32(qg, p.qss, q0, FQ, p.Sq, D, KS, q_s);
  load_rows_f32(gg, p.gss, q0, FQ, p.Sq, D, KS, g_s);
  for (int i = tid; i < FQ * D; i += 128) dq_s[i] = 0.f;
  if (tid < FQ) {
    const bool ok = q0 + tid < p.Sq;
    l_s[tid] = ok ? p.lse[(long long)bh * p.Sq + q0 + tid] : 0.f;
    d_s[tid] = ok ? p.delta[(long long)bh * p.Sq + q0 + tid] : 0.f;
  }

  for (int k0 = 0; k0 < p.Sk; k0 += FK) {
    __syncthreads();
    load_rows_f32(kg, p.kss, k0, FK, p.Sk, D, KS, k_s);
    load_rows_f32(vg, p.vss, k0, FK, p.Sk, D, KS, v_s);
    __syncthreads();
    for (int i = tid; i < FQ * FK; i += 128) {
      const int r = i / FK, j = i % FK;
      const float s = dot_row(q_s + r * KS, k_s + j * KS, D);
      const float dp = dot_row(g_s + r * KS, v_s + j * KS, D);
      const float pe = k0 + j < p.Sk ? expf(s * p.scale - l_s[r]) : 0.f;
      ds_s[i] = pe * (dp - d_s[r]) * p.scale;
    }
    __syncthreads();
    for (int i = tid; i < FQ * D; i += 128) {
      const int r = i / D, c = i % D;
      float acc = dq_s[i];
      for (int j = 0; j < FK; ++j) acc = fmaf(ds_s[r * FK + j], k_s[j * KS + c], acc);
      dq_s[i] = acc;
    }
  }
  __syncthreads();
  float* dqg = reinterpret_cast<float*>(p.dq) + b * p.dqsb + h * p.dqsh;
  for (int i = tid; i < FQ * D; i += 128) {
    const int r = i / D, c = i % D;
    if (q0 + r < p.Sq) dqg[(q0 + r) * p.dqss + c] = dq_s[i];
  }
}

cudaError_t launch_f32(const BwdParams& p, cudaStream_t stream) {
  const int D = p.D, KS = D + 1;
  const size_t smem_kv =
      (size_t)(2 * FK * KS + 2 * FQ * KS + 2 * FK * D + 2 * FQ * FK + 2 * FQ) * sizeof(float);
  const size_t smem_q =
      (size_t)(2 * FQ * KS + 2 * FK * KS + FQ * D + FQ * FK + 2 * FQ) * sizeof(float);
  cudaError_t e = set_smem((const void*)flash_bwd_dkdv_f32, smem_kv);
  if (e != cudaSuccess) return e;
  e = set_smem((const void*)flash_bwd_dq_f32, smem_q);
  if (e != cudaSuccess) return e;
  flash_bwd_dkdv_f32<<<dim3((p.Sk + FK - 1) / FK, p.B * p.H, 1), 128, smem_kv, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_bwd_dq_f32<<<dim3((p.Sq + FQ - 1) / FQ, p.B * p.H, 1), 128, smem_q, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = bf16, 1 = fp32. ``strides`` holds 24 element strides: [b, h, s]
// of q, k, v, o, dO, dq, dk, dv (the last dim of each is contiguous).
// ``lse`` is the forward's fp32 [B*H, Sq] log-sum-exp; ``delta`` is fp32
// [B*H, Sq] scratch. Requires D % 8 == 0, D <= 160, 16-byte aligned pointers
// and strides that are multiples of 8 elements (the wrapper checks).
int c2d_flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                            const void* dout, const float* lse, float* delta, void* dq,
                            void* dk, void* dv, int dtype, int B, int H, int Sq, int Sk, int D,
                            const long long* s, float scale, void* stream) {
  const BwdParams p{q,     k,     v,     o,     dout,  lse,   delta, dq,    dk,    dv,
                    B,     H,     Sq,    Sk,    D,     s[0],  s[1],  s[2],  s[3],  s[4],
                    s[5],  s[6],  s[7],  s[8],  s[9],  s[10], s[11], s[12], s[13], s[14],
                    s[15], s[16], s[17], s[18], s[19], s[20], s[21], s[22], s[23], scale};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (D % 8 || D > 160 || Sq < 1 || Sk < 1) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)B * H * Sq;
  const unsigned blocks = (unsigned)((rows * 32 + 127) / 128);
  if (dtype == 1) {
    bwd_delta<float><<<blocks, 128, 0, st>>>(p);
  } else {
    bwd_delta<__nv_bfloat16><<<blocks, 128, 0, st>>>(p);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (dtype == 1) return (int)launch_f32(p, st);
  if (D <= 48) return (int)launch_bf16<48, 48>(p, st);
  if (D <= 64) return (int)launch_bf16<64, 64>(p, st);
  if (D <= 80) return (int)launch_bf16<80, 80>(p, st);
  if (D <= 128) return (int)launch_bf16<128, 64>(p, st);
  return (int)launch_bf16<160, 80>(p, st);
}

const char* c2d_cuda_error_string_bwd(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
