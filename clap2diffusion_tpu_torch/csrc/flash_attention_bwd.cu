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
// What bounds it on an H100. The TPU kernel kept all of K and V of a head in
// VMEM and accumulated dK/dV in its output buffer across the sequential
// q-block grid; here blocks run in no order and nothing carries over between
// them, so without atomics (every output element is written by one thread,
// and two launches give the same bits) dK/dV and dQ are computed by separate
// blocks, and each recomputes S and dP: 7 products of 2*Sq*Sk*d operations
// instead of the 5 a single pass needs. At [4,8,4096,40] that is 0.217 ms of
// bf16 tensor-core time for 5 products, 0.304 ms for 7, and 0.339 ms once d
// = 40 is padded to 48 in the four products whose depth is d (S and dP, in
// both roles). The exponentials are as large: two ex2 a logit (one per
// role), 1.07e9 a call, ~0.26-0.29 ms at 16 a clock per SM. Bytes (q, k,
// v, o, dO in, dq, dk, dv out, once each) are 0.03 ms. At [4,8,256,160] the
// work is small and the grid is what matters. The design, after a delta
// pre-pass (delta = rowsum(dO * O) in fp32, one warp per query row), is one
// launch of flash_bwd_bf16 whose blocks take one of two roles by blockIdx.x:
//   * dK/dV: a block per (run of 192 keys, 128 where d > 80; batch*head), one
//     warpgroup per 64-key sub-tile, each holding its dK and dV rows in fp32
//     registers (d/2 each a thread) for the one epilogue store. K and V of
//     the block's keys are loaded once in the Q-tile layout of
//     attention_core.cuh (core matrices, a zero chunk where d % 16 != 0) and
//     serve as the A operands of S^T = K Q^T and dP^T = V dO^T. Q and dO
//     stream in 64-query tiles through a 3-stage cp.async ring in the K/V-tile
//     layout, with the tile's lse and delta beside them; one sweep over the
//     queries serves every sub-tile. That layout is the K-major B of S^T and
//     dP^T, and, read MN-major, the B of dV += P^T dO and dK += dS^T Q with
//     N = d exactly (P^T and dS^T from registers as bf16 A fragments). No
//     transpose is stored anywhere. Queries past Sq have P = 0; keys past Sk
//     are never stored;
//   * dQ: the forward's per-head pipeline, a block per (run of as many
//     queries; batch*head), one warpgroup per 64-row sub-tile: Q and dO
//     loaded once as A tiles, K and V streamed through the ring; S = Q K^T
//     and dP = dO V^T, P = exp2(S*sl2 - lse*log2 e) and dS = P (dP - delta)
//     scale, dQ += dS K with K read MN-major. Keys past Sk have P = 0.
// The roles are independent once delta exists. One launch for both fills
// the card where each alone leaves SMs idle (64 blocks a role at
// [4,8,256,160]) and has one last wave instead of two.
// Products are wgmma (m64n64k16 from shared memory for S and dP, m64nNk16
// with a register A for the rest), fp32 accumulation. Head dims run on the
// instances 40, 80 and 160, the columns past d zero in shared memory and never
// stored. P and dS are rounded to bf16 before dV = P^T dO, dK = dS^T Q and
// dQ = dS K; the TPU kernel did those products in fp32.
// fp32 inputs take a plain FMA kernel (16 queries x 32 keys per step, all
// operands in shared memory), exact to fp32 rounding; it serves the checks.
//
// Every entry returns cudaGetLastError() after its launches; the Python
// wrapper raises when it is not cudaSuccess.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_core.cuh"

namespace {

using namespace c2d;

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

cudaError_t set_smem(const void* fn, size_t bytes) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

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

__host__ __device__ inline unsigned delta_blocks(int B, int H, int Sq) {
  return (unsigned)(((long long)B * H * Sq * 32 + 127) / 128);
}

// ---------------------------------------------------------------- bf16 path

constexpr int BQ = attn::BQ;  // queries of a streamed tile, rows of a warpgroup's sub-tile
constexpr int BK = attn::BK;  // keys of a streamed tile
constexpr int STAGES = attn::STAGES;
constexpr int MAX_D = 160;
constexpr int STATS_BYTES = 2 * BQ * 4;  // lse and delta of a 64-query tile, fp32

// The instance a head dim runs on: the UNet's 40, 80 and 160, and for any
// other d the next one up (its columns past d are zeros in shared memory).
__host__ __device__ constexpr int instance_d(int d) { return d <= 40 ? 40 : d <= 80 ? 80 : MAX_D; }

// Warpgroups (64-row sub-tiles) of a block, one count for both roles since
// they share a launch. dK/dV: a thread holds dK and dV (d/2 registers each)
// beside S^T and dP^T (32 each): 144 at d = 80 about fills the 168 a thread
// of 384 may have, 224 at d = 160 needs 256 threads. dQ: 192 query rows' Q
// and dO tiles and the ring would exceed 227 KB at d = 160.
__host__ __device__ constexpr int warpgroups(int d) { return d <= 80 ? 3 : 2; }

// Bytes of a tile of `rows` rows in the Q-tile layout (A operands).
__host__ __device__ inline int a_tile_bytes(int rows, int d) {
  return rows / 8 * attn::q_block_stride(1, d);
}
// A dK/dV stage: the Q tile, the dO tile, then lse and delta of its queries.
__host__ __device__ inline int dkdv_stage_bytes(int d) {
  return 2 * attn::kv_tile_bytes(d) + STATS_BYTES;
}
// dK/dV block: K and V of its keys, and the ring of Q/dO stages.
__host__ __device__ inline int dkdv_smem_bytes(int d) {
  return 2 * a_tile_bytes(BQ * warpgroups(d), d) + STAGES * dkdv_stage_bytes(d);
}
// dQ block: Q and dO of its queries, and the ring of (K tile, V tile) stages.
__host__ __device__ inline int dq_smem_bytes(int d) {
  return 2 * a_tile_bytes(BQ * warpgroups(d), d) + STAGES * 2 * attn::kv_tile_bytes(d);
}

// Copy 4 bytes global -> shared without blocking the thread; with valid ==
// false the 4 bytes are zero-filled (src must still be a mapped address).
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

// c = X Y^T and e = X2 Y2^T for the warpgroup's 64 rows x 64 columns, one
// commit group: X, X2 in the Q-tile layout (the warpgroup's first row group
// at a1, a2; `abs` bytes per 8 rows), Y, Y2 the K-major B tiles of the K/V
// layout (`bbs`). Raw dot products, started and awaited. (Awaiting c alone
// first, so that its exponentials overlap the second product, took as long
// at [4,8,4096,40] and spilled more registers.)
template <int KS>
__device__ __forceinline__ void two_products(float c[BK / 8][4], float e[BK / 8][4], uint32_t a1,
                                             uint32_t b1, uint32_t a2, uint32_t b2, int abs,
                                             int bbs) {
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    wgmma_ss_n64(&c[0][0], wgmma_desc(a1 + 2 * ks * 128, 128, abs),
                 wgmma_desc(b1 + 2 * ks * 128, 128, bbs), ks > 0);
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    wgmma_ss_n64(&e[0][0], wgmma_desc(a2 + 2 * ks * 128, 128, abs),
                 wgmma_desc(b2 + 2 * ks * 128, 128, bbs), ks > 0);
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      wgmma_pin(c[n][i]);
      wgmma_pin(e[n][i]);
    }
  }
}

// The accumulator's 64 columns as bf16 A fragments of four k16 steps.
__device__ __forceinline__ void a_fragments(uint32_t f[BK / 16][4], const float s[BK / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    f[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
    f[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
    f[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    f[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
  }
}

// x += Px Bx and y += Py By over 64 rows of the K dimension, one commit
// group: Px, Py from registers rounded to bf16, Bx, By read MN-major from
// K/V-layout tiles with N = D columns exactly (attn::pv_columns).
template <int D>
__device__ __forceinline__ void two_pv(float x[D / 8][4], const float px[BK / 8][4], uint32_t bx,
                                       float y[D / 8][4], const float py[BK / 8][4], uint32_t by,
                                       int kbs) {
  uint32_t fx[BK / 16][4], fy[BK / 16][4];
  a_fragments(fx, px);
  a_fragments(fy, py);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    attn::pv_columns<D>(x, fx[kk], bx + 2 * kk * kbs, kbs);
    attn::pv_columns<D>(y, fy[kk], by + 2 * kk * kbs, kbs);
  }
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      wgmma_pin(fx[kk][i]);
      wgmma_pin(fy[kk][i]);
    }
  }
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      wgmma_pin(x[j][i]);
      wgmma_pin(y[j][i]);
    }
  }
}

// Rows r0 and r0 + 8 of an accumulator as bf16 pairs, the first `ncols`
// columns (a multiple of 8), rows at or past S not stored.
template <int NT>
__device__ __forceinline__ void store_acc(const float a[NT][4], __nv_bfloat16* g, long long ss,
                                          int r0, int S, int lane, int ncols) {
  const int t = lane & 3, r1 = r0 + 8;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = j * 8 + 2 * t;
    if (j * 8 >= ncols) break;
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(g + (long long)r0 * ss + col) = pack_bf16(a[j][0], a[j][1]);
    if (r1 < S)
      *reinterpret_cast<uint32_t*>(g + (long long)r1 * ss + col) = pack_bf16(a[j][2], a[j][3]);
  }
}

__device__ __forceinline__ void zero_smem(unsigned char* smem, int bytes) {
  for (int i = threadIdx.x; i < bytes / 16; i += blockDim.x)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
}

// 2. dK and dV of keys [kb * ROWS, kb * ROWS + ROWS) of head bh.
template <int D, int WG>
__device__ __forceinline__ void dkdv_block(const BwdParams& p, int kb, int bh,
                                           unsigned char* smem) {
  constexpr int NT = D / 8, KS = (D + 15) / 16, ROWS = WG * BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, t4 = lane & 3;
  const int nthreads = blockDim.x;
  const int sub = warp / 4, wq = warp % 4;
  const int k0 = kb * ROWS, b = bh / p.H, h = bh % p.H;
  const int qbs = attn::q_block_stride(1, D), kbs = attn::kv_block_stride(D);
  const int tile_bytes = attn::kv_tile_bytes(D), stage_bytes = dkdv_stage_bytes(D);
  const uint32_t k_s = smem_u32(smem), v_s = k_s + a_tile_bytes(ROWS, D);
  const uint32_t ring = v_s + a_tile_bytes(ROWS, D);
  zero_smem(smem, dkdv_smem_bytes(D));  // zero chunks, pad chunks, rows never copied

  const __nv_bfloat16* qg = reinterpret_cast<const __nv_bfloat16*>(p.q) + b * p.qsb + h * p.qsh;
  const __nv_bfloat16* kg = reinterpret_cast<const __nv_bfloat16*>(p.k) + b * p.ksb + h * p.ksh;
  const __nv_bfloat16* vg = reinterpret_cast<const __nv_bfloat16*>(p.v) + b * p.vsb + h * p.vsh;
  const __nv_bfloat16* gg = reinterpret_cast<const __nv_bfloat16*>(p.g) + b * p.gsb + h * p.gsh;
  const float* lse = p.lse + (long long)bh * p.Sq;
  const float* delta = p.delta + (long long)bh * p.Sq;
  const int ntiles = (p.Sq + BQ - 1) / BQ;

  auto load_stage = [&](int slot, int tile) {
    const uint32_t dst = ring + slot * stage_bytes;  // Q tile, dO tile, lse, delta
    attn::load_tile_async<BQ>(dst, qg, 0, p.qss, tile * BQ, p.Sq, 1, p.D, NT, kbs, nthreads);
    attn::load_tile_async<BQ>(dst + tile_bytes, gg, 0, p.gss, tile * BQ, p.Sq, 1, p.D, NT, kbs,
                              nthreads);
    if (tid < 2 * BQ) {  // past Sq: zeros (those queries' P is set to 0)
      const int qi = tile * BQ + (tid & (BQ - 1));
      const bool ok = qi < p.Sq;
      cp_async4(dst + 2 * tile_bytes + tid * 4, (tid < BQ ? lse : delta) + (ok ? qi : 0), ok);
    }
  };

  // K and V travel in the first group, with the first stage
  attn::load_tile_async<ROWS>(k_s, kg, 0, p.kss, k0, p.Sk, 1, p.D, 2 * KS, qbs, nthreads);
  attn::load_tile_async<ROWS>(v_s, vg, 0, p.vss, k0, p.Sk, 1, p.D, 2 * KS, qbs, nthreads);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ntiles) load_stage(s, s);
    cp_async_commit();
  }
  const bool active = k0 + sub * BQ < p.Sk;  // else this warpgroup loads and waits only
  const float sl2 = p.scale * LOG2E;
  const uint32_t k_sub = k_s + sub * BQ / 8 * qbs, v_sub = v_s + sub * BQ / 8 * qbs;
  float dk[NT][4], dv[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) dk[j][i] = dv[j][i] = 0.f;
  }

  for (int tile = 0; tile < ntiles; ++tile) {
    cp_async_wait<STAGES - 2>();  // this tile has landed
    fence_proxy_async();          // and wgmma may read what this thread copied
    __syncthreads();              // for every thread; the previous tile's slot is free
    if (tile + STAGES - 1 < ntiles)
      load_stage((tile + STAGES - 1) % STAGES, tile + STAGES - 1);
    cp_async_commit();
    if (!active) continue;
    const uint32_t q_t = ring + (tile % STAGES) * stage_bytes, g_t = q_t + tile_bytes;
    const float* st_lse = reinterpret_cast<const float*>(smem + (q_t - k_s) + 2 * tile_bytes);
    const float* st_delta = st_lse + BQ;
    // S^T = K Q^T and dP^T = V dO^T: the warpgroup's 64 keys x the tile's 64 queries
    float s[BK / 8][4], dp[BK / 8][4];
    two_products<KS>(s, dp, k_sub, q_t, v_sub, g_t, qbs, kbs);
    // P^T and dS^T in place; the thread's query columns are n*8 + 2*t4 + {0, 1}
    const int valid = p.Sq - tile * BQ;  // queries of this tile: 64 but in the last
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      const float2 l2 = *reinterpret_cast<const float2*>(st_lse + n * 8 + 2 * t4);
      const float2 dl = *reinterpret_cast<const float2*>(st_delta + n * 8 + 2 * t4);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float pe = fast_exp2(fmaf(s[n][i], sl2, -((i & 1) ? l2.y : l2.x) * LOG2E));
        if (n * 8 + 2 * t4 + (i & 1) >= valid) pe = 0.f;  // no P past Sq
        s[n][i] = pe;
        dp[n][i] = pe * (dp[n][i] - ((i & 1) ? dl.y : dl.x)) * p.scale;
      }
    }
    // dV += P^T dO and dK += dS^T Q, P^T and dS^T rounded to bf16
    two_pv<D>(dv, s, g_t, dk, dp, q_t, kbs);
  }
  cp_async_wait<0>();
  if (!active) return;
  __nv_bfloat16* dkg = reinterpret_cast<__nv_bfloat16*>(p.dk) + b * p.dksb + h * p.dksh;
  __nv_bfloat16* dvg = reinterpret_cast<__nv_bfloat16*>(p.dv) + b * p.dvsb + h * p.dvsh;
  const int r0 = k0 + sub * BQ + wq * 16 + (lane >> 2);
  store_acc<NT>(dk, dkg, p.dkss, r0, p.Sk, lane, p.D);
  store_acc<NT>(dv, dvg, p.dvss, r0, p.Sk, lane, p.D);
}

// 3. dQ of queries [qb * ROWS, qb * ROWS + ROWS) of head bh.
template <int D, int WG>
__device__ __forceinline__ void dq_block(const BwdParams& p, int qb, int bh, unsigned char* smem) {
  constexpr int NT = D / 8, KS = (D + 15) / 16, ROWS = WG * BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, t4 = lane & 3;
  const int nthreads = blockDim.x;
  const int sub = warp / 4, wq = warp % 4;
  const int q0 = qb * ROWS, b = bh / p.H, h = bh % p.H;
  const int qbs = attn::q_block_stride(1, D), kbs = attn::kv_block_stride(D);
  const int tile_bytes = attn::kv_tile_bytes(D);
  const uint32_t q_s = smem_u32(smem), g_s = q_s + a_tile_bytes(ROWS, D);
  const uint32_t ring = g_s + a_tile_bytes(ROWS, D);
  zero_smem(smem, dq_smem_bytes(D));

  const __nv_bfloat16* qg = reinterpret_cast<const __nv_bfloat16*>(p.q) + b * p.qsb + h * p.qsh;
  const __nv_bfloat16* kg = reinterpret_cast<const __nv_bfloat16*>(p.k) + b * p.ksb + h * p.ksh;
  const __nv_bfloat16* vg = reinterpret_cast<const __nv_bfloat16*>(p.v) + b * p.vsb + h * p.vsh;
  const __nv_bfloat16* gg = reinterpret_cast<const __nv_bfloat16*>(p.g) + b * p.gsb + h * p.gsh;
  const int ntiles = (p.Sk + BK - 1) / BK;

  auto load_stage = [&](int slot, int tile) {
    const uint32_t dst = ring + slot * 2 * tile_bytes;  // K tile, then V tile
    attn::load_tile_async<BK>(dst, kg, 0, p.kss, tile * BK, p.Sk, 1, p.D, NT, kbs, nthreads);
    attn::load_tile_async<BK>(dst + tile_bytes, vg, 0, p.vss, tile * BK, p.Sk, 1, p.D, NT, kbs,
                              nthreads);
  };

  // Q and dO travel in the first group, with the first stage
  attn::load_tile_async<ROWS>(q_s, qg, 0, p.qss, q0, p.Sq, 1, p.D, 2 * KS, qbs, nthreads);
  attn::load_tile_async<ROWS>(g_s, gg, 0, p.gss, q0, p.Sq, 1, p.D, 2 * KS, qbs, nthreads);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ntiles) load_stage(s, s);
    cp_async_commit();
  }
  const bool active = q0 + sub * BQ < p.Sq;
  const float sl2 = p.scale * LOG2E;
  const int r0 = q0 + sub * BQ + wq * 16 + (lane >> 2), r1 = r0 + 8;
  const long long base = (long long)bh * p.Sq;
  // rows past Sq: lse = delta = 0, their dS is finite and never stored
  const float l20 = r0 < p.Sq ? p.lse[base + r0] * LOG2E : 0.f;
  const float l21 = r1 < p.Sq ? p.lse[base + r1] * LOG2E : 0.f;
  const float d0 = r0 < p.Sq ? p.delta[base + r0] : 0.f;
  const float d1 = r1 < p.Sq ? p.delta[base + r1] : 0.f;
  const uint32_t q_sub = q_s + sub * BQ / 8 * qbs, g_sub = g_s + sub * BQ / 8 * qbs;
  float dq[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;

  for (int tile = 0; tile < ntiles; ++tile) {
    cp_async_wait<STAGES - 2>();
    fence_proxy_async();
    __syncthreads();
    if (tile + STAGES - 1 < ntiles)
      load_stage((tile + STAGES - 1) % STAGES, tile + STAGES - 1);
    cp_async_commit();
    if (!active) continue;
    const uint32_t k_t = ring + (tile % STAGES) * 2 * tile_bytes, v_t = k_t + tile_bytes;
    // S = Q K^T and dP = dO V^T: the warpgroup's 64 queries x the tile's 64 keys
    float s[BK / 8][4], dp[BK / 8][4];
    two_products<KS>(s, dp, q_sub, k_t, g_sub, v_t, qbs, kbs);
    const int valid = p.Sk - tile * BK;  // keys of this tile: 64 but in the last
    // P and dS in place
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float pe = fast_exp2(fmaf(s[n][i], sl2, -(i < 2 ? l20 : l21)));
        if (n * 8 + 2 * t4 + (i & 1) >= valid) pe = 0.f;  // no P past Sk
        s[n][i] = pe * (dp[n][i] - (i < 2 ? d0 : d1)) * p.scale;
      }
    }
    // dQ += dS K, dS rounded to bf16, K read MN-major
    attn::pv_tile<D>(dq, s, k_t, kbs, 0);
  }
  cp_async_wait<0>();
  if (!active) return;
  __nv_bfloat16* dqg = reinterpret_cast<__nv_bfloat16*>(p.dq) + b * p.dqsb + h * p.dqsh;
  store_acc<NT>(dq, dqg, p.dqss, r0, p.Sq, lane, p.D);
}

// Both roles in one launch: blocks x < kv_blocks of each row of the grid
// take keys, the rest queries.
template <int D>
__global__ void __launch_bounds__(128 * warpgroups(D), 1)
    flash_bwd_bf16(const BwdParams p, int kv_blocks) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  if ((int)blockIdx.x < kv_blocks)
    dkdv_block<D, warpgroups(D)>(p, blockIdx.x, blockIdx.y, smem_raw);
  else
    dq_block<D, warpgroups(D)>(p, blockIdx.x - kv_blocks, blockIdx.y, smem_raw);
}

// The bf16 launch: what the kernel is launched with, and what
// c2d_flash_bwd_plan reports. One launch for both roles: the dK/dV and the
// dQ blocks of a head side by side in a row of the grid. (Two launches, one
// a role, took 1.26-1.29 / 0.206 / 0.054 ms at [4,8,{4096,1024,256},
// {40,80,160}] on an H100 against 1.14 / 0.172 / 0.035 for one: the second
// launch waited for the first one's last wave.)
struct Geometry {
  int d;                           // the instance
  int kv_x, kv_rows;               // dK/dV: blocks along the keys of a head, keys a block
  int q_x, q_rows;                 // dQ: blocks along the queries of a head, queries a block
  dim3 grid;                       // (kv_x + q_x, batch * head)
  int threads, smem;
};

Geometry geometry(int B, int H, int Sq, int Sk, int D) {
  const int d = instance_d(D);
  const int rows = BQ * warpgroups(d);
  const int kv_x = (Sk + rows - 1) / rows, q_x = (Sq + rows - 1) / rows;
  const int smem = dkdv_smem_bytes(d) > dq_smem_bytes(d) ? dkdv_smem_bytes(d) : dq_smem_bytes(d);
  return {d, kv_x, rows, q_x, rows, dim3(kv_x + q_x, B * H, 1), 128 * warpgroups(d), smem};
}

template <int D>
cudaError_t launch_instance(const BwdParams& p, const Geometry& g, cudaStream_t stream) {
  static int configured = 0;
  if (g.smem > configured) {
    cudaError_t e = set_smem((const void*)flash_bwd_bf16<D>, g.smem);
    if (e != cudaSuccess) return e;
    configured = g.smem;
  }
  flash_bwd_bf16<D><<<g.grid, g.threads, g.smem, stream>>>(p, g.kv_x);
  return cudaGetLastError();
}

cudaError_t launch_bf16(const BwdParams& p, cudaStream_t stream) {
  const Geometry g = geometry(p.B, p.H, p.Sq, p.Sk, p.D);
  switch (g.d) {
    case 40: return launch_instance<40>(p, g, stream);
    case 80: return launch_instance<80>(p, g, stream);
    default: return launch_instance<MAX_D>(p, g, stream);
  }
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
  if (D % 8 || D < 8 || D > MAX_D || Sq < 1 || Sk < 1) return (int)cudaErrorInvalidValue;
  const unsigned blocks = delta_blocks(B, H, Sq);
  if (dtype == 1) {
    bwd_delta<float><<<blocks, 128, 0, st>>>(p);
  } else {
    bwd_delta<__nv_bfloat16><<<blocks, 128, 0, st>>>(p);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (dtype == 1) return (int)launch_f32(p, st);
  return (int)launch_bf16(p, st);
}

// The geometry c2d_flash_attention_bwd launches the bf16 kernels with on
// these arguments (no launch; host only): out = {instance head dim, delta
// pre-pass blocks, grid.x, grid.y, threads, dynamic shared memory in bytes,
// stages, dK/dV blocks of a grid row, keys a dK/dV block, dK/dV accumulator
// registers a thread, dQ blocks of a grid row, queries a dQ block, dQ
// accumulator registers a thread}.
int c2d_flash_bwd_plan(int B, int H, int Sq, int Sk, int D, int* out) {
  if (D % 8 || D < 8 || D > MAX_D || Sq < 1 || Sk < 1 || B < 1 || H < 1)
    return (int)cudaErrorInvalidValue;
  const Geometry g = geometry(B, H, Sq, Sk, D);
  const int vals[13] = {g.d,      (int)delta_blocks(B, H, Sq), (int)g.grid.x, (int)g.grid.y,
                        g.threads, g.smem,   STAGES,  g.kv_x,  g.kv_rows,   g.d,
                        g.q_x,     g.q_rows, g.d / 2};
  for (int i = 0; i < 13; ++i) out[i] = vals[i];
  return 0;
}

const char* c2d_cuda_error_string_bwd(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
