// The tile pipeline of the port's bf16 attention forward kernels on Hopper:
// a ring of shared-memory stages filled by cp.async, warpgroup products
// (wgmma) for Q K^T and P V, the online-softmax step and the epilogue with an
// optional log-sum-exp.
//
// A block owns QT sub-tiles of BQ = 64 query rows of a run of `nh` heads that
// share their K/V tile loads, and every K/V tile serves all QT sub-tiles
// before its stage is released: a block that owns few query rows re-reads K
// and V from L2 too often. In the packed kernel one warpgroup (4 warps, 16
// query rows each) serves each head of a group and walks the QT sub-tiles,
// so the heads run side by side; the per-head kernel
// (flash_attention.cu) is the case nh = 1 with one warpgroup per sub-tile,
// so that each holds one sub-tile's accumulator (d/2 registers a thread)
// where d reaches 160. A tile in shared memory holds the whole run: the `nh`
// heads' d columns one after another, as they lie in global memory where the
// tensors are [B, S, H*D] projections.
//
//   * Tiles are stored as wgmma core matrices, 8 rows x 16 bytes each:
//     [row / 8][16-byte column chunk][row % 8]. Q is loaded once and read
//     as the A operand from shared memory; d is walked in 16-column steps,
//     and where d is not a multiple of 16 every head's columns are followed
//     by a chunk of zeros in the Q tile.
//   * The K or V tile of BK = 64 keys holds the heads' columns back to
//     back. It serves as the K-major B operand of S = Q K^T (a head's
//     columns start at any chunk; under Q's zero chunk lies the next head's
//     first chunk or the zeroed pad chunk of the tile) and,
//     read MN-major, as the B operand of O += P V with N = d exactly: no
//     transpose and no padding.
//   * Online softmax in fp32, base 2, against the running row max; P is
//     rounded to bf16 for the PV product and the row sum kept in fp32; the
//     division by the row sum is the epilogue's.
#pragma once

#include <math.h>

#include "ptx.cuh"
#include "wgmma.cuh"

namespace c2d {
namespace attn {

constexpr int BQ = 64;      // query rows per sub-tile: one warpgroup, 16 rows a warp
constexpr int QT = 3;       // query sub-tiles per block, served by one sweep over K/V
constexpr int BK = 64;      // keys per stage
constexpr int STAGES = 3;   // K/V ring depth
constexpr int WARPS_PER_HEAD = BQ / 16;

// Bytes of one group of 8 keys of a K or V tile: the row's 16-byte chunks
// and one pad chunk, 128 bytes (8 keys) each.
__host__ __device__ inline int kv_block_stride(int cols) { return (cols / 8 + 1) * 128; }

__host__ __device__ inline int kv_tile_bytes(int cols) { return BK / 8 * kv_block_stride(cols); }

// Bytes of one group of 8 query rows of the Q tile: 2 * ks chunks a head.
__host__ __device__ inline int q_block_stride(int heads, int d) {
  return heads * 2 * ((d + 15) / 16) * 128;
}

// Shared memory of one block of `heads` heads of dim d: the Q tile and
// STAGES x (K tile, V tile).
__host__ __device__ inline int smem_bytes(int heads, int d) {
  return QT * BQ / 8 * q_block_stride(heads, d) + STAGES * 2 * kv_tile_bytes(heads * d);
}

// i / d for 0 <= i < 8192 and 1 <= d <= 64 by one multiply: `magic` is
// div_magic(d).
__host__ __device__ inline uint32_t div_magic(int d) { return (1u << 20) / d + 1; }
__device__ __forceinline__ int fast_div(int i, uint32_t magic) { return (i * magic) >> 20; }

// ROWS rows [r0, r0 + ROWS) of `nh` heads (d columns each, `sh` elements
// apart in global memory, rows `ss` apart) into a tile of core matrices, as
// 16-byte asynchronous copies. In the tile every head owns `head_chunks`
// 16-byte chunks (K/V: d/8, the heads back to back; Q: its columns, then
// zeros up to a multiple of 16 columns): chunk c of head hi of row r lands at
// (r / 8) * block_stride + (hi * head_chunks + c) * 128 + (r % 8) * 16. Rows
// at or past `limit` are not copied: what the tile holds there (zeros at
// first, then an earlier tile's rows) is finite, and keys there are masked.
template <int ROWS>
__device__ __forceinline__ void load_tile_async(uint32_t dst, const __nv_bfloat16* src,
                                                long long sh, long long ss, int r0, int limit,
                                                int nh, int d, int head_chunks,
                                                int block_stride, int nthreads) {
  const int ch = d / 8, per_row = nh * ch;
  const uint32_t m_row = div_magic(per_row), m_ch = div_magic(ch);
  // consecutive threads take the 8 rows of one core matrix (128 contiguous
  // bytes of shared memory: no bank conflict), then the next chunk
  for (int i = threadIdx.x; i < ROWS * per_row; i += nthreads) {
    const int rb = fast_div(i >> 3, m_row), j = (i >> 3) - rb * per_row, r = rb * 8 + (i & 7);
    const int hi = fast_div(j, m_ch), c = j - hi * ch;
    if (r0 + r < limit)
      cp_async16(dst + rb * block_stride + (hi * head_chunks + c) * 128 + (i & 7) * 16,
                 src + hi * sh + (long long)(r0 + r) * ss + c * 8, true);
  }
}

// S = Q K^T for the warpgroup's 64 rows x BK keys: the raw dot products
// (the softmax step applies the scale), started and awaited; -inf past the
// last key. `q_s` points at the head's first chunk of the Q tile, `k_s` at
// its first chunk of the K tile. Under the zero columns of Q's last step
// lies the next head's first chunk of K, or the tile's zeroed pad chunk.
template <int KS>
__device__ __forceinline__ void qk_tile(float s[BK / 8][4], uint32_t q_s, int qbs, uint32_t k_s,
                                        int kbs, int lane, int k0, int S) {
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    wgmma_ss_n64(&s[0][0], wgmma_desc(q_s + 2 * ks * 128, 128, qbs),
                 wgmma_desc(k_s + 2 * ks * 128, 128, kbs), ks > 0);
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) wgmma_pin(s[n][e]);
  }
  if (k0 + BK > S) {  // only the last tile can be ragged
    const int t = lane & 3;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (k0 + n * 8 + 2 * t + (e & 1) >= S) s[n][e] = -INFINITY;
    }
  }
}

// One online-softmax step for the thread's rows g (elements 0, 1) and g + 8
// (elements 2, 3). s holds raw logits and becomes p = 2^(s * sl2 - m), one
// fused multiply-add and one ex2 per element (`sl2` = scale * log2 e > 0, so
// the row max is taken on the raw logits); the running max m (log2 units),
// the thread's partial row sum l and the accumulator o are rescaled. The
// tile holds at least one real key, so the new max is finite.
template <int NT>
__device__ __forceinline__ void softmax_step(float s[BK / 8][4], float o[NT][4], float m[2],
                                             float l[2], float sl2) {
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int n = 0; n < BK / 8; ++n) {
    mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
    mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  const float mn0 = fmaxf(m[0], mx0 * sl2), mn1 = fmaxf(m[1], mx1 * sl2);
  const float c0 = fast_exp2(m[0] - mn0), c1 = fast_exp2(m[1] - mn1);
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int n = 0; n < BK / 8; ++n) {
    s[n][0] = fast_exp2(fmaf(s[n][0], sl2, -mn0));
    s[n][1] = fast_exp2(fmaf(s[n][1], sl2, -mn0));
    s[n][2] = fast_exp2(fmaf(s[n][2], sl2, -mn1));
    s[n][3] = fast_exp2(fmaf(s[n][3], sl2, -mn1));
    rs0 += s[n][0] + s[n][1];
    rs1 += s[n][2] + s[n][3];
  }
  l[0] = l[0] * c0 + rs0;
  l[1] = l[1] * c1 + rs1;
  m[0] = mn0;
  m[1] = mn1;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    o[j][0] *= c0;
    o[j][1] *= c0;
    o[j][2] *= c1;
    o[j][3] *= c1;
  }
}

// O[:, N0 : N0 + N] += P V[:, N0 : N0 + N] for one k16 step, N = min(64, D - N0),
// then the next 64 columns: one product where D <= 64.
template <int D, int N0 = 0>
__device__ __forceinline__ void pv_columns(float o[D / 8][4], const uint32_t a[4], uint32_t v,
                                           int kbs) {
  constexpr int N = D - N0 < 64 ? D - N0 : 64;
  wgmma_rs<N>(&o[N0 / 8][0], a, wgmma_desc(v + N0 / 8 * 128, kbs, 128), 1);
  if constexpr (N0 + 64 < D) pv_columns<D, N0 + 64>(o, a, v, kbs);
}

// O += P V for BK keys: P from the softmax registers rounded to bf16, V read
// MN-major from the tile; D = d columns exactly, in products of at most 64
// columns. Started and awaited.
template <int D>
__device__ __forceinline__ void pv_tile(float o[D / 8][4], const float s[BK / 8][4],
                                        uint32_t v_s, int kbs, int chunk) {
  uint32_t pf[BK / 16][4];
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    pf[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
    pf[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
    pf[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    pf[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
  }
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    pv_columns<D>(o, pf[kk], v_s + 2 * kk * kbs + chunk * 128, kbs);
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) wgmma_pin(pf[kk][e]);
  }
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) wgmma_pin(o[j][e]);
  }
}

// The row sums of the thread's rows over the 4 threads of its quad.
__device__ __forceinline__ void quad_sum(float l[2]) {
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l[0] += __shfl_xor_sync(0xffffffffu, l[0], off);
    l[1] += __shfl_xor_sync(0xffffffffu, l[1], off);
  }
}

// Rows r0 = g and r1 = g + 8 (absolute row numbers) of O / l as bf16 pairs,
// l the whole row sum, its first `ncols` columns (a multiple of 8), and the
// row log-sum-exp (natural log; m is in log2 units) where `lse` is not null.
template <int NT>
__device__ __forceinline__ void store_rows(const float o[NT][4], const float m[2],
                                           const float l[2], __nv_bfloat16* og, long long oss,
                                           float* lse, int r0, int r1, int S, int lane,
                                           int ncols = NT * 8) {
  const int t = lane & 3;
  const float inv0 = 1.f / l[0], inv1 = 1.f / l[1];
  if (lse != nullptr && t == 0) {
    if (r0 < S) lse[r0] = m[0] * 0.6931471805599453f + logf(l[0]);
    if (r1 < S) lse[r1] = m[1] * 0.6931471805599453f + logf(l[1]);
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = j * 8 + 2 * t;
    if (j * 8 >= ncols) break;
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(og + (long long)r0 * oss + col) =
          pack_bf16(o[j][0] * inv0, o[j][1] * inv0);
    if (r1 < S)
      *reinterpret_cast<uint32_t*>(og + (long long)r1 * oss + col) =
          pack_bf16(o[j][2] * inv1, o[j][3] * inv1);
  }
}

// The epilogue of a warpgroup that saw every key: the quad's partial row
// sums added, then store_rows.
template <int NT>
__device__ __forceinline__ void write_output(const float o[NT][4], float m[2], float l[2],
                                             __nv_bfloat16* og, long long oss, float* lse,
                                             int r0, int r1, int S, int lane,
                                             int ncols = NT * 8) {
  quad_sum(l);
  store_rows<NT>(o, m, l, og, oss, lse, r0, r1, S, lane, ncols);
}

}  // namespace attn
}  // namespace c2d
