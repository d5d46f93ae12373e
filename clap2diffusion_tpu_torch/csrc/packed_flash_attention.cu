// Head-packed flash-attention forward for Hopper (sm_90a), bf16 and fp32.
//
// Replaces the TPU kernel clap2diffusion_tpu/ops/flash_attention.py::
// _packed_fwd_kernel (launched by _packed_flash_fwd on [B,H,S,D] and by
// _packed_flash_nhd_fwd on the [B,S,H*D] projection layout): self-attention
// out = softmax(q k^T * scale) v for `pack` heads per kernel instance, with
// fp32 logits.
//
// What bounds it on an H100: at the route's shapes ([B,4096,8*40], pack 3)
// the work is tensor-core operations, 4*S*S*d per head against 4*S*d
// elements moved, and one exp2 per logit; but a block that owns few query
// rows re-reads all of K and V from L2 for them, and a first version of this
// design (64 query rows a block) spent its time on exactly that. The TPU
// kernel packed heads because its MXU contracts 128 deep: queries were
// concatenated on the feature axis and K/V made block-diagonal, so one
// [Bq,120]x[120,3S] product computed three heads' logits. On Hopper that
// block-diagonal build would triple the QK^T work with zeros. What the
// packing still gives here is contiguity: the heads of a group are one run of
// each [B,S,H*D] row (240 bytes at pack 3, d 40). The bf16 design (tile
// pipeline in attention_core.cuh):
//   * one block owns 192 query rows of one group (grid = query tiles x
//     B*groups) with one warpgroup per head, so the group's heads run side
//     by side: Q is loaded once and every 64-key K/V tile once for all heads
//     and for the block's three 64-row sub-tiles of queries, as runs of
//     pack*d contiguous elements, 16 bytes a thread, by cp.async into a ring
//     of 3 stages that runs two tiles ahead of the products. At
//     [2,4096,8*40] that is 132 blocks of 12 warps (150 KB of shared
//     memory), one wave on 132 SMs, and 264 at batch 4. A ghost head's
//     columns (H not a multiple of pack) are neither loaded nor computed;
//     its warpgroup only helps to load;
//   * two products per key tile and sub-tile, on wgmma (m64n64k16 for
//     S = Q K^T with Q and K from shared memory, m64n{d}k16 for O += P V
//     with P from registers), around an online softmax (running max,
//     P = exp2(s - m) rounded to bf16, the division by the row sum at the
//     end), as the per-head forward does. The TPU kernel normalises P before
//     PV against the final max; the plain version keeps that order and the
//     kernel stays inside the bf16 tolerance against it;
//   * K is read in place from the packed tile: d = 40 is 2.5 product depths,
//     Q's columns 40-47 are zeros in its tile, and what lies under them in K
//     is the next head's data or the tile's zeroed pad chunk. V is read from
//     the same row-major layout as the MN-major operand: d/8 column tiles,
//     nothing padded, no transpose through shared memory;
//   * the tensors are read through their (b, h, s) strides, so [B,S,H*D]
//     projections are read and written in place and [B,H,S,D] tensors take
//     the same path;
//   * for training the caller may pass an fp32 [B*H, S] buffer for the row
//     log-sum-exp (m + log l, natural log), which the backward
//     (flash_attention_bwd.cu) reads. With a null pointer nothing else
//     changes.
// fp32 inputs take a plain FMA kernel with two passes over K (16 query rows
// x 32 keys per step, everything in shared memory, P normalised before PV),
// exact to fp32 rounding; it serves the fp32 checks only.
//
// Every entry returns cudaGetLastError() after its launch; the Python
// wrapper raises when it is not cudaSuccess.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_core.cuh"

namespace {

using namespace c2d;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // null, or fp32 [B*H, S]
  int B, H, S, D, pack, groups;
  long long qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss;
  float scale;
};

// ---------------------------------------------------------------- bf16 path

// Heads per block at most, by head dim: one warpgroup a head, and the
// block's threads must fit the registers of the three sub-tiles' accumulators
// (d <= 32: 16 warps of up to 128 registers; d = 40: 12 of up to 168; beyond:
// 8 of up to 255). The tiles of max_pack(d) heads fit a block's shared memory.
__host__ __device__ constexpr int max_pack(int d) { return d <= 32 ? 4 : d <= 40 ? 3 : 2; }

template <int D>
__global__ void __launch_bounds__(32 * attn::WARPS_PER_HEAD * max_pack(D))
    packed_fwd_bf16(const Params p) {
  constexpr int NT = D / 8, KS = (D + 15) / 16;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nthreads = blockDim.x;
  const int hi = warp / attn::WARPS_PER_HEAD, wq = warp % attn::WARPS_PER_HEAD;
  const int q0 = blockIdx.x * attn::QT * attn::BQ;
  const int b = blockIdx.y / p.groups, h0 = (blockIdx.y % p.groups) * p.pack;
  const int nh = min(p.pack, p.H - h0);  // real heads of this group
  const int qbs = attn::q_block_stride(p.pack, D), kbs = attn::kv_block_stride(p.pack * D);
  const int tile_bytes = attn::kv_tile_bytes(p.pack * D);
  const uint32_t q_s = smem_u32(smem_raw);
  const uint32_t kv_s = q_s + attn::QT * attn::BQ / 8 * qbs;

  // Zero everything once: Q's chunks of zeros, and what must be finite: the
  // pad chunks of the K/V tiles and a ghost head's columns (read under Q's
  // zero chunks) and the rows past S, which are never copied.
  for (int i = tid; i < attn::smem_bytes(p.pack, D) / 16; i += nthreads)
    reinterpret_cast<uint4*>(smem_raw)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  const __nv_bfloat16* qg = reinterpret_cast<const __nv_bfloat16*>(p.q) + b * p.qsb + h0 * p.qsh;
  const __nv_bfloat16* kg = reinterpret_cast<const __nv_bfloat16*>(p.k) + b * p.ksb + h0 * p.ksh;
  const __nv_bfloat16* vg = reinterpret_cast<const __nv_bfloat16*>(p.v) + b * p.vsb + h0 * p.vsh;
  const int ntiles = (p.S + attn::BK - 1) / attn::BK;

  auto load_stage = [&](int slot, int tile) {
    const uint32_t dst = kv_s + slot * 2 * tile_bytes;  // K tile, then V tile
    attn::load_tile_async<attn::BK>(dst, kg, p.ksh, p.kss, tile * attn::BK, p.S, nh, D, NT,
                                    kbs, nthreads);
    attn::load_tile_async<attn::BK>(dst + tile_bytes, vg, p.vsh, p.vss, tile * attn::BK, p.S,
                                    nh, D, NT, kbs, nthreads);
  };

  attn::load_tile_async<attn::QT * attn::BQ>(q_s, qg, p.qsh, p.qss, q0, p.S, nh, D, 2 * KS,
                                             qbs, nthreads);
#pragma unroll
  for (int s = 0; s < attn::STAGES - 1; ++s) {  // Q travels in the first group
    if (s < ntiles) load_stage(s, s);
    cp_async_commit();
  }
  const bool active = hi < nh;  // a ghost head's warpgroup loads and waits only
  const int hcol = hi * D;
  const float sl2 = p.scale * 1.4426950408889634f;
  float o[attn::QT][NT][4], m[attn::QT][2], l[attn::QT][2];
#pragma unroll
  for (int sub = 0; sub < attn::QT; ++sub) {
    m[sub][0] = m[sub][1] = -INFINITY;
    l[sub][0] = l[sub][1] = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) o[sub][j][0] = o[sub][j][1] = o[sub][j][2] = o[sub][j][3] = 0.f;
  }

  for (int tile = 0; tile < ntiles; ++tile) {
    cp_async_wait<attn::STAGES - 2>();  // this tile has landed
    fence_proxy_async();                // and wgmma may read what this thread copied
    __syncthreads();                    // for every thread; the previous tile's slot is free
    if (tile + attn::STAGES - 1 < ntiles)
      load_stage((tile + attn::STAGES - 1) % attn::STAGES, tile + attn::STAGES - 1);
    cp_async_commit();
    if (!active) continue;
    const uint32_t k_s = kv_s + (tile % attn::STAGES) * 2 * tile_bytes;
#pragma unroll
    for (int sub = 0; sub < attn::QT; ++sub) {  // the tile serves every sub-tile of queries
      if (q0 + sub * attn::BQ >= p.S) continue;
      float s[attn::BK / 8][4];
      attn::qk_tile<KS>(s, q_s + (sub * attn::BQ / 8) * qbs + hi * 2 * KS * 128, qbs,
                        k_s + hcol / 8 * 128, kbs, lane, tile * attn::BK, p.S);
      attn::softmax_step<NT>(s, o[sub], m[sub], l[sub], sl2);
      attn::pv_tile<D>(o[sub], s, k_s + tile_bytes, kbs, hcol / 8);
    }
  }
  cp_async_wait<0>();
  if (!active) return;

  const int h = h0 + hi;
  __nv_bfloat16* og = reinterpret_cast<__nv_bfloat16*>(p.o) + b * p.osb + h * p.osh;
  float* lg = p.lse == nullptr ? nullptr : p.lse + ((long long)b * p.H + h) * p.S;
#pragma unroll
  for (int sub = 0; sub < attn::QT; ++sub) {
    const int r0 = q0 + sub * attn::BQ + wq * 16 + (lane >> 2);
    attn::write_output<NT>(o[sub], m[sub], l[sub], og, p.oss, lg, r0, r0 + 8, p.S, lane);
  }
}

// The bf16 launch: what packed_fwd_bf16 is launched with, and what
// c2d_packed_flash_plan reports. A pack above max_pack(D) runs as smaller
// groups (the heads are independent: a smaller group computes the same).
struct Geometry {
  int pack, groups;
  dim3 grid;
  int threads, smem;
};

Geometry geometry_bf16(int B, int H, int S, int D, int pack) {
  if (pack > max_pack(D)) pack = max_pack(D);
  const int groups = (H + pack - 1) / pack, rows = attn::QT * attn::BQ;
  return {pack, groups, dim3((S + rows - 1) / rows, B * groups, 1),
          32 * attn::WARPS_PER_HEAD * pack, attn::smem_bytes(pack, D)};
}

template <int D>
cudaError_t launch_bf16(const Params& p, const Geometry& g, cudaStream_t stream) {
  static int configured = 0;
  if (g.smem > configured) {
    cudaError_t e = cudaFuncSetAttribute(packed_fwd_bf16<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
    if (e != cudaSuccess) return e;
    configured = g.smem;
  }
  packed_fwd_bf16<D><<<g.grid, g.threads, g.smem, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- fp32 path

constexpr int FQ = 16;     // query rows per block
constexpr int FK = 32;     // keys per tile (one per lane in the softmax step)
constexpr int MAX_D = 64;  // the packed route's largest head dim

__global__ void __launch_bounds__(128) packed_fwd_f32(const Params p) {
  __shared__ float q_s[FQ * MAX_D];
  __shared__ float k_s[FK * (MAX_D + 1)];  // odd stride: conflict-free column reads
  __shared__ float v_s[FK * MAX_D];
  __shared__ float o_s[FQ * MAX_D];
  __shared__ float s_s[FQ * FK];
  __shared__ float m_s[FQ], l_s[FQ];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int D = p.D, KS = D + 1;
  const int q0 = blockIdx.x * FQ;
  const int b = blockIdx.y / p.groups, grp = blockIdx.y % p.groups;

  for (int hi = 0; hi < p.pack; ++hi) {
    const int h = grp * p.pack + hi;
    if (h >= p.H) break;
    const float* qg = reinterpret_cast<const float*>(p.q) + b * p.qsb + h * p.qsh;
    const float* kg = reinterpret_cast<const float*>(p.k) + b * p.ksb + h * p.ksh;
    const float* vg = reinterpret_cast<const float*>(p.v) + b * p.vsb + h * p.vsh;
    float* og = reinterpret_cast<float*>(p.o) + b * p.osb + h * p.osh;

    __syncthreads();
    for (int i = tid; i < FQ * D; i += 128) {
      const int r = i / D, c = i % D;
      q_s[i] = q0 + r < p.S ? qg[(long long)(q0 + r) * p.qss + c] : 0.f;
      o_s[i] = 0.f;
    }
    if (tid < FQ) {
      m_s[tid] = -INFINITY;
      l_s[tid] = 0.f;
    }

    for (int pass = 0; pass < 2; ++pass) {
      for (int k0 = 0; k0 < p.S; k0 += FK) {
        __syncthreads();
        for (int i = tid; i < FK * D; i += 128) {
          const int r = i / D, c = i % D;
          const bool ok = k0 + r < p.S;
          k_s[r * KS + c] = ok ? kg[(long long)(k0 + r) * p.kss + c] : 0.f;
          if (pass == 1) v_s[i] = ok ? vg[(long long)(k0 + r) * p.vss + c] : 0.f;
        }
        __syncthreads();
        for (int i = tid; i < FQ * FK; i += 128) {
          const int r = i / FK, j = i % FK;
          float acc = 0.f;
          for (int c = 0; c < D; ++c) acc = fmaf(q_s[r * D + c], k_s[j * KS + c], acc);
          s_s[i] = k0 + j < p.S ? acc * p.scale : -INFINITY;
        }
        __syncthreads();
        for (int r = warp; r < FQ; r += 4) {
          const float x = s_s[r * FK + lane];
          if (pass == 0) {  // running max and sum
            float mx = x;
            for (int off = 16; off > 0; off >>= 1)
              mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
            const float mold = m_s[r];
            const float mn = fmaxf(mold, mx);
            const float base = mn == -INFINITY ? 0.f : mn;
            float sum = expf(x - base);
            for (int off = 16; off > 0; off >>= 1)
              sum += __shfl_xor_sync(0xffffffffu, sum, off);
            __syncwarp();
            if (lane == 0) {
              l_s[r] = l_s[r] * expf(mold - base) + sum;
              m_s[r] = mn;
            }
          } else {  // normalised probability against the final max
            const float base = m_s[r] == -INFINITY ? 0.f : m_s[r];
            s_s[r * FK + lane] = l_s[r] > 0.f ? expf(x - base) * (1.f / l_s[r]) : 0.f;
          }
        }
        if (pass == 1) {
          __syncthreads();
          for (int i = tid; i < FQ * D; i += 128) {
            const int r = i / D, c = i % D;
            float acc = o_s[i];
            for (int j = 0; j < FK; ++j) acc = fmaf(s_s[r * FK + j], v_s[j * D + c], acc);
            o_s[i] = acc;
          }
        }
      }
    }
    __syncthreads();
    for (int i = tid; i < FQ * D; i += 128) {
      const int r = i / D, c = i % D;
      if (q0 + r < p.S) og[(long long)(q0 + r) * p.oss + c] = o_s[i];
    }
    if (p.lse != nullptr && tid < FQ && q0 + tid < p.S)
      p.lse[((long long)b * p.H + h) * p.S + q0 + tid] = m_s[tid] + logf(l_s[tid]);
  }
}

cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  const dim3 grid((p.S + FQ - 1) / FQ, p.B * p.groups, 1);
  packed_fwd_f32<<<grid, 128, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = bf16, 1 = fp32. q, k, v, o are [B, H, S, D] seen through element
// strides (b, h, s); the last dim is contiguous. Self-attention only (Sq ==
// Sk == S). Requires D % 8 == 0, D <= 64, 1 <= pack <= H, 16-byte aligned
// pointers and strides that are multiples of 8 elements (the wrapper
// checks); bf16 runs a pack above max_pack(D) as smaller groups and takes a
// positive scale. ``lse`` is null or an fp32 [B*H, S] buffer for the row
// log-sum-exp.
int c2d_packed_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   float* lse, int dtype, int B, int H, int S, int D,
                                   int pack, long long qsb, long long qsh, long long qss,
                                   long long ksb, long long ksh, long long kss,
                                   long long vsb, long long vsh, long long vss,
                                   long long osb, long long osh, long long oss, float scale,
                                   void* stream) {
  if (D % 8 || D < 8 || D > MAX_D || pack < 1 || pack > H || S < 1)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0 && !(scale > 0.f)) return (int)cudaErrorInvalidValue;  // max on raw logits
  const Geometry g = dtype == 0 ? geometry_bf16(B, H, S, D, pack)
                                : Geometry{pack, (H + pack - 1) / pack, dim3(), 0, 0};
  const Params p{q,   k,   v,   o,   lse, B,   H,   S,   D,   g.pack, g.groups, qsb, qsh,
                 qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss, scale};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 1) return (int)launch_f32(p, st);
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  switch (D) {  // one instance per head dim: the PV product's width is d exactly
    case 8: return (int)launch_bf16<8>(p, g, st);
    case 16: return (int)launch_bf16<16>(p, g, st);
    case 24: return (int)launch_bf16<24>(p, g, st);
    case 32: return (int)launch_bf16<32>(p, g, st);
    case 40: return (int)launch_bf16<40>(p, g, st);
    case 48: return (int)launch_bf16<48>(p, g, st);
    case 56: return (int)launch_bf16<56>(p, g, st);
    default: return (int)launch_bf16<64>(p, g, st);
  }
}

// The geometry c2d_packed_flash_attention_fwd launches the bf16 kernel with
// on these arguments (no launch; host only): out = {heads per block, groups,
// grid.x, grid.y, threads, dynamic shared memory in bytes, query rows per
// block, query sub-tiles, keys per tile, stages}.
int c2d_packed_flash_plan(int B, int H, int S, int D, int pack, int* out) {
  if (D % 8 || D < 8 || D > MAX_D || pack < 1 || pack > H || S < 1 || B < 1)
    return (int)cudaErrorInvalidValue;
  const Geometry g = geometry_bf16(B, H, S, D, pack);
  const int vals[10] = {g.pack,    g.groups, (int)g.grid.x,       (int)g.grid.y, g.threads,
                        g.smem,    attn::QT * attn::BQ, attn::QT, attn::BK,      attn::STAGES};
  for (int i = 0; i < 10; ++i) out[i] = vals[i];
  return 0;
}

const char* c2d_cuda_error_string_packed(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
