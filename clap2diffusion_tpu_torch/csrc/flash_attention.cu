// Flash-attention forward for Hopper (sm_90a), bf16 and fp32.
//
// Replaces the TPU kernel clap2diffusion_tpu/ops/flash_attention.py::_fwd_kernel
// (launched by _flash_fwd_perhead): out = softmax(q k^T * scale) v for each
// (batch, head), with fp32 logits and softmax and the normalisation applied
// after the PV product.
//
// What bounds it on an H100: at the UNet's shapes ([2,8,4096,40],
// [2,8,1024,80]) and the VAE's ([1,1,4096,512]) the work is tensor-core
// operations (4*S*S*d per head against 2*S*d*4 bytes moved) and, at d = 40,
// as much the one exp2 per logit; at [2,8,256,160] it is bytes. The TPU
// kernel kept all of K and V in VMEM; here K+V of one head at 4096x512 bf16
// is 8 MB against 227 KB of shared memory per block, so K and V stream
// through shared memory, and a block that owns few query rows re-reads them
// from L2 too often (a first design with 64 rows a block moved 805 MB a call
// at [2,8,4096,40]). The bf16 design is the tile pipeline of
// attention_core.cuh with one head a block (nh = 1):
//   * d <= 160: a block owns 192 query rows, three 64-row sub-tiles, each on
//     its own warpgroup (384 threads), so that a thread holds one
//     sub-tile's accumulator (d/2 registers: 20, 40, 80 at d = 40, 80, 160);
//     every 64-key K/V tile, loaded once by cp.async into a ring of 3 stages
//     that runs two tiles ahead, serves all three. S = Q K^T on wgmma
//     (m64n64k16, Q and K from shared memory), an online softmax in fp32
//     base 2, O += P V on wgmma with P from registers and V read MN-major
//     from the tile (products of at most 64 columns), the division by the
//     row sum in the epilogue. Head dims that are not an instance (8, 24,
//     56, 72, ...) run on the next instance up, the columns past d zero in
//     shared memory and never stored;
//   * d > 160 (the VAE's 512): a 64-row accumulator of 512 columns does not
//     fit one warpgroup's registers, and splitting the columns across blocks
//     makes each recompute S. A block owns 64 query rows and 4 warpgroups:
//     warpgroup w computes S for keys [16w, 16w + 16) of each 64-key tile at
//     full depth (m64n16k16 x 32), the row maxima meet in shared memory, P
//     (bf16) is written there, and each warpgroup adds P V[:, 128w : 128w +
//     128] to its own 64 accumulator registers (m64n64k16, both operands from
//     shared memory). K and V have one buffer each: the next K loads during
//     the softmax and PV, the next V during the next S;
//   * Sq != Sk and ragged edges are masked (keys past Sk are -inf, rows past
//     Sq are not stored); q, k, v and o are read and written through their
//     (b, h, s) strides, so [B, S, H, D] views of projections are taken in
//     place;
//   * for training, the caller may pass an fp32 [B*H, Sq] buffer for the row
//     log-sum-exp (m + log l of the online softmax, natural log), which the
//     backward (flash_attention_bwd.cu) reads. With a null pointer nothing
//     else changes: serving's outputs are the same bits.
// fp32 inputs take a plain FMA kernel (16 query rows x 32 keys per step,
// everything in shared memory), exact to fp32 rounding; it serves the checks.
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
  float* lse;  // null, or fp32 [B*H, Sq]
  int B, H, Sq, Sk, D;
  long long qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss;
  float scale;
};

// ---------------------------------------------------------------- bf16 path

constexpr int ROWS = attn::QT * attn::BQ;  // query rows of a block, d <= 160
constexpr int NARROW_WG = attn::QT;        // one warpgroup per sub-tile
constexpr int WIDE_D = 512;                // the instance for 160 < d <= 512
constexpr int WIDE_WG = 4;                 // warpgroups of the wide kernel
constexpr int WIDE_COLS = WIDE_D / WIDE_WG;

// The instance a head dim runs on: d itself where the UNet or the VAE has it,
// else the next one up (the columns past d are zeros in shared memory).
__host__ __device__ constexpr int instance_d(int d) {
  return d <= 16 ? 16 : d <= 32 ? 32 : d <= 40 ? 40 : d <= 48 ? 48 : d <= 64 ? 64
       : d <= 80 ? 80 : d <= 96 ? 96 : d <= 128 ? 128 : d <= 160 ? 160 : WIDE_D;
}

// Up to d = 40 the registers of two blocks fit an SM (85 a thread; d = 48
// spilled): six warpgroups there hide each other's softmax behind the tensor
// cores (0.272 -> 0.235 ms at [2,8,4096,40] on an H100).
template <int D>
__global__ void __launch_bounds__(32 * attn::WARPS_PER_HEAD * NARROW_WG, D <= 40 ? 2 : 1)
    flash_fwd_bf16(const Params p) {
  constexpr int NT = D / 8, KS = (D + 15) / 16;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nthreads = blockDim.x;
  const int sub = warp / attn::WARPS_PER_HEAD, wq = warp % attn::WARPS_PER_HEAD;
  const int q0 = blockIdx.x * ROWS;
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int qbs = attn::q_block_stride(1, D), kbs = attn::kv_block_stride(D);
  const int tile_bytes = attn::kv_tile_bytes(D);
  const uint32_t q_s = smem_u32(smem_raw);
  const uint32_t kv_s = q_s + ROWS / 8 * qbs;

  // Zero everything once: Q's columns past d, the K/V columns past d and pad
  // chunks (read under Q's zeros), and the rows past Sq or Sk, which are
  // never copied, must be finite.
  for (int i = tid; i < attn::smem_bytes(1, D) / 16; i += nthreads)
    reinterpret_cast<uint4*>(smem_raw)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  const __nv_bfloat16* qg = reinterpret_cast<const __nv_bfloat16*>(p.q) + b * p.qsb + h * p.qsh;
  const __nv_bfloat16* kg = reinterpret_cast<const __nv_bfloat16*>(p.k) + b * p.ksb + h * p.ksh;
  const __nv_bfloat16* vg = reinterpret_cast<const __nv_bfloat16*>(p.v) + b * p.vsb + h * p.vsh;
  const int ntiles = (p.Sk + attn::BK - 1) / attn::BK;

  auto load_stage = [&](int slot, int tile) {
    const uint32_t dst = kv_s + slot * 2 * tile_bytes;  // K tile, then V tile
    attn::load_tile_async<attn::BK>(dst, kg, 0, p.kss, tile * attn::BK, p.Sk, 1, p.D, NT, kbs,
                                    nthreads);
    attn::load_tile_async<attn::BK>(dst + tile_bytes, vg, 0, p.vss, tile * attn::BK, p.Sk, 1,
                                    p.D, NT, kbs, nthreads);
  };

  attn::load_tile_async<ROWS>(q_s, qg, 0, p.qss, q0, p.Sq, 1, p.D, 2 * KS, qbs, nthreads);
#pragma unroll
  for (int s = 0; s < attn::STAGES - 1; ++s) {  // Q travels in the first group
    if (s < ntiles) load_stage(s, s);
    cp_async_commit();
  }
  const bool active = q0 + sub * attn::BQ < p.Sq;  // else this warpgroup loads and waits only
  const float sl2 = p.scale * 1.4426950408889634f;
  float o[NT][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  for (int tile = 0; tile < ntiles; ++tile) {
    cp_async_wait<attn::STAGES - 2>();  // this tile has landed
    fence_proxy_async();                // and wgmma may read what this thread copied
    __syncthreads();                    // for every thread; the previous tile's slot is free
    if (tile + attn::STAGES - 1 < ntiles)
      load_stage((tile + attn::STAGES - 1) % attn::STAGES, tile + attn::STAGES - 1);
    cp_async_commit();
    if (!active) continue;
    const uint32_t k_s = kv_s + (tile % attn::STAGES) * 2 * tile_bytes;
    float s[attn::BK / 8][4];
    attn::qk_tile<KS>(s, q_s + sub * attn::BQ / 8 * qbs, qbs, k_s, kbs, lane, tile * attn::BK,
                      p.Sk);
    attn::softmax_step<NT>(s, o, m, l, sl2);
    attn::pv_tile<D>(o, s, k_s + tile_bytes, kbs, 0);
  }
  cp_async_wait<0>();
  if (!active) return;
  __nv_bfloat16* og = reinterpret_cast<__nv_bfloat16*>(p.o) + b * p.osb + h * p.osh;
  float* lg = p.lse == nullptr ? nullptr : p.lse + (long long)blockIdx.y * p.Sq;
  const int r0 = q0 + sub * attn::BQ + wq * 16 + (lane >> 2);
  attn::write_output<NT>(o, m, l, og, p.oss, lg, r0, r0 + 8, p.Sq, lane, p.D);
}

// Shared memory of the wide kernel: Q (64 rows), one K and one V tile, P
// (64 x 64 bf16, core matrices) and the warpgroups' row maxima or sums.
constexpr int WIDE_QBS = WIDE_D / 8 * 128;  // bytes of 8 rows of the Q tile
constexpr int WIDE_PBS = attn::BK / 8 * 128;  // bytes of 8 rows of the P tile
__host__ __device__ constexpr int wide_smem_bytes() {
  return attn::BQ / 8 * WIDE_QBS + 2 * attn::BK / 8 * ((WIDE_D / 8 + 1) * 128) +
         attn::BQ / 8 * WIDE_PBS + WIDE_WG * attn::BQ * 4;
}

__global__ void __launch_bounds__(128 * WIDE_WG, 1) flash_fwd_wide_bf16(const Params p) {
  constexpr int KB = 16;                        // keys of S a warpgroup computes per tile
  constexpr int KS = WIDE_D / 16, NT = WIDE_COLS / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nthreads = blockDim.x;
  const int wg = warp / 4, wq = warp % 4, g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * attn::BQ;
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int kbs = attn::kv_block_stride(WIDE_D), tile_bytes = attn::kv_tile_bytes(WIDE_D);
  const uint32_t q_s = smem_u32(smem_raw);
  const uint32_t k_s = q_s + attn::BQ / 8 * WIDE_QBS;
  const uint32_t v_s = k_s + tile_bytes;
  const uint32_t p_s = v_s + tile_bytes;
  float* red = reinterpret_cast<float*>(smem_raw + (p_s - q_s) + attn::BQ / 8 * WIDE_PBS);

  for (int i = tid; i < wide_smem_bytes() / 16; i += nthreads)
    reinterpret_cast<uint4*>(smem_raw)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  const __nv_bfloat16* qg = reinterpret_cast<const __nv_bfloat16*>(p.q) + b * p.qsb + h * p.qsh;
  const __nv_bfloat16* kg = reinterpret_cast<const __nv_bfloat16*>(p.k) + b * p.ksb + h * p.ksh;
  const __nv_bfloat16* vg = reinterpret_cast<const __nv_bfloat16*>(p.v) + b * p.vsb + h * p.vsh;
  const int ntiles = (p.Sk + attn::BK - 1) / attn::BK;
  auto load = [&](uint32_t dst, const __nv_bfloat16* src, long long ss, int tile) {
    attn::load_tile_async<attn::BK>(dst, src, 0, ss, tile * attn::BK, p.Sk, 1, p.D,
                                    WIDE_D / 8, kbs, nthreads);
  };
  // groups: (Q, K0), V0, then K(j+1) and V(j+1) once tile j no longer needs
  // the buffer; an empty group keeps the count where there is no next tile
  attn::load_tile_async<attn::BQ>(q_s, qg, 0, p.qss, q0, p.Sq, 1, p.D, WIDE_D / 8, WIDE_QBS,
                                  nthreads);
  load(k_s, kg, p.kss, 0);
  cp_async_commit();
  load(v_s, vg, p.vss, 0);
  cp_async_commit();

  const float sl2 = p.scale * 1.4426950408889634f;
  const int row0 = wq * 16 + g;  // the thread's rows row0 and row0 + 8 of the 64
  float o[NT][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  for (int tile = 0; tile < ntiles; ++tile) {
    const int k0 = tile * attn::BK;
    cp_async_wait<1>();  // K of this tile has landed
    fence_proxy_async();
    __syncthreads();
    // S for the warpgroup's 16 keys of the tile, at full depth
    float s[KB / 8][4];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      wgmma_ss_n16(&s[0][0], wgmma_desc(q_s + 2 * ks * 128, 128, WIDE_QBS),
                   wgmma_desc(k_s + 2 * wg * kbs + 2 * ks * 128, 128, kbs), ks > 0);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int n = 0; n < KB / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        wgmma_pin(s[n][e]);
        if (k0 + wg * KB + n * 8 + 2 * t + (e & 1) >= p.Sk) s[n][e] = -INFINITY;
      }
    }
    float mx0 = fmaxf(fmaxf(s[0][0], s[0][1]), fmaxf(s[1][0], s[1][1]));
    float mx1 = fmaxf(fmaxf(s[0][2], s[0][3]), fmaxf(s[1][2], s[1][3]));
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    if (t == 0) {
      red[wg * attn::BQ + row0] = mx0;
      red[wg * attn::BQ + row0 + 8] = mx1;
    }
    __syncthreads();  // every warpgroup is done with K and has its maxima out
    if (tile + 1 < ntiles) load(k_s, kg, p.kss, tile + 1);
    cp_async_commit();
    // the row max over the tile's 64 keys, in one order for all warpgroups
    float t0 = red[row0], t1 = red[row0 + 8];
#pragma unroll
    for (int w = 1; w < WIDE_WG; ++w) {
      t0 = fmaxf(t0, red[w * attn::BQ + row0]);
      t1 = fmaxf(t1, red[w * attn::BQ + row0 + 8]);
    }
    const float mn0 = fmaxf(m[0], t0 * sl2), mn1 = fmaxf(m[1], t1 * sl2);
    const float c0 = fast_exp2(m[0] - mn0), c1 = fast_exp2(m[1] - mn1);
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int n = 0; n < KB / 8; ++n) {
      s[n][0] = fast_exp2(fmaf(s[n][0], sl2, -mn0));
      s[n][1] = fast_exp2(fmaf(s[n][1], sl2, -mn0));
      s[n][2] = fast_exp2(fmaf(s[n][2], sl2, -mn1));
      s[n][3] = fast_exp2(fmaf(s[n][3], sl2, -mn1));
      rs0 += s[n][0] + s[n][1];
      rs1 += s[n][2] + s[n][3];
      // P as bf16 pairs into the tile, core matrices [row / 8][key / 8][row % 8]
      const uint32_t col = (2 * wg + n) * 128 + t * 4;
      *reinterpret_cast<uint32_t*>(smem_raw + (p_s - q_s) + row0 / 8 * WIDE_PBS + col +
                                   (row0 % 8) * 16) = pack_bf16(s[n][0], s[n][1]);
      *reinterpret_cast<uint32_t*>(smem_raw + (p_s - q_s) + (row0 + 8) / 8 * WIDE_PBS + col +
                                   (row0 % 8) * 16) = pack_bf16(s[n][2], s[n][3]);
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
    cp_async_wait<1>();  // V of this tile has landed
    fence_proxy_async();  // and P, written by this thread, is visible to wgmma
    __syncthreads();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < attn::BK / 16; ++kk) {
#pragma unroll
      for (int n0 = 0; n0 < WIDE_COLS; n0 += 64)
        wgmma_ss_n64_tnspb(&o[n0 / 8][0], wgmma_desc(p_s + 2 * kk * 128, 128, WIDE_PBS),
                           wgmma_desc(v_s + 2 * kk * kbs + (wg * WIDE_COLS + n0) / 8 * 128, kbs,
                                      128),
                           1);
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) wgmma_pin(o[j][e]);
    }
    __syncthreads();  // every warpgroup is done with V, P and the maxima
    if (tile + 1 < ntiles) load(v_s, vg, p.vss, tile + 1);
    cp_async_commit();
  }
  cp_async_wait<0>();
  // the row sums: each warpgroup's over its keys, then over the warpgroups in order
  attn::quad_sum(l);
  if (t == 0) {
    red[wg * attn::BQ + row0] = l[0];
    red[wg * attn::BQ + row0 + 8] = l[1];
  }
  __syncthreads();
  float lt[2] = {red[row0], red[row0 + 8]};
#pragma unroll
  for (int w = 1; w < WIDE_WG; ++w) {
    lt[0] += red[w * attn::BQ + row0];
    lt[1] += red[w * attn::BQ + row0 + 8];
  }
  __nv_bfloat16* og =
      reinterpret_cast<__nv_bfloat16*>(p.o) + b * p.osb + h * p.osh + wg * WIDE_COLS;
  float* lg = p.lse == nullptr || wg != 0 ? nullptr : p.lse + (long long)blockIdx.y * p.Sq;
  attn::store_rows<NT>(o, m, lt, og, p.oss, lg, q0 + row0, q0 + row0 + 8, p.Sq, lane,
                       p.D - wg * WIDE_COLS);
}

// The bf16 launch: what the kernels are launched with, and what
// c2d_flash_plan reports.
struct Geometry {
  int d;  // the instance
  dim3 grid;
  int threads, smem, rows, sub_tiles, stages, o_regs;
};

Geometry geometry_bf16(int B, int H, int Sq, int D) {
  const int d = instance_d(D);
  if (d == WIDE_D)
    return {d, dim3((Sq + attn::BQ - 1) / attn::BQ, B * H, 1), 128 * WIDE_WG, wide_smem_bytes(),
            attn::BQ, 1, 2, WIDE_COLS / 2};
  return {d, dim3((Sq + ROWS - 1) / ROWS, B * H, 1), 128 * NARROW_WG, attn::smem_bytes(1, d),
          ROWS, attn::QT, attn::STAGES, d / 2};
}

template <int D>
cudaError_t launch_narrow(const Params& p, const Geometry& g, cudaStream_t stream) {
  static int configured = 0;
  if (g.smem > configured) {
    cudaError_t e = cudaFuncSetAttribute(flash_fwd_bf16<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
    if (e != cudaSuccess) return e;
    configured = g.smem;
  }
  flash_fwd_bf16<D><<<g.grid, g.threads, g.smem, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t launch_wide(const Params& p, const Geometry& g, cudaStream_t stream) {
  static int configured = 0;
  if (g.smem > configured) {
    cudaError_t e = cudaFuncSetAttribute(flash_fwd_wide_bf16,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
    if (e != cudaSuccess) return e;
    configured = g.smem;
  }
  flash_fwd_wide_bf16<<<g.grid, g.threads, g.smem, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t launch_bf16(const Params& p, cudaStream_t stream) {
  const Geometry g = geometry_bf16(p.B, p.H, p.Sq, p.D);
  switch (g.d) {  // one instance per width: the PV products are d columns exactly
    case 16: return launch_narrow<16>(p, g, stream);
    case 32: return launch_narrow<32>(p, g, stream);
    case 40: return launch_narrow<40>(p, g, stream);
    case 48: return launch_narrow<48>(p, g, stream);
    case 64: return launch_narrow<64>(p, g, stream);
    case 80: return launch_narrow<80>(p, g, stream);
    case 96: return launch_narrow<96>(p, g, stream);
    case 128: return launch_narrow<128>(p, g, stream);
    case 160: return launch_narrow<160>(p, g, stream);
    default: return launch_wide(p, g, stream);
  }
}

// ---------------------------------------------------------------- fp32 path

constexpr int FQ = 16;  // query rows per block
constexpr int FK = 32;  // keys per tile (one per lane in the softmax step)

__global__ void __launch_bounds__(128) flash_fwd_f32(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int D = p.D, KS = D + 1;  // odd K stride: conflict-free column reads
  float* q_s = reinterpret_cast<float*>(smem_raw);  // [FQ][D]
  float* k_s = q_s + FQ * D;                          // [FK][D+1]
  float* v_s = k_s + FK * KS;                         // [FK][D]
  float* o_s = v_s + FK * D;                          // [FQ][D]
  float* s_s = o_s + FQ * D;                          // [FQ][FK]
  float* m_s = s_s + FQ * FK;
  float* l_s = m_s + FQ;
  float* a_s = l_s + FQ;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * FQ;
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const float* qg = reinterpret_cast<const float*>(p.q) + b * p.qsb + h * p.qsh;
  const float* kg = reinterpret_cast<const float*>(p.k) + b * p.ksb + h * p.ksh;
  const float* vg = reinterpret_cast<const float*>(p.v) + b * p.vsb + h * p.vsh;
  float* og = reinterpret_cast<float*>(p.o) + b * p.osb + h * p.osh;

  for (int i = tid; i < FQ * D; i += 128) {
    const int r = i / D, c = i % D;
    q_s[i] = q0 + r < p.Sq ? qg[(q0 + r) * p.qss + c] : 0.f;
    o_s[i] = 0.f;
  }
  if (tid < FQ) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }

  for (int k0 = 0; k0 < p.Sk; k0 += FK) {
    __syncthreads();
    for (int i = tid; i < FK * D; i += 128) {
      const int r = i / D, c = i % D;
      const bool ok = k0 + r < p.Sk;
      k_s[r * KS + c] = ok ? kg[(k0 + r) * p.kss + c] : 0.f;
      v_s[i] = ok ? vg[(k0 + r) * p.vss + c] : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < FQ * FK; i += 128) {
      const int r = i / FK, j = i % FK;
      float acc = 0.f;
      for (int c = 0; c < D; ++c) acc = fmaf(q_s[r * D + c], k_s[j * KS + c], acc);
      s_s[i] = k0 + j < p.Sk ? acc * p.scale : -INFINITY;
    }
    __syncthreads();
    for (int r = warp; r < FQ; r += 4) {
      const float x = s_s[r * FK + lane];
      float mx = x;
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mold = m_s[r];
      const float mn = fmaxf(mold, mx);
      const float base = mn == -INFINITY ? 0.f : mn;
      const float pe = expf(x - base);
      s_s[r * FK + lane] = pe;
      float sum = pe;
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float al = expf(mold - base);
        a_s[r] = al;
        l_s[r] = l_s[r] * al + sum;
        m_s[r] = mn;
      }
    }
    __syncthreads();
    for (int i = tid; i < FQ * D; i += 128) {
      const int r = i / D, c = i % D;
      float acc = o_s[i] * a_s[r];
      for (int j = 0; j < FK; ++j) acc = fmaf(s_s[r * FK + j], v_s[j * D + c], acc);
      o_s[i] = acc;
    }
  }
  __syncthreads();
  for (int i = tid; i < FQ * D; i += 128) {
    const int r = i / D, c = i % D;
    if (q0 + r < p.Sq) og[(q0 + r) * p.oss + c] = l_s[r] > 0.f ? o_s[i] / l_s[r] : 0.f;
  }
  if (p.lse != nullptr && tid < FQ && q0 + tid < p.Sq)
    p.lse[(long long)blockIdx.y * p.Sq + q0 + tid] = m_s[tid] + logf(l_s[tid]);
}

cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  const size_t smem =
      (size_t)(FQ * p.D + FK * (p.D + 1) + FK * p.D + FQ * p.D + FQ * FK + 3 * FQ) *
      sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.Sq + FQ - 1) / FQ, p.B * p.H, 1);
  flash_fwd_f32<<<grid, 128, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = bf16, 1 = fp32. Strides are in elements; the last dim is
// contiguous. Requires D % 8 == 0, D <= 512, 16-byte aligned pointers and
// strides that are multiples of 8 elements (the wrapper checks); bf16 takes
// a positive scale (the row max is taken on the raw logits). ``lse`` is null
// or an fp32 [B*H, Sq] buffer for the row log-sum-exp.
int c2d_flash_attention_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                            int dtype,
                            int B, int H, int Sq, int Sk, int D, long long qsb, long long qsh,
                            long long qss, long long ksb, long long ksh, long long kss,
                            long long vsb, long long vsh, long long vss, long long osb,
                            long long osh, long long oss, float scale, void* stream) {
  if (D % 8 || D < 8 || D > WIDE_D || Sq < 1 || Sk < 1) return (int)cudaErrorInvalidValue;
  const Params p{q,   k,   v,   o,   lse, B,   H,   Sq,  Sk,  D,   qsb, qsh, qss,
                 ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss, scale};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 1) return (int)launch_f32(p, st);
  if (dtype != 0 || !(scale > 0.f)) return (int)cudaErrorInvalidValue;
  return (int)launch_bf16(p, st);
}

// The geometry c2d_flash_attention_fwd launches the bf16 kernels with on
// these arguments (no launch; host only): out = {instance head dim, grid.x,
// grid.y, threads, dynamic shared memory in bytes, query rows per block,
// query sub-tiles, keys per tile, stages, accumulator registers a thread}.
int c2d_flash_plan(int B, int H, int Sq, int Sk, int D, int* out) {
  if (D % 8 || D < 8 || D > WIDE_D || Sq < 1 || Sk < 1 || B < 1 || H < 1)
    return (int)cudaErrorInvalidValue;
  const Geometry g = geometry_bf16(B, H, Sq, D);
  const int vals[10] = {g.d,       (int)g.grid.x, (int)g.grid.y, g.threads, g.smem,
                        g.rows,    g.sub_tiles,   attn::BK,      g.stages,  g.o_regs};
  for (int i = 0; i < 10; ++i) out[i] = vals[i];
  return 0;
}

const char* c2d_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
