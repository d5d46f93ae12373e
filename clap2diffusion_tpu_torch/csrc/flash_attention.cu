// Flash-attention forward for Hopper (sm_90a), bf16 and fp32.
//
// Replaces the TPU kernel clap2diffusion_tpu/ops/flash_attention.py:51
// _fwd_kernel (launched by _flash_fwd_perhead): out = softmax(q k^T * scale) v
// for each (batch, head), with fp32 logits and softmax and the normalisation
// applied after the PV product. The TPU kernel kept all of K and V in VMEM;
// here K and V stream through shared memory (227 KB a block), and a block
// that owns few query rows re-reads them from L2 too often, so a block owns
// 64 to 192 rows of one head and every K/V tile serves them all.
//
// The narrow heads, instances d <= 80 (the UNet's 40 at 4096 tokens and 80
// at 1024): flash_fwd_ws_bf16. What bounds it on an H100 at d = 40 is not
// the tensor cores alone: a logit costs 4d = 160 FLOPs of products and one
// ex2 (16 a clock on an SM) with the FMA, max, sum and convert around it, so
// at [16,8,4096,40] the exponentials take ~0.58 ms and their issue ~0.4 ms
// against ~0.47 ms of products. A design that runs each warpgroup's softmax
// after its products in lockstep with the others, as the three-warpgroup
// kernel below does, is bound near their sum; this one overlaps them:
//   * warp specialisation: warpgroup 0 is a producer that gives up its
//     registers (setmaxnreg 24); one thread puts Q and then every 128-key K
//     and V tile in flight by TMA (4-d tensor maps over the tensors'
//     strides, so [B, S, H*D] projections are read in place) into a ring of
//     2 stages, each tile on its own full and empty mbarrier. The loop has
//     no __syncthreads();
//   * consumer warpgroups of 64 query rows (three of 160 registers up to
//     d = 64, two of 240 at d = 80): S_j = Q K_j^T (m64n128k16, Q and K
//     from shared memory), then O += P_{j-1} V_{j-1} behind it (P from
//     registers, V read MN-major, products of at most 64 columns), then the
//     online softmax of S_j while that product runs, and the rescale of O
//     once it has landed;
//   * the consumers take turns at issuing their products (named barriers in
//     a ring), so one's exponentials run under another's products;
//   * tiles are 128-byte swizzled (TMA's SWIZZLE_128B, wgmma's 128-byte
//     layout): one copy a tile brings each row's d columns whole, where
//     16-byte columns fetched every 32-byte L2 sector twice; columns past d
//     (to 64) and rows past Sq or Sk arrive as zeros.
// What bounds it now (an H100, [16,8,4096,40]): ~0.81 ms with neither the
// exponentials nor the copies, ~0.99 ms with both: each warpgroup's chain
// of product, wait and softmax, not a unit's peak.
// Arithmetic as in attention_core.cuh's softmax_step: fp32 logits, base 2
// against the running row max, ex2.approx, P rounded to bf16 for PV, the row
// sum in fp32 from the fp32 P, the division in the epilogue; only where the
// key tiles start differs from the 64-key kernels.
//
// 80 < d <= 160 (the UNet's 160 at 256 tokens, where the work is bytes):
// flash_fwd_bf16, the tile pipeline of attention_core.cuh with one head a
// block: 192 query rows, three 64-row sub-tiles on their own warpgroups,
// every 64-key K/V tile loaded once by cp.async into a ring of 3 stages;
// S on wgmma m64n64k16, the softmax, then O += P V.
//
// d > 160 (the VAE's 512): flash_fwd_wide_bf16. A 64-row accumulator of 512
// columns does not fit one warpgroup's registers, and splitting the columns
// across blocks makes each recompute S. A block owns 64 query rows and 4
// warpgroups: warpgroup w computes S for keys [16w, 16w + 16) of each 64-key
// tile at full depth (m64n16k16 x 32), the row maxima meet in shared memory,
// P (bf16) is written there, and each warpgroup adds P V[:, 128w : 128w +
// 128] to its own 64 accumulator registers. K and V have one buffer each.
//
// All three: head dims that are not an instance (8, 24, 56, 72, ...) run on
// the next instance up, the columns past d zero and never stored; Sq != Sk
// and ragged edges are masked (keys past Sk are -inf, rows past Sq are not
// stored); q, k, v and o are read and written through their (b, h, s)
// strides; for training, the caller may pass an fp32 [B*H, Sq] buffer for
// the row log-sum-exp (m + log l, natural log), which the backward
// (flash_attention_bwd.cu) reads. With a null pointer nothing else changes.
// fp32 inputs take a plain FMA kernel (16 query rows x 32 keys per step,
// everything in shared memory), exact to fp32 rounding; it serves the checks.
//
// Every entry returns cudaGetLastError() after its launch; the Python
// wrapper raises when it is not cudaSuccess.

#include <cuda.h>  // CUtensorMap and its encoder's types
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

constexpr int ROWS = attn::QT * attn::BQ;  // query rows of a block, 80 < d <= 160
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

// ------------------------------------------- warp-specialised, d <= 80

constexpr int WS_MAX_D = 80;          // the largest instance it runs
constexpr int WS_BK = 128;            // keys a stage
constexpr int WS_STAGES = 2;          // K and V ring depth (3 measured no faster)
constexpr int WS_PRODUCER_REGS = 24;  // registers a producer thread keeps

// Consumer warpgroups (64 query rows each) and their registers by instance:
// three of 160 up to d = 64 (S, P and O fit), two of 240 at d = 80, where a
// third's would spill; the producer's warpgroup gives up what they take.
__host__ __device__ constexpr int ws_consumers(int d) { return d <= 64 ? 3 : 2; }
__host__ __device__ constexpr int ws_consumer_regs(int d) { return d <= 64 ? 160 : 240; }
// 128-byte swizzled column blocks a tile row spans: 64 columns each.
__host__ __device__ constexpr int ws_atoms(int d) { return (d + 63) / 64; }

// Shared memory: Q, the K ring, the V ring (each tile ws_atoms(d) blocks of
// 128-byte rows), the mbarriers (Q full; K, V full; K, V empty), and 1 KB to
// align the first to the swizzle's atoms.
__host__ __device__ constexpr int ws_smem_bytes(int d) {
  return (64 * ws_consumers(d) + 2 * WS_STAGES * WS_BK) * 128 * ws_atoms(d) +
         8 * (1 + 4 * WS_STAGES) + 1024;
}

static_assert(128 * WS_PRODUCER_REGS + 128 * ws_consumers(64) * ws_consumer_regs(64) <= 65536 &&
                  128 * WS_PRODUCER_REGS + 128 * ws_consumers(80) * ws_consumer_regs(80) <= 65536,
              "the register split must fit the SM");

// What a block reads through TMA: a 4-d map per tensor (d, then its s, h and
// b dims by rising stride) and where s and h sit among coordinates 1-3.
struct WsArgs {
  CUtensorMap tq, tk, tv;
  Params p;
  int order_q, order_k, order_v;  // s's position | h's position << 2
};

// Columns [col, col + 64) of rows [row, row + box) of head (b, h) into shared
// memory at dst, 128-byte swizzled, completing on `bar`; columns past d and
// rows past the tensor's end arrive as zeros.
__device__ __forceinline__ void ws_load(uint32_t dst, const CUtensorMap* map, int order,
                                        uint32_t bar, int col, int row, int h, int b) {
  const int ps = order & 3, ph = order >> 2;
  tma_load_4d(dst, map, bar, col, ps == 0 ? row : ph == 0 ? h : b,
              ps == 1 ? row : ph == 1 ? h : b, ps == 2 ? row : ph == 2 ? h : b);
}

// S = Q K^T for the warpgroup's 64 rows and the tile's 128 keys, started
// and committed: k16 step ks reads 32 bytes of each row of block ks / 4.
template <int KS, int QBLOCK, int KBLOCK>
__device__ __forceinline__ void ws_qk(float s[WS_BK / 8][4], uint32_t q, uint32_t k) {
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const uint32_t off = ks % 4 * 32;
    wgmma_ss_n128(&s[0][0], wgmma_desc_sw128(q + ks / 4 * QBLOCK + off, 16, 1024),
                  wgmma_desc_sw128(k + ks / 4 * KBLOCK + off, 16, 1024), ks > 0);
  }
  wgmma_commit();
}

// O[:, N0 : N0 + N] += P V[:, N0 : N0 + N] for one k16 step (v: its first key's
// row), N = min(64, D - N0): V read MN-major, column block N0 / 64.
template <int D, int KBLOCK, int N0 = 0>
__device__ __forceinline__ void ws_pv_columns(float o[D / 8][4], const uint32_t a[4], uint32_t v) {
  constexpr int N = D - N0 < 64 ? D - N0 : 64;
  wgmma_rs<N>(&o[N0 / 8][0], a, wgmma_desc_sw128(v + N0 / 64 * KBLOCK, KBLOCK, 1024), 1);
  if constexpr (N0 + 64 < D) ws_pv_columns<D, KBLOCK, N0 + 64>(o, a, v);
}

// O += P V for the tile's 128 keys, P bf16 from registers; started and committed.
template <int D, int KBLOCK>
__device__ __forceinline__ void ws_pv(float o[D / 8][4], const uint32_t pf[WS_BK / 16][4],
                                      uint32_t v) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < WS_BK / 16; ++kk) ws_pv_columns<D, KBLOCK>(o, pf[kk], v + kk * 16 * 128);
  wgmma_commit();
}

// softmax_step's arithmetic without the rescale of O, which the caller
// applies once the PV product in flight has landed: s becomes p = 2^(s * sl2
// - m), the running max m and the thread's partial row sums l move on, and
// the factors for O are returned.
__device__ __forceinline__ float2 ws_softmax(float s[WS_BK / 8][4], float m[2], float l[2],
                                             float sl2) {
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int n = 0; n < WS_BK / 8; ++n) {
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
  for (int n = 0; n < WS_BK / 8; ++n) {
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
  return make_float2(c0, c1);
}

// One block: 64 query rows a consumer, of one head. Warpgroup 0 is the
// producer: its first thread puts Q and then every 128-key K and V tile in
// flight by TMA into a ring, each tile awaited on its own full barrier and
// reused once every consumer warp has released it. The consumers: S_j = Q
// K_j^T, then O += P_{j-1} V_{j-1} behind it, then the softmax of S_j while
// that product runs; they take turns at issuing their products (named
// barriers 1.., a ring), so one's exponentials run under another's products.
template <int D>
__global__ void __launch_bounds__(128 * (1 + ws_consumers(D)), 1)
    flash_fwd_ws_bf16(const __grid_constant__ WsArgs a) {
  constexpr int CONSUMERS = ws_consumers(D), STAGES = WS_STAGES, ATOMS = ws_atoms(D);
  constexpr int ROWS = 64 * CONSUMERS, KS = (D + 15) / 16, NT = D / 8;
  constexpr int QBLOCK = ROWS * 128, KBLOCK = WS_BK * 128;  // bytes of a 64-column block
  constexpr int TILE = ATOMS * KBLOCK;                        // bytes of a K or V tile
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const Params& p = a.p;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int q0 = blockIdx.x * ROWS;
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int ntiles = (p.Sk + WS_BK - 1) / WS_BK;
  const uint32_t q_s = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t k_s = q_s + ATOMS * QBLOCK, v_s = k_s + STAGES * TILE;
  const uint32_t q_full = v_s + STAGES * TILE;
  auto k_full = [&](int st) { return q_full + 8 * (1 + st); };
  auto v_full = [&](int st) { return q_full + 8 * (1 + STAGES + st); };
  auto k_empty = [&](int st) { return q_full + 8 * (1 + 2 * STAGES + st); };
  auto v_empty = [&](int st) { return q_full + 8 * (1 + 3 * STAGES + st); };

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(k_empty(st), 4 * CONSUMERS);  // one arrival a consumer warp
      mbar_init(v_empty(st), 4 * CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    setmaxnreg_dec<WS_PRODUCER_REGS>();
    if (tid == 0) {
      mbar_arrive_expect_tx(q_full, ATOMS * QBLOCK);  // TMA counts the zeros it fills
      for (int at = 0; at < ATOMS; ++at)
        ws_load(q_s + at * QBLOCK, &a.tq, a.order_q, q_full, 64 * at, q0, h, b);
      for (int t = 0; t < ntiles; ++t) {
        const int st = t % STAGES;
        const uint32_t parity = ((t / STAGES) & 1) ^ 1;  // a fresh barrier passes at once
        mbar_wait(k_empty(st), parity);
        mbar_arrive_expect_tx(k_full(st), TILE);
        for (int at = 0; at < ATOMS; ++at)
          ws_load(k_s + st * TILE + at * KBLOCK, &a.tk, a.order_k, k_full(st), 64 * at,
                  t * WS_BK, h, b);
        mbar_wait(v_empty(st), parity);
        mbar_arrive_expect_tx(v_full(st), TILE);
        for (int at = 0; at < ATOMS; ++at)
          ws_load(v_s + st * TILE + at * KBLOCK, &a.tv, a.order_v, v_full(st), 64 * at,
                  t * WS_BK, h, b);
      }
    }
    return;
  }

  setmaxnreg_inc<ws_consumer_regs(D)>();
  const int c = wg - 1, lane = tid & 31, warp = (tid >> 5) & 3;
  // named barriers 1..CONSUMERS: whose turn at the tensor cores, in a ring
  const int mine = 1 + c, next = 1 + (c + 1) % CONSUMERS;
  const bool last = c == CONSUMERS - 1;
  const uint32_t q = q_s + c * 64 * 128;
  const float sl2 = p.scale * 1.4426950408889634f;
  float o[NT][4], s[WS_BK / 8][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  uint32_t pf[WS_BK / 16][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  // after the wait that lands S_t: K_t is free, keys past Sk (zeros) -> -inf
  auto landed = [&](int t) {
#pragma unroll
    for (int n = 0; n < WS_BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) wgmma_pin(s[n][e]);
    }
    if (lane == 0) mbar_arrive(k_empty(t % STAGES));
    if ((t + 1) * WS_BK > p.Sk) {  // only the last tile
#pragma unroll
      for (int n = 0; n < WS_BK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (t * WS_BK + n * 8 + 2 * (lane & 3) + (e & 1) >= p.Sk) s[n][e] = -INFINITY;
      }
    }
  };
  // after the wait that lands P_{t} V_{t}: O and P are this thread's again, V_t is free
  auto pv_landed = [&](int t) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) wgmma_pin(o[j][e]);
    }
#pragma unroll
    for (int kk = 0; kk < WS_BK / 16; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) wgmma_pin(pf[kk][e]);
    }
    if (lane == 0) mbar_arrive(v_empty(t % STAGES));
  };
  auto rescale_and_pack = [&](float2 cf) {  // O by the new max; P to bf16 A fragments
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      o[j][0] *= cf.x;
      o[j][1] *= cf.x;
      o[j][2] *= cf.y;
      o[j][3] *= cf.y;
    }
#pragma unroll
    for (int kk = 0; kk < WS_BK / 16; ++kk) {
      pf[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pf[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pf[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pf[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }
  };

  if (last) named_bar_arrive(1, 256);  // the first consumer takes the first turn
  mbar_wait(q_full, 0);
  mbar_wait(k_full(0), 0);
  named_bar_sync(mine, 256);
  ws_qk<KS, QBLOCK, KBLOCK>(s, q, k_s);
  if (!last || ntiles > 1) named_bar_arrive(next, 256);  // the turns pair up
  wgmma_wait<0>();
  landed(0);
  rescale_and_pack(ws_softmax(s, m, l, sl2));
  for (int t = 1; t < ntiles; ++t) {
    const int st = t % STAGES, sp = (t - 1) % STAGES;
    mbar_wait(k_full(st), (t / STAGES) & 1);
    named_bar_sync(mine, 256);
    ws_qk<KS, QBLOCK, KBLOCK>(s, q, k_s + st * TILE);
    mbar_wait(v_full(sp), ((t - 1) / STAGES) & 1);
    ws_pv<D, KBLOCK>(o, pf, v_s + sp * TILE);
    if (!last || t + 1 < ntiles) named_bar_arrive(next, 256);
    wgmma_wait<1>();  // S_t has landed; P_{t-1} V_{t-1} runs on
    landed(t);
    const float2 cf = ws_softmax(s, m, l, sl2);
    wgmma_wait<0>();
    pv_landed(t - 1);
    rescale_and_pack(cf);
  }
  const int sp = (ntiles - 1) % STAGES;
  mbar_wait(v_full(sp), ((ntiles - 1) / STAGES) & 1);
  ws_pv<D, KBLOCK>(o, pf, v_s + sp * TILE);
  wgmma_wait<0>();
  pv_landed(ntiles - 1);
  __nv_bfloat16* og = reinterpret_cast<__nv_bfloat16*>(p.o) + b * p.osb + h * p.osh;
  float* lg = p.lse == nullptr ? nullptr : p.lse + (long long)blockIdx.y * p.Sq;
  const int r0 = q0 + c * 64 + warp * 16 + (lane >> 2);
  attn::write_output<NT>(o, m, l, og, p.oss, lg, r0, r0 + 8, p.Sq, lane, p.D);
}

// ------------------------------------------------- three warpgroups, 80 < d <= 160

template <int D>
__global__ void __launch_bounds__(32 * attn::WARPS_PER_HEAD * NARROW_WG, 1)
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
enum Design { DESIGN_WS = 0, DESIGN_NARROW = 1, DESIGN_WIDE = 2 };

struct Geometry {
  int design, d;  // the kernel, and its instance
  dim3 grid;
  int threads, smem, rows, sub_tiles, bk, stages, o_regs, consumers;
};

Geometry geometry_bf16(int B, int H, int Sq, int D) {
  const int d = instance_d(D);
  if (d <= WS_MAX_D) {
    const int cons = ws_consumers(d), rows = 64 * cons;
    return {DESIGN_WS, d, dim3((Sq + rows - 1) / rows, B * H, 1), 128 * (1 + cons),
            ws_smem_bytes(d), rows, cons, WS_BK, WS_STAGES, d / 2, cons};
  }
  if (d == WIDE_D)
    return {DESIGN_WIDE, d, dim3((Sq + attn::BQ - 1) / attn::BQ, B * H, 1), 128 * WIDE_WG,
            wide_smem_bytes(), attn::BQ, 1, attn::BK, 2, WIDE_COLS / 2, WIDE_WG};
  return {DESIGN_NARROW, d, dim3((Sq + ROWS - 1) / ROWS, B * H, 1), 128 * NARROW_WG,
          attn::smem_bytes(1, d), ROWS, attn::QT, attn::BK, attn::STAGES, d / 2, NARROW_WG};
}

// The driver's tensor-map encoder, looked up once through the runtime (no
// link against libcuda).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                                     cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault,
                                            &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// The 4-d map of a bf16 [B, H, S, D] tensor (strides in elements, the last
// dim contiguous) whose box is 64 columns of `box_rows` rows of one head,
// 128-byte swizzled: d, then s, h and b by rising stride, a dim of size 1
// outermost (its stride is never used). `order` gets s's and h's positions
// among coordinates 1-3.
cudaError_t encode_map(CUtensorMap* map, int* order, const void* base, int B, int H, int S,
                       int D, long long sb, long long sh, long long ss, int box_rows) {
  EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  long long size[3] = {S, H, B}, stride[3] = {ss, sh, sb};
  int dim[3] = {0, 1, 2};  // s, h, b, to be sorted
  for (int i = 1; i < 3; ++i)
    for (int j = i; j > 0; --j) {
      const int x = dim[j - 1], y = dim[j];
      const bool swap = size[x] == 1 ? size[y] != 1 : size[y] != 1 && stride[y] < stride[x];
      if (!swap) break;
      dim[j - 1] = y;
      dim[j] = x;
    }
  cuuint64_t gdim[4] = {(cuuint64_t)D, 0, 0, 0}, gstride[3];
  cuuint32_t box[4] = {64, 1, 1, 1}, estride[4] = {1, 1, 1, 1};
  long long extent = D;  // elements spanned by the dims so far
  for (int i = 0; i < 3; ++i) {
    const int x = dim[i];
    const long long st = size[x] == 1 ? extent : stride[x];
    if (st <= 0 || st % 8) return cudaErrorInvalidValue;
    gdim[i + 1] = (cuuint64_t)size[x];
    gstride[i] = (cuuint64_t)st * 2;
    box[i + 1] = x == 0 ? box_rows : 1;
    extent = st * size[x] > extent ? st * size[x] : extent;
    if (x == 0) order[0] = i;
    if (x == 1) order[1] = i;
  }
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                            gdim, gstride, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D>
cudaError_t launch_ws(const Params& p, const Geometry& g, cudaStream_t stream) {
  static int configured = 0;
  if (g.smem > configured) {
    cudaError_t e = cudaFuncSetAttribute(flash_fwd_ws_bf16<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
    if (e != cudaSuccess) return e;
    configured = g.smem;
  }
  WsArgs a;
  a.p = p;
  int oq[2], ok[2], ov[2];
  cudaError_t e = encode_map(&a.tq, oq, p.q, p.B, p.H, p.Sq, p.D, p.qsb, p.qsh, p.qss, g.rows);
  if (e == cudaSuccess)
    e = encode_map(&a.tk, ok, p.k, p.B, p.H, p.Sk, p.D, p.ksb, p.ksh, p.kss, WS_BK);
  if (e == cudaSuccess)
    e = encode_map(&a.tv, ov, p.v, p.B, p.H, p.Sk, p.D, p.vsb, p.vsh, p.vss, WS_BK);
  if (e != cudaSuccess) return e;
  a.order_q = oq[0] | oq[1] << 2;
  a.order_k = ok[0] | ok[1] << 2;
  a.order_v = ov[0] | ov[1] << 2;
  flash_fwd_ws_bf16<D><<<g.grid, g.threads, g.smem, stream>>>(a);
  return cudaGetLastError();
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
    case 16: return launch_ws<16>(p, g, stream);
    case 32: return launch_ws<32>(p, g, stream);
    case 40: return launch_ws<40>(p, g, stream);
    case 48: return launch_ws<48>(p, g, stream);
    case 64: return launch_ws<64>(p, g, stream);
    case 80: return launch_ws<80>(p, g, stream);
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
// query sub-tiles, keys per tile, stages, accumulator registers a thread,
// design (0 warp-specialised, 1 narrow, 2 wide), warpgroups that compute}.
int c2d_flash_plan(int B, int H, int Sq, int Sk, int D, int* out) {
  if (D % 8 || D < 8 || D > WIDE_D || Sq < 1 || Sk < 1 || B < 1 || H < 1)
    return (int)cudaErrorInvalidValue;
  const Geometry g = geometry_bf16(B, H, Sq, D);
  const int vals[12] = {g.d,    (int)g.grid.x, (int)g.grid.y, g.threads, g.smem,   g.rows,
                        g.sub_tiles, g.bk,     g.stages,      g.o_regs,  g.design, g.consumers};
  for (int i = 0; i < 12; ++i) out[i] = vals[i];
  return 0;
}

const char* c2d_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
