// Winograd F(2x2, 3x3) convolution for Hopper (sm_90a), bf16 and fp32.
//
// Replaces the TPU kernel clap2diffusion_tpu/ops/winograd_pallas.py::_kernel
// (launched by conv3x3_winograd_pallas): an NHWC 3x3, stride-1, SAME conv in
// which each 2x2 output tile is
//   V[i][j] = sum_pq BT[i,p] BT[j,q] d[p][q]   (d: the tile's 4x4 input patch,
//                                              fp32, adds only; cast to x's type)
//   M[4i+j] = V[4i+j] . U[4i+j]                (16 products over Cin, fp32 sums)
//   Y[a][b] = sum_ij AT[a,i] AT[b,j] M[4i+j]   (adds only)
// with U = G w G^T (fp32, cast once to x's type). The result is cast to x's
// type and the bias is added after that cast, in x's type, as the TPU
// kernel's wrapper does.
//
// What bounds it on an H100. The UNet's 3x3 convs fall into two regimes.
// With many tiles (32x32 and 64x64 images) the 16 products are
// 8*B*H*W*Cin*Cout tensor-core operations against little data. With few
// tiles and large weights (8x8 and 16x16 images, Cin and Cout 1280-2560)
// the bound is the weight bytes: every SM has to pull its share of U at
// full width. The TPU kernel held a whole image in VMEM and walked its grid
// in order; here neither holds, and the design is:
//   * wino_filter: U = G w G^T in one pass over the HWIO weights (9 reads,
//     16 writes per (Cin, Cout) pair, 16 bytes a thread), as [16][Cin][Cout],
//     so no transpose is needed: the products read it through
//     ldmatrix.trans. The same sums in the same order as the step-by-step
//     plain version (filter_transform_steps in ops/winograd_pallas.py);
//   * wino_input_bf16: the input transform once per patch, for all output
//     channels: one thread per (tile, 8 channels) reads the 4x4 patch as
//     16-byte loads (SAME padding masked), runs BT in fp32 registers in
//     the TPU's order (the same bits as the plain version) and writes
//     V[16][tiles][Cin] in bf16 to a scratch buffer the wrapper allocates
//     (it stays in the 50 MB L2 at the UNet's shapes);
//   * wino_gemm_bf16: 16 products per block tile of 64 tiles x 64 output
//     channels, 8 warps (4 x 2, each 16 tiles x 32 channels), Cin walked in
//     steps of 16 through a ring of 3 shared-memory stages (64 KB each: the
//     16 V and the 16 U slices) that cp.async fills two steps ahead of the
//     products; fragments come from ldmatrix (V) and ldmatrix.trans (U) on
//     XOR-swizzled rows, free of bank conflicts; the products run on
//     mma.sync.m16n8k16 with fp32 sums. The output transform is linear, so
//     no M[16] buffer is kept: the column half of AT is applied as the
//     products accumulate, R[i][b] = sum_j AT[b,j] M[4i+j], by issuing each
//     product into R[i][0] and/or R[i][1] with the V fragment negated where
//     the coefficient is -1 (24 products into 8 accumulators, 128 registers,
//     where 16 into 16 would halve the warp tile and double the shared-memory
//     reads per product); the row half runs once in the epilogue;
//   * where tiles x Cout give fewer blocks than the card has SMs, the Cin
//     loop is split across blockIdx.z (the launch plan of the wrapper
//     chooses the split); each split writes its fp32 partial of Y and
//     wino_reduce_bf16 sums the partials in a fixed order, casts and adds
//     the bias: no atomics, so two launches give the same bits.
// fp32 inputs take one FMA kernel (32 tiles x 64 channels per block of 8
// warps, 8 input channels per step, the input transform fused), exact to
// fp32 rounding; it serves the fp32 checks only.
//
// Every entry returns cudaGetLastError() after its launches; the Python
// wrapper raises when it is not cudaSuccess.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ptx.cuh"

namespace {

using namespace c2d;

struct Params {
  const void* x;     // [B, H, W, Cin], contiguous
  const void* u;     // [16, Cin, Cout], contiguous, x's type
  const void* bias;  // [Cout] in x's type, or null
  void* y;           // [B, H, W, Cout], contiguous
  void* v;           // bf16 scratch [16, tiles, Cin] (bf16 path)
  float* partial;    // fp32 scratch [split, B*H*W, Cout] when split > 1
  int B, H, W, Cin, Cout, TH, TW, tiles, split;
};

// BT = [[1,0,-1,0],[0,1,1,0],[0,-1,1,0],[0,1,0,-1]], applied as the TPU
// kernel's _bt_rows: the same adds in the same order, so V has the same bits.
template <typename T>
__device__ __forceinline__ void bt_rows(const T in[4], T out[4]) {
  out[0] = in[0] - in[2];
  out[1] = in[1] + in[2];
  out[2] = in[2] - in[1];
  out[3] = in[1] - in[3];
}

// V[4i+j] of one tile's patch d[p][q] (p the row, q the column offset).
__device__ __forceinline__ void input_transform(const float d[4][4], float v[16]) {
  float t[4][4];  // t[q][i] = sum_p BT[i,p] d[p][q]
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float col[4] = {d[0][q], d[1][q], d[2][q], d[3][q]};
    bt_rows(col, t[q]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float row[4] = {t[0][i], t[1][i], t[2][i], t[3][i]};
    float vi[4];
    bt_rows(row, vi);
#pragma unroll
    for (int j = 0; j < 4; ++j) v[4 * i + j] = vi[j];
  }
}

// Tile index -> (image, tile row, tile column).
__device__ __forceinline__ void tile_coords(const Params& p, int tile, int& b, int& tr,
                                            int& tc) {
  b = tile / (p.TH * p.TW);
  const int rem = tile % (p.TH * p.TW);
  tr = rem / p.TW;
  tc = rem % p.TW;
}

__device__ __forceinline__ long long pixel(const Params& p, int b, int yy, int xx) {
  return ((long long)b * p.H + yy) * p.W + xx;
}

// ------------------------------------------------------- filter transform

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float o[8]) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const float2 a = unpack_bf16(r.x), b = unpack_bf16(r.y), c = unpack_bf16(r.z),
               d = unpack_bf16(r.w);
  o[0] = a.x, o[1] = a.y, o[2] = b.x, o[3] = b.y, o[4] = c.x, o[5] = c.y, o[6] = d.x, o[7] = d.y;
}

__device__ __forceinline__ void load8(const float* p, float o[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0], b = reinterpret_cast<const float4*>(p)[1];
  o[0] = a.x, o[1] = a.y, o[2] = a.z, o[3] = a.w, o[4] = b.x, o[5] = b.y, o[6] = b.z, o[7] = b.w;
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float o[8]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(pack_bf16(o[0], o[1]), pack_bf16(o[2], o[3]),
                                            pack_bf16(o[4], o[5]), pack_bf16(o[6], o[7]));
}

__device__ __forceinline__ void store8(float* p, const float o[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(o[0], o[1], o[2], o[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(o[4], o[5], o[6], o[7]);
}

// G = [[1,0,0],[.5,.5,.5],[.5,-.5,.5],[0,0,1]]; one row of G applied to
// three values, the sum taken left to right in fp32.
__device__ __forceinline__ void g_rows(float a, float b, float c, float out[4]) {
  out[0] = a;
  out[1] = 0.5f * ((a + b) + c);
  out[2] = 0.5f * ((a - b) + c);
  out[3] = c;
}

// U[4i+j][ci][co] = sum_pq G[i,p] G[j,q] w[p][q][ci][co]: one thread per
// (ci, 8 output channels), w HWIO [3, 3, Cin, Cout].
template <typename TI, typename TO>
__global__ void __launch_bounds__(128) wino_filter(const TI* __restrict__ w, TO* __restrict__ u,
                                                   int Cin, int Cout) {
  const int chunks = Cout / 8;
  const long long idx = (long long)blockIdx.x * 128 + threadIdx.x;
  if (idx >= (long long)Cin * chunks) return;
  const int ci = (int)(idx / chunks), c8 = (int)(idx % chunks);
  float wv[9][8];
#pragma unroll
  for (int pq = 0; pq < 9; ++pq) load8(w + ((long long)pq * Cin + ci) * Cout + c8 * 8, wv[pq]);
  float out[16][8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    float t[3][4];  // t[q][i] = sum_p G[i,p] w[p][q]
#pragma unroll
    for (int q = 0; q < 3; ++q) g_rows(wv[q][e], wv[3 + q][e], wv[6 + q][e], t[q]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float ui[4];
      g_rows(t[0][i], t[1][i], t[2][i], ui);
#pragma unroll
      for (int j = 0; j < 4; ++j) out[4 * i + j][e] = ui[j];
    }
  }
#pragma unroll
  for (int n = 0; n < 16; ++n) store8(u + ((long long)n * Cin + ci) * Cout + c8 * 8, out[n]);
}

// ---------------------------------------------------------------- bf16 path

constexpr int TM = 64;      // tiles per block, 16 per warp row
constexpr int TN = 64;      // output channels per block, 32 per warp column
constexpr int KC = 16;      // input channels per step (one mma depth)
constexpr int STAGES = 3;   // shared-memory ring
constexpr int GEMM_THREADS = 256;
constexpr int V_STAGE = 16 * TM * KC * 2;  // bytes: [16][TM] rows of 32 bytes
constexpr int U_STAGE = 16 * KC * TN * 2;  // bytes: [16][KC] rows of 128 bytes
constexpr int STAGE_BYTES = V_STAGE + U_STAGE;

// V[16][tiles][Cin] (bf16) from x: one thread per (tile, 8 channels).
__global__ void __launch_bounds__(128) wino_input_bf16(const Params p) {
  const int chunks = p.Cin / 8;
  const long long idx = (long long)blockIdx.x * 128 + threadIdx.x;
  if (idx >= (long long)p.tiles * chunks) return;
  const int tile = (int)(idx / chunks), c8 = (int)(idx % chunks);
  const __nv_bfloat16* x = reinterpret_cast<const __nv_bfloat16*>(p.x);
  __nv_bfloat16* v = reinterpret_cast<__nv_bfloat16*>(p.v);
  int b, tr, tc;
  tile_coords(p, tile, b, tr, tc);
  uint32_t d[16][4];
#pragma unroll
  for (int py = 0; py < 4; ++py) {
#pragma unroll
    for (int px = 0; px < 4; ++px) {
      const int yy = 2 * tr + py - 1, xx = 2 * tc + px - 1;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (yy >= 0 && yy < p.H && xx >= 0 && xx < p.W)
        val = *reinterpret_cast<const uint4*>(x + pixel(p, b, yy, xx) * p.Cin + c8 * 8);
      d[py * 4 + px][0] = val.x, d[py * 4 + px][1] = val.y;
      d[py * 4 + px][2] = val.z, d[py * 4 + px][3] = val.w;
    }
  }
  uint32_t out[16][4];
#pragma unroll
  for (int pr = 0; pr < 4; ++pr) {  // channel pairs 2pr, 2pr+1 of the 8
    float d0[4][4], d1[4][4];
#pragma unroll
    for (int py = 0; py < 4; ++py) {
#pragma unroll
      for (int px = 0; px < 4; ++px) {
        const float2 f = unpack_bf16(d[py * 4 + px][pr]);
        d0[py][px] = f.x;
        d1[py][px] = f.y;
      }
    }
    float v0[16], v1[16];
    input_transform(d0, v0);
    input_transform(d1, v1);
#pragma unroll
    for (int n = 0; n < 16; ++n) out[n][pr] = pack_bf16(v0[n], v1[n]);
  }
#pragma unroll
  for (int n = 0; n < 16; ++n)
    *reinterpret_cast<uint4*>(v + ((long long)n * p.tiles + tile) * p.Cin + c8 * 8) =
        make_uint4(out[n][0], out[n][1], out[n][2], out[n][3]);
}

// Byte offsets inside a stage. V rows are 32 bytes (two 16-byte chunks), U
// rows 128 bytes (eight chunks); the chunk index is XOR-ed with row bits so
// that the 8 rows of one ldmatrix phase fall into 8 different bank groups.
__device__ __forceinline__ int v_off(int n, int row, int c) {
  return (((n * TM + row) * 2 + (c ^ ((row >> 2) & 1))) << 4);
}

__device__ __forceinline__ int u_off(int n, int k, int c) {
  return V_STAGE + (((n * KC + k) * 8 + (c ^ (k & 7))) << 4);
}

__global__ void __launch_bounds__(GEMM_THREADS, 1) wino_gemm_bf16(const Params p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t smem = smem_u32(smem_raw);
  const __nv_bfloat16* v = reinterpret_cast<const __nv_bfloat16*>(p.v);
  const __nv_bfloat16* u = reinterpret_cast<const __nv_bfloat16*>(p.u);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;
  const int tile0 = blockIdx.x * TM, co0 = blockIdx.y * TN;
  const int steps = p.Cin / KC;
  const int s_begin = (int)((long long)blockIdx.z * steps / p.split);
  const int s_end = (int)((long long)(blockIdx.z + 1) * steps / p.split);
  const int nsteps = s_end - s_begin;

  // One stage: the 16 V slices [TM][KC] and the 16 U slices [KC][TN] of
  // input channels [k0, k0 + KC); rows past the last tile and channels past
  // Cout are zero-filled.
  auto load_stage = [&](int slot, int step) {
    const int k0 = (s_begin + step) * KC;
    const uint32_t base = smem + slot * STAGE_BYTES;
#pragma unroll
    for (int it = 0; it < 16 * TM * 2 / GEMM_THREADS; ++it) {
      const int i = tid + it * GEMM_THREADS;
      const int n = i / (TM * 2), row = (i % (TM * 2)) >> 1, c = i & 1;
      const bool ok = tile0 + row < p.tiles;
      const __nv_bfloat16* src =
          v + ((long long)n * p.tiles + (ok ? tile0 + row : 0)) * p.Cin + k0 + c * 8;
      cp_async16(base + v_off(n, row, c), src, ok);
    }
#pragma unroll
    for (int it = 0; it < 16 * KC * 8 / GEMM_THREADS; ++it) {
      const int i = tid + it * GEMM_THREADS;
      const int n = i / (KC * 8), k = (i % (KC * 8)) >> 3, c = i & 7;
      const bool ok = co0 + c * 8 < p.Cout;
      const __nv_bfloat16* src =
          u + ((long long)n * p.Cin + k0 + k) * p.Cout + (ok ? co0 + c * 8 : 0);
      cp_async16(base + u_off(n, k, c), src, ok);
    }
  };

  // R[i][b][n8 sub-tile][fragment]: R[i][b] = sum_j AT[b,j] M[4i+j]
  float r[4][2][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int s = 0; s < 4; ++s) r[i][b][s][0] = r[i][b][s][1] = r[i][b][s][2] = r[i][b][s][3] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nsteps) load_stage(s, s);
    cp_async_commit();
  }

  const int a_row = wm * 16 + (lane & 15), a_c = lane >> 4;
  const int b_k = lane & 15, b_c = wn * 4 + (lane >> 4);

  for (int step = 0; step < nsteps; ++step) {
    cp_async_wait<STAGES - 2>();  // this step's stage has landed
    __syncthreads();              // for every thread; the previous step's slot is free
    if (step + STAGES - 1 < nsteps) load_stage((step + STAGES - 1) % STAGES, step + STAGES - 1);
    cp_async_commit();
    const uint32_t base = smem + (step % STAGES) * STAGE_BYTES;

#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = 4 * i + j;
        uint32_t a[4];
        ldmatrix_x4(a, base + v_off(n, a_row, a_c));
        const uint32_t an[4] = {a[0] ^ 0x80008000u, a[1] ^ 0x80008000u, a[2] ^ 0x80008000u,
                                a[3] ^ 0x80008000u};
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          uint32_t bq[4];  // (b0, b1) of sub-tiles 2*half and 2*half + 1
          ldmatrix_x4_trans(bq, base + u_off(n, b_k, b_c + 2 * half));
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int s = 2 * half + q;
            // AT = [[1,1,1,0],[0,1,-1,-1]]
            if (j < 3) mma_bf16(r[i][0][s], a, bq[2 * q], bq[2 * q + 1]);
            if (j == 1) mma_bf16(r[i][1][s], a, bq[2 * q], bq[2 * q + 1]);
            if (j >= 2) mma_bf16(r[i][1][s], an, bq[2 * q], bq[2 * q + 1]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  const __nv_bfloat16* bias = reinterpret_cast<const __nv_bfloat16*>(p.bias);
  __nv_bfloat16* y = reinterpret_cast<__nv_bfloat16*>(p.y);
  const long long npix = (long long)p.B * p.H * p.W;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int col = co0 + wn * 32 + s * 8 + 2 * t;  // even; Cout % 8 == 0
    if (col >= p.Cout) continue;
    float2 bv = make_float2(0.f, 0.f);
    if (bias != nullptr) bv = unpack_bf16(*reinterpret_cast<const uint32_t*>(bias + col));
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int tile = tile0 + wm * 16 + g + 8 * half;
      if (tile >= p.tiles) continue;
      int b, tr, tc;
      tile_coords(p, tile, b, tr, tc);
      const int e = 2 * half;
#pragma unroll
      for (int a = 0; a < 2; ++a) {
#pragma unroll
        for (int bc = 0; bc < 2; ++bc) {
          float y0, y1;  // Y[a][bc] = sum_i AT[a,i] R[i][bc]
          if (a == 0) {
            y0 = r[0][bc][s][e] + r[1][bc][s][e] + r[2][bc][s][e];
            y1 = r[0][bc][s][e + 1] + r[1][bc][s][e + 1] + r[2][bc][s][e + 1];
          } else {
            y0 = r[1][bc][s][e] - r[2][bc][s][e] - r[3][bc][s][e];
            y1 = r[1][bc][s][e + 1] - r[2][bc][s][e + 1] - r[3][bc][s][e + 1];
          }
          const long long at = pixel(p, b, 2 * tr + a, 2 * tc + bc) * p.Cout + col;
          if (p.split > 1) {  // this split's fp32 partial; wino_reduce_bf16 finishes
            *reinterpret_cast<float2*>(p.partial + (long long)blockIdx.z * npix * p.Cout + at) =
                make_float2(y0, y1);
            continue;
          }
          uint32_t out = pack_bf16(y0, y1);
          if (bias != nullptr) {  // bias after the cast, in bf16
            const float2 yv = unpack_bf16(out);
            out = pack_bf16(yv.x + bv.x, yv.y + bv.y);
          }
          *reinterpret_cast<uint32_t*>(y + at) = out;
        }
      }
    }
  }
}

// y = bf16(sum over splits, in order, of the fp32 partials), then the bias
// added in bf16: four channels a thread.
__global__ void __launch_bounds__(256) wino_reduce_bf16(const Params p) {
  const long long total = (long long)p.B * p.H * p.W * p.Cout;
  const long long at = ((long long)blockIdx.x * 256 + threadIdx.x) * 4;
  if (at >= total) return;
  float4 acc = *reinterpret_cast<const float4*>(p.partial + at);
  for (int z = 1; z < p.split; ++z) {
    const float4 q = *reinterpret_cast<const float4*>(p.partial + z * total + at);
    acc.x += q.x, acc.y += q.y, acc.z += q.z, acc.w += q.w;
  }
  uint32_t lo = pack_bf16(acc.x, acc.y), hi = pack_bf16(acc.z, acc.w);
  if (p.bias != nullptr) {
    const int col = (int)(at % p.Cout);  // Cout % 8 == 0: the four share a row
    const uint2 bb = *reinterpret_cast<const uint2*>(
        reinterpret_cast<const __nv_bfloat16*>(p.bias) + col);
    const float2 b0 = unpack_bf16(bb.x), b1 = unpack_bf16(bb.y);
    const float2 y0 = unpack_bf16(lo), y1 = unpack_bf16(hi);
    lo = pack_bf16(y0.x + b0.x, y0.y + b0.y);
    hi = pack_bf16(y1.x + b1.x, y1.y + b1.y);
  }
  *reinterpret_cast<uint2*>(reinterpret_cast<__nv_bfloat16*>(p.y) + at) = make_uint2(lo, hi);
}

// The products' launch: what wino_gemm_bf16 is launched with, and what
// c2d_winograd_plan reports.
struct Geometry {
  dim3 grid;
  int threads, smem, tile_m, tile_n, step_k, stages;
};

Geometry geometry_bf16(int tiles, int Cout, int split) {
  return {dim3((tiles + TM - 1) / TM, (Cout + TN - 1) / TN, split), GEMM_THREADS,
          STAGES * STAGE_BYTES, TM, TN, KC, STAGES};
}

cudaError_t launch_bf16(const Params& p, cudaStream_t stream) {
  const Geometry g = geometry_bf16(p.tiles, p.Cout, p.split);
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(wino_gemm_bf16,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const long long items = (long long)p.tiles * (p.Cin / 8);
  wino_input_bf16<<<(unsigned)((items + 127) / 128), 128, 0, stream>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  wino_gemm_bf16<<<g.grid, g.threads, g.smem, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess || p.split == 1) return e;
  const long long quads = (long long)p.B * p.H * p.W * p.Cout / 4;
  wino_reduce_bf16<<<(unsigned)((quads + 255) / 256), 256, 0, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- fp32 path

constexpr int FTM = 32;  // tiles per block, 4 per warp
constexpr int FTN = 64;  // output channels per block, 2 per lane
constexpr int FKC = 8;   // input channels per step

__global__ void __launch_bounds__(256) wino_f32(const Params p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* v_s = reinterpret_cast<float*>(smem_raw);  // [16][FKC][FTM]
  float* u_s = v_s + 16 * FKC * FTM;                // [16][FKC][FTN]
  const float* x = reinterpret_cast<const float*>(p.x);
  const float* u = reinterpret_cast<const float*>(p.u);

  const int tid = threadIdx.x, tg = tid >> 5, lane = tid & 31;
  const int tile0 = blockIdx.x * FTM, co0 = blockIdx.y * FTN;

  float r[4][2][4][2];  // [i][b][tile of the warp's 4][channel of the lane's 2]
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int k = 0; k < 4; ++k) r[i][b][k][0] = r[i][b][k][1] = 0.f;

  for (int c0 = 0; c0 < p.Cin; c0 += FKC) {
    __syncthreads();
    {  // one (tile, channel) per thread
      const int tl = tid / FKC, c = tid % FKC;
      const int tile = tile0 + tl;
      int b = 0, tr = 0, tc = 0;
      if (tile < p.tiles) tile_coords(p, tile, b, tr, tc);
      float d[4][4];
#pragma unroll
      for (int py = 0; py < 4; ++py) {
#pragma unroll
        for (int px = 0; px < 4; ++px) {
          const int yy = 2 * tr + py - 1, xx = 2 * tc + px - 1;
          d[py][px] = (tile < p.tiles && yy >= 0 && yy < p.H && xx >= 0 && xx < p.W)
                          ? x[pixel(p, b, yy, xx) * p.Cin + c0 + c]
                          : 0.f;
        }
      }
      float v[16];
      input_transform(d, v);
#pragma unroll
      for (int n = 0; n < 16; ++n) v_s[(n * FKC + c) * FTM + tl] = v[n];
    }
    for (int i = tid; i < 16 * FKC * (FTN / 4); i += 256) {
      const int n = i / (FKC * (FTN / 4)), rem = i % (FKC * (FTN / 4));
      const int k = rem / (FTN / 4), cq = (rem % (FTN / 4)) * 4;
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (co0 + cq < p.Cout)
        val = *reinterpret_cast<const float4*>(
            u + ((long long)n * p.Cin + c0 + k) * p.Cout + co0 + cq);
      *reinterpret_cast<float4*>(u_s + (n * FKC + k) * FTN + cq) = val;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = 4 * i + j;
#pragma unroll 2
        for (int k = 0; k < FKC; ++k) {
          const float4 a4 = *reinterpret_cast<const float4*>(v_s + (n * FKC + k) * FTM + tg * 4);
          const float2 u2 = *reinterpret_cast<const float2*>(u_s + (n * FKC + k) * FTN + 2 * lane);
          const float a[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if (j < 3) {
              r[i][0][q][0] = fmaf(a[q], u2.x, r[i][0][q][0]);
              r[i][0][q][1] = fmaf(a[q], u2.y, r[i][0][q][1]);
            }
            if (j == 1) {
              r[i][1][q][0] = fmaf(a[q], u2.x, r[i][1][q][0]);
              r[i][1][q][1] = fmaf(a[q], u2.y, r[i][1][q][1]);
            }
            if (j >= 2) {
              r[i][1][q][0] = fmaf(-a[q], u2.x, r[i][1][q][0]);
              r[i][1][q][1] = fmaf(-a[q], u2.y, r[i][1][q][1]);
            }
          }
        }
      }
    }
  }

  const float* bias = reinterpret_cast<const float*>(p.bias);
  float* y = reinterpret_cast<float*>(p.y);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int tile = tile0 + tg * 4 + q;
    if (tile >= p.tiles) continue;
    int b, tr, tc;
    tile_coords(p, tile, b, tr, tc);
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      const int col = co0 + 2 * lane + cc;
      if (col >= p.Cout) continue;
      const float bv = bias != nullptr ? bias[col] : 0.f;
#pragma unroll
      for (int a = 0; a < 2; ++a) {
#pragma unroll
        for (int bc = 0; bc < 2; ++bc) {
          const float yv = a == 0 ? r[0][bc][q][cc] + r[1][bc][q][cc] + r[2][bc][q][cc]
                                  : r[1][bc][q][cc] - r[2][bc][q][cc] - r[3][bc][q][cc];
          y[pixel(p, b, 2 * tr + a, 2 * tc + bc) * p.Cout + col] = yv + bv;
        }
      }
    }
  }
}

Geometry geometry_f32(int tiles, int Cout) {
  return {dim3((tiles + FTM - 1) / FTM, (Cout + FTN - 1) / FTN, 1), 256,
          (int)((16 * FKC * FTM + 16 * FKC * FTN) * sizeof(float)), FTM, FTN, FKC, 1};
}

cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  const Geometry g = geometry_f32(p.tiles, p.Cout);
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(wino_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         g.smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  wino_f32<<<g.grid, g.threads, g.smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename TI, typename TO>
cudaError_t launch_filter(const void* w, void* u, int Cin, int Cout, cudaStream_t stream) {
  const long long items = (long long)Cin * (Cout / 8);
  wino_filter<TI, TO><<<(unsigned)((items + 127) / 128), 128, 0, stream>>>(
      reinterpret_cast<const TI*>(w), reinterpret_cast<TO*>(u), Cin, Cout);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = bf16, 1 = fp32. x [B, H, W, Cin] and y [B, H, W, Cout] NHWC
// contiguous, u = G w G^T as [16, Cin, Cout] contiguous in x's type, bias
// [Cout] in x's type or null. bf16 needs v, a bf16 scratch of
// 16 * B*(H/2)*(W/2) * Cin elements, and, when split > 1 (the Cin loop cut
// into `split` ranges of 16-channel steps, 1 <= split <= Cin/16), partial,
// an fp32 scratch of split * B*H*W*Cout elements. fp32 takes split == 1 and
// neither scratch. Requires H and W even, Cin % 16 == 0, Cout % 8 == 0 and
// 16-byte aligned pointers (the wrapper checks).
int c2d_winograd_conv3x3(const void* x, const void* u, const void* bias, void* y, void* v,
                         float* partial, int dtype, int B, int H, int W, int Cin, int Cout,
                         int split, void* stream) {
  if (H < 2 || W < 2 || H % 2 || W % 2 || Cin % 16 || Cout % 8 || B < 1 || split < 1 ||
      split > Cin / 16 || split > 65535 || (Cout + TN - 1) / TN > 65535)
    return (int)cudaErrorInvalidValue;
  const Params p{x, u, bias, y, v, partial, B, H, W, Cin, Cout, H / 2, W / 2,
                 B * (H / 2) * (W / 2), split};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (v == nullptr || (split > 1 && partial == nullptr)) return (int)cudaErrorInvalidValue;
    return (int)launch_bf16(p, st);
  }
  if (dtype == 1 && split == 1) return (int)launch_f32(p, st);
  return (int)cudaErrorInvalidValue;
}

// The geometry c2d_winograd_conv3x3 launches its products with on these
// arguments (no launch; host only), for a caller that plans scratch and
// occupancy: out = {grid.x, grid.y, grid.z, threads, dynamic shared memory in
// bytes, tiles per block, output channels per block, input channels per step,
// stages}.
int c2d_winograd_plan(int dtype, int B, int H, int W, int Cout, int split, int* out) {
  if (dtype < 0 || dtype > 1 || B < 1 || H < 2 || W < 2 || H % 2 || W % 2 || split < 1 ||
      (dtype == 1 && split != 1))
    return (int)cudaErrorInvalidValue;
  const int tiles = B * (H / 2) * (W / 2);
  const Geometry g = dtype == 0 ? geometry_bf16(tiles, Cout, split) : geometry_f32(tiles, Cout);
  const int vals[9] = {(int)g.grid.x, (int)g.grid.y, (int)g.grid.z, g.threads, g.smem,
                       g.tile_m,      g.tile_n,      g.step_k,      g.stages};
  for (int i = 0; i < 9; ++i) out[i] = vals[i];
  return 0;
}

// U = G w G^T of HWIO weights w [3, 3, Cin, Cout] (type code in_dtype) as
// [16, Cin, Cout] (type code out_dtype): fp32 sums, one cast. Cout % 8 == 0.
int c2d_winograd_filter(const void* w, void* u, int in_dtype, int out_dtype, int Cin, int Cout,
                        void* stream) {
  if (Cin < 1 || Cout < 8 || Cout % 8) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (in_dtype == 0 && out_dtype == 0)
    return (int)launch_filter<__nv_bfloat16, __nv_bfloat16>(w, u, Cin, Cout, st);
  if (in_dtype == 1 && out_dtype == 0)
    return (int)launch_filter<float, __nv_bfloat16>(w, u, Cin, Cout, st);
  if (in_dtype == 0 && out_dtype == 1)
    return (int)launch_filter<__nv_bfloat16, float>(w, u, Cin, Cout, st);
  if (in_dtype == 1 && out_dtype == 1)
    return (int)launch_filter<float, float>(w, u, Cin, Cout, st);
  return (int)cudaErrorInvalidValue;
}

const char* c2d_cuda_error_string_winograd(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
