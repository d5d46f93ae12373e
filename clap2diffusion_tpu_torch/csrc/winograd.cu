// Winograd F(2x2, 3x3) convolution for Hopper (sm_90a), bf16 and fp32.
//
// Replaces the TPU kernel clap2diffusion_tpu/ops/winograd_pallas.py::_kernel
// (launched by conv3x3_winograd_pallas): an NHWC 3x3, stride-1, SAME conv in
// which each 2x2 output tile is
//   V[i][j] = sum_pq BT[i,p] BT[j,q] d[p][q]   (d: the tile's 4x4 input patch,
//                                              fp32, adds only; cast to x's type)
//   M[4i+j] = V[4i+j] . U[4i+j]                (16 products over Cin, fp32 sums)
//   Y[a][b] = sum_ij AT[a,i] AT[b,j] M[4i+j]   (adds only)
// with U = G w G^T computed by the wrapper (fp32, cast to x's type, outside
// the kernel as on the TPU). The result is cast to x's type and the bias is
// added after that cast, in x's type, as the TPU kernel's wrapper does.
//
// What bounds it on an H100: the 16 products are 8*B*H*W*Cin*Cout
// operations against x, w and y moved once; at the UNet's shapes (Cin, Cout
// >= 320) that is tensor-core operations. The TPU kernel split x into four
// stride-2 quadrants and re-interleaved its four output planes in two XLA
// relayout passes outside the kernel, and held a whole image in VMEM. Here:
//   * one block of 4 warps owns 32 tiles (64 outputs x 2 rows) x 64 output
//     channels; for each step of 16 input channels it reads every tile's 4x4
//     patch straight from x (SAME padding masked, channel pairs as 32-bit
//     loads), runs the BT transform in fp32 registers in the TPU's order
//     and stages V[n] in bf16 in shared memory, beside U[n] for its 64
//     output channels;
//   * the products run on mma.sync.m16n8k16 (bf16 in, fp32 accumulate), each
//     warp 16 tiles x 32 channels. The output transform is linear, so no
//     M[16] buffer is kept: the column half of AT is applied as the products
//     accumulate, R[i][b] = sum_j AT[b,j] M[4i+j], by issuing each product
//     into R[i][0] and/or R[i][1] with A negated where the coefficient is -1
//     (24 products per tile and channel step instead of 16, against 36 for a
//     direct conv, and no fp32 adds in the loop); the row half,
//     Y[a][b] = sum_i AT[a,i] R[i][b], runs once in the epilogue;
//   * the epilogue writes the interleaved NHWC output once, as bf16 pairs.
// fp32 inputs take an FMA kernel of the same structure (32 tiles x 64
// channels per block of 8 warps, 8 input channels per step), exact to fp32
// rounding.
//
// Every entry returns cudaGetLastError() after its launch; the Python
// wrapper raises when it is not cudaSuccess.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Params {
  const void* x;     // [B, H, W, Cin], contiguous
  const void* u;     // [16, Cout, Cin], contiguous, x's type
  const void* bias;  // [Cout] in x's type, or null
  void* y;           // [B, H, W, Cout], contiguous
  int B, H, W, Cin, Cout, TH, TW, tiles;
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

// ---------------------------------------------------------------- bf16 path

constexpr int TM = 32;        // tiles per block, 16 per warp row
constexpr int TN = 64;        // output channels per block, 32 per warp column
constexpr int KC = 16;        // input channels per step (one mma depth)
constexpr int VSTR = KC + 8;  // shared row stride: conflict-free fragment reads

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

__global__ void __launch_bounds__(128) wino_bf16(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* v_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [16][TM][VSTR]
  __nv_bfloat16* u_s = v_s + 16 * TM * VSTR;                          // [16][TN][VSTR]
  const __nv_bfloat16* x = reinterpret_cast<const __nv_bfloat16*>(p.x);
  const __nv_bfloat16* u = reinterpret_cast<const __nv_bfloat16*>(p.u);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp & 1, wn = warp >> 1;
  const int tile0 = blockIdx.x * TM, co0 = blockIdx.y * TN;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  // R[i][b][n8 sub-tile][fragment]: R[i][b] = sum_j AT[b,j] M[4i+j]
  float r[4][2][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int s = 0; s < 4; ++s) r[i][b][s][0] = r[i][b][s][1] = r[i][b][s][2] = r[i][b][s][3] = 0.f;

  for (int c0 = 0; c0 < p.Cin; c0 += KC) {
    __syncthreads();  // the previous step's V and U are consumed
    for (int item = tid; item < TM * (KC / 2); item += 128) {
      const int tl = item / (KC / 2), cp = item % (KC / 2);
      const int tile = tile0 + tl;
      float d0[4][4], d1[4][4];  // channels c0+2cp and c0+2cp+1
      int b = 0, tr = 0, tc = 0;
      if (tile < p.tiles) tile_coords(p, tile, b, tr, tc);
#pragma unroll
      for (int py = 0; py < 4; ++py) {
#pragma unroll
        for (int px = 0; px < 4; ++px) {
          const int yy = 2 * tr + py - 1, xx = 2 * tc + px - 1;
          float2 f = make_float2(0.f, 0.f);
          if (tile < p.tiles && yy >= 0 && yy < p.H && xx >= 0 && xx < p.W) {
            const __nv_bfloat162 v2 = *reinterpret_cast<const __nv_bfloat162*>(
                x + pixel(p, b, yy, xx) * p.Cin + c0 + 2 * cp);
            f = __bfloat1622float2(v2);
          }
          d0[py][px] = f.x;
          d1[py][px] = f.y;
        }
      }
      float v0[16], v1[16];
      input_transform(d0, v0);
      input_transform(d1, v1);
#pragma unroll
      for (int n = 0; n < 16; ++n)
        *reinterpret_cast<uint32_t*>(v_s + (n * TM + tl) * VSTR + 2 * cp) =
            pack_bf16(v0[n], v1[n]);
    }
    for (int i = tid; i < 16 * TN * (KC / 8); i += 128) {
      const int n = i / (TN * (KC / 8)), rem = i % (TN * (KC / 8));
      const int co = rem / (KC / 8), kc = (rem % (KC / 8)) * 8;
      uint4 val = zero;
      if (co0 + co < p.Cout)
        val = *reinterpret_cast<const uint4*>(
            u + ((long long)n * p.Cout + co0 + co) * p.Cin + c0 + kc);
      *reinterpret_cast<uint4*>(u_s + (n * TN + co) * VSTR + kc) = val;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = 4 * i + j;
        const __nv_bfloat16* va = v_s + (n * TM + wm * 16 + g) * VSTR + 2 * t;
        const uint32_t a[4] = {lds32(va), lds32(va + 8 * VSTR), lds32(va + 8),
                               lds32(va + 8 * VSTR + 8)};
        const uint32_t an[4] = {a[0] ^ 0x80008000u, a[1] ^ 0x80008000u, a[2] ^ 0x80008000u,
                                a[3] ^ 0x80008000u};
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const __nv_bfloat16* ub = u_s + (n * TN + wn * 32 + s * 8 + g) * VSTR + 2 * t;
          const uint32_t b0 = lds32(ub), b1 = lds32(ub + 8);
          // AT = [[1,1,1,0],[0,1,-1,-1]]
          if (j < 3) mma_bf16(r[i][0][s], a, b0, b1);
          if (j == 1) mma_bf16(r[i][1][s], a, b0, b1);
          if (j >= 2) mma_bf16(r[i][1][s], an, b0, b1);
        }
      }
    }
  }

  const __nv_bfloat16* bias = reinterpret_cast<const __nv_bfloat16*>(p.bias);
  __nv_bfloat16* y = reinterpret_cast<__nv_bfloat16*>(p.y);
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int col = co0 + wn * 32 + s * 8 + 2 * t;  // even; Cout % 8 == 0
    if (col >= p.Cout) continue;
    float2 bv = make_float2(0.f, 0.f);
    if (bias != nullptr)
      bv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias + col));
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
          uint32_t out = pack_bf16(y0, y1);
          if (bias != nullptr) {  // bias after the cast, in bf16
            const float2 yv =
                __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&out));
            out = pack_bf16(yv.x + bv.x, yv.y + bv.y);
          }
          *reinterpret_cast<uint32_t*>(y + pixel(p, b, 2 * tr + a, 2 * tc + bc) * p.Cout +
                                       col) = out;
        }
      }
    }
  }
}

cudaError_t launch_bf16(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = (size_t)(16 * TM * VSTR + 16 * TN * VSTR) * sizeof(__nv_bfloat16);
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(wino_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const dim3 grid((p.tiles + TM - 1) / TM, (p.Cout + TN - 1) / TN, 1);
  wino_bf16<<<grid, 128, smem, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- fp32 path

constexpr int FTM = 32;  // tiles per block, 4 per warp
constexpr int FTN = 64;  // output channels per block, 2 per lane
constexpr int FKC = 8;   // input channels per step

__global__ void __launch_bounds__(256) wino_f32(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
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
    for (int i = tid; i < 16 * FTN * (FKC / 4); i += 256) {
      const int n = i / (FTN * (FKC / 4)), rem = i % (FTN * (FKC / 4));
      const int co = rem / (FKC / 4), kq = (rem % (FKC / 4)) * 4;
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (co0 + co < p.Cout)
        val = *reinterpret_cast<const float4*>(
            u + ((long long)n * p.Cout + co0 + co) * p.Cin + c0 + kq);
      u_s[(n * FKC + kq) * FTN + co] = val.x;
      u_s[(n * FKC + kq + 1) * FTN + co] = val.y;
      u_s[(n * FKC + kq + 2) * FTN + co] = val.z;
      u_s[(n * FKC + kq + 3) * FTN + co] = val.w;
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

cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = (size_t)(16 * FKC * FTM + 16 * FKC * FTN) * sizeof(float);
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(wino_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const dim3 grid((p.tiles + FTM - 1) / FTM, (p.Cout + FTN - 1) / FTN, 1);
  wino_f32<<<grid, 256, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = bf16, 1 = fp32. x [B, H, W, Cin] and y [B, H, W, Cout] NHWC
// contiguous, u = G w G^T as [16, Cout, Cin] contiguous in x's type, bias
// [Cout] in x's type or null. Requires H and W even, Cin % 16 == 0,
// Cout % 8 == 0 and 16-byte aligned pointers (the wrapper checks).
int c2d_winograd_conv3x3(const void* x, const void* u, const void* bias, void* y, int dtype,
                         int B, int H, int W, int Cin, int Cout, void* stream) {
  if (H < 2 || W < 2 || H % 2 || W % 2 || Cin % 16 || Cout % 8 || B < 1)
    return (int)cudaErrorInvalidValue;
  const Params p{x, u, bias, y, B, H, W, Cin, Cout, H / 2, W / 2, B * (H / 2) * (W / 2)};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_bf16(p, st);
  if (dtype == 1) return (int)launch_f32(p, st);
  return (int)cudaErrorInvalidValue;
}

const char* c2d_cuda_error_string_winograd(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
