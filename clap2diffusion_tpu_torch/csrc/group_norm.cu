// GroupNorm (+SiLU) over channels-last data for Hopper (sm_90a): one
// cooperative launch per call.
//
// Replaces the TPU kernel clap2diffusion_tpu/ops/groupnorm.py::_kernel
// (launched by _pallas_group_norm_silu): GroupNorm with fp32 statistics, the
// affine and SiLU (optional here) over an NHWC activation [B, H*W, C], in
// bf16, fp16 or fp32, the scale and bias in any of the three.
//
// What bounds it on an H100: bytes. It does ~10 operations per element it
// moves, so the least time is reading x once and writing y once at
// 3.35 TB/s. At the UNet's slabs (0.3-15.7 MB in bf16) that is 0.2-9.4 us,
// less than the cost of a launch from Python, so the host's cost per call
// counts as much as the bytes: one launch through ctypes, nothing else.
// The TPU kernel ran one grid step per sample over a VMEM-resident slab. Here
// the statistics of a group span the whole sample, and a sample spans many
// SMs, so the design is one persistent grid with one grid-wide barrier
// (cooperative launch, so that every block is resident):
//   * block k of sample b owns a contiguous run of pixel rows, all C
//     channels, so its loads are 16-byte vectors, coalesced, whatever C/G is
//     (a group of 10 bf16 channels is 20 bytes of a row);
//   * phase 1: the block copies its first `keep` rows into shared memory
//     (cp.async) and, while they fly, streams the rest; per channel it sums
//     x and x^2 in fp32 over row lanes, then per group over the lanes and
//     the group's channels in one order, and writes the block's per-group
//     partials to a workspace;
//   * grid barrier; phase 2: every block of a sample sums the sample's
//     partials in the same fixed order (no atomics: every block holds the
//     same statistics, and two launches give the same bits), and takes mean
//     and rsqrt(max(var, 0) + eps) per group;
//   * phase 3: y = x * a + b with the affine folded per channel (a = scale *
//     inv, b = bias - mean * a), then y * sigmoid(y), from the rows kept in
//     shared memory and, past them, from x in device memory.
// A first version had a second barrier (one warp per (sample, group) wrote
// the folded affine for all blocks to read) and a precise division in the
// SiLU: on an H100 (700 W) it took 9.3-30.2 us of device time a call at the
// UNet's bf16 slabs, 1.3-2.9x the three Triton kernels it replaces; this one
// takes 8.3-17.7 us (0.9-1.6x). What is left at the small slabs is the
// cooperative launch and the barrier's round trip through device memory.
// Where the whole slab fits the grid's shared memory (every UNet slab in
// bf16: the largest, [2,64,64,960], is 15.7 MB against 132 x 227 KB), x is
// read once; otherwise (the VAE's 32-128 MB slabs) the rows past `keep` are
// read twice, at most 1.5x the byte bound. The plan (geometry() below, and
// its mirror ops/groupnorm.py::launch_plan) says which.
//
// The entry returns cudaGetLastError() after its launch (a cooperative launch
// larger than the resident capacity is refused); the Python wrapper raises
// when it is not cudaSuccess.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ptx.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace c2d;

constexpr int THREADS = 512;
constexpr int MAX_SMEM = 232448;         // bytes of shared memory one block may use
constexpr int MIN_BLOCK_BYTES = 32768;   // of x a block owns at least, where the slab allows
constexpr int MAX_ITEMS = 2;             // (vector column, row lane) items per thread
constexpr int MAX_C = 4096;

struct Params {
  const void* x;
  void* y;
  const void* scale;
  const void* bias;
  float* ws;  // [grid][G][2] the blocks' per-group sums of x and x^2
  int B, HW, C, G, bps, rpb, keep, lanes;
  float eps;
  int silu;
};

// What the kernel is launched with, and what c2d_group_norm_plan reports.
struct Geometry {
  int grid, bps, rpb, keep, lanes, smem, resident;
  long long ws_floats;
};

// vec = 16 bytes of x in elements. Blocks per sample: enough that each owns
// MIN_BLOCK_BYTES of x, at most capacity / B, at most one a row; rows per
// block evened out over them. A thread's items are (vector column, row lane):
// lanes = THREADS / (vector columns), at least 1.
Geometry geometry(int B, int HW, int C, int G, int elem, int capacity) {
  const long long row_bytes = (long long)C * elem;
  const long long per_sample = (long long)HW * row_bytes;
  long long want = (per_sample * B + MIN_BLOCK_BYTES - 1) / MIN_BLOCK_BYTES;
  want = (want + B - 1) / B;
  long long bps = capacity / B;
  if (want < bps) bps = want;
  if (HW < bps) bps = HW;
  if (bps < 1) bps = 1;
  const int rpb = (int)((HW + bps - 1) / bps);
  bps = (HW + rpb - 1) / rpb;
  const int vcols = (int)(row_bytes / 16);
  const int lanes = vcols >= THREADS ? 1 : THREADS / vcols;
  const int fixed = lanes * 2 * C * 4;
  long long keep = (MAX_SMEM - fixed) / row_bytes;
  if (keep > rpb) keep = rpb;
  if (keep < 0) keep = 0;
  const int grid = (int)(B * bps);
  return {grid, (int)bps, rpb, (int)keep, lanes, (int)(fixed + keep * row_bytes),
          keep == rpb, (long long)grid * 2 * G};
}

template <typename T> struct Vec;
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void unpack(uint4 u, float f[8]) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 v = unpack_bf16(w[i]);
      f[2 * i] = v.x;
      f[2 * i + 1] = v.y;
    }
  }
  __device__ static uint4 pack(const float f[8]) {
    return make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]), pack_bf16(f[4], f[5]),
                      pack_bf16(f[6], f[7]));
  }
};
template <> struct Vec<__half> {
  static constexpr int N = 8;
  __device__ static void unpack(uint4 u, float f[8]) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 v = __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
      f[2 * i] = v.x;
      f[2 * i + 1] = v.y;
    }
  }
  __device__ static uint32_t pack2(float a, float b) {
    __half2 v = __floats2half2_rn(a, b);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  __device__ static uint4 pack(const float f[8]) {
    return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]), pack2(f[6], f[7]));
  }
};
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void unpack(uint4 u, float f[4]) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ static uint4 pack(const float f[4]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
};

__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_float(float v) { return v; }

// Two sums over a warp: lane-strided partials, a butterfly, then lane 0's
// result in every lane (one order for every use).
__device__ __forceinline__ void sum_warp(float& t1, float& t2) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    t1 += __shfl_xor_sync(0xffffffffu, t1, off);
    t2 += __shfl_xor_sync(0xffffffffu, t2, off);
  }
  t1 = __shfl_sync(0xffffffffu, t1, 0);
  t2 = __shfl_sync(0xffffffffu, t2, 0);
}

// 1 / x by the special-function unit (rcp.approx, 1 ulp; 1 / inf = 0)
__device__ __forceinline__ float fast_rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 16 bytes of x, read-only for the kernel's lifetime
__device__ __forceinline__ uint4 ld_x(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

template <typename T, typename P>
__global__ void __launch_bounds__(THREADS, 1) group_norm_fwd(const Params p) {
  constexpr int V = Vec<T>::N;
  extern __shared__ __align__(16) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem);  // [lanes][2][C]
  unsigned char* xs = smem + p.lanes * 2 * p.C * 4;
  const int tid = threadIdx.x;
  const int C = p.C, VC = C / V, items = VC * p.lanes;
  const int b = blockIdx.x / p.bps, k = blockIdx.x % p.bps;
  const int r0 = k * p.rpb, rows = min(p.rpb, p.HW - r0), keep = min(rows, p.keep);
  const T* xg = static_cast<const T*>(p.x) + ((long long)b * p.HW + r0) * C;
  T* yg = static_cast<T*>(p.y) + ((long long)b * p.HW + r0) * C;
  cg::grid_group grid = cg::this_grid();

  // phase 1: the kept rows are one contiguous run of x; copy it asynchronously
  for (int i = tid; i < keep * VC; i += THREADS)
    cp_async16(smem_u32(xs) + i * 16, xg + (long long)i * V, true);
  cp_async_commit();
  // the scale and bias of the thread's channels, read now, used after the barrier
  float w[MAX_ITEMS][V], bi[MAX_ITEMS][V];
#pragma unroll
  for (int j = 0; j < MAX_ITEMS; ++j) {
    const int c0 = (tid + j * THREADS) % VC * V;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const bool ok = tid + j * THREADS < items;
      w[j][e] = ok ? to_float(static_cast<const P*>(p.scale)[c0 + e]) : 0.f;
      bi[j][e] = ok ? to_float(static_cast<const P*>(p.bias)[c0 + e]) : 0.f;
    }
  }

  float s1[MAX_ITEMS][V], s2[MAX_ITEMS][V];
#pragma unroll
  for (int j = 0; j < MAX_ITEMS; ++j)
#pragma unroll
    for (int e = 0; e < V; ++e) s1[j][e] = s2[j][e] = 0.f;

  // the rows past `keep`, from device memory, four loads in flight a thread
#pragma unroll
  for (int j = 0; j < MAX_ITEMS; ++j) {
    const int it = tid + j * THREADS;
    if (it < items) {
      const int vc = it % VC, lane = it / VC;
      const T* col = xg + vc * V;
      int r = keep + lane;
      for (; r + 3 * p.lanes < rows; r += 4 * p.lanes) {
        uint4 u[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) u[q] = ld_x(col + (long long)(r + q * p.lanes) * C);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float f[V];
          Vec<T>::unpack(u[q], f);
#pragma unroll
          for (int e = 0; e < V; ++e) {
            s1[j][e] += f[e];
            s2[j][e] = fmaf(f[e], f[e], s2[j][e]);
          }
        }
      }
      for (; r < rows; r += p.lanes) {
        float f[V];
        Vec<T>::unpack(ld_x(col + (long long)r * C), f);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          s1[j][e] += f[e];
          s2[j][e] = fmaf(f[e], f[e], s2[j][e]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  // then the kept rows, from shared memory; each item's sums to its lane's row
#pragma unroll
  for (int j = 0; j < MAX_ITEMS; ++j) {
    const int it = tid + j * THREADS;
    if (it < items) {
      const int vc = it % VC, lane = it / VC;
      for (int r = lane; r < keep; r += p.lanes) {
        float f[V];
        Vec<T>::unpack(*reinterpret_cast<const uint4*>(xs + ((long long)r * VC + vc) * 16), f);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          s1[j][e] += f[e];
          s2[j][e] = fmaf(f[e], f[e], s2[j][e]);
        }
      }
      float* out = red + lane * 2 * C + vc * V;
#pragma unroll
      for (int e = 0; e < V; e += 4) {
        *reinterpret_cast<float4*>(out + e) = make_float4(s1[j][e], s1[j][e + 1], s1[j][e + 2],
                                                          s1[j][e + 3]);
        *reinterpret_cast<float4*>(out + C + e) =
            make_float4(s2[j][e], s2[j][e + 1], s2[j][e + 2], s2[j][e + 3]);
      }
    }
  }
  __syncthreads();
  // the block's partials per group: a warp per group sums its row lanes and
  // channels in one order (lane-strided, then a butterfly, lane 0's result)
  const int warp = tid >> 5, wl = tid & 31, cgs = C / p.G;
  float* part = p.ws + (long long)blockIdx.x * 2 * p.G;
  for (int g = warp; g < p.G; g += THREADS / 32) {
    float t1 = 0.f, t2 = 0.f;
    for (int i = wl; i < p.lanes * cgs; i += 32) {
      const float* r = red + (i / cgs) * 2 * C + g * cgs + i % cgs;
      t1 += r[0];
      t2 += r[C];
    }
    sum_warp(t1, t2);
    if (wl == 0) {
      part[2 * g] = t1;
      part[2 * g + 1] = t2;
    }
  }
  grid.sync();

  // phase 2: every block of sample b sums the sample's block partials in the
  // same order, so all hold the same statistics; they go where `red` was
  float* stats = red;  // [G][2]: mean, 1/std
  for (int g = warp; g < p.G; g += THREADS / 32) {
    float t1 = 0.f, t2 = 0.f;
    for (int k2 = wl; k2 < p.bps; k2 += 32) {
      const float* q = p.ws + ((long long)b * p.bps + k2) * 2 * p.G + 2 * g;
      t1 += q[0];
      t2 += q[1];
    }
    sum_warp(t1, t2);
    if (wl == 0) {
      const float cnt = (float)p.HW * (float)cgs;
      const float mean = t1 / cnt;
      stats[2 * g] = mean;
      stats[2 * g + 1] = rsqrtf(fmaxf(t2 / cnt - mean * mean, 0.f) + p.eps);
    }
  }
  __syncthreads();

  // phase 3: y = x * a + b (+ SiLU), kept rows from shared memory, the rest
  // from device memory
#pragma unroll
  for (int j = 0; j < MAX_ITEMS; ++j) {
    const int it = tid + j * THREADS;
    if (it >= items) continue;
    const int vc = it % VC, lane = it / VC;
    float a[V], sh[V];  // the affine folded per channel: a = scale / std, b = bias - mean a
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const int g = (vc * V + e) / cgs;
      a[e] = stats[2 * g + 1] * w[j][e];
      sh[e] = bi[j][e] - stats[2 * g] * a[e];
    }
    auto apply = [&](uint4 u, long long r) {
      float f[V];
      Vec<T>::unpack(u, f);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        float v = fmaf(f[e], a[e], sh[e]);
        if (p.silu) v *= fast_rcp(1.f + __expf(-v));
        f[e] = v;
      }
      *reinterpret_cast<uint4*>(yg + r * C + vc * V) = Vec<T>::pack(f);
    };
    for (int r = lane; r < keep; r += p.lanes)
      apply(*reinterpret_cast<const uint4*>(xs + ((long long)r * VC + vc) * 16), r);
    const T* col = xg + vc * V;
    int r = keep + lane;
    for (; r + 3 * p.lanes < rows; r += 4 * p.lanes) {
      uint4 u[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) u[q] = ld_x(col + (long long)(r + q * p.lanes) * C);
#pragma unroll
      for (int q = 0; q < 4; ++q) apply(u[q], r + q * p.lanes);
    }
    for (; r < rows; r += p.lanes) apply(ld_x(col + (long long)r * C), r);
  }
}

// Blocks of 512 threads with the largest shared memory a plan asks for that
// can be resident at once on this device (cooperative launch's limit).
template <typename T, typename P>
cudaError_t capacity_of(int* out) {
  static int cached = 0;  // per device ordinal would matter on a mixed host
  if (cached == 0) {
    cudaError_t e = cudaFuncSetAttribute(group_norm_fwd<T, P>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (e != cudaSuccess) return e;
    int dev = 0, sms = 0, per_sm = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, group_norm_fwd<T, P>, THREADS,
                                                      MAX_SMEM);
    if (e != cudaSuccess) return e;
    cached = per_sm * sms;
  }
  *out = cached;
  return cudaSuccess;
}

// Every instance's capacity (they differ only in registers): the smallest.
cudaError_t capacity(int* out) {
  int caps[9], i = 0;
  cudaError_t e = cudaSuccess;
#define C2D_CAP(T, P) \
  if (e == cudaSuccess) e = capacity_of<T, P>(&caps[i++]);
  C2D_CAP(__nv_bfloat16, __nv_bfloat16) C2D_CAP(__nv_bfloat16, __half) C2D_CAP(__nv_bfloat16, float)
  C2D_CAP(__half, __nv_bfloat16) C2D_CAP(__half, __half) C2D_CAP(__half, float)
  C2D_CAP(float, __nv_bfloat16) C2D_CAP(float, __half) C2D_CAP(float, float)
#undef C2D_CAP
  if (e != cudaSuccess) return e;
  int m = caps[0];
  for (int j = 1; j < 9; ++j) m = caps[j] < m ? caps[j] : m;
  *out = m;
  return cudaSuccess;
}

template <typename T, typename P>
cudaError_t launch(const Params& p, const Geometry& g, cudaStream_t stream) {
  int cap = 0;
  cudaError_t e = capacity_of<T, P>(&cap);  // also sets the shared-memory attribute
  if (e != cudaSuccess) return e;
  void* args[] = {const_cast<Params*>(&p)};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(group_norm_fwd<T, P>),
                                  dim3(g.grid), dim3(THREADS), args, g.smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(const Params& p, const Geometry& g, int pdtype, cudaStream_t stream) {
  switch (pdtype) {
    case 0: return launch<T, __nv_bfloat16>(p, g, stream);
    case 1: return launch<T, __half>(p, g, stream);
    case 2: return launch<T, float>(p, g, stream);
    default: return cudaErrorInvalidValue;
  }
}

int elem_size(int dtype) { return dtype == 2 ? 4 : dtype == 0 || dtype == 1 ? 2 : 0; }

bool valid(int B, int HW, int C, int G, int dtype) {
  return B >= 1 && HW >= 1 && C >= 8 && C <= MAX_C && C % 8 == 0 && G >= 1 && C % G == 0 &&
         elem_size(dtype) > 0;
}

}  // namespace

extern "C" {

// dtype, pdtype (x and y; scale and bias): 0 = bf16, 1 = fp16, 2 = fp32. x and
// y are contiguous [B, HW, C], 16-byte aligned; scale and bias [C]; ws holds
// at least the plan's workspace floats (ws_floats). Requires C % 8 == 0,
// C <= 4096, C % G == 0 and B no larger than the resident capacity.
int c2d_group_norm_fwd(const void* x, void* y, const void* scale, const void* bias, float* ws,
                       long long ws_floats, int dtype, int pdtype, int B, int HW, int C, int G,
                       float eps, int silu, void* stream) {
  if (!valid(B, HW, C, G, dtype)) return (int)cudaErrorInvalidValue;
  int cap = 0;
  cudaError_t e = capacity(&cap);
  if (e != cudaSuccess) return (int)e;
  if (B > cap) return (int)cudaErrorInvalidValue;
  const Geometry g = geometry(B, HW, C, G, elem_size(dtype), cap);
  if (ws_floats < g.ws_floats) return (int)cudaErrorInvalidValue;
  const Params p{x, y, scale, bias, ws, B, HW, C, G, g.bps, g.rpb, g.keep, g.lanes, eps, silu};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch_t<__nv_bfloat16>(p, g, pdtype, st);
    case 1: return (int)launch_t<__half>(p, g, pdtype, st);
    default: return (int)launch_t<float>(p, g, pdtype, st);
  }
}

// The geometry c2d_group_norm_fwd launches with on these arguments (no
// launch; sets the kernels' shared-memory attribute once): out = {grid,
// blocks per sample, rows per block, kept rows, row lanes, dynamic shared
// memory in bytes, resident (0/1), workspace floats, threads, capacity}.
// capacity < 1 asks for the device's.
int c2d_group_norm_plan(int B, int HW, int C, int dtype, int G, int capacity_in,
                        long long* out) {
  if (!valid(B, HW, C, G, dtype)) return (int)cudaErrorInvalidValue;
  int cap = capacity_in;
  if (cap < 1) {
    cudaError_t e = capacity(&cap);
    if (e != cudaSuccess) return (int)e;
  }
  if (B > cap) return (int)cudaErrorInvalidValue;
  const Geometry g = geometry(B, HW, C, G, elem_size(dtype), cap);
  const long long vals[10] = {g.grid, g.bps,       g.rpb,   g.keep, g.lanes,
                              g.smem, g.resident, g.ws_floats, THREADS, cap};
  for (int i = 0; i < 10; ++i) out[i] = vals[i];
  return 0;
}

const char* c2d_cuda_error_string_gn(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
