// Flash-attention forward for Hopper (sm_90a), bf16 and fp32.
//
// Replaces the TPU kernel clap2diffusion_tpu/ops/flash_attention.py::_fwd_kernel
// (launched by _flash_fwd_perhead): out = softmax(q k^T * scale) v for each
// (batch, head), with fp32 logits and softmax and the normalisation applied
// after the PV product.
//
// What bounds it on an H100: at the UNet's shapes ([2,8,4096,40],
// [2,8,1024,80]) and the VAE's ([1,1,4096,512]) the work is tensor-core
// operations (4*S*S*d per head against 2*S*d*4 bytes moved); at [2,8,256,160]
// it is bytes. The TPU kernel kept all of K and V in VMEM; here K+V of one
// head at 4096x512 bf16 is 8 MB against 227 KB of shared memory per block,
// so the design streams them:
//   * one block of 4 warps per (batch*head, 64-query tile, column chunk);
//   * K and V stream through shared memory in 64-key tiles, V stored
//     transposed so the PV operand is read as 32-bit pairs;
//   * each warp owns 16 query rows; S = Q K^T and O += P V run on
//     mma.sync.m16n8k16 (bf16 in, fp32 accumulate); P goes from the S
//     accumulators to the A operand in registers, without shared memory;
//   * an online softmax (running max and sum in fp32, exp2 with the scale
//     folded into log2(e)) replaces the TPU's single pass over all keys;
//   * head dims are zero-padded to a multiple of 16 in shared memory only
//     (d=40 -> 48); device memory holds the real width;
//   * the fp32 accumulator of a 64-row tile at d=512 does not fit in
//     registers, so for d > 160 the output columns are split into chunks of
//     128 across blocks (grid.z); each chunk recomputes S.
// fp32 inputs take a plain FMA kernel (16 query rows x 32 keys per step,
// everything in shared memory), exact to fp32 rounding.
//
// Every entry returns cudaGetLastError() after its launch; the Python
// wrapper raises when it is not cudaSuccess.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, H, Sq, Sk, D;
  long long qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss;
  float scale;
};

// ---------------------------------------------------------------- bf16 path

constexpr int BQ = 64;  // query rows per block, 16 per warp
constexpr int BK = 64;  // keys per shared-memory tile
constexpr int PAD = 8;  // row padding in elements: conflict-free fragment reads

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

template <int DP, int DVC>
__global__ void __launch_bounds__(128) flash_fwd_bf16(const Params p) {
  constexpr int QS = DP + PAD;  // Q and K row stride in shared memory
  constexpr int VS = BK + PAD;  // V^T row stride
  constexpr int CH = DP / 8;    // 16-byte chunks per Q/K row
  constexpr int VCH = DVC / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* k_s = q_s + BQ * QS;
  __nv_bfloat16* vt_s = k_s + BK * QS;  // [DVC][VS]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int c0 = blockIdx.z * DVC;
  const __nv_bfloat16* qg =
      reinterpret_cast<const __nv_bfloat16*>(p.q) + b * p.qsb + h * p.qsh;
  const __nv_bfloat16* kg =
      reinterpret_cast<const __nv_bfloat16*>(p.k) + b * p.ksb + h * p.ksh;
  const __nv_bfloat16* vg =
      reinterpret_cast<const __nv_bfloat16*>(p.v) + b * p.vsb + h * p.vsh;
  __nv_bfloat16* og = reinterpret_cast<__nv_bfloat16*>(p.o) + b * p.osb + h * p.osh;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  for (int i = tid; i < BQ * CH; i += 128) {
    const int r = i / CH, c = (i % CH) * 8;
    uint4 val = zero;
    if (q0 + r < p.Sq && c < p.D)
      val = *reinterpret_cast<const uint4*>(qg + (q0 + r) * p.qss + c);
    *reinterpret_cast<uint4*>(q_s + r * QS + c) = val;
  }

  float o[DVC / 8][4];
#pragma unroll
  for (int j = 0; j < DVC / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  const float sl2 = p.scale * 1.4426950408889634f;
  const int qr = warp * 16;

  for (int k0 = 0; k0 < p.Sk; k0 += BK) {
    __syncthreads();  // the previous tile is consumed (and Q is stored)
    for (int i = tid; i < BK * CH; i += 128) {
      const int r = i / CH, c = (i % CH) * 8;
      uint4 val = zero;
      if (k0 + r < p.Sk && c < p.D)
        val = *reinterpret_cast<const uint4*>(kg + (k0 + r) * p.kss + c);
      *reinterpret_cast<uint4*>(k_s + r * QS + c) = val;
    }
    for (int i = tid; i < BK * VCH; i += 128) {
      const int r = i % BK, c = (i / BK) * 8;
      uint4 val = zero;
      if (k0 + r < p.Sk && c0 + c < p.D)
        val = *reinterpret_cast<const uint4*>(vg + (k0 + r) * p.vss + c0 + c);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int j = 0; j < 8; ++j) vt_s[(c + j) * VS + r] = e[j];
    }
    __syncthreads();

    // S = Q K^T: this warp's 16 rows x BK keys, as BK/8 accumulators of 16x8.
    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks) {
      const __nv_bfloat16* qa = q_s + (qr + g) * QS + ks * 16 + 2 * t;
      const uint32_t a[4] = {lds32(qa), lds32(qa + 8 * QS), lds32(qa + 8),
                             lds32(qa + 8 * QS + 8)};
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        const __nv_bfloat16* kb = k_s + (n * 8 + g) * QS + ks * 16 + 2 * t;
        mma_bf16(s[n], a, lds32(kb), lds32(kb + 8));
      }
    }

    // Online softmax. Thread holds rows g (s[n][0..1]) and g+8 (s[n][2..3]);
    // the 4 threads of a quad share a row.
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + n * 8 + 2 * t + (e & 1);
        const float x = key < p.Sk ? s[n][e] * sl2 : -INFINITY;
        s[n][e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x);
        else mx1 = fmaxf(mx1, x);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float base0 = mn0 == -INFINITY ? 0.f : mn0;
    const float base1 = mn1 == -INFINITY ? 0.f : mn1;
    const float al0 = exp2f(m0 - base0), al1 = exp2f(m1 - base1);
    m0 = mn0;
    m1 = mn1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      s[n][0] = exp2f(s[n][0] - base0);
      s[n][1] = exp2f(s[n][1] - base0);
      s[n][2] = exp2f(s[n][2] - base1);
      s[n][3] = exp2f(s[n][3] - base1);
      rs0 += s[n][0] + s[n][1];
      rs1 += s[n][2] + s[n][3];
    }
    l0 = l0 * al0 + rs0;
    l1 = l1 * al1 + rs1;
#pragma unroll
    for (int j = 0; j < DVC / 8; ++j) {
      o[j][0] *= al0;
      o[j][1] *= al0;
      o[j][2] *= al1;
      o[j][3] *= al1;
    }

    // O += P V, with P rounded to bf16 as the TPU kernel rounds it to v's type.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < DVC / 8; ++j) {
        const __nv_bfloat16* vb = vt_s + (j * 8 + g) * VS + kk * 16 + 2 * t;
        mma_bf16(o[j], a, lds32(vb), lds32(vb + 8));
      }
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  const int r0 = q0 + qr + g, r1 = r0 + 8;
#pragma unroll
  for (int j = 0; j < DVC / 8; ++j) {
    const int col = c0 + j * 8 + 2 * t;  // even; D % 8 == 0 keeps col+1 < D
    if (col >= p.D) continue;
    if (r0 < p.Sq)
      *reinterpret_cast<uint32_t*>(og + r0 * p.oss + col) =
          pack_bf16(o[j][0] * inv0, o[j][1] * inv0);
    if (r1 < p.Sq)
      *reinterpret_cast<uint32_t*>(og + r1 * p.oss + col) =
          pack_bf16(o[j][2] * inv1, o[j][3] * inv1);
  }
}

template <int DP, int DVC>
cudaError_t launch_bf16(const Params& p, cudaStream_t stream) {
  constexpr int QS = DP + PAD, VS = BK + PAD;
  constexpr size_t smem = (size_t)(BQ * QS + BK * QS + DVC * VS) * sizeof(__nv_bfloat16);
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_bf16<DP, DVC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.B * p.H, (p.D + DVC - 1) / DVC);
  flash_fwd_bf16<DP, DVC><<<grid, 128, smem, stream>>>(p);
  return cudaGetLastError();
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
// strides that are multiples of 8 elements (the wrapper checks).
int c2d_flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int dtype,
                            int B, int H, int Sq, int Sk, int D, long long qsb, long long qsh,
                            long long qss, long long ksb, long long ksh, long long kss,
                            long long vsb, long long vsh, long long vss, long long osb,
                            long long osh, long long oss, float scale, void* stream) {
  const Params p{q,   k,   v,   o,   B,   H,   Sq,  Sk,  D,   qsb, qsh, qss,
                 ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss, scale};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 1) return (int)launch_f32(p, st);
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  if (D <= 48) return (int)launch_bf16<48, 48>(p, st);
  if (D <= 64) return (int)launch_bf16<64, 64>(p, st);
  if (D <= 80) return (int)launch_bf16<80, 80>(p, st);
  if (D <= 128) return (int)launch_bf16<128, 128>(p, st);
  if (D <= 160) return (int)launch_bf16<160, 160>(p, st);
  if (D <= 256) return (int)launch_bf16<256, 128>(p, st);
  if (D <= 512) return (int)launch_bf16<512, 128>(p, st);
  return (int)cudaErrorInvalidValue;
}

const char* c2d_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
