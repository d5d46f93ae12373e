// Head-packed flash-attention forward for Hopper (sm_90a), bf16 and fp32.
//
// Replaces the TPU kernel clap2diffusion_tpu/ops/flash_attention.py::
// _packed_fwd_kernel (launched by _packed_flash_fwd on [B,H,S,D] and by
// _packed_flash_nhd_fwd on the [B,S,H*D] projection layout): self-attention
// out = softmax(q k^T * scale) v for `pack` heads per kernel instance, with
// fp32 logits and a softmax that is normalised BEFORE the PV product
// (p * (1/sum), rounded to v's type, then PV with fp32 sums).
//
// What bounds it on an H100: at the route's shapes ([B,4096,8*40], pack 3)
// the work is tensor-core operations, 4*S*S*d per head against 4*S*d
// elements moved. The TPU kernel packed heads because its MXU contracts 128
// deep: queries were concatenated on the feature axis and K/V made
// block-diagonal, so one [Bq,120]x[120,3S] product computed three heads'
// logits. On Hopper that block-diagonal build would triple the QK^T work
// with zeros, and mma.sync tiles are 16 deep, so the design keeps what the
// packing was for (one instance per group of heads, no head transposes) and
// drops the zeros:
//   * one block of 4 warps owns a 64-query tile of the `pack` heads of one
//     group (grid = query tiles x B*groups); it loops over the group's heads
//     and reads each head's d columns straight from the caller's tensors
//     through their (b, h, s) strides, so the [B,S,H*D] projections are
//     read in place and the output is written in place into [B,S,H*D]
//     storage: a group's heads are one contiguous run of each row (240 bytes
//     at pack 3, d 40). Ghost heads (H not a multiple of pack) are skipped:
//     no zero head is built or computed;
//   * each head's products are its own: S = Q K^T and O += P V on
//     mma.sync.m16n8k16 (bf16 in, fp32 accumulate), each warp 16 query
//     rows, K and V^T through shared memory in 64-key tiles, d zero-padded to
//     a multiple of 16 in shared memory only (40 -> 48);
//   * the TPU's order is kept exactly, which takes two passes over K:
//     pass 1 computes the row max m and the row sum l (running max, fp32);
//     pass 2 recomputes S, forms p = exp(s - m) * (1/l) against the FINAL
//     max, rounds it to bf16 and accumulates PV. That is 3 products instead
//     of an online softmax's 2, the price of the TPU's rounding of P;
//   * for training the caller may pass an fp32 [B*H, S] buffer for the row
//     log-sum-exp (m + log l, natural log), the convention the per-head
//     forward uses, which the backward (flash_attention_bwd.cu) reads. With
//     a null pointer nothing else changes.
// fp32 inputs take a plain FMA kernel with the same two passes (16 query
// rows x 32 keys per step, everything in shared memory), exact to fp32
// rounding.
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
  float* lse;  // null, or fp32 [B*H, S]
  int B, H, S, D, pack, groups;
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

// Rows [r0, r0+rows) x the first D columns of a strided matrix into shared
// memory rows of stride QS, zero beyond the rows or D.
template <int DP, int QS>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long stride, int r0, int nrows, int limit,
                                          int D) {
  constexpr int CH = DP / 8;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int i = threadIdx.x; i < nrows * CH; i += 128) {
    const int r = i / CH, c = (i % CH) * 8;
    uint4 val = zero;
    if (r0 + r < limit && c < D)
      val = *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * stride + c);
    *reinterpret_cast<uint4*>(dst + r * QS + c) = val;
  }
}

// S = Q K^T for this warp's 16 rows against BK keys, as BK/8 accumulators of
// 16x8, scaled to log2 units and masked past the last key.
template <int DP, int QS>
__device__ __forceinline__ void qk_tile(float s[BK / 8][4], const __nv_bfloat16* q_s,
                                        const __nv_bfloat16* k_s, int qr, int g, int t,
                                        int k0, int S, float sl2) {
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
#pragma unroll
  for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = k0 + n * 8 + 2 * t + (e & 1);
      s[n][e] = key < S ? s[n][e] * sl2 : -INFINITY;
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(128) packed_fwd_bf16(const Params p) {
  constexpr int QS = DP + PAD;  // Q and K row stride in shared memory
  constexpr int VS = BK + PAD;  // V^T row stride
  constexpr int CH = DP / 8;
  __shared__ __align__(16) unsigned char smem_raw[(BQ * QS + BK * QS + DP * VS) * 2];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* k_s = q_s + BQ * QS;
  __nv_bfloat16* vt_s = k_s + BK * QS;  // [DP][VS]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / p.groups, grp = blockIdx.y % p.groups;
  const float sl2 = p.scale * 1.4426950408889634f;
  const int qr = warp * 16;
  const int r0 = q0 + qr + g, r1 = r0 + 8;

  for (int hi = 0; hi < p.pack; ++hi) {
    const int h = grp * p.pack + hi;
    if (h >= p.H) break;  // ghost head: nothing to compute
    const __nv_bfloat16* qg =
        reinterpret_cast<const __nv_bfloat16*>(p.q) + b * p.qsb + h * p.qsh;
    const __nv_bfloat16* kg =
        reinterpret_cast<const __nv_bfloat16*>(p.k) + b * p.ksb + h * p.ksh;
    const __nv_bfloat16* vg =
        reinterpret_cast<const __nv_bfloat16*>(p.v) + b * p.vsb + h * p.vsh;
    __nv_bfloat16* og = reinterpret_cast<__nv_bfloat16*>(p.o) + b * p.osb + h * p.osh;

    __syncthreads();  // the previous head's tiles are consumed
    load_rows<DP, QS>(q_s, qg, p.qss, q0, BQ, p.S, p.D);

    // Pass 1: row max and row sum (running max; the thread holds rows g and
    // g+8, the 4 threads of a quad share a row).
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    for (int k0 = 0; k0 < p.S; k0 += BK) {
      __syncthreads();
      load_rows<DP, QS>(k_s, kg, p.kss, k0, BK, p.S, p.D);
      __syncthreads();
      float s[BK / 8][4];
      qk_tile<DP, QS>(s, q_s, k_s, qr, g, t, k0, p.S, sl2);
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
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float base0 = mn0 == -INFINITY ? 0.f : mn0;
      const float base1 = mn1 == -INFINITY ? 0.f : mn1;
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        rs0 += exp2f(s[n][0] - base0) + exp2f(s[n][1] - base0);
        rs1 += exp2f(s[n][2] - base1) + exp2f(s[n][3] - base1);
      }
      l0 = l0 * exp2f(m0 - base0) + rs0;
      l1 = l1 * exp2f(m1 - base1) + rs1;
      m0 = mn0;
      m1 = mn1;
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
    const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
    const float base0 = m0 == -INFINITY ? 0.f : m0;
    const float base1 = m1 == -INFINITY ? 0.f : m1;

    // Pass 2: P = exp(s - m) * (1/l) against the final max, rounded to bf16
    // as the TPU kernel rounds it to v's type, then O += P V.
    float o[DP / 8][4];
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
    for (int k0 = 0; k0 < p.S; k0 += BK) {
      __syncthreads();
      load_rows<DP, QS>(k_s, kg, p.kss, k0, BK, p.S, p.D);
      for (int i = tid; i < BK * CH; i += 128) {
        const int r = i % BK, c = (i / BK) * 8;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (k0 + r < p.S && c < p.D)
          val = *reinterpret_cast<const uint4*>(vg + (long long)(k0 + r) * p.vss + c);
        const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
        for (int j = 0; j < 8; ++j) vt_s[(c + j) * VS + r] = e[j];
      }
      __syncthreads();
      float s[BK / 8][4];
      qk_tile<DP, QS>(s, q_s, k_s, qr, g, t, k0, p.S, sl2);
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        s[n][0] = exp2f(s[n][0] - base0) * inv0;
        s[n][1] = exp2f(s[n][1] - base0) * inv0;
        s[n][2] = exp2f(s[n][2] - base1) * inv1;
        s[n][3] = exp2f(s[n][3] - base1) * inv1;
      }
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                               pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                               pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                               pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int j = 0; j < DP / 8; ++j) {
          const __nv_bfloat16* vb = vt_s + (j * 8 + g) * VS + kk * 16 + 2 * t;
          mma_bf16(o[j], a, lds32(vb), lds32(vb + 8));
        }
      }
    }

    if (p.lse != nullptr && t == 0) {
      // m is in log2 units: sum_k exp(s_k * scale) = 2^m * l
      float* lg = p.lse + ((long long)b * p.H + h) * p.S;
      if (r0 < p.S) lg[r0] = m0 * 0.6931471805599453f + logf(l0);
      if (r1 < p.S) lg[r1] = m1 * 0.6931471805599453f + logf(l1);
    }
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = j * 8 + 2 * t;  // even; D % 8 == 0 keeps col+1 < D
      if (col >= p.D) continue;
      if (r0 < p.S)
        *reinterpret_cast<uint32_t*>(og + (long long)r0 * p.oss + col) =
            pack_bf16(o[j][0], o[j][1]);
      if (r1 < p.S)
        *reinterpret_cast<uint32_t*>(og + (long long)r1 * p.oss + col) =
            pack_bf16(o[j][2], o[j][3]);
    }
  }
}

template <int DP>
cudaError_t launch_bf16(const Params& p, cudaStream_t stream) {
  const dim3 grid((p.S + BQ - 1) / BQ, p.B * p.groups, 1);
  packed_fwd_bf16<DP><<<grid, 128, 0, stream>>>(p);
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
// checks). ``lse`` is null or an fp32 [B*H, S] buffer for the row
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
  const int groups = (H + pack - 1) / pack;
  const Params p{q,   k,   v,   o,   lse, B,   H,   S,   D,   pack, groups, qsb, qsh,
                 qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss, scale};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 1) return (int)launch_f32(p, st);
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  if (D <= 16) return (int)launch_bf16<16>(p, st);
  if (D <= 32) return (int)launch_bf16<32>(p, st);
  if (D <= 48) return (int)launch_bf16<48>(p, st);
  return (int)launch_bf16<64>(p, st);
}

const char* c2d_cuda_error_string_packed(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
