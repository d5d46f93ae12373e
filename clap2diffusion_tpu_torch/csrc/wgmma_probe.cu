// A probe of wgmma with its A operand in registers, held across a loop of
// products (no kernel of the port uses this; tools/probe_opt_in_kernels.py
// runs it on the card).
//
// The question: the first per-head design of the packed attention kernel
// kept each warpgroup's Q fragments in registers as wgmma's A operand for
// the whole key loop, and its output came back corrupted at d = 64 (right at
// d <= 40). Candidates: the fragment layout at more than three k16 steps,
// registers reused while a product that reads them is in flight (pressure
// near 255 registers a thread, spills), or the pin that keeps them live.
//
// One warpgroup; Q [64 x 16 KS] and NT key tiles K_j [64 x 16 KS], bf16,
// row-major in device memory. For every tile, S_j = Q K_j^T (m64n64k16, KS
// steps) is written to out[j]:
//   * QREG: Q's A fragments (mma.sync m16n8k16 layout, 4 registers a k16
//     step) are loaded from device memory once, before the loop, and every
//     product reads them; with PIN they are pinned after every wait
//     (wgmma_pin), as the port pins its P fragments;
//   * !QREG, the reference: Q is a shared-memory operand, as in the port's
//     kernels;
//   * EXTRA fp32 registers a thread are live across the loop (each tile adds
//     its logits into them; their sum goes to `sink`), to push the
//     register count towards the 255 a thread may have and past it.
// The same products in the same order: a right QREG instance gives the
// reference's bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ptx.cuh"
#include "wgmma.cuh"

namespace {

using namespace c2d;

// d[64 x 64] (+)= a[64 x 16] (registers) * b, B K-major from shared memory.
__device__ __forceinline__ void wgmma_rs_n64_kmajor(float* d, const uint32_t a[4],
                                                    uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// rows x (16 KS) bf16, row-major, into core matrices [row / 8][chunk][row % 8]
template <int KS>
__device__ void to_tile(uint32_t dst, const __nv_bfloat16* src, int rows) {
  for (int i = threadIdx.x; i < rows * 2 * KS; i += 128) {
    const int r = i / (2 * KS), c = i % (2 * KS);
    const uint4 v = *reinterpret_cast<const uint4*>(src + r * 16 * KS + c * 8);
    asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                     dst + (r / 8) * (2 * KS * 128) + c * 128 + (r % 8) * 16),
                 "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
                 : "memory");
  }
}

template <int KS, int EXTRA, bool QREG, bool PIN>
__global__ void __launch_bounds__(128, 1)
    qreg_probe(const __nv_bfloat16* q, const __nv_bfloat16* k, float* out, float* sink,
               int ntiles) {
  __shared__ __align__(128) unsigned char smem[2 * 64 * 16 * KS * 2];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int bs = 2 * KS * 128;  // bytes of 8 rows of a tile
  const uint32_t q_s = smem_u32(smem), k_s = q_s + 8 * bs;
  uint32_t qf[KS][4];
  if constexpr (QREG) {
    const uint32_t* qw = reinterpret_cast<const uint32_t*>(q);  // bf16 pairs
    const int row = warp * 16 + g, w = 8 * KS;                  // words a row
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      qf[ks][0] = qw[row * w + ks * 8 + t];
      qf[ks][1] = qw[(row + 8) * w + ks * 8 + t];
      qf[ks][2] = qw[row * w + ks * 8 + 4 + t];
      qf[ks][3] = qw[(row + 8) * w + ks * 8 + 4 + t];
    }
  } else {
    to_tile<KS>(q_s, q, 64);
  }
  float extra[EXTRA > 0 ? EXTRA : 1];
#pragma unroll
  for (int i = 0; i < (EXTRA > 0 ? EXTRA : 1); ++i) extra[i] = 0.f;

  for (int j = 0; j < ntiles; ++j) {
    __syncthreads();  // the previous tile is consumed
    to_tile<KS>(k_s, k + (long long)j * 64 * 16 * KS, 64);
    fence_proxy_async();
    __syncthreads();
    float s[32];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const uint64_t db = wgmma_desc(k_s + 2 * ks * 128, 128, bs);
      if constexpr (QREG)
        wgmma_rs_n64_kmajor(s, qf[ks], db, ks > 0);
      else
        wgmma_ss_n64(s, wgmma_desc(q_s + 2 * ks * 128, 128, bs), db, ks > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 32; ++i) wgmma_pin(s[i]);
    if constexpr (QREG && PIN) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
#pragma unroll
        for (int e = 0; e < 4; ++e) wgmma_pin(qf[ks][e]);
    }
    // out[j] in the accumulator layout: thread, then its 32 values
    float* o = out + ((long long)j * 128 + tid) * 32;
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = s[i];
#pragma unroll
    for (int i = 0; i < EXTRA; ++i) extra[i] = fmaf(s[i % 32], 1.f + i, extra[i]);
  }
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < (EXTRA > 0 ? EXTRA : 1); ++i) acc += extra[i];
  sink[tid] = acc;
}

template <int KS, int EXTRA, bool QREG, bool PIN>
cudaError_t run(const void* q, const void* k, float* out, float* sink, int ntiles,
                cudaStream_t st) {
  qreg_probe<KS, EXTRA, QREG, PIN><<<1, 128, 0, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k), out, sink,
      ntiles);
  return cudaGetLastError();
}

template <int KS, int EXTRA>
cudaError_t run_mode(int mode, const void* q, const void* k, float* out, float* sink,
                     int ntiles, cudaStream_t st) {
  switch (mode) {
    case 0: return run<KS, EXTRA, false, false>(q, k, out, sink, ntiles, st);
    case 1: return run<KS, EXTRA, true, true>(q, k, out, sink, ntiles, st);
    default: return run<KS, EXTRA, true, false>(q, k, out, sink, ntiles, st);
  }
}

}  // namespace

extern "C" {

// mode: 0 = Q from shared memory (reference), 1 = Q in registers, pinned,
// 2 = Q in registers, not pinned. ks in {3, 4, 5} (d = 48, 64, 80), extra in
// {0, 160, 224}. q: [64, 16 ks] bf16; k: [ntiles, 64, 16 ks] bf16; out:
// fp32 [ntiles, 128, 32]; sink: fp32 [128].
int c2d_qreg_probe(int mode, int ks, int extra, const void* q, const void* k, float* out,
                   float* sink, int ntiles, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
#define C2D_CASE(KS, EX) \
  if (ks == KS && extra == EX) return (int)run_mode<KS, EX>(mode, q, k, out, sink, ntiles, st);
  C2D_CASE(3, 0) C2D_CASE(3, 160) C2D_CASE(3, 224)
  C2D_CASE(4, 0) C2D_CASE(4, 160) C2D_CASE(4, 224)
  C2D_CASE(5, 0) C2D_CASE(5, 160) C2D_CASE(5, 224)
#undef C2D_CASE
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
