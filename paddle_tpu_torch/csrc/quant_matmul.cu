// int8_matmul for Hopper (sm_90a): out = dequant(quant(x) @ w_int).
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/quant_matmul.py:40
// (_qmm_kernel, launched by int8_matmul:59).  One kernel does the whole
// function, as the TPU kernel did: it quantizes the float activation tile to
// int8 on its way into shared memory, accumulates int8 x int8 products in
// int32 over all of K on the tensor cores (mma.sync m16n8k32 s8.s8.s32), and
// dequantizes per output channel in the epilogue.  The int8 activations and
// the int32 sums never touch device memory.
//
// What bounds it on an H100: at the serving shapes (M = slots in decode,
// M = prefill bucket) it moves far fewer bytes per operation than the card's
// balance point of ~590 int8 operations per byte, so it is bound by the bytes
// it streams, and those are almost all the K x N int8 weight.  The design
// reads each weight byte from device memory once per block row of M (once
// in all for decode, where one block row covers every slot) and keeps the
// quantized activations in shared memory.  Each thread loads 16 bytes at a
// time and issues the next K step's loads before this step's mma, so one
// step of load latency overlaps the tensor cores and the barriers.  It does
// not yet keep several stages in flight (cp.async/TMA ring), use wgmma, or
// split K when M is small and N gives few blocks; those are the next steps
// when the kernel is made fast.
//
// Numerics (held bit for bit against int8_matmul_plain on the card):
//   xq  = clamp(rint((x_f32 / a_s) * 127), -128, 127)   divide, then multiply;
//                                                       rint rounds half to even
//   acc = sum_k xq * w_int                                exact in int32
//   out = (float)acc * ((a_s / 127) * (w_scale[n] / 127)), rounded to out's type
// Every float operation is an explicit round-to-nearest intrinsic, so that no
// contraction or reciprocal rewrite can change a bit; build without
// --use_fast_math.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBK = 64;        // K depth of one shared-memory stage: two mma k-steps
constexpr int kLDS = kBK + 4;  // row stride in bytes: 17 words, coprime with the 32 banks

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}
__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
// Eight consecutive activations as fp32: one 16-byte load per 16 bytes
// when the row has them all and the address allows; element by element at
// a ragged edge, where out-of-range values read as 0 (and quantize to 0).
__device__ __forceinline__ void load_x8(const float* p, int valid, float (&v)[8]) {
  if (valid >= 8 && aligned16(p)) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = j < valid ? load_f32(p + j) : 0.f;
  }
}
__device__ __forceinline__ void load_x8(const __nv_bfloat16* p, int valid,
                                        float (&v)[8]) {
  if (valid >= 8 && aligned16(p)) {
    // a bf16 is the top half of its fp32: widening is exact bit placement
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const uint32_t words[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[2 * j] = __uint_as_float(words[j] << 16);
      v[2 * j + 1] = __uint_as_float(words[j] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = j < valid ? load_f32(p + j) : 0.f;
  }
}
// Sixteen consecutive int8 weights of one row, packed little-endian.
__device__ __forceinline__ uint4 load_w16(const int8_t* p, int valid) {
  if (valid >= 16 && aligned16(p)) return *reinterpret_cast<const uint4*>(p);
  uint32_t words[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < 16; ++j)
    if (j < valid)
      words[j >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(p[j]))
                       << ((j & 3) * 8);
  return make_uint4(words[0], words[1], words[2], words[3]);
}
__device__ __forceinline__ void store_out(float* p, long i, float v) { p[i] = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, long i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

__device__ __forceinline__ int8_t quantize(float x, float a_s) {
  float r = rintf(__fmul_rn(__fdiv_rn(x, a_s), 127.f));
  r = fminf(fmaxf(r, -128.f), 127.f);
  return static_cast<int8_t>(static_cast<int>(r));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A block of WM x WN warps computes a BM x BN output tile; each warp owns
// MI x NI mma tiles of 16 x 8.  Ragged edges in M, K and N are masked here:
// out-of-range operands load as 0 and out-of-range outputs are not stored.
template <typename XT, typename OT, int WM, int WN, int MI, int NI>
__global__ void __launch_bounds__(WM * WN * 32)
int8_matmul_kernel(const XT* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ w_scale,
                   const float* __restrict__ act_scale, OT* __restrict__ out,
                   int M, int K, int N) {
  constexpr int BM = WM * MI * 16;
  constexpr int BN = WN * NI * 8;
  constexpr int NT = WM * WN * 32;
  __shared__ __align__(16) int8_t As[BM * kLDS];  // [m][k] quantized activations
  __shared__ __align__(16) int8_t Bs[BN * kLDS];  // [n][k] weights, k contiguous

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WN, wn = warp % WN;
  const int g = lane >> 2, t = lane & 3;  // mma fragment group and thread-in-group
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const float a_s = *act_scale;

  int acc[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0;

  // Per thread and K step: AC runs of 8 activations, BC runs of 16 weights.
  constexpr int AC = BM * kBK / 8 / NT;
  constexpr int BC = kBK * BN / 16 / NT;
  static_assert(AC * 8 * NT == BM * kBK && BC * 16 * NT == kBK * BN,
                "tile sizes must split evenly over the block's threads");
  float xa[AC][8];
  uint4 wb[BC];
  auto load_tiles = [&](int k0) {
#pragma unroll
    for (int c = 0; c < AC; ++c) {
      const int i = (tid + c * NT) * 8;
      const int gm = m0 + i / kBK, gk = k0 + i % kBK;
      load_x8(x + (long)gm * K + gk, gm < M ? K - gk : 0, xa[c]);
    }
#pragma unroll
    for (int c = 0; c < BC; ++c) {
      const int i = (tid + c * NT) * 16;
      const int gk = k0 + i / BN, gn = n0 + i % BN;
      wb[c] = load_w16(w + (long)gk * N + gn, gk < K ? N - gn : 0);
    }
  };
  load_tiles(0);

  // The TPU grid's sequential k axis becomes this loop inside the block.
  // The next step's global loads are issued before this step's mma, so
  // their latency overlaps the tensor-core work and the barriers.
  for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
    for (int c = 0; c < AC; ++c) {
      const int i = (tid + c * NT) * 8;
      uint32_t packed[2] = {0u, 0u};
#pragma unroll
      for (int j = 0; j < 8; ++j)
        packed[j >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(
                              quantize(xa[c][j], a_s)))
                          << ((j & 3) * 8);
      uint32_t* dst = reinterpret_cast<uint32_t*>(As + (i / kBK) * kLDS + i % kBK);
      dst[0] = packed[0];
      dst[1] = packed[1];
    }
    // w is (K, N) row-major; stored transposed so that four consecutive k of
    // one column fill the 32-bit register an mma B fragment takes.
#pragma unroll
    for (int c = 0; c < BC; ++c) {
      const int i = (tid + c * NT) * 16;
      const int r = i / BN, col = i % BN;
      const uint32_t words[4] = {wb[c].x, wb[c].y, wb[c].z, wb[c].w};
#pragma unroll
      for (int j = 0; j < 16; ++j)
        Bs[(col + j) * kLDS + r] =
            static_cast<int8_t>((words[j >> 2] >> ((j & 3) * 8)) & 0xff);
    }
    __syncthreads();
    if (k0 + kBK < K) load_tiles(k0 + kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t af[MI][4], bf[NI][2];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const int8_t* p = As + (wm * MI * 16 + mi * 16 + g) * kLDS + kk + t * 4;
        af[mi][0] = *reinterpret_cast<const uint32_t*>(p);
        af[mi][1] = *reinterpret_cast<const uint32_t*>(p + 8 * kLDS);
        af[mi][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        af[mi][3] = *reinterpret_cast<const uint32_t*>(p + 8 * kLDS + 16);
      }
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int8_t* p = Bs + (wn * NI * 8 + ni * 8 + g) * kLDS + kk + t * 4;
        bf[ni][0] = *reinterpret_cast<const uint32_t*>(p);
        bf[ni][1] = *reinterpret_cast<const uint32_t*>(p + 16);
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
    }
    __syncthreads();
  }

  // Epilogue: per-channel dequant in the order of quant_matmul.py:54-56.
  const float a_f = __fdiv_rn(a_s, 127.f);
#pragma unroll
  for (int ni = 0; ni < NI; ++ni) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int gn = n0 + wn * NI * 8 + ni * 8 + t * 2 + j;
      if (gn >= N) continue;
      const float s = __fmul_rn(a_f, __fdiv_rn(w_scale[gn], 127.f));
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int gm = m0 + wm * MI * 16 + mi * 16 + g + h * 8;
          if (gm < M)
            store_out(out, (long)gm * N + gn,
                      __fmul_rn(__int2float_rn(acc[mi][ni][h * 2 + j]), s));
        }
      }
    }
  }
}

template <typename XT, typename OT, int WM, int WN, int MI, int NI>
void launch(const void* x, const void* w, const void* w_scale,
            const void* act_scale, void* out, int M, int K, int N,
            cudaStream_t stream) {
  constexpr int BM = WM * MI * 16;
  constexpr int BN = WN * NI * 8;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  int8_matmul_kernel<XT, OT, WM, WN, MI, NI><<<grid, WM * WN * 32, 0, stream>>>(
      static_cast<const XT*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(w_scale), static_cast<const float*>(act_scale),
      static_cast<OT*>(out), M, K, N);
}

template <typename XT, typename OT>
void launch_for_m(const void* x, const void* w, const void* w_scale,
                  const void* act_scale, void* out, int M, int K, int N,
                  cudaStream_t stream) {
  if (M <= 16)  // decode: one 16-row block row covers every slot
    launch<XT, OT, 1, 4, 1, 1>(x, w, w_scale, act_scale, out, M, K, N, stream);
  else          // prefill: 64 x 64 tiles, 2 x 2 warps of 32 x 32
    launch<XT, OT, 2, 2, 2, 4>(x, w, w_scale, act_scale, out, M, K, N, stream);
}

}  // namespace

// x: (M, K) fp32 or bf16; w: (K, N) int8; w_scale: (N,) fp32; act_scale: one
// fp32 in device memory; out: (M, N) fp32 or bf16.  All contiguous, all on
// the current device.  Launches on `stream`, does not synchronise, returns
// cudaGetLastError() of the launch.
extern "C" int int8_matmul_launch(const void* x, int x_bf16, const void* w,
                                  const void* w_scale, const void* act_scale,
                                  void* out, int out_bf16, int M, int K, int N,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    if (out_bf16)
      launch_for_m<__nv_bfloat16, __nv_bfloat16>(x, w, w_scale, act_scale, out, M, K, N, s);
    else
      launch_for_m<__nv_bfloat16, float>(x, w, w_scale, act_scale, out, M, K, N, s);
  } else {
    if (out_bf16)
      launch_for_m<float, __nv_bfloat16>(x, w, w_scale, act_scale, out, M, K, N, s);
    else
      launch_for_m<float, float>(x, w, w_scale, act_scale, out, M, K, N, s);
  }
  return static_cast<int>(cudaGetLastError());
}
