// The 3x3 convolution core of K1 (modconv3x3.cu) and K2 (conv3x3.cu) on
// Hopper's tensor cores, in two forms: fp32 in and out (3xTF32, below) and
// bf16 in and out (one bf16 MMA; the last paragraph below); NHWC, stride 1,
// zero padding 1, sm_90a only (wgmma).
//
//   out[b,h,w,o] = act( demod[b,o] * sum_{ky,kx,i} x[b,h+ky-1,w+kx-1,i] * style[b,i]
//                                                  * (scale*wt[ky,kx,i,o])
//                       + noise_w * noise[b,h,w] + bias[o] )
//
// with act = lrelu(0.2)*sqrt(2) when `act` is set. style, demod, noise and
// bias are optional: a null pointer reads as a factor of 1 or a term of 0.
// K1 passes the style and demod of a modulated conv, its noise and scale 1;
// K2 passes the equalised-lr scale and nothing else. Each source names its
// kernels with a tag type of its own (a profile tells K1 from K2), which
// also says whether the input is modulated.
//
// An implicit GEMM: M = B*H*W output pixels, N = Cout, K = 9*Cin. Bound on
// the H100: operations, at the tensor cores' rate for fp32-accurate
// products. Each fp32 operand v is split into big = tf32(v) (round to
// nearest, cvt.rna.tf32.f32) and small = tf32(v - big), and every product
// is taken as three TF32 MMAs, small terms first:
//
//   acc += a_small*b_big + a_big*b_small + a_big*b_big
//
// ("3xTF32"). The dropped a_small*b_small is ~2^-22 of the product, so the
// result keeps fp32 accuracy (the port's policy), at a third of the TF32
// rate: 495/3 = 165 TFLOP/s, against 67 TFLOP/s for fp32 FMAs. One TF32 MMA
// alone would keep ~11 bits per operand, ~4e-4 of the output's scale at K =
// 4608 (tests/test_torch_tf32_split.py).
//
// Design:
// - A block holds an output tile of BM = 128 pixels (a TH x TW patch of one
//   image, or NI whole images when an image has fewer than 128 pixels) and
//   BN = 32, 64 or 128 output channels (by Cout); two warpgroups each own
//   64 of the pixels and issue wgmma.m64nBNk8.
// - K runs over chunks of CK = 8 input channels; a chunk serves the 9 taps.
//   Per chunk the block stages, with cp.async into a ring of two stages (the
//   next chunk's loads overlap this chunk's MMAs): the halo'd input patch,
//   (TH+2) x (TW+2) x 8 fp32 per image, zero outside the image and past Cin;
//   and the chunk's weights for the 9 taps, already split into big and
//   small, each a K-major BN x 8 tile in wgmma's unswizzled core-matrix
//   layout (8 rows of N x 16 bytes of K; the two K halves 128 bytes apart,
//   the next 8 rows 256 bytes on).
// - B (weights, big and small) is read by wgmma from shared memory. A comes
//   from registers: a shifted 3x3 tap does not fit a shared-memory
//   descriptor, so each thread reads its fragment's four values of the tap
//   out of the halo patch (two 8-byte loads: the kernel's K order inside a
//   chunk puts channels 2t and 2t+1 at fragment columns t and t+4) and
//   splits them itself.
// - K1's modulation, a per-(image, Cin) style factor, multiplies those
//   values before the split (after it, the parts would not stay exact in
//   TF32). The chunk's style rows (NI x 8 values) are staged with it, zero
//   past B and Cin; each thread reads its two rows' four values once per
//   chunk, each row from its own image (a block of small images holds
//   several). demod (per image and Cout), the per-pixel noise and the bias
//   are the epilogue's, in the plain version's order:
//   act(acc * demod + noise_w * noise + bias).
// - The weights are prepared by conv3x3_tc_prep: HWIO in, scaled by
//   `scale` (as the plain version scales them), permuted K-major, split
//   and tiled per (Cout tile, chunk, tap, part), so a stage is one
//   contiguous copy. Cout is padded to BN and Cin to CK with zeros, so
//   ragged channel counts (final_conv's 513 inputs, its input gradient's
//   513 outputs) need no other masking than at the stores. A call prepares
//   them itself, or takes a buffer prepared earlier (K1 at inference, where
//   a layer's weights stay as they are from call to call).
// - Where the (pixel tile, Cout tile) grid would not fill the SMs (16^2 and
//   below at batch 8, 32^2 and below at batch 1) the chunks are split
//   across blocks (split-K): each block writes raw sums to fp32 scratch
//   (splits, B, H, W, Cout) and conv3x3_tc_reduce sums the splits in a
//   fixed order and applies the epilogue, so the result does not depend on
//   the order blocks ran in.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <type_traits>

namespace conv3x3_tc {

constexpr int kThreads = 256;  // two warpgroups
constexpr int BM = 128;        // output pixels per block
using bf16 = __nv_bfloat16;

// Per element type: CK input channels per chunk (one MMA depth per tap) and
// the parts each weight is kept in (fp32: big and small TF32 parts).
template <class T> struct Elem;
template <> struct Elem<float> { static constexpr int CK = 8, parts = 2; };
template <> struct Elem<bf16> { static constexpr int CK = 16, parts = 1; };

constexpr int kMaxSmem = 232448;  // bytes a block may use on the H100
constexpr int kMinChunks = 2;     // chunks per split at least
constexpr float kSqrt2 = 1.4142135623730951f;

inline int cdiv(long long a, long long b) { return static_cast<int>((a + b - 1) / b); }

// ---------------------------------------------------------------------------
// device helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void split_tf32(float v, uint32_t& big, uint32_t& small) {
  big = to_tf32(v);
  small = to_tf32(v - __uint_as_float(big));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes from global to shared, asynchronously; zeros when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread's copies are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// shared-memory writes made visible to wgmma's (async proxy) reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keeps the compiler from moving accesses of v across the asm statements
// around it (the accumulators are written by the tensor cores behind the
// compiler's back until wgmma_wait)
template <int N>
__device__ __forceinline__ void fence_operand(float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(v[i]) :: "memory");
}

// Descriptor of a K-major BN x 8 tf32 (or BN x 16 bf16) tile in the unswizzled core-matrix
// layout: core matrix (8 rows of N, 16 bytes of K) (nb, kh) at byte
// (2*nb + kh)*128 from the tile's start. Leading byte offset (between the
// two K halves) 128, stride byte offset (between groups of 8 rows) 256,
// both in units of 16 bytes; layout type 0 (no swizzle).
__device__ __forceinline__ uint64_t tile_desc(const void* tile) {
  uint64_t d = (smem_addr(tile) >> 4) & 0x3FFF;
  d |= static_cast<uint64_t>(128 >> 4) << 16;
  d |= static_cast<uint64_t>(256 >> 4) << 32;
  return d;
}

// acc(64 x BN, this thread's BN/2 values) = A(64 x 8, from registers) *
// B(8 x BN, from shared memory via desc) + (scale_d ? acc : 0), TF32 in,
// fp32 accumulate.
template <int BN>
__device__ __forceinline__ void mma(float (&d)[BN / 2], const uint32_t (&a)[4],
                                    uint64_t desc, int scale_d);

template <>
__device__ __forceinline__ void mma<32>(float (&d)[16], const uint32_t (&a)[4],
                                         uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void mma<64>(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void mma<128>(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// The bf16 form: acc(64 x BN) = A(64 x 16 bf16, from registers, packed in
// pairs) * B(16 x BN bf16, K-major in shared memory via desc) + (scale_d ?
// acc : 0), fp32 accumulate. The last immediate (0) keeps B K-major.
#define W2E_D8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
                  "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define W2E_A_DESC "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d)

template <int BN>
__device__ __forceinline__ void mma_bf16(float (&d)[BN / 2], const uint32_t (&a)[4],
                                         uint64_t desc, int scale_d);

template <>
__device__ __forceinline__ void mma_bf16<32>(float (&d)[16], const uint32_t (&a)[4],
                                              uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : W2E_D8(0), W2E_D8(8)
      : W2E_A_DESC);
}

template <>
__device__ __forceinline__ void mma_bf16<64>(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : W2E_D8(0), W2E_D8(8), W2E_D8(16), W2E_D8(24)
      : W2E_A_DESC);
}

template <>
__device__ __forceinline__ void mma_bf16<128>(float (&d)[64], const uint32_t (&a)[4],
                                               uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : W2E_D8(0), W2E_D8(8), W2E_D8(16), W2E_D8(24),
        W2E_D8(32), W2E_D8(40), W2E_D8(48), W2E_D8(56)
      : W2E_A_DESC);
}
#undef W2E_D8
#undef W2E_A_DESC

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// round(v * s) of a packed bf16 pair (low half: the lower channel), the
// product taken in fp32, where it is exact
__device__ __forceinline__ uint32_t modulate_bf16x2(uint32_t v, float s_lo, float s_hi) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
  return bf16x2_bits(__floats2bfloat162_rn(f.x * s_lo, f.y * s_hi));
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// a value of the output type from the fp32 epilogue
template <class T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_float<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// two neighbouring output values (channels n, n + 1) at p[i]: one store
// when `pair` (the pair is aligned), else one or two (`second`: n + 1 is
// in range)
__device__ __forceinline__ void store2(float* p, size_t i, float a, float b,
                                       bool pair, bool second) {
  if (pair) {
    *reinterpret_cast<float2*>(p + i) = make_float2(a, b);
  } else {
    p[i] = a;
    if (second) p[i + 1] = b;
  }
}

__device__ __forceinline__ void store2(bf16* p, size_t i, float a, float b,
                                       bool pair, bool second) {
  if (pair) {
    *reinterpret_cast<__nv_bfloat162*>(p + i) = __floats2bfloat162_rn(a, b);
  } else {
    p[i] = __float2bfloat16_rn(a);
    if (second) p[i + 1] = __float2bfloat16_rn(b);
  }
}

// ---------------------------------------------------------------------------
// kernels
// ---------------------------------------------------------------------------

// The weights: wt (3,3,Cin,Cout) HWIO times `scale` into
// wp[n_tile][chunk][tap][part][nb][kh][r][q] (part 0 big, 1 small), the
// element of output channel n_tile*BN + 8*nb + r and input channel
// chunk*CK + 2*q + kh: inside a chunk, K position kh*4 + q holds channel
// 2*q + kh, the order the A fragments are read in. Zeros past Cin and Cout.
// One thread per (n_tile, chunk, tap, nb, kh, r) writes the four q of both
// parts as two 16-byte stores. (kernels/common.py::tc_prepared_plain is its
// plain twin.)
template <class Kind>
__global__ void __launch_bounds__(256)
conv3x3_tc_prep(const float* __restrict__ wt, float scale, float* __restrict__ wp,
                int Cin, int Cout, int BN, int chunks, int total) {
  constexpr int CK = Elem<float>::CK;
  // 32-bit index arithmetic (a 64-bit division by a run-time value costs
  // more than the element's bytes); the host keeps total under 2^31
  const unsigned e = blockIdx.x * 256u + threadIdx.x;
  if (e >= static_cast<unsigned>(total)) return;
  // r fastest: neighbouring threads read neighbouring output channels
  const int r = static_cast<int>(e % 8);
  unsigned rest = e / 8;
  const int kh = static_cast<int>(rest % 2);
  rest /= 2;
  const unsigned nbs = static_cast<unsigned>(BN / 8);
  const int nb = static_cast<int>(rest % nbs);
  rest /= nbs;
  const int tap = static_cast<int>(rest % 9);
  rest /= 9;
  const int chunk = static_cast<int>(rest % static_cast<unsigned>(chunks));
  const int nt = static_cast<int>(rest / static_cast<unsigned>(chunks));
  const int n = nt * BN + nb * 8 + r;
  float big[4], small[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int ci = chunk * CK + 2 * q + kh;
    const float v = (n < Cout && ci < Cin)
        ? wt[((size_t)tap * Cin + ci) * Cout + n] * scale : 0.f;
    uint32_t b, sm;
    split_tf32(v, b, sm);
    big[q] = __uint_as_float(b);
    small[q] = __uint_as_float(sm);
  }
  const size_t base = (((size_t)nt * chunks + chunk) * 9 + tap) * 2 * BN * CK;
  const int within = ((nb * 2 + kh) * 8 + r) * 4;
  *reinterpret_cast<float4*>(wp + base + within) =
      make_float4(big[0], big[1], big[2], big[3]);
  *reinterpret_cast<float4*>(wp + base + BN * CK + within) =
      make_float4(small[0], small[1], small[2], small[3]);
}

// The bf16 form: round(scale * wt) into
// wp[n_tile][chunk][tap][nb][kh][r][j], the element of output channel
// n_tile*BN + 8*nb + r and input channel chunk*16 + 4*(j/2) + 2*kh + j%2
// (K position 8*kh + j; see the header). One thread per (n_tile, chunk,
// tap, nb, kh, r) writes its eight j as one 16-byte store.
// (kernels/common.py::tc_prepared_plain with dtype bf16 is its plain twin.)
template <class Kind>
__global__ void __launch_bounds__(256)
conv3x3_tc_prep_bf16(const float* __restrict__ wt, float scale, bf16* __restrict__ wp,
                     int Cin, int Cout, int BN, int chunks, int total) {
  constexpr int CK = Elem<bf16>::CK;
  const unsigned e = blockIdx.x * 256u + threadIdx.x;
  if (e >= static_cast<unsigned>(total)) return;
  const int r = static_cast<int>(e % 8);
  unsigned rest = e / 8;
  const int kh = static_cast<int>(rest % 2);
  rest /= 2;
  const unsigned nbs = static_cast<unsigned>(BN / 8);
  const int nb = static_cast<int>(rest % nbs);
  rest /= nbs;
  const int tap = static_cast<int>(rest % 9);
  rest /= 9;
  const int chunk = static_cast<int>(rest % static_cast<unsigned>(chunks));
  const int nt = static_cast<int>(rest / static_cast<unsigned>(chunks));
  const int n = nt * BN + nb * 8 + r;
  uint32_t packed[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {  // j = 2q, 2q + 1
    float v[2];
#pragma unroll
    for (int lo = 0; lo < 2; ++lo) {
      const int ci = chunk * CK + 4 * q + 2 * kh + lo;
      v[lo] = (n < Cout && ci < Cin) ? wt[((size_t)tap * Cin + ci) * Cout + n] * scale : 0.f;
    }
    packed[q] = bf16x2_bits(__floats2bfloat162_rn(v[0], v[1]));
  }
  const size_t base = (((size_t)nt * chunks + chunk) * 9 + tap) * BN * CK;
  const int within = ((nb * 2 + kh) * 8 + r) * 8;
  *reinterpret_cast<uint4*>(wp + base + within) =
      make_uint4(packed[0], packed[1], packed[2], packed[3]);
}

// The block's pixel tile.
struct Tile {
  int th, tw, ni;         // rows and columns of the patch; images per block
  int tiles_h, tiles_w;   // patches per image
  int m_tiles;            // pixel tiles in the whole batch
  int halo;               // staged positions per block: ni*(th+2)*(tw+2)
};

inline Tile make_tile(int B, int H, int W) {
  Tile t;
  t.tw = std::min(W, 16);
  t.th = std::min(H, BM / t.tw);
  t.ni = (t.th == H && t.tw == W) ? std::max(1, BM / (H * W)) : 1;
  t.tiles_h = cdiv(H, t.th);
  t.tiles_w = cdiv(W, t.tw);
  t.m_tiles = cdiv(B, t.ni) * t.tiles_h * t.tiles_w;
  t.halo = t.ni * (t.th + 2) * (t.tw + 2);
  return t;
}

// a stage's weights, in elements of T
template <class T>
__host__ __device__ constexpr int b_elems(int BN) {
  return 9 * Elem<T>::parts * BN * Elem<T>::CK;
}

constexpr int kStages = 2;  // of the cp.async ring

// blocks resident on an SM: more where the Cout tile is narrow, whose MMAs
// are short, so that other warpgroups' MMAs cover each one's fragment
// loads and barriers (the registers then allowed: 64 at BN = 32, 128 at 64)
__host__ __device__ constexpr int min_blocks(int BN) { return BN == 32 ? 4 : BN == 64 ? 2 : 1; }

// a stage: the weights and the halo'd input patch (T) and, when modulated,
// the chunk's style rows of the block's images (fp32); bytes, 128-byte
// aligned
template <class T>
__host__ __device__ inline int stage_bytes(int BN, const Tile& t, bool modulated) {
  constexpr int CK = Elem<T>::CK;
  return static_cast<int>(((b_elems<T>(BN) + t.halo * CK) * sizeof(T)
                           + (modulated ? t.ni * CK * sizeof(float) : 0) + 127)
                          / 128 * 128);
}

// The epilogue's operands; a null pointer is a factor of 1 or a term of 0.
struct Epilogue {
  const float* demod;        // (B, Cout)
  const float* noise;        // (B or 1, H, W), image b at b * noise_bstride
  long long noise_bstride;   // H*W, or 0 for one noise shared by the batch
  const float* noise_w;      // (1,)
  const float* bias;         // (Cout,)
  int act;                   // lrelu(0.2)*sqrt(2)
};

// act(v * demod + nz + bias) for image b, output channel n; nz is the
// pixel's noise_w * noise (0 without noise). demod and noise exist only
// where MOD (K1): K2's epilogue is the bias and the activation alone.
template <bool MOD>
__device__ __forceinline__ float finish(float v, const Epilogue e, float nz, int b,
                                        int n, int Cout) {
  if (MOD && e.demod != nullptr) v *= e.demod[(size_t)b * Cout + n];
  if (MOD && e.noise != nullptr) v += nz;
  if (e.bias != nullptr) v += e.bias[n];
  if (e.act) v = (v >= 0.f ? v : 0.2f * v) * kSqrt2;
  return v;
}


// One block: pixel tile blockIdx.x, Cout tile blockIdx.y, chunk range
// blockIdx.z. VEC: a row of Cin is whole 16-byte copies (Cin % 4 == 0 in
// fp32, Cin % 8 == 0 in bf16), else one value at a time. Kind::modulated:
// x is multiplied by style (B, Cin), or by 1 where style is null. T: float
// (3xTF32) or bf16 (one bf16 MMA per tap, see the header).
template <int BN, bool VEC, class Kind, class T>
__global__ void __launch_bounds__(kThreads, min_blocks(BN))
conv3x3_tc_kernel(const T* __restrict__ x, const float* __restrict__ style,
                  const T* __restrict__ wp, Epilogue epi,
                  T* __restrict__ out, float* __restrict__ partial, int B,
                  int H, int W, int Cin, int Cout, Tile tile, int chunks,
                  int chunks_per_split) {
  constexpr bool MOD = Kind::modulated;
  constexpr bool BF16 = std::is_same<T, bf16>::value;
  constexpr int CK = Elem<T>::CK;
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int BE = b_elems<T>(BN);
  const int halo_w = tile.tw + 2;
  const int halo_img = (tile.th + 2) * halo_w;
  const int sb = stage_bytes<T>(BN, tile, MOD);
  // the style rows, in bytes from a stage's start
  const int style_at = static_cast<int>((BE + tile.halo * CK) * sizeof(T));

  const int mt = blockIdx.x;
  const int nt = blockIdx.y;
  const int split = blockIdx.z;
  const int w0 = (mt % tile.tiles_w) * tile.tw;
  const int h0 = ((mt / tile.tiles_w) % tile.tiles_h) * tile.th;
  const int b0 = (mt / (tile.tiles_w * tile.tiles_h)) * tile.ni;
  const int c_begin = split * chunks_per_split;
  const int c_end = min(chunks, c_begin + chunks_per_split);

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int row0 = (tid / 128) * 64 + ((tid / 32) % 4) * 16 + g;  // M row of a0
  const int tile_px = tile.th * tile.tw;
  // the channels of a row's fragment values inside a chunk: 2t, 2t + 1
  // (fp32), 4t .. 4t + 3 (bf16)
  constexpr int FRAG = BF16 ? 4 : 2;

  // halo position of tap (0, 0) for the fragment's two rows (row0, row0 + 8),
  // and where the row's style values sit among the stage's style rows
  int hpos[2], spos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = row0 + 8 * h;
    if (p < tile.ni * tile_px) {
      const int img = p / tile_px;
      const int rem = p % tile_px;
      hpos[h] = img * halo_img + (rem / tile.tw) * halo_w + rem % tile.tw;
      spos[h] = img * CK + FRAG * t;
    } else {
      // a padding row: reads valid positions, never stored
      hpos[h] = 0;
      spos[h] = FRAG * t;
    }
  }

  const T* wtile = wp + (size_t)nt * chunks * BE;
  constexpr int W16 = 16 / sizeof(T);  // values per 16-byte copy
  constexpr int PER = VEC ? W16 : 1;   // values per copy of x
  constexpr int SPER = VEC ? 4 : 1;    // values per copy of the style

  auto load_stage = [&](int chunk, unsigned char* st) {
    T* ws = reinterpret_cast<T*>(st);
    const T* src = wtile + (size_t)chunk * BE;
    for (int i = tid; i < BE / W16; i += kThreads) cp_async16(ws + W16 * i, src + W16 * i, true);
    T* as = ws + BE;
    const int c0 = chunk * CK;
    for (int i = tid; i < tile.halo * (CK / PER); i += kThreads) {
      const int k = (i % (CK / PER)) * PER;
      const int pos = i / (CK / PER);
      const int img = pos / halo_img;
      const int rem = pos % halo_img;
      const int b = b0 + img;
      const int hh = h0 + rem / halo_w - 1;
      const int ww = w0 + rem % halo_w - 1;
      const int ci = c0 + k;
      const bool ok = b < B && hh >= 0 && hh < H && ww >= 0 && ww < W && ci < Cin;
      const T* s = ok ? x + (((size_t)b * H + hh) * W + ww) * Cin + ci : x;
      if constexpr (VEC) cp_async16(as + pos * CK + k, s, ok);
      else if constexpr (!BF16) cp_async4(as + pos * CK + k, s, ok);
      else as[pos * CK + k] = ok ? *s : from_float<T>(0.f);  // no 2-byte cp.async
    }
    if constexpr (MOD) {
      // the style rows of the block's images: zero past B and Cin, where
      // x is zero too (a read past the array's end could be NaN, 0*NaN)
      if (style != nullptr) {
        float* ss = reinterpret_cast<float*>(st + style_at);
        for (int i = tid; i < tile.ni * (CK / SPER); i += kThreads) {
          const int k = (i % (CK / SPER)) * SPER;
          const int img = i / (CK / SPER);
          const int b = b0 + img;
          const int ci = c0 + k;
          const bool ok = b < B && ci < Cin;
          const float* s = ok ? style + (size_t)b * Cin + ci : style;
          if constexpr (VEC) cp_async16(ss + img * CK + k, s, ok);
          else cp_async4(ss + img * CK + k, s, ok);
        }
      }
    }
  };

  if constexpr (MOD) {
    // no style: a factor of 1, written once into both stages (the loop's
    // first barrier makes it visible)
    if (style == nullptr) {
      for (int i = tid; i < kStages * tile.ni * CK; i += kThreads)
        reinterpret_cast<float*>(smem + (i / (tile.ni * CK)) * sb + style_at)
            [i % (tile.ni * CK)] = 1.f;
    }
  }

  // The tensor cores do not round their fp32 sums to nearest, so a sum
  // carried through all of K drifts with K (measured: ~2.6e-5 of the
  // output's scale at K = 4608). Each chunk (9 * CK K positions) therefore
  // sums into a fresh accumulator `part`, which is added to `acc` in fp32.
  float acc[BN / 2], part[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = part[i] = 0.f;

  // the ring: chunk c in stage (c - c_begin) % S; S - 1 chunks in flight
  constexpr int S = kStages;
#pragma unroll
  for (int k = 0; k < S - 1; ++k) {
    if (c_begin + k < c_end) load_stage(c_begin + k, smem + k * sb);
    cp_async_commit();
  }
  for (int c = c_begin; c < c_end; ++c) {
    const unsigned char* st = smem + ((c - c_begin) % S) * sb;
    cp_async_wait<S - 2>();  // chunk c's copies are in
    fence_proxy_async();
    __syncthreads();  // ... for every thread; all MMAs of chunk c - 1 are done
    if (c + S - 1 < c_end)  // into the stage chunk c - 1 used
      load_stage(c + S - 1, smem + ((c + S - 1 - c_begin) % S) * sb);
    cp_async_commit();
    const T* wst = reinterpret_cast<const T*>(st);
    const T* as = wst + BE;
    const float* ss = reinterpret_cast<const float*>(st + style_at);
    if constexpr (BF16) {
      // the two rows' style for channels 4t .. 4t + 3, rounded to bf16 as
      // the TPU kernel rounds it, once a chunk
      float4 s0 = make_float4(1.f, 1.f, 1.f, 1.f), s1 = s0;
      if constexpr (MOD) {
        s0 = *reinterpret_cast<const float4*>(ss + spos[0]);
        s1 = *reinterpret_cast<const float4*>(ss + spos[1]);
        s0 = make_float4(round_bf16(s0.x), round_bf16(s0.y), round_bf16(s0.z), round_bf16(s0.w));
        s1 = make_float4(round_bf16(s1.x), round_bf16(s1.y), round_bf16(s1.z), round_bf16(s1.w));
      }
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int off = (tap / 3) * halo_w + tap % 3;
        uint2 v0 = *reinterpret_cast<const uint2*>(as + (hpos[0] + off) * CK + 4 * t);
        uint2 v1 = *reinterpret_cast<const uint2*>(as + (hpos[1] + off) * CK + 4 * t);
        if constexpr (MOD) {
          v0 = make_uint2(modulate_bf16x2(v0.x, s0.x, s0.y), modulate_bf16x2(v0.y, s0.z, s0.w));
          v1 = make_uint2(modulate_bf16x2(v1.x, s1.x, s1.y), modulate_bf16x2(v1.y, s1.z, s1.w));
        }
        // fragment a0..a3 = (row0, k 2t..2t+1), (row0 + 8, 2t..2t+1),
        // (row0, 2t+8..2t+9), (row0 + 8, 2t+8..2t+9): channels 4t, 4t + 1
        // and 4t + 2, 4t + 3 of each row
        const uint32_t a[4] = {v0.x, v1.x, v0.y, v1.y};
        const uint64_t d = tile_desc(wst + tap * BN * CK);
        wgmma_fence();
        mma_bf16<BN>(part, a, d, tap > 0);
        wgmma_commit();
        wgmma_wait<1>();  // the previous tap's fragments are free again
      }
    } else {
      // the two rows' style for channels 2t (.x) and 2t + 1 (.y), once a chunk
      float2 s0 = make_float2(1.f, 1.f), s1 = s0;
      if constexpr (MOD) {
        s0 = *reinterpret_cast<const float2*>(ss + spos[0]);
        s1 = *reinterpret_cast<const float2*>(ss + spos[1]);
      }
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int off = (tap / 3) * halo_w + tap % 3;
        float2 v0 = *reinterpret_cast<const float2*>(as + (hpos[0] + off) * CK + 2 * t);
        float2 v1 = *reinterpret_cast<const float2*>(as + (hpos[1] + off) * CK + 2 * t);
        if constexpr (MOD) {  // modulate before the split
          v0.x *= s0.x; v0.y *= s0.y;
          v1.x *= s1.x; v1.y *= s1.y;
        }
        // fragment a0..a3 = (row0, t), (row0 + 8, t), (row0, t + 4), (row0 + 8, t + 4)
        uint32_t big[4], small[4];
        split_tf32(v0.x, big[0], small[0]);
        split_tf32(v1.x, big[1], small[1]);
        split_tf32(v0.y, big[2], small[2]);
        split_tf32(v1.y, big[3], small[3]);
        const T* wb = wst + tap * 2 * BN * CK;
        const uint64_t d_big = tile_desc(wb);
        const uint64_t d_small = tile_desc(wb + BN * CK);
        wgmma_fence();
        mma<BN>(part, small, d_big, tap > 0);
        mma<BN>(part, big, d_small, 1);
        mma<BN>(part, big, d_big, 1);
        wgmma_commit();
        wgmma_wait<1>();  // the previous tap's fragments are free again
      }
    }
    wgmma_wait<0>();
    fence_operand(part);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
  }

  // acc[4j + 2h + e] is (row0 + 8h, column 8j + 2t + e); raw sums go to the
  // fp32 scratch of split split, finished values to out
  const bool pairs = (Cout & 1) == 0;
  float* raw = partial != nullptr ? partial + (size_t)split * B * H * W * Cout : nullptr;
  const bool noisy = MOD && partial == nullptr && epi.noise != nullptr;
  const float nw = noisy ? *epi.noise_w : 0.f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = row0 + 8 * h;
    if (p >= tile.ni * tile_px) continue;
    const int img = p / tile_px;
    const int rem = p % tile_px;
    const int b = b0 + img;
    const int hh = h0 + rem / tile.tw;
    const int ww = w0 + rem % tile.tw;
    if (b >= B || hh >= H || ww >= W) continue;
    const size_t o = (((size_t)b * H + hh) * W + ww) * Cout;
    const float nz = noisy
        ? nw * epi.noise[(size_t)b * epi.noise_bstride + (size_t)hh * W + ww] : 0.f;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = nt * BN + 8 * j + 2 * t;
      if (n >= Cout) continue;
      float v[2] = {acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]};
      if (raw != nullptr) {
        store2(raw, o + n, v[0], v[1], pairs, n + 1 < Cout);
      } else {
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (n + e < Cout) v[e] = finish<MOD>(v[e], epi, nz, b, n + e, Cout);
        store2(out, o + n, v[0], v[1], pairs, n + 1 < Cout);
      }
    }
  }
}

// Split-K second pass: one thread per output element sums the splits in
// order, then applies the epilogue and stores in the output's type.
template <class Kind, class T>
__global__ void __launch_bounds__(256)
conv3x3_tc_reduce(const float* __restrict__ partial, int splits, Epilogue epi,
                  T* __restrict__ out, long long n, int HW, int Cout) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= n) return;
  float v = 0.f;
  for (int s = 0; s < splits; ++s) v += partial[s * n + i];
  const long long pix = i / Cout;
  const int b = static_cast<int>(pix / HW);
  constexpr bool MOD = Kind::modulated;
  const float nz = MOD && epi.noise != nullptr
      ? *epi.noise_w * epi.noise[(size_t)b * epi.noise_bstride + pix % HW] : 0.f;
  out[i] = from_float<T>(finish<MOD>(v, epi, nz, b, static_cast<int>(i % Cout), Cout));
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

inline int tile_n(int Cout) { return Cout <= 32 ? 32 : Cout <= 64 ? 64 : 128; }

template <class T>
inline size_t smem_bytes(int BN, const Tile& t, bool modulated) {
  return static_cast<size_t>(kStages) * stage_bytes<T>(BN, t, modulated);
}

// How many ways to split the chunks for this shape on a card with `sms`
// SMs: 1 when the (pixel tile, Cout tile) grid fills the SMs, else as many
// as keep the grid within one wave, each split at least kMinChunks chunks.
template <class T>
inline int splits_for(int B, int H, int W, int Cin, int Cout, int sms, bool modulated) {
  const Tile t = make_tile(B, H, W);
  const int BN = tile_n(Cout);
  const int base = t.m_tiles * cdiv(Cout, BN);
  if (base >= sms) return 1;
  const int per_sm = std::max(1, std::min(2048 / kThreads,
      kMaxSmem / (int)(smem_bytes<T>(BN, t, modulated) + 1024)));
  const int chunks = cdiv(Cin, Elem<T>::CK);
  const int splits = std::min(per_sm * sms / base, chunks / kMinChunks);
  return splits < 2 ? 1 : cdiv(chunks, cdiv(chunks, splits));
}

// values of T in the prepared weights of a (Cin, Cout) layer
template <class T>
inline long long prepared_elems(int Cin, int Cout) {
  const int BN = tile_n(Cout);
  return (long long)cdiv(Cout, BN) * cdiv(Cin, Elem<T>::CK) * b_elems<T>(BN);
}

// the same in floats (whole: a multiple of 8 values of T)
template <class T>
inline long long prepared_floats(int Cin, int Cout) {
  return prepared_elems<T>(Cin, Cout) * (long long)sizeof(T) / (long long)sizeof(float);
}

// fp32 scratch a call needs: the prepared weights unless the caller passes
// its own, then (splits > 1) the split-K partial sums.
template <class T>
inline long long workspace_floats(int B, int H, int W, int Cin, int Cout, int splits,
                                  bool prepared) {
  return (prepared ? 0 : prepared_floats<T>(Cin, Cout))
      + (splits > 1 ? (long long)splits * B * H * W * Cout : 0);
}

// The weights of a (Cin, Cout) layer into wp (prepared_elems<T> values).
template <class Kind, class T>
int prepare(const float* wt, float scale, T* wp, int Cin, int Cout, cudaStream_t s) {
  const int BN = tile_n(Cout);
  const int chunks = cdiv(Cin, Elem<T>::CK);
  // threads: 8 values (fp32: 4 q x (big, small)) each
  const long long n = prepared_elems<T>(Cin, Cout) / 8;
  if (n >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (std::is_same<T, bf16>::value)
    conv3x3_tc_prep_bf16<Kind><<<cdiv(n, 256), 256, 0, s>>>(wt, scale, wp, Cin, Cout, BN,
                                                             chunks, static_cast<int>(n));
  else
    conv3x3_tc_prep<Kind><<<cdiv(n, 256), 256, 0, s>>>(wt, scale, wp, Cin, Cout, BN,
                                                        chunks, static_cast<int>(n));
  return static_cast<int>(cudaGetLastError());
}

template <int BN, bool VEC, class Kind, class T>
int launch_tiles(const T* x, const float* style, const T* wp,
                 const Epilogue& epi, T* out, float* partial, int B, int H,
                 int W, int Cin, int Cout, int splits, cudaStream_t s) {
  const Tile t = make_tile(B, H, W);
  const size_t smem = smem_bytes<T>(BN, t, Kind::modulated);
  if (smem > (size_t)kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = conv3x3_tc_kernel<BN, VEC, Kind, T>;
  cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int chunks = cdiv(Cin, Elem<T>::CK);
  const dim3 grid(t.m_tiles, cdiv(Cout, BN), splits);
  kernel<<<grid, kThreads, smem, s>>>(x, style, wp, epi, out,
                                      splits > 1 ? partial : nullptr, B, H, W,
                                      Cin, Cout, t, chunks, cdiv(chunks, splits));
  return static_cast<int>(cudaGetLastError());
}

// The whole convolution: the weight preparation (unless `wp` holds weights
// prepared earlier from the same wt and scale), the tiled kernel and, with
// splits > 1 (from splits_for<T>), the reduce pass. `work` is fp32 scratch
// of workspace_floats<T>(..., wp != nullptr) floats (null where that is 0),
// the prepared weights first; x, style, wt, wp and work 16-byte aligned
// (checked by the Python wrappers). Returns the launches'
// cudaGetLastError().
template <class Kind, class T>
int conv3x3_tc_launch(const T* x, const float* style, const float* wt,
                      const T* wp, float scale, const Epilogue& epi,
                      T* out, float* work, int B, int H, int W, int Cin,
                      int Cout, int splits, cudaStream_t s) {
  if (splits < 1) return static_cast<int>(cudaErrorInvalidValue);
  float* partial = work;
  int rc = 0;
  if (wp == nullptr) {
    if (work == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    rc = prepare<Kind, T>(wt, scale, reinterpret_cast<T*>(work), Cin, Cout, s);
    if (rc != 0) return rc;
    wp = reinterpret_cast<const T*>(work);
    partial = work + prepared_floats<T>(Cin, Cout);
  }
  if (splits > 1 && partial == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int BN = tile_n(Cout);
  const bool vec = Cin % (16 / (int)sizeof(T)) == 0;
#define W2E_TC_CASE(N)                                                             \
  if (BN == N)                                                                     \
    rc = vec ? launch_tiles<N, true, Kind, T>(x, style, wp, epi, out, partial, B,  \
                                              H, W, Cin, Cout, splits, s)          \
             : launch_tiles<N, false, Kind, T>(x, style, wp, epi, out, partial, B, \
                                               H, W, Cin, Cout, splits, s);
  W2E_TC_CASE(32) W2E_TC_CASE(64) W2E_TC_CASE(128)
#undef W2E_TC_CASE
  if (rc != 0 || splits == 1) return rc;
  const long long n = (long long)B * H * W * Cout;
  conv3x3_tc_reduce<Kind, T><<<cdiv(n, 256), 256, 0, s>>>(partial, splits, epi, out,
                                                           n, H * W, Cout);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace conv3x3_tc
