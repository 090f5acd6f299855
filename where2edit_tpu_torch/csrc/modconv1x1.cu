// K3: modulated 1x1 convolution with an optional fused epilogue for Hopper
// (sm_90a): fp32 in and out on the FMA units (below), or bf16 in and fp32
// or bf16 out on the tensor cores (the bf16 form, further below).
//
// Replaces the TPU kernel tools/pallas_bench.py::modulated_conv1x1 (body
// _kernel): every ToRGB of the generator and every attention StyledConv of
// the mapper (where2edit_tpu/nn/layers.py ModulatedConv2d with k=1, then
// ToRGB's bias + upsampled skip, or StyledConv's noise + bias + activation):
//
//   out[b,p,o] = act( demod[b,o] * sum_i x[b,p,i] * style[b,i] * w[i,o]
//                     + noise_w * noise[b,p] + bias[o] ) + residual[b,p,o]
//
// act = lrelu(0.2)*sqrt(2) when `act` is set; demod, noise, bias and residual
// are optional (null pointers).
//
// The fp32 form. Bound on the H100: bytes. Cout is at most 32 on the path (3 for ToRGB, 32 or
// 1 in the mapper), so a pixel's Cin inputs are read once for at most 32
// multiply-adds each, far below the card's ~20 FLOP/byte balance point in
// fp32. Most of the path's shapes are small (16 to 4096 pixels at Cin 512),
// so the design spreads one pixel's work over many lanes instead of giving
// each thread a pixel:
//
// - A group of L lanes owns PPG pixels (2 for Cout > 4, else 1) and reads
//   their contiguous Cin rows, L = 32 at Cin >= 128, 16 at Cin 64, 8 below: lane l
//   takes the 16-byte quads l, l + L, l + 2L, ... (single floats, masked at
//   the row's end, when Cin is not a multiple of 4).
// - style[b,i] * w[i,o] is folded once per block into shared memory, laid out
//   [o][i] (row stride Cin rounded up to 4, plus 4), so a lane reads the fold
//   of its quad for every output channel as one 16-byte load. Output channels
//   are padded to CO = 4 (Cout <= 4) or 32 with zero columns.
// - Each lane keeps CO partial sums; the group reduces them with warp
//   shuffles. The reduction transposes while it halves: at each step a lane
//   sends half of its sums to its partner and keeps the other half, so for
//   CO = 32 over 32 lanes it takes 31 shuffles and leaves one output channel
//   per lane (32 full butterflies would take 160).
// - The lane that holds an output channel applies demod, noise, bias, the
//   activation and the residual, in that order, and stores it; it loads
//   those operands before the sums, so their latency hides behind them.
//
// Grid: (blocks, B); a block of kThreads threads walks its sample's
// pixels in steps of (groups per block) x PPG. The block count covers the
// pixels, capped at what the card holds at once (so the fold is repeated by
// at most that many blocks): a 16x16 ToRGB (256 pixels, Cin 512) launches 32
// blocks of 8 groups, where the earlier thread-per-pixel kernel launched one.
// w2e_modconv1x1_blocks reports the grid for a shape.
//
// The bf16 form (w2e_modconv1x1_bf16): x bf16 (B, P, Cx), Cx = Cin rounded
// up to 8 (TMA reads whole 16-byte rows: the Python wrapper pads x with zero
// channels); style, w, demod, noise and bias fp32; out and residual fp32
// (ToRGB, whose RGB skip chain stays fp32, as the JAX ToRGB's rgb_dtype) or
// bf16 (a 1x1 StyledConv, the mapper's convs). The sums and the epilogue are
// fp32, with one rounding at the store. A persistent, warp-specialised
// TMA streaming kernel, its sums on the tensor cores (wgmma) or, for the
// ToRGBs, on the FMA units in the FMA kernel's order (below); sm_90a only.
//
// What bounds it on the H100 (NVIDIA H100 80GB HBM3, 700 W) and what the
// design does about it:
//
// - The large ToRGBs (Cout 3, fp32 out with an fp32 residual; 1024^2 at Cin
//   32, 512^2 at 64, 256^2 at 128): bytes. At batch 8 they move 738 MB,
//   319 MB and 147 MB (x read once, the residual read once, out written
//   once): 0.2204, 0.0952 and 0.0438 ms at 3.35 TB/s, at ~2 operations a
//   byte. The FMA kernel this replaces reached 29-38 % of that rate there:
//   half its lanes loaded nothing at Cin 32-128, one 16-byte load a lane was
//   in flight, and the epilogue read and stored 4-byte values 12 bytes
//   apart. Here one producer thread per SM keeps a ring of up to 8 stages a
//   consumer in flight by TMA, every tile one contiguous box of x per slice
//   and one contiguous bulk copy of its residual, and the output leaves in
//   contiguous 16-byte stores. Their sums run in the FMA form (below): at
//   batch 8 they take 0.3062, 0.1695 and 0.0771 ms, 72, 56 and 57 % of the
//   bound (chip_kernel_ab.py, PERF.md "PR 14"), where the stream alone
//   takes 0.2286, 0.0997 and 0.0484: the FMA sums, on 8 consumer warps an
//   SM, are what is left over the stream. On the way the epilogue had bound
//   them too: its global loads (bias, demod, the noise gain) waited behind
//   the stream's traffic, and its per-value residual reads were serialised
//   behind branches (both repaired below).
// - The mapper's convs (4^2-16^2 at Cin 32-576, Cout 32 or 1) and the
//   small ToRGBs: fixed cost, a few microseconds a launch. The FMA kernel
//   read its fp32 fold from shared memory at 32x the bytes of x it
//   multiplied, and every block refolded the whole 32 x Cin fold before its
//   first product. Here the mapper's products run on the tensor cores, and
//   the fold is made once per block and sample: the block's first by eleven
//   of its twelve warps while the first tiles land, a later one (where a
//   block's units run into the next sample) by the producer warpgroup's
//   other three warps; work units never cross a sample. What is left is
//   fixed: a launch whose blocks return once their barriers are made takes
//   2.0-2.3 us in a CUDA graph, the fold 1.0 (Cin 512 -> 3) to 2.3 us (Cin
//   512 -> 32), then a TMA round trip, the sums and the epilogue: 5-10 us a
//   call, where the FMA kernel took 4.2-8.9; it stays faster at the 4^2-32^2
//   ToRGBs (whose FMA form here has 8-16 blocks at batch 8) and at the
//   16^2 mapper convs of Cin <= 256.
//
// The design:
// - Persistent blocks: min(units, SMs) blocks of 384 threads, block i takes
//   the contiguous run of units [i U / G, (i + 1) U / G); a unit is one
//   sample x one tile of T pixels, sample-major, so a block's consecutive
//   tiles share a fold and it makes each fold once. T is 128; 64 where P <=
//   64, where Cout > 8, where the FMA form (below) has Cx > 128 or where
//   128-pixel units would be fewer than the SMs (more blocks share the
//   small shapes' fixed costs); 256 at Cx <= 32 and Cout <= 8 where
//   256-pixel units still fill the card (the 1024^2 ToRGB: a unit's fixed
//   costs then cover 16 KiB of x, not 8).
// - Warp specialisation: warpgroup 0 is the producer (thread 0 issues every
//   copy; warps 1-3 make the later folds), warpgroups 1 and 2 consume
//   alternate units of the block, so one tile's epilogue overlaps the
//   other's products. Each consumer has its own ring of stages (full and
//   empty mbarriers) and waits on them in order.
// - The x tile: one TMA box per K slice of 64 channels (32 where Cx <= 32),
//   T rows, from a 3-D tensor map over x (Cx, P, B), swizzled (128- or
//   64-byte) as wgmma's shared-memory descriptors read it. TMA fills the
//   rows past P with zeros (the 4^2 convs' P = 16 is under a 64-row tile)
//   and the channels past Cx. The tile's residual (T x Cout contiguous
//   values) lands in the stage of its last slice by one 1-D bulk copy where
//   both its ends are 16-byte aligned; a tail tile whose rows do not make
//   whole 16-byte units reads it value by value in the epilogue.
// - The products of a bf16 output (the mapper's convs; and an fp32 one of
//   more than 8 channels): wgmma m64nNk16, A (the x tile) and B (the fold)
//   both by descriptor from shared memory. The fold s*w is made in fp32 and
//   split into two bf16 parts, hi = round(s*w) and lo = round(s*w - hi), so
//   each product is the fp32 fold's to 2^-16; B holds them side by side, NC
//   rows each, K-major, swizzled as TMA would (NC = 8 for Cout <= 8, 32 for
//   Cout <= 32). So one MMA per K step (N = 2 NC) takes both parts and
//   reads A from shared memory once; the parts' sums are added in fp32. K <=
//   576 on every path shape: one accumulator runs over the whole K (the
//   bf16 3x3 core found that safe up to K = 1152, chip_smoke.py 17d).
// - The sums of an fp32 output of at most 8 channels (the ToRGBs') are the
//   FMA kernel's, bit for bit, on the FMA units, from the staged tile (the
//   FMA form; a unit's slices are all staged at once): per output, L lanes
//   (32 where Cx >= 128, 16 where >= 64, else 8), each a chain of fmaf
//   over its 8-channel units g, g + L, ... of the fp32 fold, then the
//   lanes' butterfly tree (lanes g and g + L / 2 first), spread over 1-8
//   threads a pixel and four channels at once. Why: the ToRGB's output
//   feeds the fp32 RGB chain and the discriminator, whose gradient in
//   chip_smoke.py 17d (a 64^2 bf16 GAN, card against CPU) moved past its
//   bar with every other order of the same sums we tried, the tensor
//   cores' in bf16 parts (two; three, to 2^-24), with and without fresh accumulators
//   per slice (0.050-0.059 against 0.047, bar 0.05; chip_kernel_ab.py
//   --whole, PERF.md "PR 14"). On the CPU any change of those last bits, an
//   fp64-exact sum included, moves that gradient by 3-4 %: the bar sits at
//   that noise, so this form keeps the sums the phase was read with. At ~2
//   operations a byte the FMA units keep up with the stream.
// - The epilogue, in fp32 and in the plain version's order: demod, noise
//   (shared or per sample), bias, lrelu(0.2)*sqrt(2), then the residual.
//   First pass: the sums into a staged fp32 tile in the output's layout (T
//   x Cout contiguous values; two a consumer in turn, so one barrier a
//   unit); second pass: the tile in order, 16 bytes a thread, plus the
//   residual, one rounding, straight to global (one value a thread where
//   the tile's first value is not 16-byte aligned). The epilogue's own
//   operands (bias, demod, the noise gain) are read once per consumer or
//   sample: a global load in each unit's epilogue waited behind the
//   stream's traffic. A 1-D bulk store of the staged tile measured no
//   faster and needs a proxy fence and a wait, so it went.
// - w2e_modconv1x1_bf16_plan reports a call's work plan (tiles, ring,
//   fold slots, shared memory, how each unit's residual and output move);
//   tests/torch_parity.py mirrors it in Python, and
//   tests/test_torch_k3_bf16_core.py emulates both forms' arithmetic on
//   the CPU.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include "conv3x3_bf16.cuh"  // the Hopper helpers: mbarriers, TMA, swizzle, descriptors

using bf16 = __nv_bfloat16;
using conv3x3_tc::cdiv;

// ---------------------------------------------------------------------------
// the fp32 form
// ---------------------------------------------------------------------------

namespace {

constexpr float kSqrt2 = 1.4142135623730951f;
constexpr int kMaxSmem = 232448;  // bytes a block may use on the H100

constexpr int kThreads = 256;  // threads per block (up to 255 registers each)

// pixels per lane group and step: two for CO = 32, so each fold value read
// from shared memory feeds two pixels
template <int CO>
constexpr int kPPG = CO == 32 ? 2 : 1;

// row units loaded ahead of their multiply-adds (two for CO = 32, whose
// 2 x 32 sums already take half of the 128 registers a thread may use)
template <int CO>
constexpr int kUnroll = CO == 32 ? 2 : 4;

__host__ __device__ int fold_stride(int Cin) { return (Cin + 3) / 4 * 4 + 4; }

// Sum v[0..N) across the S*2 lanes of a group (S = half the group), halving
// the number of values at each step while more than one is left: afterwards,
// for N >= group size, lane gl holds channels gl*N/L ... in v[0 .. N/L); for
// N < group size every lane holds channel gl*N/L in v[0].
template <int N, int S>
__device__ __forceinline__ void group_reduce(float* v, int gl) {
  if constexpr (S > 0) {
    if constexpr (N == 1) {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], S);
      group_reduce<1, S / 2>(v, gl);
    } else {
      const bool upper = (gl & S) != 0;
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        const float send = upper ? v[i] : v[i + N / 2];
        const float keep = upper ? v[i + N / 2] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, S);
      }
      group_reduce<N / 2, S / 2>(v, gl);
    }
  }
}

// CO: padded output channels (4 or 32); L: lanes per pixel (8, 16 or 32);
// VEC: Cin is whole 16-byte units (a multiple of 4), else single values.
template <int CO, int L, bool VEC>
__global__ void __launch_bounds__(kThreads)
modconv1x1_kernel(const float* __restrict__ x, const float* __restrict__ style,
                  const float* __restrict__ w, const float* __restrict__ demod,
                  const float* __restrict__ noise, long long noise_bstride,
                  const float* __restrict__ noise_w,
                  const float* __restrict__ bias,
                  const float* __restrict__ residual, float* __restrict__ out,
                  int P, int Cin, int Cout, int act) {
  constexpr int THREADS = kThreads;
  constexpr int PPG = kPPG<CO>;
  constexpr int GROUPS = THREADS / L;
  constexpr int U = VEC ? 4 : 1;  // values per row unit
  constexpr int LINE = 32;        // values per cache line
  extern __shared__ __align__(16) float ws[];  // [CO][stride]

  const int b = blockIdx.y;
  const int stride = fold_stride(Cin);
  const int gl = threadIdx.x % L;
  const int group = threadIdx.x / L;
  const int units = Cin / U;  // whole units; VEC means Cin % U == 0
  const float* xb = x + (size_t)b * P * Cin;
  const float* sb = style + (size_t)b * Cin;

  // ask L2 for the first step's pixel rows now, so their DRAM latency
  // overlaps the fold's
  for (int j = 0; j < PPG; ++j) {
    const int p = (blockIdx.x * GROUPS + group) * PPG + j;
    if (p < P)
      for (int line = gl; line * LINE < Cin; line += L)
        asm volatile("prefetch.global.L2 [%0];" :: "l"(xb + (size_t)p * Cin + line * LINE));
  }

  // fold style * w, reading w along its rows (o fastest): 16 bytes at a time
  // when w's rows are whole float4s (Cout = CO), with several loads in
  // flight per thread, since at the smallest shapes the fold is most of the
  // kernel's time
  if (Cout == CO) {
#pragma unroll 8
    for (int i = threadIdx.x; i < CO / 4 * Cin; i += THREADS) {
      const int o = i % (CO / 4) * 4;
      const int ci = i / (CO / 4);
      const float4 v = *reinterpret_cast<const float4*>(w + (size_t)ci * CO + o);
      const float s = sb[ci];
      ws[o * stride + ci] = s * v.x;
      ws[(o + 1) * stride + ci] = s * v.y;
      ws[(o + 2) * stride + ci] = s * v.z;
      ws[(o + 3) * stride + ci] = s * v.w;
    }
  } else {
#pragma unroll 8
    for (int i = threadIdx.x; i < CO * Cin; i += THREADS) {
      const int o = i % CO;
      const int ci = i / CO;
      ws[o * stride + ci] = o < Cout ? sb[ci] * w[(size_t)ci * Cout + o] : 0.f;
    }
  }
  __syncthreads();

  // the output channels this lane holds after the reduction: NV from c0
  constexpr int NV = CO >= L ? CO / L : 1;
  const int c0 = gl * CO / L;
  const bool holder = CO >= L || gl % (L / CO) == 0;
  // per-channel epilogue operands, read once
  float e_demod[NV], e_bias[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int co = c0 + k;
    const bool ok = holder && co < Cout;
    e_demod[k] = ok && demod != nullptr ? demod[(size_t)b * Cout + co] : 1.f;
    e_bias[k] = ok && bias != nullptr ? bias[co] : 0.f;
  }
  const float nw = noise != nullptr ? *noise_w : 0.f;

  // every thread of the block runs the same number of steps, so the
  // shuffles below always find their whole warp
  for (int step = blockIdx.x; (size_t)step * GROUPS * PPG < (size_t)P;
       step += gridDim.x) {
    const int p0 = (step * GROUPS + group) * PPG;
    // per-pixel epilogue operands, loaded ahead of the sums that need them
    float e_noise[PPG], e_res[PPG][NV];
#pragma unroll
    for (int j = 0; j < PPG; ++j) {
      const int p = p0 + j;
      const bool ok = holder && p < P;
      e_noise[j] = ok && noise != nullptr
          ? nw * noise[(size_t)b * noise_bstride + p] : 0.f;
#pragma unroll
      for (int k = 0; k < NV; ++k)
        e_res[j][k] = ok && residual != nullptr && c0 + k < Cout
            ? residual[((size_t)b * P + p) * Cout + c0 + k] : 0.f;
    }
    float acc[PPG][CO];
#pragma unroll
    for (int j = 0; j < PPG; ++j)
#pragma unroll
      for (int o = 0; o < CO; ++o) acc[j][o] = 0.f;

    for (int q0 = gl; q0 < units; q0 += kUnroll<CO> * L) {
      float4 xv[kUnroll<CO>][PPG];
#pragma unroll
      for (int u = 0; u < kUnroll<CO>; ++u) {
        const int q = q0 + u * L;
#pragma unroll
        for (int j = 0; j < PPG; ++j) {
          const int p = p0 + j;
          // a unit: 16 bytes (4 values), or one value
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (q < units && p < P) {
            if constexpr (VEC)
              v = *reinterpret_cast<const float4*>(xb + (size_t)p * Cin + U * q);
            else
              v.x = xb[(size_t)p * Cin + q];
          }
          xv[u][j] = v;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll<CO>; ++u) {
        const int q = q0 + u * L;
        if (q >= units) break;
#pragma unroll
        for (int o = 0; o < CO; ++o) {
          if constexpr (VEC) {
            const float4 f = *reinterpret_cast<const float4*>(ws + o * stride + 4 * q);
#pragma unroll
            for (int j = 0; j < PPG; ++j) {
              float a = acc[j][o];
              a = fmaf(xv[u][j].x, f.x, a);
              a = fmaf(xv[u][j].y, f.y, a);
              a = fmaf(xv[u][j].z, f.z, a);
              acc[j][o] = fmaf(xv[u][j].w, f.w, a);
            }
          } else {
            const float f = ws[o * stride + q];
#pragma unroll
            for (int j = 0; j < PPG; ++j) acc[j][o] = fmaf(xv[u][j].x, f, acc[j][o]);
          }
        }
      }
    }

#pragma unroll
    for (int j = 0; j < PPG; ++j) {
      group_reduce<CO, L / 2>(acc[j], gl);
      const int p = p0 + j;
      if (p >= P || !holder) continue;
      const size_t o_base = ((size_t)b * P + p) * Cout;
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const int co = c0 + k;
        if (co >= Cout) break;
        float v = acc[j][k] * e_demod[k] + e_noise[j] + e_bias[k];
        if (act) v = (v >= 0.f ? v : 0.2f * v) * kSqrt2;
        out[o_base + co] = v + e_res[j][k];
      }
    }
  }
}

template <int CO, int L, bool VEC>
void configure(int B, int P, int Cin, int sms, dim3* grid, int* threads,
               size_t* smem, const void** fn) {
  *threads = kThreads;
  *smem = sizeof(float) * CO * fold_stride(Cin);
  // CO = 32: one block per SM (its sums take most of the registers), so
  // each SM makes the 32 x Cin fold once and walks more pixels with it
  const int per_sm = CO == 32 ? 1
      : std::max(1, std::min(2048 / kThreads, kMaxSmem / (int)(*smem + 1024)));
  const int steps = cdiv(P, (long long)(kThreads / L) * kPPG<CO>);
  *grid = dim3(std::max(1, std::min(steps, cdiv((long long)per_sm * sms, B))), B);
  *fn = reinterpret_cast<const void*>(modconv1x1_kernel<CO, L, VEC>);
}

// The kernel, grid, block and shared memory for a shape; false if the shape
// is outside what the kernel takes (Cout > 32, or a fold above kMaxSmem).
bool plan(int B, int P, int Cin, int Cout, int sms, dim3* grid, int* threads,
          size_t* smem, const void** fn) {
  if (Cout > 32 || Cin < 1 || P < 1 || B < 1) return false;
  const bool vec = Cin % 4 == 0;
  const int lanes = Cin >= 128 ? 32 : Cin >= 64 ? 16 : 8;
#define W2E_K3_CASE(CO, L)                                                     \
  if (lanes == L) {                                                            \
    if (vec) configure<CO, L, true>(B, P, Cin, sms, grid, threads, smem, fn);  \
    else configure<CO, L, false>(B, P, Cin, sms, grid, threads, smem, fn);     \
  }
  if (Cout <= 4) {
    W2E_K3_CASE(4, 8) W2E_K3_CASE(4, 16) W2E_K3_CASE(4, 32)
  } else {
    W2E_K3_CASE(32, 8) W2E_K3_CASE(32, 16) W2E_K3_CASE(32, 32)
  }
#undef W2E_K3_CASE
  return *smem <= (size_t)kMaxSmem;
}

int launch(const float* x, const float* style, const float* w, const float* demod,
           const float* noise, long long noise_bstride, const float* noise_w,
           const float* bias, const float* residual, float* out, int B, int P, int Cin,
           int Cout, int act, int sms, void* stream) {
  dim3 grid;
  int threads;
  size_t smem;
  const void* fn;
  if (!plan(B, P, Cin, Cout, sms, &grid, &threads, &smem, &fn))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t rc = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  void* args[] = {&x, &style, &w, &demod, &noise, &noise_bstride, &noise_w,
                  &bias, &residual, &out, &P, &Cin, &Cout, &act};
  rc = cudaLaunchKernel(fn, grid, dim3(threads), args, smem,
                        static_cast<cudaStream_t>(stream));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ---------------------------------------------------------------------------
// the bf16 form (see the header)
// ---------------------------------------------------------------------------

namespace k3_bf16 {

using conv3x3_bf16::b_desc;
using conv3x3_bf16::mbar_arrive;
using conv3x3_bf16::mbar_expect_tx;
using conv3x3_bf16::mbar_init;
using conv3x3_bf16::mbar_wait;
using conv3x3_bf16::pack_bf16x2;
using conv3x3_bf16::swizzle;
using conv3x3_bf16::warpgroup_sync;
using conv3x3_tc::Epilogue;
using conv3x3_tc::fence_operand;
using conv3x3_tc::fence_proxy_async;
using conv3x3_tc::kSqrt2;
using conv3x3_tc::smem_addr;
using conv3x3_tc::wgmma_commit;
using conv3x3_tc::wgmma_fence;
using conv3x3_tc::wgmma_wait;

constexpr int kThreads = 384;       // the producer warpgroup and two consumers
constexpr int kParts = 2;           // the fold's bf16 parts on the tensor cores: hi, lo

// An fp32 output of at most 8 channels (the ToRGBs') is summed on the FMA
// units in the FMA kernel's order (see the header), every other on the
// tensor cores.
__host__ __device__ constexpr bool fma_form(int out_size, int Cout) {
  return out_size == 4 && Cout <= 8;
}
constexpr int kFolders = 3;         // the producer warpgroup's warps 1-3 make later folds
constexpr int kMaxStages = 8;       // ring stages a consumer, at most
constexpr int kMinStages = 2;
constexpr int kRichStages = 4;      // two fold slots only where they leave this many
constexpr int kMaxSmem = 232448;    // bytes a block may use on the H100

inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

// The work plan of a call (host and device): smem == 0 where the core does
// not take the shape.
struct Plan {
  int tile, tiles;          // pixels per unit (64, 128 or 256), units per sample
  int units, grid;          // B * tiles; blocks, min(units, SMs)
  int kc, slices;           // K: slices of kc channels (32 where Cx <= 32, else 64)
  int nc;                   // the fold's output channels (8 or 32): N = kParts nc
  int res_size, out_size;   // bytes per residual value (0: none) and per output
  int x_bytes;              // one slice's TMA box: tile x kc bf16
  int stage_bytes, stages;  // a stage (box, then the residual tile), per consumer
  int fold_bytes, fold_slots;  // one sample's fold (all slices, all parts)
  int out_bytes;            // a staged fp32 output tile (two a consumer)
  int ring_off, out_off, bar_off, smem;  // from the 1 KiB aligned base; total
};

inline Plan make_plan(int B, int P, int Cin, int Cout, int out_size, int res_size,
                      int sms) {
  Plan p{};
  if (B < 1 || P < 1 || Cin < 1 || Cout < 1 || Cout > 32 || sms < 1) return p;
  const int cx = (Cin + 7) / 8 * 8;
  const bool fma = fma_form(out_size, Cout);
  // 128-pixel tiles; 64 where P <= 64, where Cout > 8 (two 64-row
  // accumulators of 48 values would not fit the registers), where the FMA
  // form has more than 2 slices (all of a unit's slices stay in the ring)
  // or where 128-pixel units would leave SMs idle (more blocks share the
  // fixed costs); 256 at Cx <= 32 and Cout <= 8 where the card still fills
  // (a box of 16 KiB, not 8: a unit's fixed costs are spread over twice
  // the bytes)
  p.tile = P <= 64 || Cout > 8 || (fma && cx > 128) || (long long)B * cdiv(P, 128) < sms ? 64
      : cx <= 32 && Cout <= 8 && (long long)B * cdiv(P, 256) >= sms ? 256 : 128;
  const long long units = (long long)B * cdiv(P, p.tile);
  if (units >= (1LL << 31)) return p;
  p.tiles = cdiv(P, p.tile);
  p.units = static_cast<int>(units);
  p.grid = std::min(p.units, sms);
  p.kc = cx <= 32 ? 32 : 64;
  p.slices = cdiv(cx, p.kc);
  p.nc = Cout <= 8 ? 8 : 32;
  p.res_size = res_size;
  p.out_size = out_size;
  p.x_bytes = p.tile * p.kc * 2;
  p.stage_bytes = round_up(p.x_bytes + round_up(p.tile * Cout * res_size, 16), 1024);
  // the FMA form's fold is fp32, [channel][K]; the tensor cores' its bf16
  // parts, per slice [part][channel][KC]
  p.fold_bytes = round_up(fma ? p.nc * p.slices * p.kc * 4
                              : p.slices * kParts * p.nc * p.kc * 2, 1024);
  p.out_bytes = round_up(p.tile * Cout * 4, 128);
  const int need = fma ? std::max(kMinStages, p.slices) : kMinStages;  // stages a consumer
  const int cap = std::max(kMaxStages, need);
  for (p.fold_slots = 2; p.fold_slots >= 1; --p.fold_slots) {
    p.ring_off = p.fold_slots * p.fold_bytes;
    const int fixed = 1024 + p.ring_off + 4 * p.out_bytes + 8 * (4 * cap + 4);
    p.stages = std::min(cap, (kMaxSmem - fixed) / (2 * p.stage_bytes));
    if (p.stages >= (p.fold_slots == 2 ? std::max(kRichStages, need) : need)) break;
  }
  if (p.fold_slots < 1) return Plan{};
  p.out_off = p.ring_off + 2 * p.stages * p.stage_bytes;
  p.bar_off = p.out_off + 4 * p.out_bytes;
  p.smem = 1024 + p.bar_off + 8 * (4 * p.stages + 2 * p.fold_slots);
  return p;
}

// element `first` of a 16-byte aligned tensor of `size`-byte values is
// 16-byte aligned
__host__ __device__ inline bool aligned16(long long first, int size) {
  return size > 0 && (first * size) % 16 == 0;
}

// n values of `size` bytes from element `first` of a 16-byte aligned
// tensor move as one bulk copy: both ends 16-byte aligned
__host__ __device__ inline bool bulk_ok(long long first, int n, int size) {
  return aligned16(first, size) && ((long long)n * size) % 16 == 0;
}

// the operands of a call
struct Args {
  const float* style;   // (B, Cin)
  const float* w;       // (Cin, Cout)
  Epilogue epi;         // demod (B, Cout), noise (B or 1, P), noise_w, bias, act
  const void* residual; // (B, P, Cout) in the output's type, or null
  void* out;            // (B, P, Cout)
  int B, P, Cin, Cout;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }
template <class T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_float<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// `bytes` (a multiple of 16) from src (16-byte aligned) to shared dst,
// counted on bar
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, int bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// The second pass of the epilogue: a unit's n output values, in order,
// from its staged fp32 tile `ep`, plus the residual where there is one (in
// shared memory or global), rounded once to TO; thread t of a consumer's
// 128 takes 16 bytes of output at a time where `vec` (the tile's first
// value is 16-byte aligned), then one value at a time for the rest.
template <class TO>
__device__ __forceinline__ void store_tile(TO* dst, const float* ep, const TO* res, int n,
                                           bool vec, int t) {
  constexpr int V = 16 / sizeof(TO);  // values per 16 bytes
  int k0 = 0;
  if (vec) {
    for (int q = t; q < n / V; q += 128) {
      float v[V];
#pragma unroll
      for (int k = 0; k < V; k += 4) {
        const float4 f = *reinterpret_cast<const float4*>(ep + q * V + k);
        v[k] = f.x, v[k + 1] = f.y, v[k + 2] = f.z, v[k + 3] = f.w;
      }
      uint4 o;
      if constexpr (V == 4) {
        if (res != nullptr) {
          const float4 r = reinterpret_cast<const float4*>(res)[q];
          v[0] += r.x, v[1] += r.y, v[2] += r.z, v[3] += r.w;
        }
        o = make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                       __float_as_uint(v[3]));
      } else {
        if (res != nullptr) {
          const uint4 r = reinterpret_cast<const uint4*>(res)[q];
          const uint32_t rw[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            v[2 * k] += __uint_as_float(rw[k] << 16);
            v[2 * k + 1] += __uint_as_float(rw[k] & 0xFFFF0000u);
          }
        }
        o = make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                       pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7]));
      }
      reinterpret_cast<uint4*>(dst)[q] = o;
    }
    k0 = n / V * V;
  }
  for (int k = k0 + t; k < n; k += 128)
    dst[k] = from_float<TO>(res != nullptr ? ep[k] + to_float(res[k]) : ep[k]);
}

// A pair of channels' fp32 values in kParts bf16 parts, hi = round(v) and
// lo = round(v - hi), the difference exact in fp32: their sum is v to
// 2^-16; each part packed as bf16x2 with the lower channel in the low half
__device__ __forceinline__ void split_bf16x2(float v0, float v1, uint32_t (&part)[kParts]) {
#pragma unroll
  for (int k = 0; k < kParts; ++k) {
    part[k] = pack_bf16x2(v0, v1);
    v0 -= __uint_as_float(part[k] << 16);
    v1 -= __uint_as_float(part[k] & 0xFFFF0000u);
  }
}

// acc(64 x N, this thread's N/2 values) = A(64 x 16 bf16) * B(16 x N bf16)
// + (scale_d ? acc : 0), fp32 accumulate; A and B K-major in shared memory,
// by descriptor.
template <int N>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int scale_d);

#define W2E_D8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
                  "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

template <>
__device__ __forceinline__ void mma_ss<16>(float (&d)[8], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : W2E_D8(0)
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void mma_ss<64>(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : W2E_D8(0), W2E_D8(8), W2E_D8(16), W2E_D8(24)
      : "l"(a), "l"(b), "r"(scale_d));
}

#undef W2E_D8

// One sample's fold into a slot: for the tensor cores (a B operand), for
// every slice, N = kParts NC rows of KC bf16 (part k of output channel o in
// row k NC + o), K-major, swizzled as TMA swizzles a KC-wide box; for the
// FMA form (FP32), the fp32 fold, NC rows of K = slices KC; zeros past
// Cout and Cin. Thread t of nt
// makes 8 input channels x 4 output channels at a time, and issues all its
// loads of w (16-byte rows of 4 channels where Cout is a multiple of 4) and
// of the style before it uses any, so that many are in flight.
template <int NC, int KC, bool FP32>
__device__ __forceinline__ void make_fold(unsigned char* slot, const Args& a, int b, int slices,
                                          int t, int nt) {
  constexpr int ROWB = KC * 2;
  const float* __restrict__ sb = a.style + (size_t)b * a.Cin;
  const float* __restrict__ w = a.w;
  const bool vec = a.Cout % 4 == 0;
  const int n = NC / 4 * slices * (KC / 8);
  for (int e = t; e < n; e += nt) {
    const int o0 = 4 * (e % (NC / 4)), i0 = 8 * (e / (NC / 4));
    float s[8], wv[8][4];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int i = i0 + k;
      const float* row = w + (size_t)i * a.Cout + o0;
      s[k] = i < a.Cin ? __ldg(sb + i) : 0.f;
      if (vec && i < a.Cin && o0 < a.Cout) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(row));
        wv[k][0] = v.x, wv[k][1] = v.y, wv[k][2] = v.z, wv[k][3] = v.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wv[k][j] = !vec && i < a.Cin && o0 + j < a.Cout ? __ldg(row + j) : 0.f;
      }
    }
    if constexpr (FP32) {  // [channel][K], K = slices KC
      float* row = reinterpret_cast<float*>(slot) + (size_t)o0 * slices * KC + i0;
#pragma unroll
      for (int j = 0; j < 4; ++j, row += slices * KC) {
        *reinterpret_cast<float4*>(row) = make_float4(s[0] * wv[0][j], s[1] * wv[1][j],
                                                      s[2] * wv[2][j], s[3] * wv[3][j]);
        *reinterpret_cast<float4*>(row + 4) = make_float4(s[4] * wv[4][j], s[5] * wv[5][j],
                                                          s[6] * wv[6][j], s[7] * wv[7][j]);
      }
      continue;
    }
    unsigned char* tile = slot + (i0 / KC) * (kParts * NC * ROWB);
    const int c = (i0 % KC) / 8;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t q[4][kParts];  // the four channel pairs' parts
#pragma unroll
      for (int k = 0; k < 4; ++k)
        split_bf16x2(s[2 * k] * wv[2 * k][j], s[2 * k + 1] * wv[2 * k + 1][j], q[k]);
#pragma unroll
      for (int k = 0; k < kParts; ++k) {
        const int row = k * NC + o0 + j;
        *reinterpret_cast<uint4*>(tile + row * ROWB + ((c ^ swizzle<KC>(row)) << 4)) =
            make_uint4(q[0][k], q[1][k], q[2][k], q[3][k]);
      }
    }
  }
}

// The persistent kernel (see the header). NC: the fold's output channels;
// KC: channels per K slice; MB: 64-row blocks per tile; TO: the output's
// (and residual's) type.
template <int NC, int KC, int MB, class TO>
__global__ void __launch_bounds__(kThreads, 1)
modconv1x1_bf16_kernel(const __grid_constant__ CUtensorMap tmap_x, const Args a, const Plan p) {
  constexpr bool FMA = fma_form(sizeof(TO), NC);  // NC 8: Cout <= 8
  constexpr int N = kParts * NC;  // B's rows: the fold's parts
  constexpr int KS = KC / 16;   // k16 steps per slice
  constexpr int ROWB = KC * 2;  // bytes per staged row
  constexpr int T = 64 * MB;    // pixels per unit
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzle repeats every 1 KiB
  unsigned char* smem = smem_raw + (base - raw);
  // full[c][s], then empty[c][s] (consumer c's stage s), fold_full[f],
  // fold_empty[f]
  const uint32_t bars = base + p.bar_off;
  const uint32_t fold_full = bars + 8 * 4 * p.stages;
  const uint32_t fold_empty = fold_full + 8 * p.fold_slots;
  auto full = [&](int c, int s) { return bars + 8 * (c * p.stages + s); };
  auto empty = [&](int c, int s) { return bars + 8 * ((2 + c) * p.stages + s); };
  auto stage = [&](int c, int s) { return p.ring_off + (c * p.stages + s) * p.stage_bytes; };
  // this block's units, a contiguous run
  const int u0 = static_cast<int>((long long)blockIdx.x * p.units / gridDim.x);
  const int u1 = static_cast<int>((long long)(blockIdx.x + 1) * p.units / gridDim.x);

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < 2 * p.stages; ++i) {
      mbar_init(bars + 8 * i, 1);                    // full: the producer's arrival
      mbar_init(bars + 8 * (2 * p.stages + i), 4);   // empty: the consumer's warps
    }
    for (int f = 0; f < p.fold_slots; ++f) {
      mbar_init(fold_full + 8 * f, kFolders);        // the folding warps
      mbar_init(fold_empty + 8 * f, 8);              // both consumers' warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid >= 32) {
    // the block's first fold, into slot 0, by every warp but the producer's
    // (it starts the loads meanwhile): at the small shapes it is most of
    // the kernel's time. The folding warps then count it on fold_full.
    make_fold<NC, KC, FMA>(smem, a, u0 / p.tiles, p.slices, tid - 32, kThreads - 32);
    fence_proxy_async();  // these writes come before wgmma's reads
    asm volatile("bar.sync 1, %0;\n" :: "n"(kThreads - 32) : "memory");
    if (tid < 128 && tid % 32 == 0) mbar_arrive(fold_full);
  }

  if (tid == 0) {
    // ---- the producer: every copy, in unit order, into the ring of the
    // unit's consumer ----
    asm volatile("prefetch.tensormap [%0];\n"
                 :: "l"(reinterpret_cast<uint64_t>(&tmap_x)) : "memory");
    int seq[2] = {0, 0};
    for (int u = u0; u < u1; ++u) {
      const int c = (u - u0) & 1;
      const int b = u / p.tiles, p0 = (u % p.tiles) * T;
      const int rows = min(T, a.P - p0);
      const long long first = ((long long)b * a.P + p0) * a.Cout;
      const int res_bytes = a.residual != nullptr && bulk_ok(first, rows * a.Cout, p.res_size)
          ? rows * a.Cout * p.res_size : 0;
      for (int sl = 0; sl < p.slices; ++sl) {
        const int n = seq[c]++, s = n % p.stages;
        mbar_wait(empty(c, s), ((n / p.stages) & 1) ^ 1);
        const bool last = sl + 1 == p.slices;
        const uint32_t dst = base + stage(c, s);
        mbar_expect_tx(full(c, s), p.x_bytes + (last ? res_bytes : 0));
        tma_load_3d(dst, &tmap_x, sl * KC, p0, b, full(c, s));
        if (last && res_bytes > 0)
          bulk_load(dst + p.x_bytes, static_cast<const char*>(a.residual) + first * p.res_size,
                    res_bytes, full(c, s));
      }
    }
  } else if (tid >= 32 && tid < 128) {
    // ---- the folding warps: each later sample's fold, once, into a slot ----
    int fs = 1;
    for (int u = (u0 / p.tiles + 1) * p.tiles; u < u1;) {
      const int b = u / p.tiles, f = fs % p.fold_slots;
      mbar_wait(fold_empty + 8 * f, ((fs / p.fold_slots) & 1) ^ 1);
      ++fs;
      make_fold<NC, KC, FMA>(smem + f * p.fold_bytes, a, b, p.slices, tid - 32,
                             32 * kFolders);
      fence_proxy_async();  // these writes come before wgmma's reads
      __syncwarp();
      if (tid % 32 == 0) mbar_arrive(fold_full + 8 * f);
      u = (b + 1) * p.tiles;
    }
  } else if (tid >= 128) {
    // ---- the two consumers: alternate units, MMAs, then the epilogue ----
    const int cw = (tid - 128) / 128;  // consumer: units u0 + cw, u0 + cw + 2, ...
    const int wt = tid % 128;
    const int warp = wt / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
    // the tensor cores' accumulators: part k of output channel 8 j + 2 t4 +
    // e of row 64 i + 16 warp + g + 8 h at acc[i][4 (j + k NC / 8) + 2 h + e]
    float acc[MB][N / 2];
    // the epilogue's operands of this thread's output channels c = 8 j +
    // 2 t4 + e, read once (demod once per sample): the memory system is busy
    // with the stream, and a load in each unit's epilogue would wait behind it
    float dm[NC / 8][2], bi[NC / 8][2];
#pragma unroll
    for (int j = 0; j < NC / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * t4 + e;
        bi[j][e] = c < a.Cout && a.epi.bias != nullptr ? a.epi.bias[c] : 0.f;
      }
    const float nw = a.epi.noise != nullptr ? *a.epi.noise_w : 0.f;
    // the FMA form's: every output channel's, as a thread there takes any
    float cdm[8], cbi[8];
#pragma unroll
    for (int c = 0; c < 8; ++c)
      cbi[c] = FMA && c < a.Cout && a.epi.bias != nullptr ? a.epi.bias[c] : 0.f;
    int seq = 0, fs = 0, fslot = 0, cur_b = -1, done = 0;
    for (int u = u0; u < u1; ++u) {
      const int b = u / p.tiles;
      if (b != cur_b) {  // both consumers pass every sample's fold, in order
        if (cur_b >= 0) {
          __syncwarp();
          if (lane == 0) mbar_arrive(fold_empty + 8 * fslot);
        }
#pragma unroll
        for (int j = 0; j < NC / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 8 * j + 2 * t4 + e;
            dm[j][e] = c < a.Cout && a.epi.demod != nullptr
                ? a.epi.demod[(size_t)b * a.Cout + c] : 1.f;
          }
#pragma unroll
        for (int c = 0; c < 8; ++c)
          cdm[c] = FMA && c < a.Cout && a.epi.demod != nullptr
              ? a.epi.demod[(size_t)b * a.Cout + c] : 1.f;
        fslot = fs % p.fold_slots;
        mbar_wait(fold_full + 8 * fslot, (fs / p.fold_slots) & 1);
        ++fs;
        cur_b = b;
      }
      if (((u - u0) & 1) != cw) continue;
      const int p0 = (u % p.tiles) * T;
      const int rows = min(T, a.P - p0);
      // the epilogue's first pass fills the unit's staged fp32 tile (T x
      // Cout, the output's layout), two a consumer in turn, so a unit's
      // writes need no barrier against the second pass of the unit before
      float* ep = reinterpret_cast<float*>(smem + p.out_off
                                           + (2 * cw + (done++ & 1)) * p.out_bytes);
      int s = 0;
      if constexpr (FMA) {
        // The FMA kernel's sums, bit for bit (see the header), from every
        // slice of the unit at once (the plan keeps them all in the ring).
        // A pixel's L lanes (by Cx, as that kernel) are spread over TPP
        // threads: thread j takes lanes g = j, j + TPP, ..., each a chain of
        // fmaf over the 8-channel units g, g + L, ... in order; the lanes add
        // in the butterfly's tree, g and g + L / 2 first: the levels that
        // pair lanes TPP or more apart in the thread, the rest by shuffles.
        const int seq0 = seq;
        for (int sl = 0; sl < p.slices; ++sl, ++seq)
          mbar_wait(full(cw, seq % p.stages), (seq / p.stages) & 1);
        s = (seq - 1) % p.stages;
        const int first_slot = seq0 % p.stages;
        const int cx = (a.Cin + 7) / 8 * 8, units = cx / 8, K = p.slices * KC;
        const float* ff = reinterpret_cast<const float*>(smem + fslot * p.fold_bytes);
        const unsigned char* ring = smem + p.ring_off + cw * p.stages * p.stage_bytes;
        auto unit_sums = [&](auto lanes, auto threads, auto pixels, auto half) {
          constexpr int L = decltype(lanes)::value, TPP = decltype(threads)::value;
          constexpr int PPT = decltype(pixels)::value;  // pixels a thread at once
          // HALF: units = L / 2 (Cx 32, 64, 128: the large ToRGBs), so a
          // thread's first LPT / 2 lanes hold one unit each and the rest none
          constexpr bool HALF = decltype(half)::value;
          constexpr int LPT = L / TPP;                   // lanes a thread
          constexpr int STEP = 128 / TPP;                // rows between them
          const int j = wt % TPP;
          // every loop bound is the same across the warpgroup, so the
          // shuffles below always find their whole warp
          for (int rb = 0; rb < rows; rb += STEP * PPT) {
            int r[PPT], rowoff[PPT], sw[PPT];
#pragma unroll
            for (int pp = 0; pp < PPT; ++pp) {
              r[pp] = rb + wt / TPP + pp * STEP;
              const int rr = r[pp] < rows ? r[pp] : 0;
              rowoff[pp] = rr * ROWB;
              sw[pp] = swizzle<KC>(rr);
            }
            for (int c0 = 0; c0 < a.Cout; c0 += 4) {  // four channels' chains at once
              const int nch = min(4, a.Cout - c0);
              float lp[PPT][LPT][4];
#pragma unroll
              for (int pp = 0; pp < PPT; ++pp)
#pragma unroll
                for (int i = 0; i < LPT; ++i)
#pragma unroll
                  for (int cc = 0; cc < 4; ++cc) lp[pp][i][cc] = 0.f;
              for (int qb = 0; qb < (HALF ? 1 : units); qb += L) {
#pragma unroll
                for (int i = 0; i < (HALF ? LPT / 2 : LPT); ++i) {
                  const int q = qb + j + i * TPP;  // lane j + i TPP's next unit
                  if (!HALF && q >= units) continue;  // the same for every thread
                  int slot = first_slot + q / (KC / 8);
                  if (slot >= p.stages) slot -= p.stages;
                  const unsigned char* xs = ring + slot * p.stage_bytes;
                  float x[PPT][8];
#pragma unroll
                  for (int pp = 0; pp < PPT; ++pp) {
                    const uint4 xv = *reinterpret_cast<const uint4*>(
                        xs + rowoff[pp] + (((q % (KC / 8)) ^ sw[pp]) << 4));
                    const uint32_t w4[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
                    for (int k = 0; k < 4; ++k) {
                      x[pp][2 * k] = __uint_as_float(w4[k] << 16);
                      x[pp][2 * k + 1] = __uint_as_float(w4[k] & 0xFFFF0000u);
                    }
                  }
#pragma unroll
                  for (int cc = 0; cc < 4; ++cc) {
                    if (cc >= nch) break;
                    const float* f = ff + (c0 + cc) * K + 8 * q;
                    const float4 f0 = *reinterpret_cast<const float4*>(f);
                    const float4 f1 = *reinterpret_cast<const float4*>(f + 4);
                    const float fv[8] = {f0.x, f0.y, f0.z, f0.w, f1.x, f1.y, f1.z, f1.w};
#pragma unroll
                    for (int pp = 0; pp < PPT; ++pp) {
                      float acc = lp[pp][i][cc];
#pragma unroll
                      for (int k = 0; k < 8; ++k) acc = fmaf(x[pp][k], fv[k], acc);
                      lp[pp][i][cc] = acc;
                    }
                  }
                }
              }
#pragma unroll
              for (int pp = 0; pp < PPT; ++pp)
#pragma unroll
                for (int cc = 0; cc < 4; ++cc) {
                  if (cc >= nch) break;
#pragma unroll
                  for (int h = L / 2; h >= TPP; h /= 2)
#pragma unroll
                    for (int i = 0; i < h / TPP; ++i)
                      lp[pp][i][cc] = lp[pp][i][cc] + lp[pp][i + h / TPP][cc];
                  float v = lp[pp][0][cc];
#pragma unroll
                  for (int h = TPP / 2; h >= 1; h /= 2)
                    v = v + __shfl_xor_sync(0xffffffffu, v, h, TPP);
                  const int c = c0 + cc;
                  if (j == 0 && r[pp] < rows) {
                    float dmc = 1.f, bic = 0.f;
#pragma unroll
                    for (int k = 0; k < 8; ++k)
                      if (k == c) dmc = cdm[k], bic = cbi[k];
                    const float nzr = a.epi.noise != nullptr
                        ? nw * a.epi.noise[(size_t)b * a.epi.noise_bstride + p0 + r[pp]] : 0.f;
                    v = v * dmc + nzr + bic;
                    if (a.epi.act) v = (v >= 0.f ? v : 0.2f * v) * kSqrt2;
                    ep[r[pp] * a.Cout + c] = v;
                  }
                }
            }
          }
        };
        // at most 8 lanes a thread (their 4 channels' chains in registers),
        // two pixels a thread where the tile has the rows, 8 threads a
        // pixel where it has at most 16
        using I1 = std::integral_constant<int, 1>;
        using I2 = std::integral_constant<int, 2>;
        using I4 = std::integral_constant<int, 4>;
        using I8 = std::integral_constant<int, 8>;
        using I16 = std::integral_constant<int, 16>;
        using I32 = std::integral_constant<int, 32>;
        using Yes = std::true_type;
        using No = std::false_type;
        if constexpr (KC == 32) {  // Cx <= 32: 8 lanes, a thread a pixel
          if (cx == 32 && T >= 256) unit_sums(I8{}, I1{}, I2{}, Yes{});
          else if (cx == 32) unit_sums(I8{}, I1{}, I1{}, Yes{});
          else unit_sums(I8{}, I1{}, I1{}, No{});
        } else if (cx < 64) {
          unit_sums(I8{}, I1{}, I1{}, No{});
        } else if (cx < 128) {
          if (cx == 64 && T >= 128) unit_sums(I16{}, I2{}, I2{}, Yes{});
          else unit_sums(I16{}, I2{}, I1{}, No{});
        } else if (cx == 128 && rows > 16) {
          unit_sums(I32{}, I4{}, I2{}, Yes{});
        } else if (rows > 16) {
          unit_sums(I32{}, I4{}, I2{}, No{});
        } else {
          unit_sums(I32{}, I8{}, I1{}, No{});
        }
      } else {
        // the noise of this thread's rows, loaded before the products
        float nz[MB][2];
#pragma unroll
        for (int i = 0; i < MB; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = 64 * i + 16 * warp + g + 8 * h;
            nz[i][h] = a.epi.noise != nullptr && r < rows
                ? nw * a.epi.noise[(size_t)b * a.epi.noise_bstride + p0 + r] : 0.f;
          }

        // the products, slice by slice, into one accumulator over the whole
        // K (K <= 576 on every path shape; the bf16 3x3 core found that
        // safe up to K = 1152, chip_smoke.py phase 17d); a slice's stage is
        // released once the next slice's MMAs are issued and its own are done
        const uint32_t fold = base + fslot * p.fold_bytes;
        for (int sl = 0; sl < p.slices; ++sl, ++seq) {
          const int prev = s;
          s = seq % p.stages;
          mbar_wait(full(cw, s), (seq / p.stages) & 1);
          const uint32_t xs = base + stage(cw, s);
          const uint64_t bd = b_desc<KC>(fold + sl * N * ROWB);
          wgmma_fence();
#pragma unroll
          for (int j = 0; j < KS; ++j)
#pragma unroll
            for (int i = 0; i < MB; ++i)
              mma_ss<N>(acc[i], b_desc<KC>(xs + i * 64 * ROWB) + 2 * j, bd + 2 * j,
                        sl > 0 || j > 0);
          wgmma_commit();
          if (sl > 0) {
            wgmma_wait<1>();
            __syncwarp();
            if (lane == 0) mbar_arrive(empty(cw, prev));
          }
        }
        wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < MB; ++i) fence_operand(acc[i]);

        // the epilogue's first pass: the parts' sums added in fp32, hi + lo,
        // then act(sum * demod + noise + bias), into the staged tile
#pragma unroll
        for (int i = 0; i < MB; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = 64 * i + 16 * warp + g + 8 * h;
#pragma unroll
            for (int j = 0; j < NC / 8; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int c = 8 * j + 2 * t4 + e;
                const int q = 4 * j + 2 * h + e;
                float v = acc[i][q] + acc[i][q + NC / 2];
                v = v * dm[j][e] + nz[i][h] + bi[j][e];
                if (a.epi.act) v = (v >= 0.f ? v : 0.2f * v) * kSqrt2;
                if (r < rows && c < a.Cout) ep[r * a.Cout + c] = v;
              }
          }
      }
      warpgroup_sync(cw);
      // second pass: the tile in order, + the residual (the last stage's
      // copy, or global on a tail), one rounding, out
      const long long first = ((long long)b * a.P + p0) * a.Cout;
      const int n_out = rows * a.Cout;
      const TO* res = a.residual == nullptr ? nullptr
          : bulk_ok(first, n_out, p.res_size)
              ? reinterpret_cast<const TO*>(smem + stage(cw, s) + p.x_bytes)
              : static_cast<const TO*>(a.residual) + first;
      store_tile<TO>(static_cast<TO*>(a.out) + first, ep, res, n_out,
                     aligned16(first, p.out_size), wt);
      __syncwarp();
      // the last slice and the residual are read (the FMA form: every slice)
      for (int k = FMA ? seq - p.slices : seq - 1; k < seq && lane == 0; ++k)
        mbar_arrive(empty(cw, k % p.stages));
    }
  }
}

// the tensor map of x (B, P, Cx bf16): boxes of kc channels x tile rows of
// one sample, swizzled as wgmma reads them
inline bool x_map(CUtensorMap* map, const bf16* x, int B, int P, int Cin, const Plan& p) {
  const cuuint64_t cx = static_cast<cuuint64_t>((Cin + 7) / 8 * 8);
  const cuuint64_t dims[3] = {cx, (cuuint64_t)P, (cuuint64_t)B};
  const cuuint64_t strides[2] = {cx * 2, cx * 2 * P};
  const cuuint32_t box[3] = {(cuuint32_t)p.kc, (cuuint32_t)p.tile, 1};
  return conv3x3_bf16::encode(map, x, 3, dims, strides, box,
                              p.kc == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                         : CU_TENSOR_MAP_SWIZZLE_64B);
}

template <int NC, int KC, int MB, class TO>
int launch_plan(const CUtensorMap& tx, const Args& a, const Plan& p, cudaStream_t s) {
  auto kernel = modconv1x1_bf16_kernel<NC, KC, MB, TO>;
  cudaError_t rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        p.smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  kernel<<<p.grid, kThreads, p.smem, s>>>(tx, a, p);
  return static_cast<int>(cudaGetLastError());
}

// x (B, P, Cx) bf16, 16-byte aligned (the wrapper checks and pads);
// cudaErrorInvalidValue where no plan fits or the tensor map does not encode
template <class TO>
int launch(const bf16* x, const Args& a, int sms, cudaStream_t s) {
  const Plan p = make_plan(a.B, a.P, a.Cin, a.Cout, sizeof(TO),
                           a.residual != nullptr ? sizeof(TO) : 0, sms);
  CUtensorMap tx;
  if (p.smem == 0 || !x_map(&tx, x, a.B, a.P, a.Cin, p))
    return static_cast<int>(cudaErrorInvalidValue);
  const int mb = p.tile / 64;
#define W2E_K3_BF16_CASE(NC, KC, MB)                                   \
  if (p.nc == NC && p.kc == KC && mb == MB) return launch_plan<NC, KC, MB, TO>(tx, a, p, s);
  W2E_K3_BF16_CASE(8, 32, 1) W2E_K3_BF16_CASE(8, 32, 2) W2E_K3_BF16_CASE(8, 32, 4)
  W2E_K3_BF16_CASE(8, 64, 1) W2E_K3_BF16_CASE(8, 64, 2)
  W2E_K3_BF16_CASE(32, 32, 1) W2E_K3_BF16_CASE(32, 64, 1)  // Cout > 8: 64-pixel units
#undef W2E_K3_BF16_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace k3_bf16

// Blocks the fp32 kernel launches for this shape on a card with `sms` SMs,
// or 0 when it does not take the shape.
extern "C" int w2e_modconv1x1_blocks(int B, int P, int Cin, int Cout, int sms) {
  dim3 grid;
  int threads;
  size_t smem;
  const void* fn;
  if (!plan(B, P, Cin, Cout, sms, &grid, &threads, &smem, &fn)) return 0;
  return static_cast<int>(grid.x * grid.y);
}

// x (B,P,Cin), style (B,Cin), w (Cin,Cout), demod (B,Cout) or null, noise
// (B or 1,P) or null with batch stride noise_bstride, noise_w (1,), bias
// (Cout,) or null, residual (B,P,Cout) or null, out (B,P,Cout); Cout <= 32;
// x 16-byte aligned. Returns the launch's cudaGetLastError().
extern "C" int w2e_modconv1x1(const float* x, const float* style,
                              const float* w, const float* demod,
                              const float* noise, long long noise_bstride,
                              const float* noise_w, const float* bias,
                              const float* residual, float* out, int B, int P,
                              int Cin, int Cout, int act, int sms, void* stream) {
  return launch(x, style, w, demod, noise, noise_bstride, noise_w, bias, residual, out, B, P,
                Cin, Cout, act, sms, stream);
}

// The bf16 form: x bf16 (B, P, Cx), Cx = Cin rounded up to 8, zeros past
// Cin; out and residual bf16 when out_bf16, else fp32; every other operand
// fp32, as above.
extern "C" int w2e_modconv1x1_bf16(const bf16* x, const float* style, const float* w,
                                   const float* demod, const float* noise,
                                   long long noise_bstride, const float* noise_w,
                                   const float* bias, const void* residual, void* out,
                                   int B, int P, int Cin, int Cout, int act, int sms,
                                   int out_bf16, void* stream) {
  const k3_bf16::Args a{style, w, {demod, noise, noise_bstride, noise_w, bias, act},
                        residual, out, B, P, Cin, Cout};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_bf16 ? k3_bf16::launch<bf16>(x, a, sms, s) : k3_bf16::launch<float>(x, a, sms, s);
}

// The bf16 form's work plan for a call, into fields (19 ints, in Plan's
// order from `tile` to `smem`) and, where unit_flags is not null,
// one byte a unit: bit 0 its residual tile moves by bulk copy, bit 1 its
// output tile leaves in 16-byte stores (its first value is 16-byte
// aligned). Returns 1, or 0 where the core does not take the shape.
extern "C" int w2e_modconv1x1_bf16_plan(int B, int P, int Cin, int Cout, int out_bf16,
                                        int has_residual, int sms, int* fields,
                                        unsigned char* unit_flags) {
  const int out_size = out_bf16 ? 2 : 4;
  const k3_bf16::Plan p = k3_bf16::make_plan(B, P, Cin, Cout, out_size,
                                             has_residual ? out_size : 0, sms);
  const int f[] = {p.tile, p.tiles, p.units, p.grid, p.kc, p.slices, p.nc, p.res_size,
                   p.out_size, p.x_bytes, p.stage_bytes, p.stages, p.fold_bytes,
                   p.fold_slots, p.out_bytes, p.ring_off, p.out_off, p.bar_off, p.smem};
  for (int i = 0; i < static_cast<int>(sizeof(f) / sizeof(f[0])); ++i) fields[i] = f[i];
  if (p.smem == 0) return 0;
  for (int u = 0; unit_flags != nullptr && u < p.units; ++u) {
    const int b = u / p.tiles, p0 = (u % p.tiles) * p.tile;
    const long long first = ((long long)b * P + p0) * Cout;
    const int n = std::min(p.tile, P - p0) * Cout;
    unit_flags[u] = static_cast<unsigned char>(k3_bf16::bulk_ok(first, n, p.res_size)
                                               | k3_bf16::aligned16(first, p.out_size) << 1);
  }
  return 1;
}
