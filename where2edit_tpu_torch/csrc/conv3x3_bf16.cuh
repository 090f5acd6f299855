// The bf16 3x3 convolution core of K1 (modconv3x3.cu) and K2 (conv3x3.cu)
// on Hopper: NHWC, stride 1, zero padding 1, bf16 in and out, fp32 sums;
// sm_90a only (TMA, wgmma, setmaxnreg).
//
//   out[b,h,w,o] = act( demod[b,o] * sum_{ky,kx,i} round(x[b,h+ky-1,w+kx-1,i] * round(style[b,i]))
//                                                  * round(scale * wt[ky,kx,i,o])
//                       + noise_w * noise[b,h,w] + bias[o] )
//
// round: to bf16, nearest even; products and sums in fp32; one rounding at
// the store. The arithmetic of the TPU kernels (tools/conv3x3_bench.py),
// which take bf16. K1 passes its style, demod and noise (scale 1); K2 its
// equalised-lr scale and nothing else. The epilogue is the fp32 core's
// (conv3x3_tc.cuh: Epilogue, finish).
//
// An implicit GEMM: M = B*H*W output pixels, N = Cout, K = 9*Cin. Bound on
// the H100 (NVIDIA H100 80GB HBM3, 700 W): operations at the bf16 tensor
// cores' 989 TFLOP/s from 16^2 up at 512 channels, bytes (3.35 TB/s) at
// 32 and 64 channels (512^2, 1024^2); the 4^2 and 8^2 shapes are a few
// microseconds of fixed cost (launches, the weight preparation, the split
// sums). What the design does about each:
//
// - Warp specialisation. A block is one producer warpgroup and two
//   consumer warpgroups that run wgmma, each on half of a tile's pixels:
//   1, 2 or 4 blocks of 64 rows (m_blocks), so that a narrow Cout still
//   gives each tile's loads, barriers and epilogue many MMAs to share.
//   ptxas holds the kernel to 168 registers a thread (65536 / 384,
//   whatever setmaxnreg grants), so a warpgroup's accumulator stays at
//   64-128 fp32 values and a step's MMAs go in batches whose fragments fit
//   beside it.
// - The sums. The tensor cores truncate their own fp32 sums; carried over
//   a whole K of 4608 (512 channels) that biases the result towards 0 by
//   ~3e-6 and puts ~7x as many bf16 outputs off the plain twin as short
//   sums do, which is enough to move a whole bf16 training step's
//   gradients measurably. So where Cin > 128 each pair of K steps (128
//   products an output) sums into a fresh tensor-core accumulator that is
//   added to an fp32 register sum (Cout tile at most 128, 64 values each);
//   where K <= 1152 one accumulator runs over the whole K (Cout tile up to
//   256: 128-pixel tiles at 256, 256 at 128 and 64 (K1's: 128 at 128, its
//   epilogue needs the registers), 512 at 32). Step sums there cost the
//   narrow shapes their long MMA batches (K1-bf16 at 1024^2, 32 channels,
//   batch 8 took twice the time on the H100 above); chip_smoke.py 17d
//   holds a whole bf16 training step on each side of the threshold against
//   the CPU (a 64^2 GAN, every 3x3 conv at 512 channels, and a 256^2 GAN
//   at channel multiplier 1, 64 and 128 channels at 256^2 and 128^2).
// - Persistent blocks. At most one block per SM walks the work units
//   (Cout tile fastest, then pixel tile, then K split) in a fixed order, so
//   that the producer loads one unit's first stages while the consumers
//   finish the previous unit's epilogue.
// - Two rings of stages in shared memory, each guarded by full and empty
//   mbarriers; one producer thread issues every copy with TMA. The halo
//   ring: per (pixel tile, 64-channel slice), one box of the halo'd input
//   patch, (th + 2) x (tw + 2) pixels of ni images, by a 4-D tensor map
//   over x (B, H, W, Cin) at (b0, h0 - 1, w0 - 1, c0); TMA fills what lies
//   outside the image (and past B and Cin) with zeros, which is the conv's
//   padding. Tiles are up to 64 pixels wide, so rows are long runs. The
//   weight ring: per (tap, slice), the BN x 64 tile of the prepared
//   weights; where a Cout tile's weights for the whole K fit (32 and 64
//   channels: 18 and 72 KiB) they are loaded once per block and stay. K
//   runs slice by slice, the 9 taps of a slice in order.
// - The tap shift is an address. A's fragments are read with ldmatrix from
//   the halo patch at the tap's offset (one shifted row per lane; the
//   patch is 128-byte swizzled, so the 8 rows of a matrix hit distinct
//   banks) and handed to wgmma from registers (the RS form), B by
//   descriptor from the swizzled weight stage. One halo load serves the 9
//   taps of a slice: A crosses from L2 once, not 9 times. A warpgroup
//   loads fragments only while none of its wgmma is in flight (ptxas
//   serialises every wgmma of a kernel that writes a fragment under a
//   running one); the other warpgroup's MMAs cover those loads.
// - K1's modulation, round(x * round(s)), is one pass over each landed
//   patch, in place, by the producer warpgroup's three other warps, while
//   the consumers run the previous patch's MMAs; the consumers wait for it
//   on a third barrier (h_ready). Each staged value is modulated once per
//   slice, not once per tap.
// - The epilogue: act(acc * demod + noise + bias) in fp32, without a branch
//   per value; the quad of lanes that holds a pixel's row trades its pairs
//   by shuffles so that each lane holds 8 neighbouring channels; where a
//   tile's halves are whole image rows, each warpgroup stages its half in
//   shared memory and one thread stores it with TMA (which clips the image
//   edges), else each lane stores 16 bytes.
// - Where the unit grid would not fill the SMs (4^2 to 16^2 at batch 8) the
//   K steps are split across blocks, at least one slice each (split-K):
//   each writes raw fp32 sums to scratch (splits, B, H, W, Cout) and
//   conv3x3_bf16_reduce sums the splits in a fixed order and applies the
//   epilogue, so the result does not depend on the order blocks ran in.
// - The weights are prepared by conv3x3_bf16_prep: round(scale * wt) into
//   [Cout tile][slice][tap][BN][KC], K-major, zeros past Cin and Cout; TMA
//   swizzles each tile as it loads it. KC is 64 channels (128-byte rows,
//   128-byte swizzle), or 32 (64-byte rows and swizzle) where Cin <= 32.
// - Ragged channel counts: x's rows must be whole 16-byte units for TMA,
//   so a Cin that is not a multiple of 8 (final_conv's 513) reaches the
//   kernel padded with zero channels to the next multiple of 8 (the Python
//   wrapper does it); ragged Cout (513, the input gradient of final_conv)
//   is masked at the stores.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (no driver library is linked)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "conv3x3_tc.cuh"  // Epilogue, finish, cdiv, the wgmma fences

namespace conv3x3_bf16 {

using bf16 = __nv_bfloat16;
using conv3x3_tc::cdiv;
using conv3x3_tc::Epilogue;
using conv3x3_tc::fence_operand;
using conv3x3_tc::smem_addr;
using conv3x3_tc::wgmma_commit;
using conv3x3_tc::wgmma_fence;
using conv3x3_tc::wgmma_wait;

constexpr int kConsumers = 2;                    // warpgroups running wgmma
constexpr int kThreads = 128 * (1 + kConsumers);  // and the producer's
constexpr int kMaxNI = 8;                        // whole images per tile at most
constexpr int kMaxSmem = 232448;                 // bytes a block may use on the H100
constexpr int kMinSteps = 9;                     // K steps per split at least: a slice
constexpr int kResidentBytes = 112 * 1024;       // weights kept whole up to this
constexpr int kModulators = 3;  // the producer warpgroup's other warps: K1's modulation
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

// ---------------------------------------------------------------------------
// the plan of a call: tiles, stages and shared memory (host and device)
// ---------------------------------------------------------------------------

struct Plan {
  int tw, th, ni;               // the pixel tile: ni images of th x tw pixels
                                // (at most 128 * m_blocks(bn), tw at most 16 *
                                // m_blocks(bn))
  int tiles_w, tiles_h, m_tiles;
  int kc, slices, steps;        // K: steps = 9 taps x slices of kc channels
  int bn, n_tiles;              // the Cout tile
  int splits, steps_per_split;
  int units;                    // n_tiles x m_tiles x splits
  int resident;                 // the weights stay in shared memory
  int w_stages, h_stages;       // ring depths
  int w_bytes, h_bytes, h_rows, h_tx;  // a weight stage, a halo stage (1 KiB
                                       // aligned), its rows, its copy's bytes
  int tma_store;                       // the epilogue stages bf16 tiles for TMA stores
  int sums;                            // step_sums(Cin)
  int stage_off, style_off, bar_off, smem;  // byte offsets from the aligned base, total
};

// Where K = 9 Cin is long (Cin > 128), each K step sums into a fresh
// tensor-core accumulator that is added to an fp32 sum (see the consumer);
// that second accumulator limits the Cout tile to 128.
inline bool step_sums(int Cin) { return Cin > 128; }

// The Cout tile: 32, 64, 128 or, without step sums, 256 channels.
inline int tile_n(int Cout, bool sums) {
  return Cout <= 32 ? 32 : Cout <= 64 ? 64 : Cout <= 128 || sums ? 128 : 256;
}

inline int slice_k(int Cin) { return Cin <= 32 ? 32 : 64; }

// 64-row blocks of the tile each consumer warpgroup holds: as many as keep
// its accumulator at 64 (with step sums, and K1's at Cout tile 128: its
// epilogue needs the registers) or 64-128 fp32 values a thread (a
// narrow Cout tile takes more pixels, so that a tile's fixed costs are
// spread over more MMAs)
__host__ __device__ constexpr int m_blocks(int BN, bool sums, bool k1) {
  return sums || (k1 && BN == 128) ? 128 / BN : BN == 32 ? 4 : BN == 256 ? 1 : 2;
}

// channels of x as the kernel reads it: Cin rounded up to 8 (16 bytes)
inline int x_channels(int Cin) { return (Cin + 7) / 8 * 8; }

// The plan for a shape and split count; smem == 0 when no ring fits. k1:
// K1's tiles; styled: K1 with a style (the style table is staged).
inline Plan make_plan(int B, int H, int W, int Cin, int Cout, int splits, bool k1,
                      bool styled) {
  Plan p{};
  p.sums = step_sums(Cin);
  p.bn = tile_n(Cout, p.sums);
  const int mb = m_blocks(p.bn, p.sums, k1);
  const int bm = 64 * kConsumers * mb;  // output pixels per tile
  // wide tiles: each staged row and each stored row is a long run of
  // neighbouring pixels (up to 64 x 64 bytes at 32 channels); the halo box
  // (th + 2 rows) stays within TMA's 256 a dimension
  p.tw = std::min(W, 16 * mb);
  p.th = std::min({H, bm / p.tw, 254});
  p.ni = (p.th == H && p.tw == W) ? std::max(1, std::min(kMaxNI, bm / (H * W))) : 1;
  p.tiles_w = cdiv(W, p.tw);
  p.tiles_h = cdiv(H, p.th);
  p.m_tiles = cdiv(B, p.ni) * p.tiles_h * p.tiles_w;
  p.kc = slice_k(Cin);
  p.slices = cdiv(Cin, p.kc);
  p.steps = 9 * p.slices;
  p.n_tiles = cdiv(Cout, p.bn);
  p.splits = std::max(1, splits);
  p.steps_per_split = cdiv(p.steps, p.splits);
  p.units = p.n_tiles * p.m_tiles * p.splits;
  p.w_bytes = p.bn * p.kc * 2;
  p.h_rows = p.ni * (p.th + 2) * (p.tw + 2);
  p.h_tx = p.h_rows * p.kc * 2;
  p.h_bytes = (p.h_tx + 1023) / 1024 * 1024;
  const int style_bytes = styled ? p.ni * p.slices * p.kc * 4 : 0;
  p.resident = p.n_tiles == 1 && p.splits == 1 && p.steps * p.w_bytes <= kResidentBytes;
  // A tile whose two halves are whole image rows of one image, in a
  // tensor whose pixel rows are whole 16-byte units, is stored by TMA from
  // a staged copy (one per consumer warpgroup) where that copy still leaves
  // 4 weight stages; else each lane stores its own values.
  const int stage_bytes = 2 * 64 * mb * p.bn * 2;
  p.tma_store = p.splits == 1 && Cout % 8 == 0 && p.ni == 1 && p.th % 2 == 0
      && p.th * p.tw == bm;
  p.w_stages = p.resident ? p.steps : 6;
  p.h_stages = p.steps_per_split <= 9 ? 4 : 2;
  for (;;) {
    p.stage_off = p.w_stages * p.w_bytes + p.h_stages * p.h_bytes;
    p.style_off = p.stage_off + (p.tma_store ? stage_bytes : 0);
    p.bar_off = p.style_off + (style_bytes + 15) / 16 * 16;
    p.smem = 1024 + p.bar_off + 16 * p.w_stages + 24 * p.h_stages;  // + alignment slack
    if (p.smem <= kMaxSmem) return p;
    if (!p.resident && p.w_stages > 4) --p.w_stages;
    else if (p.h_stages > 2) --p.h_stages;
    else if (p.tma_store) { p.tma_store = 0; p.w_stages = p.resident ? p.steps : 6; }
    else if (p.resident) { p.resident = 0; p.w_stages = 6; }
    else if (p.w_stages > 2) --p.w_stages;
    else { p.smem = 0; return p; }
  }
}

// ---------------------------------------------------------------------------
// device helpers
// ---------------------------------------------------------------------------

// (round(lo), round(hi)) packed as bf16 in one register, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// round(v * s) of a packed bf16 pair (low half: the lower channel), the
// product taken in fp32, where it is exact
__device__ __forceinline__ uint32_t modulate_bf16x2(uint32_t v, float s_lo, float s_hi) {
  return pack_bf16x2(__uint_as_float(v << 16) * s_lo, __uint_as_float(v & 0xFFFF0000u) * s_hi);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// until the phase of parity `parity` has completed. A wait of more than
// ~10 s (2^34 clocks) can only be a broken pipeline: it traps, so the
// launch fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  long long start = 0;
  for (unsigned spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if ((spin & 1023) == 1023) {
      const long long now = clock64();
      if (start == 0) start = now;
      else if (now - start > (1LL << 34)) __trap();
    }
  }
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
         "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// until this thread's bulk stores have read their shared memory (read) or
// are done
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// the three modulating warps (96 threads), named barrier 1
__device__ __forceinline__ void modulator_sync() {
  asm volatile("bar.sync 1, 96;\n" ::: "memory");
}

// one consumer warpgroup (128 threads), named barrier 2 + cw
__device__ __forceinline__ void warpgroup_sync(int cw) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(2 + cw) : "memory");
}

// The 16-byte unit a logical (row, 16-byte chunk) of a staged tile sits at:
// TMA's 128-byte swizzle (KC = 64, 128-byte rows) XORs the chunk with the
// row mod 8, its 64-byte swizzle (KC = 32, 64-byte rows) with (row / 2)
// mod 4; both tiles start 1 KiB aligned.
template <int KC>
__device__ __forceinline__ int swizzle(int row) {
  return KC == 64 ? (row & 7) : ((row >> 1) & 3);
}

// Descriptor of a K-major BN x KC bf16 tile as TMA swizzled it: 8-row
// groups KC*2*8 bytes apart (stride byte offset), the leading byte offset
// unused by swizzled K-major tiles, layout type 1 (128-byte swizzle) or 2
// (64-byte). A k16 step further along K is 32 bytes on: +2 in the address
// field.
template <int KC>
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  uint64_t d = (addr >> 4) & 0x3FFF;
  d |= static_cast<uint64_t>(1) << 16;
  d |= static_cast<uint64_t>((8 * KC * 2) >> 4) << 32;
  d |= static_cast<uint64_t>(KC == 64 ? 1 : 2) << 62;
  return d;
}

// acc(64 x BN, this thread's BN/2 values) = A(64 x 16 bf16, from registers,
// packed in pairs) * B(16 x BN bf16, K-major in shared memory via desc) +
// (scale_d ? acc : 0), fp32 accumulate. The last immediate (0) keeps B
// K-major.
#define W2E_D8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
                  "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define W2E_D32(i) W2E_D8(i), W2E_D8(i + 8), W2E_D8(i + 16), W2E_D8(i + 24)
#define W2E_A_DESC "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d)

template <int BN>
__device__ __forceinline__ void mma_rs(float (&d)[BN / 2], const uint32_t (&a)[4], uint64_t desc,
                                       int scale_d);

template <>
__device__ __forceinline__ void mma_rs<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t desc,
                                       int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : W2E_D8(0), W2E_D8(8)
      : W2E_A_DESC);
}

template <>
__device__ __forceinline__ void mma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t desc,
                                       int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : W2E_D32(0)
      : W2E_A_DESC);
}

template <>
__device__ __forceinline__ void mma_rs<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t desc,
                                       int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : W2E_D32(0), W2E_D32(32)
      : W2E_A_DESC);
}

template <>
__device__ __forceinline__ void mma_rs<256>(float (&d)[128], const uint32_t (&a)[4],
                                            uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : W2E_D32(0), W2E_D32(32), W2E_D32(64), W2E_D32(96)
      : W2E_A_DESC);
}
#undef W2E_D8
#undef W2E_D32
#undef W2E_A_DESC

// ---------------------------------------------------------------------------
// kernels
// ---------------------------------------------------------------------------

// The weights: round(scale * wt) of wt (3,3,Cin,Cout) HWIO into
// wp[n_tile][slice][tap][n][k], the element of output channel
// n_tile*BN + n and input channel slice*KC + k; zeros past Cin and Cout.
// One thread per 8 k of one n writes them as one 16-byte store; a warp
// takes 4 (KC 32) or 8 (KC 64) such units of 4 or 8 neighbouring n, so
// that its reads of a row of wt and its writes are whole 32-byte sectors.
// (kernels/common.py::tc_prepared_plain with dtype bf16 is its plain twin.)
template <class Kind>
__global__ void __launch_bounds__(256)
conv3x3_bf16_prep(const float* __restrict__ wt, float scale, bf16* __restrict__ wp, int Cin,
                  int Cout, int BN, int KC, int slices, int total) {
  // 32-bit index arithmetic; the host keeps total under 2^31
  const unsigned e = blockIdx.x * 256u + threadIdx.x;
  if (e >= static_cast<unsigned>(total)) return;
  const unsigned k8s = static_cast<unsigned>(KC / 8);
  const int k8 = static_cast<int>(e % k8s);  // fastest: one n's row, 16 bytes a lane
  const unsigned stage = e / k8s;            // (nt, slice, tap, n)
  const int n = static_cast<int>(stage % static_cast<unsigned>(BN));
  unsigned rest = stage / static_cast<unsigned>(BN);
  const int tap = static_cast<int>(rest % 9);
  rest /= 9;
  const int slice = static_cast<int>(rest % static_cast<unsigned>(slices));
  const int nt = static_cast<int>(rest / static_cast<unsigned>(slices));
  const int co = nt * BN + n;
  uint32_t packed[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float v[2];
#pragma unroll
    for (int lo = 0; lo < 2; ++lo) {
      const int ci = slice * KC + k8 * 8 + 2 * q + lo;
      v[lo] = (co < Cout && ci < Cin) ? wt[((size_t)tap * Cin + ci) * Cout + co] * scale : 0.f;
    }
    packed[q] = pack_bf16x2(v[0], v[1]);
  }
  reinterpret_cast<uint4*>(wp)[e] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
}

// A work unit: one pixel tile, one Cout tile, one range of K steps.
struct Unit {
  int b0, h0, w0, nt, split, kb, ke;
};

__device__ __forceinline__ Unit unit_at(const Plan& p, int u) {
  Unit r;
  r.nt = u % p.n_tiles;
  const int rest = u / p.n_tiles;
  const int mt = rest % p.m_tiles;
  r.split = rest / p.m_tiles;
  r.w0 = (mt % p.tiles_w) * p.tw;
  r.h0 = ((mt / p.tiles_w) % p.tiles_h) * p.th;
  r.b0 = (mt / (p.tiles_w * p.tiles_h)) * p.ni;
  r.kb = r.split * p.steps_per_split;
  r.ke = min(p.steps, r.kb + p.steps_per_split);
  return r;
}

// The persistent, warp-specialised kernel (see the header). x is read
// through tmap_x (B, H, W, Cx bf16), the prepared weights through tmap_w,
// and out is written through tmap_out (B, H, W, Cout) where p.tma_store;
// style (B, Cin) fp32 or null (K1; null is a factor of 1); raw sums go to
// `partial` (splits, B, H, W, Cout) when it is set, finished values to out.
template <int BN, int KC, bool SUMS, class Kind>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_bf16_kernel(const __grid_constant__ CUtensorMap tmap_x,
                    const __grid_constant__ CUtensorMap tmap_w,
                    const __grid_constant__ CUtensorMap tmap_out, const float* __restrict__ style,
                    Epilogue epi, bf16* __restrict__ out, float* __restrict__ partial, int B,
                    int H, int W, int Cin, int Cout, const Plan p) {
  constexpr bool MOD = Kind::modulated;
  constexpr int KS = KC / 16;    // k16 MMAs per stage
  constexpr int ROWB = KC * 2;   // bytes per staged row
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzle repeats every 1 KiB
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t w_ring = base;
  const uint32_t h_ring = base + p.w_stages * p.w_bytes;
  const uint32_t bars = base + p.bar_off;
  // w_full, w_empty (w_stages each), h_full, h_empty, h_ready (h_stages each)
  const uint32_t w_full = bars, w_empty = bars + 8 * p.w_stages;
  const uint32_t h_full = bars + 16 * p.w_stages, h_empty = h_full + 8 * p.h_stages;
  const uint32_t h_ready = h_empty + 8 * p.h_stages;
  const bool modulate = MOD && style != nullptr;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < p.w_stages; ++s) {
      mbar_init(w_full + 8 * s, 1);
      mbar_init(w_empty + 8 * s, 4 * kConsumers);  // one arrival per consumer warp
    }
    for (int s = 0; s < p.h_stages; ++s) {
      mbar_init(h_full + 8 * s, 1);
      mbar_init(h_empty + 8 * s, 4 * kConsumers);
      mbar_init(h_ready + 8 * s, kModulators);  // one arrival per modulating warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    // ---- the producer warpgroup: one thread issues every copy ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kProducerRegs));
    if (tid == 0) {
      asm volatile("prefetch.tensormap [%0];\n"
                   :: "l"(reinterpret_cast<uint64_t>(&tmap_x)) : "memory");
      asm volatile("prefetch.tensormap [%0];\n"
                   :: "l"(reinterpret_cast<uint64_t>(&tmap_w)) : "memory");
      if (p.resident) {  // the one Cout tile's weights, every step, once
        for (int k = 0; k < p.steps; ++k) {
          mbar_expect_tx(w_full + 8 * k, p.w_bytes);
          tma_load_2d(w_ring + k * p.w_bytes, &tmap_w, 0, k * BN, w_full + 8 * k);
        }
      }
      int ws = 0, wph = 0, hs = 0, hph = 0;
      for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
        const Unit t = unit_at(p, u);
        for (int k = t.kb; k < t.ke; ++k) {
          const int slice = k / 9, tap = k - 9 * slice;
          if (k == t.kb || tap == 0) {  // the slice's halo patch
            mbar_wait(h_empty + 8 * hs, hph ^ 1);
            mbar_expect_tx(h_full + 8 * hs, p.h_tx);
            tma_load_4d(h_ring + hs * p.h_bytes, &tmap_x, slice * KC, t.w0 - 1, t.h0 - 1, t.b0,
                        h_full + 8 * hs);
            if (++hs == p.h_stages) { hs = 0; hph ^= 1; }
          }
          if (!p.resident) {  // the (tap, slice)'s weights
            mbar_wait(w_empty + 8 * ws, wph ^ 1);
            mbar_expect_tx(w_full + 8 * ws, p.w_bytes);
            tma_load_2d(w_ring + ws * p.w_bytes, &tmap_w, 0,
                        ((t.nt * p.slices + slice) * 9 + tap) * BN, w_full + 8 * ws);
            if (++ws == p.w_stages) { ws = 0; wph ^= 1; }
          }
        }
      }
    } else if (modulate && tid >= 32) {
      // K1's modulation, round(x * round(s)), over each landed patch, in
      // place, by the other three warps (16 bytes, 8 channels of one row,
      // at a time), while the consumers run the previous patch's MMAs; the
      // consumers wait for h_ready. The style table holds round(style) of
      // the unit's images over the slices the unit reads, 0 past B and Cin
      // (x is 0 there too, and 0 times a value past the array could be NaN).
      const int mt = tid - 32;  // 0 .. 95
      float* style_tab = reinterpret_cast<float*>(smem + p.style_off);
      const int cp = p.slices * KC;
      const int box_img = (p.th + 2) * (p.tw + 2);
      int tab_b0 = -1, tab_lo = -1, tab_hi = -1;  // what the table holds
      int hs = 0, hph = 0;
      for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
        const Unit t = unit_at(p, u);
        const int lo = t.kb / 9, hi = (t.ke - 1) / 9;
        if (t.b0 != tab_b0 || lo < tab_lo || hi > tab_hi) {
          modulator_sync();  // no warp reads the table any more
          for (int i = mt; i < p.ni * (hi - lo + 1) * KC; i += 32 * kModulators) {
            const int img = i / ((hi - lo + 1) * KC);
            const int c = lo * KC + i % ((hi - lo + 1) * KC);
            const int b = t.b0 + img;
            style_tab[img * cp + c] =
                (b < B && c < Cin) ? round_bf16(style[(size_t)b * Cin + c]) : 0.f;
          }
          tab_b0 = t.b0, tab_lo = lo, tab_hi = hi;
          modulator_sync();
        }
        for (int slice = lo; slice <= hi; ++slice) {
          mbar_wait(h_full + 8 * hs, hph);
          constexpr int CH = KC / 8;  // 16-byte units per row
          constexpr int STEP = 32 * kModulators;  // units, a multiple of CH
          unsigned char* patch = smem + (p.w_stages * p.w_bytes + hs * p.h_bytes);
          // a thread keeps one logical unit (8 channels) of every STEP/CH-th
          // row, so within one image its style comes once per slice
          const int lc = mt % CH;
          const float* sv0 = style_tab + slice * KC + lc * 8;
          float4 s0 = *reinterpret_cast<const float4*>(sv0);
          float4 s1 = *reinterpret_cast<const float4*>(sv0 + 4);
#pragma unroll 2
          for (int r = mt / CH; r < p.h_rows; r += STEP / CH) {
            if (p.ni > 1) {
              const float* sv = sv0 + (r / box_img) * cp;
              s0 = *reinterpret_cast<const float4*>(sv);
              s1 = *reinterpret_cast<const float4*>(sv + 4);
            }
            uint4* q = reinterpret_cast<uint4*>(patch + r * ROWB + ((lc ^ swizzle<KC>(r)) << 4));
            uint4 v = *q;
            v.x = modulate_bf16x2(v.x, s0.x, s0.y);
            v.y = modulate_bf16x2(v.y, s0.z, s0.w);
            v.z = modulate_bf16x2(v.z, s1.x, s1.y);
            v.w = modulate_bf16x2(v.w, s1.z, s1.w);
            *q = v;
          }
          // these generic-proxy writes come before the next TMA write here
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          __syncwarp();
          if (tid % 32 == 0) mbar_arrive(h_ready + 8 * hs);
          if (++hs == p.h_stages) { hs = 0; hph ^= 1; }
        }
      }
    }
  } else {
    // ---- the two consumer warpgroups ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kConsumerRegs));
    constexpr int MB = m_blocks(BN, SUMS, MOD);  // 64-row blocks of this warpgroup
    const int ct = tid - 128;         // 0 .. 255
    const int cw = ct / 128;          // consumer warpgroup: blocks MB*cw ..
    const int warp = (ct / 32) % 4;   // warp in the warpgroup: rows 16*warp ..
    const int lane = tid % 32;
    const int g = lane / 4, t4 = lane % 4;
    const int tile_px = p.th * p.tw;
    const int box_w = p.tw + 2, box_img = (p.th + 2) * box_w;
    // a patch is read once it has landed (K2, K1 without style) or been
    // modulated (K1)
    const uint32_t h_use = modulate ? h_ready : h_full;

    // this lane's ldmatrix row in each block: matrices 0..3 are rows 0-7 /
    // 8-15 of the warp's 16, k 0-7 / 8-15 of the k16 step (a0..a3 of the
    // fragment); its halo row at tap (0, 0) (a padding row reads row 0)
    int hrow0[MB];
#pragma unroll
    for (int i = 0; i < MB; ++i) {
      const int m = 64 * (MB * cw + i) + 16 * warp + (lane % 8) + 8 * ((lane / 8) % 2);
      hrow0[i] = 0;
      if (m < p.ni * tile_px) {
        const int img = m / tile_px, rem = m % tile_px;
        hrow0[i] = img * box_img + (rem / p.tw) * box_w + rem % p.tw;
      }
    }
    const int lchunk = lane / 16;
    // where accumulator row 16*warp + g + 8h of block i sits in a tile:
    // image * 2^20 + row * 64 + column (tw <= 64), or -1 past its pixels
    auto place = [&](int i, int h) {
      const int m = 64 * (MB * cw + i) + 16 * warp + g + 8 * h;
      const int rem = m % tile_px;
      return m < p.ni * tile_px ? (m / tile_px) * (1 << 20) + (rem / p.tw) * 64 + rem % p.tw
                                : -1;
    };
    // Where one accumulator of at most 64 values leaves registers to spare,
    // the rows' places are kept and each unit's noise is loaded before its
    // MMAs (else both come after them: no register held across the MMAs).
    constexpr bool RICH = !SUMS && MB * BN / 2 <= 64;
    int rowpos[MB][2];
#pragma unroll
    for (int i = 0; i < MB; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) rowpos[i][h] = RICH ? place(i, h) : 0;
    // that row's pixel in unit t; false where it lies past the tensor
    auto pixel = [&](const Unit& t, int i, int h, int& b, int& hh, int& ww) {
      const int pos = RICH ? rowpos[i][h] : place(i, h);
      b = t.b0 + (pos >> 20);
      hh = t.h0 + ((pos >> 6) & 16383);
      ww = t.w0 + (pos & 63);
      return pos >= 0 && b < B && hh < H && ww < W;
    };

    int ws = 0, wph = 0, hs = 0, hph = 0;
    // With SUMS each pair of K steps sums into a fresh tensor-core
    // accumulator `acc` that is added to `sum` in fp32 (the header says
    // why); without, `acc` runs over the whole K. A step's k16 MMAs go in
    // batches of KH whose fragments fit beside the accumulators under the
    // 168-register cap.
    constexpr int KH = SUMS ? (4 / MB < KS ? 4 / MB : KS)
                            : (MB * BN / 2 + MB * KS * 4 > 144 ? KS / 2 : KS);
    float acc[MB][BN / 2], sum[MB][BN / 2];  // sum: only with SUMS
    // the unit's sums
    auto total = [&](int i, int j) -> float {
      if constexpr (SUMS) return sum[i][j];
      else return acc[i][j];
    };
#pragma unroll
    for (int i = 0; i < MB; ++i)
#pragma unroll
      for (int j = 0; j < BN / 2; ++j) acc[i][j] = 0.f;  // each step overwrites it
    uint32_t a[MB][KH][4];

    for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
      const Unit t = unit_at(p, u);
      const bool noisy = MOD && partial == nullptr && epi.noise != nullptr;
      // the noise of this thread's pixels, for the epilogue
      float nz[MB][2];
      auto load_noise = [&]() {
#pragma unroll
        for (int i = 0; i < MB; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            int b, hh, ww;
            nz[i][h] = noisy && pixel(t, i, h, b, hh, ww)
                ? epi.noise[(size_t)b * epi.noise_bstride + (size_t)hh * W + ww] : 0.f;
          }
      };
      if (RICH) load_noise();
#pragma unroll
      for (int i = 0; i < MB; ++i) {
#pragma unroll
        for (int j = 0; j < BN / 2; ++j) {
          if constexpr (SUMS) sum[i][j] = 0.f;
          else acc[i][j] = 0.f;
        }
        fence_operand(acc[i]);
      }

      int cur_h = 0;  // the halo stage in use
      for (int k = t.kb; k < t.ke; ++k) {
        const int slice = k / 9, tap = k - 9 * slice;
        if (k == t.kb || tap == 0) {
          if (k != t.kb) {  // the previous slice's patch is read out
            __syncwarp();
            if (lane == 0) mbar_arrive(h_empty + 8 * cur_h);
          }
          mbar_wait(h_use + 8 * hs, hph);
          cur_h = hs;
          if (++hs == p.h_stages) { hs = 0; hph ^= 1; }
        }
        const int wsl = p.resident ? k : ws;
        mbar_wait(w_full + 8 * wsl, p.resident ? 0 : wph);
        // A: the tap-shifted rows of the patch, every block, KH k16 steps at
        // a time; loaded while no wgmma of this warpgroup is in flight (a
        // register written under a running wgmma would serialise every
        // wgmma)
        const uint32_t patch = h_ring + cur_h * p.h_bytes;
        const int off = (tap / 3) * box_w + tap % 3;
        const uint64_t desc = b_desc<KC>(w_ring + wsl * p.w_bytes);
#pragma unroll
        for (int j0 = 0; j0 < KS; j0 += KH) {
#pragma unroll
          for (int i = 0; i < MB; ++i) {
            const int hr = hrow0[i] + off;
            const uint32_t row = patch + hr * ROWB;
            const int sw = swizzle<KC>(hr);
#pragma unroll
            for (int j = 0; j < KH; ++j)
              ldmatrix_x4(a[i][j], row + (((2 * (j0 + j) + lchunk) ^ sw) << 4));
          }
          wgmma_fence();
#pragma unroll
          for (int j = 0; j < KH; ++j)
#pragma unroll
            for (int i = 0; i < MB; ++i)
              mma_rs<BN>(acc[i], a[i][j], desc + 2 * (j0 + j),
                         !SUMS || (k - t.kb) % 2 == 1 || j0 + j > 0);
          wgmma_commit();
          wgmma_wait<0>();  // the other warpgroup's MMAs cover this one's loads
#pragma unroll
          for (int i = 0; i < MB; ++i) fence_operand(acc[i]);
        }
        if constexpr (SUMS) {
          if ((k - t.kb) % 2 == 1 || k + 1 == t.ke) {
#pragma unroll
            for (int i = 0; i < MB; ++i)
#pragma unroll
              for (int j = 0; j < BN / 2; ++j) sum[i][j] += acc[i][j];
          }
        }
        if (!p.resident) {  // the stage is read out
          __syncwarp();
          if (lane == 0) mbar_arrive(w_empty + 8 * ws);
          if (++ws == p.w_stages) { ws = 0; wph ^= 1; }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(h_empty + 8 * cur_h);
      if (!RICH) load_noise();
      // each row's image and pixel (b * H + hh) * W + ww, or -1 past the tensor
      int rb[MB][2], pix[MB][2];
#pragma unroll
      for (int i = 0; i < MB; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          int b, hh, ww;
          rb[i][h] = 0;
          pix[i][h] = -1;
          if (pixel(t, i, h, b, hh, ww)) {
            rb[i][h] = b;
            pix[i][h] = (b * H + hh) * W + ww;
          }
        }

      // the epilogue: total(i, 4j + 2h + e) is (row 16*warp + g + 8h of block
      // i, column 8j + 2*t4 + e); raw sums to the split's scratch, finished
      // values to out
      float* raw_out = partial != nullptr
          ? partial + (size_t)t.split * B * H * W * Cout : nullptr;
      const float nw = noisy ? *epi.noise_w : 0.f;
      const bool pairs = (Cout & 1) == 0;
      // whole 16-byte rows of 8 channels: the quad of a row (t4 = 0..3)
      // trades its pairs so that each lane holds 8 neighbouring channels,
      // then stores them to the warpgroup's staged tile (TMA stores it) or
      // to out
      const bool rows16 = raw_out == nullptr && Cout % 8 == 0;
      unsigned char* stage = smem + p.stage_off + cw * (64 * MB * BN * 2);
      if (p.tma_store) {
        if (ct % 128 == 0) bulk_wait_read();  // the last unit's store has read it
        warpgroup_sync(cw);
      }
      if (rows16) {
        // by column block: the block's bias (and demod, where the tile is
        // one image) once, then every row, where the accumulator leaves the
        // registers (BN <= 64); every lane takes part in the shuffles
        constexpr bool HOIST = BN <= 64;
        const bool one_b = p.ni == 1;
#pragma unroll
        for (int q = 0; q < BN / 32; ++q) {
          float bias[4][2], dm[4][2];
          auto load_cols = [&](int m) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int n = t.nt * BN + 8 * (4 * q + m) + 2 * t4 + e;
              bias[m][e] = epi.bias != nullptr && n < Cout ? epi.bias[n] : 0.f;
              dm[m][e] = MOD && one_b && epi.demod != nullptr && t.b0 < B && n < Cout
                  ? epi.demod[(size_t)t.b0 * Cout + n] : 1.f;
            }
          };
          if (HOIST) {
#pragma unroll
            for (int m = 0; m < 4; ++m) load_cols(m);
          }
          // several images in a tile: each row's demod is its image's
          const bool row_demod = MOD && !one_b && epi.demod != nullptr;
#pragma unroll
          for (int i = 0; i < MB; ++i) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const bool valid = pix[i][h] >= 0;
              const int b = rb[i][h];
              const float nzv = nw * nz[i][h];
              uint32_t mine[4];  // this lane's pair of column group 4q + m
#pragma unroll
              for (int m = 0; m < 4; ++m) {
                const int j = 4 * q + m;
                if (!HOIST) load_cols(m);
                float v[2] = {total(i, 4 * j + 2 * h), total(i, 4 * j + 2 * h + 1)};
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  // the plain version's order, act(v * demod + nz + bias),
                  // with no branch per value: demod 1 and nz 0 where absent
                  if (MOD) {
                    const int n = t.nt * BN + 8 * j + 2 * t4 + e;
                    const float d = row_demod
                        ? (valid && n < Cout ? epi.demod[(size_t)b * Cout + n] : 1.f)
                        : dm[m][e];
                    v[e] = v[e] * d + nzv;
                  }
                  v[e] += bias[m][e];
                  if (epi.act) v[e] = (v[e] >= 0.f ? v[e] : 0.2f * v[e]) * conv3x3_tc::kSqrt2;
                }
                mine[m] = pack_bf16x2(v[0], v[1]);
              }
              // round k: lane s sends its pair of group 4q + (s + k) % 4, so
              // lane d receives lane (d - k) % 4's pair of group 4q + d
              uint32_t got[4];
#pragma unroll
              for (int k = 0; k < 4; ++k) {
                const int send = (t4 + k) & 3, from = (t4 - k) & 3;
                const uint32_t x = send == 0 ? mine[0] : send == 1 ? mine[1]
                                 : send == 2 ? mine[2] : mine[3];
                const uint32_t y = k == 0 ? x : __shfl_sync(0xffffffffu, x, (lane & ~3) | from);
#pragma unroll
                for (int m = 0; m < 4; ++m) got[m] = from == m ? y : (k == 0 ? 0u : got[m]);
              }
              const uint4 v = make_uint4(got[0], got[1], got[2], got[3]);
              const int c8 = 8 * (4 * q + t4);  // in the Cout tile
              if (p.tma_store) {
                const int row = 64 * i + 16 * warp + g + 8 * h;  // in the warpgroup's half
                *reinterpret_cast<uint4*>(stage + (row * BN + c8) * 2) = v;
              } else if (valid && t.nt * BN + c8 < Cout) {
                *reinterpret_cast<uint4*>(out + (size_t)pix[i][h] * Cout + t.nt * BN + c8) = v;
              }
            }
          }
        }
      }
      if (!rows16) {
#pragma unroll
      for (int i = 0; i < MB; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (pix[i][h] < 0) continue;
          const int b = rb[i][h];
          const size_t o = (size_t)pix[i][h] * Cout;
          const float nzv = nw * nz[i][h];
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
            const int n = t.nt * BN + 8 * j + 2 * t4;
            if (n >= Cout) continue;
            float v0 = total(i, 4 * j + 2 * h), v1 = total(i, 4 * j + 2 * h + 1);
            const bool second = n + 1 < Cout;
            if (raw_out != nullptr) {
              if (pairs) {
                *reinterpret_cast<float2*>(raw_out + o + n) = make_float2(v0, v1);
              } else {
                raw_out[o + n] = v0;
                if (second) raw_out[o + n + 1] = v1;
              }
            } else {
              v0 = conv3x3_tc::finish<MOD>(v0, epi, nzv, b, n, Cout);
              if (second) v1 = conv3x3_tc::finish<MOD>(v1, epi, nzv, b, n + 1, Cout);
              if (pairs) {
                *reinterpret_cast<__nv_bfloat162*>(out + o + n) = __floats2bfloat162_rn(v0, v1);
              } else {
                out[o + n] = __float2bfloat16_rn(v0);
                if (second) out[o + n + 1] = __float2bfloat16_rn(v1);
              }
            }
          }
        }
      }
      }
      if (p.tma_store) {
        // the staged half tile (th / 2 rows of tw pixels) to out; TMA
        // clips what lies past the image
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        warpgroup_sync(cw);
        if (ct % 128 == 0)
          tma_store_4d(&tmap_out, smem_addr(stage), t.nt * BN, t.w0, t.h0 + cw * (p.th / 2),
                       t.b0);
      }
    }
    if (p.tma_store && ct % 128 == 0) bulk_wait();  // the stores are done before exit
  }
}

// Split-K second pass: one thread per output element sums the splits in
// order, then applies the epilogue and rounds once to bf16.
template <class Kind>
__global__ void __launch_bounds__(256)
conv3x3_bf16_reduce(const float* __restrict__ partial, int splits, Epilogue epi,
                    bf16* __restrict__ out, long long n, int HW, int Cout) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= n) return;
  float v = 0.f;
  for (int s = 0; s < splits; ++s) v += partial[s * n + i];
  const long long pix = i / Cout;
  const int b = static_cast<int>(pix / HW);
  constexpr bool MOD = Kind::modulated;
  const float nz = MOD && epi.noise != nullptr
      ? *epi.noise_w * epi.noise[(size_t)b * epi.noise_bstride + pix % HW] : 0.f;
  out[i] = __float2bfloat16_rn(
      conv3x3_tc::finish<MOD>(v, epi, nz, b, static_cast<int>(i % Cout), Cout));
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// How many ways to split the K steps for this shape on a card with `sms`
// SMs: 1 when the unit grid fills the SMs, else as many as keep the grid
// within one wave, each split at least kMinSteps steps.
inline int splits_for(int B, int H, int W, int Cin, int Cout, int sms, bool k1) {
  const Plan p = make_plan(B, H, W, Cin, Cout, 1, k1, false);
  const int base = p.m_tiles * p.n_tiles;
  if (base >= sms) return 1;
  const int splits = std::min(sms / base, p.steps / kMinSteps);
  return splits < 2 ? 1 : cdiv(p.steps, cdiv(p.steps, splits));
}

// bf16 values in the prepared weights of a (Cin, Cout) layer
inline long long prepared_elems(int Cin, int Cout) {
  const int bn = tile_n(Cout, step_sums(Cin)), kc = slice_k(Cin);
  return (long long)cdiv(Cout, bn) * cdiv(Cin, kc) * 9 * bn * kc;
}

// fp32 scratch a call needs: the prepared weights (as floats) unless the
// caller passes its own, then (splits > 1) the split-K partial sums.
inline long long workspace_floats(int B, int H, int W, int Cin, int Cout, int splits,
                                  bool prepared) {
  return (prepared ? 0 : prepared_elems(Cin, Cout) / 2)
      + (splits > 1 ? (long long)splits * B * H * W * Cout : 0);
}

// The weights of a (Cin, Cout) layer into wp (prepared_elems values).
template <class Kind>
int prepare(const float* wt, float scale, bf16* wp, int Cin, int Cout, cudaStream_t s) {
  const int bn = tile_n(Cout, step_sums(Cin)), kc = slice_k(Cin), slices = cdiv(Cin, kc);
  const long long n = prepared_elems(Cin, Cout) / 8;  // threads: 8 values each
  if (n >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = cdiv(n, 256);
  conv3x3_bf16_prep<Kind><<<grid, 256, 0, s>>>(wt, scale, wp, Cin, Cout, bn, kc, slices,
                                               static_cast<int>(n));
  return static_cast<int>(cudaGetLastError());
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no -lcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                                            cudaEnableDefault, &q);
#else
    const cudaError_t rc = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                                   cudaEnableDefault, &q);
#endif
    if (rc != cudaSuccess || q != cudaDriverEntryPointSuccess)
      f = nullptr;
    return reinterpret_cast<EncodeTiled>(f);
  }();
  return fn;
}

// A bf16 tensor map of `rank` dims (innermost first), zeros outside the
// tensor. True on success.
inline bool encode(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims,
                   const cuuint64_t* strides, const cuuint32_t* box, CUtensorMapSwizzle swz) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), dims, strides,
            box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swz, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
  return sms;
}

template <int BN, int KC, bool SUMS, class Kind>
int launch_tiles(const CUtensorMap& tx, const CUtensorMap& tw, const CUtensorMap& to,
                 const float* style,
                 const Epilogue& epi, bf16* out, float* partial, int B, int H, int W, int Cin,
                 int Cout, const Plan& p, cudaStream_t s) {
  auto kernel = conv3x3_bf16_kernel<BN, KC, SUMS, Kind>;
  cudaError_t rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        p.smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int sms = sm_count();
  if (sms == 0) return static_cast<int>(cudaErrorInvalidDevice);
  kernel<<<std::min(p.units, sms), kThreads, p.smem, s>>>(
      tx, tw, to, style, epi, out, p.splits > 1 ? partial : nullptr, B, H, W, Cin, Cout, p);
  return static_cast<int>(cudaGetLastError());
}

// The whole convolution: the weight preparation (unless `wp` holds weights
// prepared earlier from the same wt and scale), the persistent kernel and,
// with splits > 1 (from splits_for), the reduce pass. x has
// x_channels(Cin) channels (zeros past Cin); `work` is fp32 scratch of
// workspace_floats(..., wp != nullptr) floats (null where that is 0), the
// prepared weights first; x, wt, wp and work 16-byte aligned (checked by
// the Python wrappers). Returns the launches' cudaGetLastError(), or
// cudaErrorInvalidValue where no plan fits or no tensor map encodes.
template <class Kind>
int launch(const bf16* x, const float* style, const float* wt, const bf16* wp, float scale,
           const Epilogue& epi, bf16* out, float* work, int B, int H, int W, int Cin, int Cout,
           int splits, cudaStream_t s) {
  if (splits < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = make_plan(B, H, W, Cin, Cout, splits, Kind::modulated,
                           Kind::modulated && style != nullptr);
  if (p.smem == 0) return static_cast<int>(cudaErrorInvalidValue);
  float* partial = work;
  int rc = 0;
  if (wp == nullptr) {
    if (work == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    rc = prepare<Kind>(wt, scale, reinterpret_cast<bf16*>(work), Cin, Cout, s);
    if (rc != 0) return rc;
    wp = reinterpret_cast<const bf16*>(work);
    partial = work + prepared_elems(Cin, Cout) / 2;
  }
  if (splits > 1 && partial == nullptr) return static_cast<int>(cudaErrorInvalidValue);

  const cuuint64_t cx = static_cast<cuuint64_t>(x_channels(Cin));
  const CUtensorMapSwizzle swz = p.kc == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                            : CU_TENSOR_MAP_SWIZZLE_64B;
  CUtensorMap tx, tw, to{};
  const cuuint64_t x_dims[4] = {cx, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t x_strides[3] = {cx * 2, cx * 2 * W, cx * 2 * W * H};
  const cuuint32_t x_box[4] = {(cuuint32_t)p.kc, (cuuint32_t)(p.tw + 2), (cuuint32_t)(p.th + 2),
                               (cuuint32_t)p.ni};
  const cuuint64_t w_dims[2] = {(cuuint64_t)p.kc,
                                (cuuint64_t)(prepared_elems(Cin, Cout) / p.kc)};
  const cuuint64_t w_strides[1] = {(cuuint64_t)p.kc * 2};
  const cuuint32_t w_box[2] = {(cuuint32_t)p.kc, (cuuint32_t)p.bn};
  const cuuint64_t co = static_cast<cuuint64_t>(Cout);
  const cuuint64_t o_dims[4] = {co, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t o_strides[3] = {co * 2, co * 2 * W, co * 2 * W * H};
  const cuuint32_t o_box[4] = {(cuuint32_t)p.bn, (cuuint32_t)p.tw, (cuuint32_t)(p.th / 2), 1};
  if (!encode(&tx, x, 4, x_dims, x_strides, x_box, swz)
      || !encode(&tw, wp, 2, w_dims, w_strides, w_box, swz)
      || (p.tma_store
          && !encode(&to, out, 4, o_dims, o_strides, o_box, CU_TENSOR_MAP_SWIZZLE_NONE)))
    return static_cast<int>(cudaErrorInvalidValue);

  rc = static_cast<int>(cudaErrorInvalidValue);
#define W2E_BF16_CASE(N, K, S)                                                        \
  if (p.bn == N && p.kc == K && p.sums == S)                                          \
    rc = launch_tiles<N, K, S, Kind>(tx, tw, to, style, epi, out, partial, B, H, W, Cin, \
                                     Cout, p, s);
  // step sums come with Cin > 128, so with 64-channel slices
  W2E_BF16_CASE(32, 32, false) W2E_BF16_CASE(64, 32, false) W2E_BF16_CASE(128, 32, false)
  W2E_BF16_CASE(256, 32, false) W2E_BF16_CASE(32, 64, false) W2E_BF16_CASE(64, 64, false)
  W2E_BF16_CASE(128, 64, false) W2E_BF16_CASE(256, 64, false) W2E_BF16_CASE(32, 64, true)
  W2E_BF16_CASE(64, 64, true) W2E_BF16_CASE(128, 64, true)
#undef W2E_BF16_CASE
  if (rc != 0 || splits == 1) return rc;
  const long long n = (long long)B * H * W * Cout;
  conv3x3_bf16_reduce<Kind><<<cdiv(n, 256), 256, 0, s>>>(partial, splits, epi, out, n, H * W,
                                                          Cout);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace conv3x3_bf16
