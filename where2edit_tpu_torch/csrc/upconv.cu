// K4: the modulated transposed up-conv of StyleGAN2's upsampling
// StyledConvs, fp32 in and out (3xTF32 on wgmma), NHWC, sm_90a only.
//
// Replaces no TPU kernel: the JAX package leaves the transposed conv to XLA
// (where2edit_tpu/nn/layers.py, _conv_transpose2x). The port ran it as an
// input modulation pass, cuDNN's fp32 dgrad (conv_transpose2d, on NCHW
// views, with its layout transforms) and a demod pass over the permuted
// output. This kernel is all three:
//
//   y[b, 2m+py, 2n+px, o] = demod[b,o] * sum_{taps (ky,kx) of phase (py,px)} sum_i
//                             x[b, m-dy, n-dx, i] * style[b,i] * w[o,i,ky,kx]
//
// for x (B,H,W,Cin), style (B,Cin) (the equalised-lr scale folded in), w
// (Cout,Cin,3,3) and demod (B,Cout) or null, into y (B,2H+1,2W+1,Cout):
// conv_transpose2d(x*style, w^T, stride 2, padding 0), times demod.
//
// Sub-pixel phases. Output parity (py, px) splits the stride-2 transposed
// conv into four stride-1 convs over the input, each with the taps whose
// (ky, kx) have that parity (dy = ky/2 and dx = kx/2 on an even axis, 0 on
// an odd one):
//
//   phase (even, even): taps (0,0) (0,2) (2,0) (2,2), grid (H+1) x (W+1)
//   phase (even, odd):  taps (0,1) (2,1),             grid (H+1) x W
//   phase (odd, even):  taps (1,0) (1,2),             grid H x (W+1)
//   phase (odd, odd):   tap  (1,1),                   grid H x W
//
// 9 taps per input pixel, the transposed conv's own work: no zero-stuffed
// input, no structural zero tap, no blur folded into the weights (a 6x6
// folded kernel, as the TPU path runs it, would be 4x the work on a card
// where the tensor cores, not the memory, are the limit).
//
// Bound on the H100: operations, 2 * 9 * Cin * Cout per input pixel, at the
// 3xTF32 rate of conv3x3_tc.cuh (495/3 TFLOP/s): 45.1 GFLOP a 1024^2
// config-f synthesis, 0.274 ms an image. Against it the kernel reads x and
// writes y once (~24 bytes per 2 * 9 * 512 * 512 FLOP at 8^2, ~1.5 KFLOP a
// byte at 1024^2's 64 -> 32 channels).
//
// Design (the implicit GEMM of conv3x3_tc.cuh, per phase):
// - Each phase is an implicit GEMM: M = the phase's output pixels, N = Cout,
//   K = taps * Cin. A block holds 64 * warpgroups pixels (a TH x TW patch of
//   one image, or several whole images when one is small) and BN = 32, 64
//   or 128 output channels (by Cout); each warpgroup owns 64 pixels and
//   issues wgmma.m64nBNk8, small terms first, as K1 (3xTF32: the fp32
//   operands split into big and small TF32 parts, big*big + big*small +
//   small*big). Three warpgroups at BN = 32, so that more pixels share each
//   weight copy; two elsewhere (the registers of BN = 128).
// - The tile shape is chosen per phase on the host, to waste the fewest
//   rows on the odd grids (17 x 17 runs as 3 tiles of 128, not 6 of 8 x 16).
// - K runs in stages of KS = 64 (BN 128) or 32 (BN 32, 64) K positions:
//   KS / (8 * taps) chunks of 8 input channels, each serving the phase's
//   taps. So every phase issues the same number of MMAs per stage, and the
//   one-tap phase does not pay a barrier per 8 K positions. Each stage sums
//   into a fresh accumulator that is added to the block's in fp32 (the
//   tensor cores truncate their sums; see conv3x3_tc.cuh).
// - A stage is staged into a ring of two (the next stage's loads overlap
//   this one's MMAs): the weights, already split and tiled (B, read by
//   wgmma from shared memory), one bulk copy a chunk issued by one thread
//   and counted on the slot's mbarrier; the halo'd input patch, (TH + 1) x
//   (TW + 1) positions on an even axis (one tap back), TH x TW on an odd
//   one, by cp.async, zero outside the image and past Cin, from a table of
//   each position's source pixel made once a block (a copy then costs no
//   division), its 8-channel groups swizzled by position so that a warp's
//   fragment reads hit distinct banks; and the stage's style rows. A comes
//   from registers: each thread reads its fragment's values of a tap out of
//   the patch, multiplies them by the style before the split (as K1), and
//   splits them itself. The copies' instructions, not their bytes, were the
//   measured cost: the table and the bulk copies took the sum over
//   config-f's eight up-convs from 9.1 to 6.8 ms at batch 8.
// - The weights are prepared as K1's (conv3x3_tc_prep on this tag) from
//   the phase-ordered (9, Cin, Cout) weights that kernels/upconv.py builds
//   in plain torch (phase_weights): [Cout tile][chunk][9 taps, phase by
//   phase][part][BN x 8], so a phase's taps of a chunk are one contiguous
//   run. A caller that keeps a layer's weights prepares them once.
// - One launch covers all four phases: blocks are numbered phase by phase,
//   heaviest first ((even, even) with 4 taps, then the 2-tap phases, then
//   the 1-tap one), the Cout tiles of a pixel tile adjacent (they share its
//   input in L2). The card takes blocks in about that order, so the long
//   blocks start first and the short ones fill the tail. Tiles sized per
//   phase to equal work would give the 1-tap phase 4x the pixels, more
//   than the registers hold; a pixel tile's four phases made adjacent (its
//   input read from memory once) and persistent blocks that walk many tiles
//   were both measured slower.
// - The epilogue multiplies by demod and stores each phase's pixels at their
//   interleaved positions (2m + py, 2n + px); the four phases write every
//   output value once. No split-K: the grid of the smallest call (4^2 at
//   batch 8) is small, but so is its work.

#include "conv3x3_bf16.cuh"  // mbar_init, mbar_expect_tx, mbar_wait
#include "conv3x3_tc.cuh"

// K4's kernel names carry this tag (a profile tells them from K1's and K2's)
struct upconv_k4 {
  static constexpr bool modulated = true;
};

namespace upconv_k4_core {

using conv3x3_tc::CK;
using conv3x3_tc::cdiv;
using conv3x3_tc::kMaxSmem;

constexpr int kPhases = 4;
constexpr int kMaxImages = 16;  // whole images a block holds at most

// taps of phase p = 2 * py + px, and the first of them among a chunk's 9
// prepared taps (phase by phase, in kernels/upconv.py's PHASE_TAPS order)
__host__ __device__ constexpr int phase_taps(int p) { return p == 0 ? 4 : p == 3 ? 1 : 2; }
__host__ __device__ constexpr int first_tap(int p) { return p == 0 ? 0 : p == 1 ? 4 : p == 2 ? 6 : 8; }

// (ky, kx) of tap j of phase p
__host__ __device__ constexpr int tap_ky(int p, int j) {
  return p == 0 ? 2 * (j / 2) : p == 1 ? 2 * j : 1;
}
__host__ __device__ constexpr int tap_kx(int p, int j) {
  return p == 0 ? 2 * (j % 2) : p == 2 ? 2 * j : 1;
}

// K positions per stage: 64 at BN 128, 32 where BN is 32 or 64 (a wider
// stage there costs occupancy and gains nothing, measured on the H100)
__host__ __device__ constexpr int stage_k(int BN) { return BN == 128 ? 64 : 32; }
// warpgroups per block, each 64 pixels of the tile: 3 at BN 32 (more
// pixels share each weight copy; 2 or 4 measured slower), else 2
__host__ __device__ constexpr int warpgroups(int BN) { return BN == 32 ? 3 : 2; }
// blocks an SM holds (the registers the compiler may take): 1 at BN 128
// (~210 registers), 2 below
__host__ __device__ constexpr int min_blocks(int BN) { return BN == 128 ? 1 : 2; }
// stages of the ring (a third, where shared memory allows it, measured slower)
constexpr int S_RING = conv3x3_tc::kStages;
constexpr int kBarBytes = 64;  // the ring's mbarriers, after the ring

// `bytes` from global to shared memory in one bulk copy, its completion
// counted on the mbarrier `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(conv3x3_tc::smem_addr(dst)), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// The pixel tiles of one phase.
struct PhaseTile {
  int hp, wp;            // the phase's output grid per image
  int th, tw, ni;        // rows and columns of the patch; images per block
  int tiles_h, tiles_w;  // patches per image
  int halo_h, halo_w;    // staged patch per image
  int block_begin;       // the phase's first block
};

struct Plan {
  PhaseTile ph[kPhases];
  int n_tiles;  // Cout tiles
  int blocks;   // all phases
  int smem;     // bytes, the largest phase's ring
};

// bytes of a stage of phase P, 128-byte aligned: the weights, the halo'd
// patch [position][CKS] and the style rows [image][CKS]
__host__ __device__ inline int stage_bytes(int BN, int P, const PhaseTile& t) {
  const int KS = stage_k(BN);
  const int CKS = KS / phase_taps(P);  // input channels per stage
  const int halo = t.ni * t.halo_h * t.halo_w;
  return static_cast<int>(((KS * 2 * BN + halo * CKS + t.ni * CKS) * sizeof(float) + 127)
                          / 128 * 128);
}

// The tile of a phase with an hp x wp grid at batch B for a block of `bm`
// pixels: the patch that wastes the fewest rows (fewest tiles), then the
// smallest halo.
inline PhaseTile make_tile(int B, int hp, int wp, int py, int px, int bm) {
  PhaseTile best{};
  long long best_tiles = -1;
  int best_halo = 0;
  for (int tw = 1; tw <= std::min(wp, bm); ++tw) {
    PhaseTile t{};
    t.hp = hp;
    t.wp = wp;
    t.tw = tw;
    t.th = std::min(hp, bm / tw);
    t.ni = (t.th == hp && t.tw == wp) ? std::max(1, std::min(kMaxImages, bm / (hp * wp))) : 1;
    t.tiles_h = cdiv(hp, t.th);
    t.tiles_w = cdiv(wp, t.tw);
    t.halo_h = t.th + (py == 0 ? 1 : 0);
    t.halo_w = t.tw + (px == 0 ? 1 : 0);
    const long long tiles = (long long)cdiv(B, t.ni) * t.tiles_h * t.tiles_w;
    const int halo = t.ni * t.halo_h * t.halo_w;
    if (best_tiles < 0 || tiles < best_tiles || (tiles == best_tiles && halo < best_halo)) {
      best = t;
      best_tiles = tiles;
      best_halo = halo;
    }
  }
  return best;
}

inline int tile_n(int Cout) { return conv3x3_tc::tile_n(Cout); }

// Each phase's tiles and first block, heaviest phase first; the ring's
// shared memory. plan.blocks is -1 for a shape the kernel does not take.
inline Plan make_plan(int B, int H, int W, int Cout) {
  Plan plan{};
  const int BN = tile_n(Cout);
  plan.n_tiles = cdiv(Cout, BN);
  long long blocks = 0;
  plan.smem = 0;
  for (int p = 0; p < kPhases; ++p) {
    const int py = p / 2, px = p % 2;
    PhaseTile t = make_tile(B, H + 1 - py, W + 1 - px, py, px, 64 * warpgroups(BN));
    t.block_begin = static_cast<int>(std::min<long long>(blocks, 0x7fffffffLL));
    blocks += (long long)cdiv(B, t.ni) * t.tiles_h * t.tiles_w * plan.n_tiles;
    // the ring, its mbarriers, then the patch's source table (an int a position)
    plan.smem = std::max(plan.smem, S_RING * stage_bytes(BN, p, t) + kBarBytes
                                        + t.ni * t.halo_h * t.halo_w * static_cast<int>(sizeof(int)));
    plan.ph[p] = t;
  }
  // the grid's limit, and pixel indices in 32 bits
  const bool fits = blocks <= 0x7fffffffLL && (long long)B * H * W <= 0x7fffffffLL;
  plan.blocks = fits ? static_cast<int>(blocks) : -1;
  return plan;
}

// The 8-channel group of chunk g of a stage (G chunks) at a patch position:
// swizzled so that four neighbouring positions, whose fragment values a
// half-warp reads together, lie in four distinct 32-byte bank groups.
template <int G>
__device__ __forceinline__ int swizzle(int pos, int g) {
  if constexpr (G >= 4) return g ^ (pos & 3);
  else if constexpr (G == 2) return g ^ ((pos >> 1) & 1);
  else return g;
}

// One block of phase P: pixel tile mt, Cout tile nt, the whole K range.
template <int BN, bool VEC, int P>
__device__ __forceinline__ void phase_block(
    unsigned char* smem, const float* __restrict__ x, const float* __restrict__ style,
    const float* __restrict__ wp, const float* __restrict__ demod, float* __restrict__ out,
    int B, int H, int W, int Cin, int Cout, const PhaseTile tile, int mt, int nt) {
  constexpr int PY = P / 2, PX = P % 2;
  constexpr int T = phase_taps(P);
  constexpr int KS = stage_k(BN);
  constexpr int G = KS / (CK * T);  // chunks of 8 channels per stage
  constexpr int CKS = G * CK;       // input channels per stage
  constexpr int TILE_B = 2 * BN * CK;      // one tap's B tile, both parts (floats)
  constexpr int WE = G * T * TILE_B;       // a stage's weights (floats)
  constexpr int CHUNK_B = 9 * TILE_B;      // a chunk's prepared weights (floats)
  constexpr int W16 = 4;
  constexpr int PER = VEC ? W16 : 1;       // values per copy of x and the style
  constexpr int NT = 128 * warpgroups(BN);  // threads
  constexpr int S = S_RING;

  const int halo_w = tile.halo_w;
  const int halo_img = tile.halo_h * halo_w;
  const int halo = tile.ni * halo_img;
  const int sb = stage_bytes(BN, P, tile);
  const int style_at = (WE + halo * CKS) * static_cast<int>(sizeof(float));

  const int w0 = (mt % tile.tiles_w) * tile.tw;
  const int h0 = ((mt / tile.tiles_w) % tile.tiles_h) * tile.th;
  const int b0 = (mt / (tile.tiles_w * tile.tiles_h)) * tile.ni;
  // the patch's first input row and column: one tap back on an even axis
  const int iy0 = h0 - (PY == 0 ? 1 : 0);
  const int ix0 = w0 - (PX == 0 ? 1 : 0);
  const int chunks = (Cin + CK - 1) / CK;
  const int stages = (chunks + G - 1) / G;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int t = lane % 4;
  const int row0 = (tid / 128) * 64 + ((tid / 32) % 4) * 16 + lane / 4;  // M row of a0
  const int tile_px = tile.th * tile.tw;

  // patch position of the fragment's two rows (row0, row0 + 8) at offset
  // (0, 0), and their images' style rows
  int hpos[2], spos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = row0 + 8 * h;
    if (p < tile.ni * tile_px) {
      const int img = p / tile_px;
      const int rem = p % tile_px;
      hpos[h] = img * halo_img + (rem / tile.tw) * halo_w + rem % tile.tw;
      spos[h] = img * CKS + 2 * t;
    } else {
      // a padding row: reads valid positions, never stored
      hpos[h] = 0;
      spos[h] = 2 * t;
    }
  }

  const float* wtile = wp + (size_t)nt * chunks * CHUNK_B + first_tap(P) * TILE_B;

  // each patch position's input pixel (b*H + row)*W + column, or -1 outside
  // the image or past B: computed once, so a stage's copies do no division
  const uint32_t bars = conv3x3_tc::smem_addr(smem + S * sb);  // one a slot, 8 bytes each
  int* src_pix = reinterpret_cast<int*>(smem + S * sb + kBarBytes);
  if (tid == 0) {
    for (int k = 0; k < S; ++k) conv3x3_bf16::mbar_init(bars + 8 * k, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int pos = tid; pos < halo; pos += NT) {
    const int img = pos / halo_img;
    const int rem = pos % halo_img;
    const int b = b0 + img;
    const int hh = iy0 + rem / halo_w;
    const int ww = ix0 + rem % halo_w;
    src_pix[pos] = b < B && hh >= 0 && hh < H && ww >= 0 && ww < W ? (b * H + hh) * W + ww : -1;
  }
  __syncthreads();
  // a thread's copies of the patch all take one group of PER channels
  constexpr int COPIES = CKS / PER;  // copies a position
  static_assert(NT % COPIES == 0, "a thread keeps its channels");
  const int k_own = (tid % COPIES) * PER;
  const int k_dst = (k_own / CK) * CK;  // its 8-channel group, before the swizzle
  const int pos_own = tid / COPIES;

  auto load_stage = [&](int s, unsigned char* st) {
    float* ws = reinterpret_cast<float*>(st);
    // G chunks' T taps, each chunk's one contiguous run; zeros past the
    // last chunk
    // one thread copies the stage's chunks, each one run; the block zeroes
    // the runs past the last chunk
    const int valid = min(G, chunks - s * G);
    if (tid == 0) {
      const uint32_t bar = bars + 8 * (s % S);
      conv3x3_bf16::mbar_expect_tx(bar, valid * T * TILE_B * static_cast<int>(sizeof(float)));
      for (int g = 0; g < valid; ++g)
        bulk_load(ws + g * T * TILE_B, wtile + (size_t)(s * G + g) * CHUNK_B,
                  T * TILE_B * static_cast<int>(sizeof(float)), bar);
    }
    for (int i = valid * T * TILE_B + tid; i < WE; i += NT) ws[i] = 0.f;
    float* as = ws + WE;
    const int c0 = s * CKS;
    const int ci = c0 + k_own;
    const float* xc = x + ci;
    for (int pos = pos_own; pos < halo; pos += NT / COPIES) {
      const int pix = src_pix[pos];
      const bool ok = pix >= 0 && ci < Cin;
      const float* src = ok ? xc + (size_t)pix * Cin : x;
      float* dst = as + pos * CKS + swizzle<G>(pos, k_dst / CK) * CK + (k_own - k_dst);
      if constexpr (VEC) conv3x3_tc::cp_async16(dst, src, ok);
      else conv3x3_tc::cp_async4(dst, src, ok);
    }
    // the style rows of the block's images: zero past B and Cin, where x is
    // zero too (a read past the array's end could be NaN, 0*NaN)
    float* ss = reinterpret_cast<float*>(st + style_at);
    for (int i = tid; i < tile.ni * (CKS / PER); i += NT) {
      const int k = (i % (CKS / PER)) * PER;
      const int img = i / (CKS / PER);
      const int b = b0 + img;
      const int ci = c0 + k;
      const bool ok = b < B && ci < Cin;
      const float* src = ok ? style + (size_t)b * Cin + ci : style;
      if constexpr (VEC) conv3x3_tc::cp_async16(ss + img * CKS + k, src, ok);
      else conv3x3_tc::cp_async4(ss + img * CKS + k, src, ok);
    }
  };

  // as K1: each stage sums into a fresh accumulator `part`, added to `acc`
  // in fp32
  float acc[BN / 2], part[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = part[i] = 0.f;

#pragma unroll
  for (int k = 0; k < S - 1; ++k) {
    if (k < stages) load_stage(k, smem + k * sb);
    conv3x3_tc::cp_async_commit();
  }
  for (int s = 0; s < stages; ++s) {
    const unsigned char* st = smem + (s % S) * sb;
    conv3x3_tc::cp_async_wait<S - 2>();  // stage s's copies are in
    conv3x3_bf16::mbar_wait(bars + 8 * (s % S), (s / S) & 1);  // and its weights
    conv3x3_tc::fence_proxy_async();
    __syncthreads();  // ... for every thread; all MMAs of stage s - 1 are done
    if (s + S - 1 < stages) load_stage(s + S - 1, smem + ((s + S - 1) % S) * sb);
    conv3x3_tc::cp_async_commit();
    const float* wst = reinterpret_cast<const float*>(st);
    const float* as = wst + WE;
    const float* ss = reinterpret_cast<const float*>(st + style_at);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      // the two rows' style for channels 2t (.x) and 2t + 1 (.y) of chunk g
      const float2 s0 = *reinterpret_cast<const float2*>(ss + spos[0] + g * CK);
      const float2 s1 = *reinterpret_cast<const float2*>(ss + spos[1] + g * CK);
#pragma unroll
      for (int j = 0; j < T; ++j) {
        // the tap's patch offset: one row (column) back for ky (kx) = 0 on
        // an even axis, none for 2 or on an odd axis
        const int oy = PY == 0 ? 1 - tap_ky(P, j) / 2 : 0;
        const int ox = PX == 0 ? 1 - tap_kx(P, j) / 2 : 0;
        const int p0 = hpos[0] + oy * halo_w + ox;
        const int p1 = hpos[1] + oy * halo_w + ox;
        float2 v0 = *reinterpret_cast<const float2*>(as + p0 * CKS + swizzle<G>(p0, g) * CK + 2 * t);
        float2 v1 = *reinterpret_cast<const float2*>(as + p1 * CKS + swizzle<G>(p1, g) * CK + 2 * t);
        v0.x *= s0.x; v0.y *= s0.y;  // modulate before the split
        v1.x *= s1.x; v1.y *= s1.y;
        // fragment a0..a3 = (row0, t), (row0 + 8, t), (row0, t + 4), (row0 + 8, t + 4)
        uint32_t big[4], small[4];
        conv3x3_tc::split_tf32(v0.x, big[0], small[0]);
        conv3x3_tc::split_tf32(v1.x, big[1], small[1]);
        conv3x3_tc::split_tf32(v0.y, big[2], small[2]);
        conv3x3_tc::split_tf32(v1.y, big[3], small[3]);
        const float* wb = wst + (g * T + j) * TILE_B;
        const uint64_t d_big = conv3x3_tc::tile_desc(wb);
        const uint64_t d_small = conv3x3_tc::tile_desc(wb + BN * CK);
        conv3x3_tc::wgmma_fence();
        conv3x3_tc::mma<BN>(part, small, d_big, (g | j) != 0);
        conv3x3_tc::mma<BN>(part, big, d_small, 1);
        conv3x3_tc::mma<BN>(part, big, d_big, 1);
        conv3x3_tc::wgmma_commit();
        conv3x3_tc::wgmma_wait<1>();  // the previous step's fragments are free again
      }
    }
    conv3x3_tc::wgmma_wait<0>();
    conv3x3_tc::fence_operand(part);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
  }

  // acc[4j + 2h + e] is (row0 + 8h, column 8j + 2t + e): times demod, to
  // the phase's interleaved position
  const bool pairs = (Cout & 1) == 0;
  const int OH = 2 * H + 1, OW = 2 * W + 1;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = row0 + 8 * h;
    if (p >= tile.ni * tile_px) continue;
    const int img = p / tile_px;
    const int rem = p % tile_px;
    const int b = b0 + img;
    const int m = h0 + rem / tile.tw;
    const int n = w0 + rem % tile.tw;
    if (b >= B || m >= tile.hp || n >= tile.wp) continue;
    const size_t o = (((size_t)b * OH + 2 * m + PY) * OW + 2 * n + PX) * Cout;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = nt * BN + 8 * j + 2 * t;
      if (c >= Cout) continue;
      float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (demod != nullptr) {
        v0 *= demod[(size_t)b * Cout + c];
        if (c + 1 < Cout) v1 *= demod[(size_t)b * Cout + c + 1];
      }
      conv3x3_tc::store2(out, o + c, v0, v1, pairs, c + 1 < Cout);
    }
  }
}

// The whole call: block blockIdx.x of the phase whose range holds it, the
// Cout tiles of a pixel tile adjacent.
template <int BN, bool VEC>
__global__ void __launch_bounds__(128 * warpgroups(BN), min_blocks(BN))
upconv_k4_kernel(const float* __restrict__ x, const float* __restrict__ style,
                 const float* __restrict__ wp, const float* __restrict__ demod,
                 float* __restrict__ out, int B, int H, int W, int Cin, int Cout,
                 const Plan plan) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int blk = blockIdx.x;
  const int p = (blk >= plan.ph[1].block_begin) + (blk >= plan.ph[2].block_begin)
                + (blk >= plan.ph[3].block_begin);
  const int local = blk - plan.ph[p].block_begin;
  const int nt = local % plan.n_tiles;
  const int mt = local / plan.n_tiles;
  if (p == 0)
    phase_block<BN, VEC, 0>(smem, x, style, wp, demod, out, B, H, W, Cin, Cout, plan.ph[0], mt, nt);
  else if (p == 1)
    phase_block<BN, VEC, 1>(smem, x, style, wp, demod, out, B, H, W, Cin, Cout, plan.ph[1], mt, nt);
  else if (p == 2)
    phase_block<BN, VEC, 2>(smem, x, style, wp, demod, out, B, H, W, Cin, Cout, plan.ph[2], mt, nt);
  else
    phase_block<BN, VEC, 3>(smem, x, style, wp, demod, out, B, H, W, Cin, Cout, plan.ph[3], mt, nt);
}

template <int BN, bool VEC>
int launch(const float* x, const float* style, const float* wp, const float* demod,
           float* out, int B, int H, int W, int Cin, int Cout, cudaStream_t s) {
  const Plan plan = make_plan(B, H, W, Cout);
  if (plan.blocks <= 0 || plan.smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = upconv_k4_kernel<BN, VEC>;
  cudaError_t rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        plan.smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  kernel<<<plan.blocks, 128 * warpgroups(BN), plan.smem, s>>>(x, style, wp, demod, out, B, H,
                                                               W, Cin, Cout, plan);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace upconv_k4_core

// floats of a (Cin, Cout) layer's prepared weights: K1's layout, 9 taps
extern "C" long long w2e_upconv_prepared_floats(int Cin, int Cout) {
  return conv3x3_tc::prepared_floats(Cin, Cout);
}

// The phase-ordered weights wph (9, Cin, Cout) (kernels/upconv.py,
// phase_weights) split and tiled into wp, of w2e_upconv_prepared_floats
// floats; both 16-byte aligned. Returns cudaGetLastError().
extern "C" int w2e_upconv_prep(const float* wph, float* wp, int Cin, int Cout, void* stream) {
  return conv3x3_tc::prepare<upconv_k4>(wph, 1.f, wp, Cin, Cout,
                                        static_cast<cudaStream_t>(stream));
}

// The plan of a call with this shape, for the tests and chip_smoke.py:
// fields[0..3] the blocks of each phase, fields[4] the threads a block,
// fields[5] the dynamic shared memory.
extern "C" void w2e_upconv_plan(int B, int H, int W, int Cout, int* fields) {
  using namespace upconv_k4_core;
  const Plan plan = make_plan(B, H, W, Cout);
  for (int p = 0; p < kPhases; ++p) {
    const int end = p + 1 < kPhases ? plan.ph[p + 1].block_begin : plan.blocks;
    fields[p] = end - plan.ph[p].block_begin;
  }
  fields[kPhases] = 128 * warpgroups(tile_n(Cout));
  fields[kPhases + 1] = plan.smem;
}

// x (B,H,W,Cin), style (B,Cin), wp from w2e_upconv_prep, demod (B,Cout) or
// null, out (B,2H+1,2W+1,Cout); all 16-byte aligned and contiguous (checked
// by the Python wrapper). Returns the launch's cudaGetLastError().
extern "C" int w2e_upconv(const float* x, const float* style, const float* wp,
                          const float* demod, float* out, int B, int H, int W, int Cin,
                          int Cout, void* stream) {
  using namespace upconv_k4_core;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bn = tile_n(Cout);
  const bool vec = Cin % 4 == 0;
#define W2E_K4_CASE(N)                                                                 \
  if (bn == N)                                                                         \
    return vec ? launch<N, true>(x, style, wp, demod, out, B, H, W, Cin, Cout, s)      \
               : launch<N, false>(x, style, wp, demod, out, B, H, W, Cin, Cout, s);
  W2E_K4_CASE(32) W2E_K4_CASE(64) W2E_K4_CASE(128)
#undef W2E_K4_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
