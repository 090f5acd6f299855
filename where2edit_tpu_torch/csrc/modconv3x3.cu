// K1: modulated 3x3 convolution with demodulation and a fused epilogue,
// fp32, NHWC, for Hopper (sm_90a).
//
// Replaces the TPU kernel tools/conv3x3_bench.py::conv3x3_mod_fused (body
// _kernel_mod): the function of every non-upsampling StyledConv of the
// StyleGAN2 generator (where2edit_tpu/nn/layers.py ModulatedConv2d plain
// branch + NoiseInjection + FusedLeakyReLU):
//
//   out[b,h,w,o] = act( demod[b,o] * sum_{ky,kx,i} x[b,h+ky-1,w+kx-1,i]
//                                  * style[b,i] * wt[ky,kx,i,o]
//                       + noise_w * noise[b,h,w] + bias[o] )
//
// with act = lrelu(0.2)*sqrt(2) when `act` is set; demod, noise and bias
// are optional (null pointers).
//
// Bound on the H100: operations. At every octave from 64^2 up the layer is
// ~19.3 GFLOP against at most ~270 MB, so fp32 FMA throughput (67 TFLOP/s
// without tensor cores) is the limit. Design: one block per (sample, spatial
// tile, Cout tile); the halo'd input tile of a Cin chunk is staged in shared
// memory already multiplied by the style (the single modulation pass of the
// Pallas kernel), the chunk's 9 taps of weights beside it; each thread keeps
// a PX-pixel x 4-channel register tile, reuses each staged input across the
// three horizontal taps and each float4 of weights across its PX pixels, and
// applies demod, noise, bias and the activation before its one store. The
// staged row stride is CK+1 floats so the pixel groups of a warp read distinct
// banks. Tensor cores (TF32/bf16 wgmma) are left to a later change.
//
// Below 64^2 (4^2 to 32^2, 512 -> 512) the (tile, Cout tile) grid has 8 to 64
// blocks for 132 SMs, and each block would walk all 64 Cin chunks one after
// another. There the Cin range is split across blocks (split-K): each block
// sums its share of the chunks into an fp32 scratch (splits, B, H, W, Cout)
// that the wrapper allocates, and a second kernel sums the splits in a fixed
// order and applies the epilogue, so the result does not depend on the order
// the blocks ran in.

#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int CK = 8;        // input channels staged per chunk
constexpr int CKP = CK + 1;  // padded per-pixel stride of the staged input
constexpr int PX = 8;        // consecutive output columns per thread
constexpr float kSqrt2 = 1.4142135623730951f;

__device__ __forceinline__ float4 load4_or(const float* p, size_t i, float v) {
  return p != nullptr ? *reinterpret_cast<const float4*>(p + i)
                      : make_float4(v, v, v, v);
}

// act(acc * demod + noise + bias), act = lrelu(0.2) * sqrt(2) when set
__device__ __forceinline__ float4 finish(float4 a, float4 d, float4 bi,
                                         float nz, int act) {
  float o[4] = {a.x * d.x + nz + bi.x, a.y * d.y + nz + bi.y,
                a.z * d.z + nz + bi.z, a.w * d.w + nz + bi.w};
  if (act) {
#pragma unroll
    for (int k = 0; k < 4; ++k) o[k] = (o[k] >= 0.f ? o[k] : 0.2f * o[k]) * kSqrt2;
  }
  return make_float4(o[0], o[1], o[2], o[3]);
}

template <int CO, int TH, int TW>
__global__ void __launch_bounds__(kThreads)
modconv3x3_kernel(const float* __restrict__ x, const float* __restrict__ style,
                  const float* __restrict__ wt, const float* __restrict__ demod,
                  const float* __restrict__ noise, long long noise_bstride,
                  const float* __restrict__ noise_w,
                  const float* __restrict__ bias, float* __restrict__ out,
                  float* __restrict__ partial, int H, int W, int Cin, int Cout,
                  int tiles_w, int splits, int chunks_per_split, int act) {
  constexpr int CG = CO / 4;   // thread groups along Cout
  constexpr int PG = TW / PX;  // pixel groups along a tile row
  static_assert(CG * PG * TH == kThreads, "tile does not match block size");
  constexpr int XH = TH + 2, XW = TW + 2;
  __shared__ float xs[XH * XW * CKP];               // [row][col][ci]
  __shared__ __align__(16) float ws[9 * CK * CO];   // [tap][ci][co]

  const int b = blockIdx.z / splits;
  const int split = blockIdx.z % splits;
  const int c_begin = split * chunks_per_split * CK;
  const int c_end = min(Cin, c_begin + chunks_per_split * CK);
  const int h0 = (blockIdx.x / tiles_w) * TH;
  const int w0 = (blockIdx.x % tiles_w) * TW;
  const int co0 = blockIdx.y * CO;
  const int tid = threadIdx.x;
  const int cg = tid % CG;
  const int pg = tid / CG;
  const int row = pg / PG;
  const int col = (pg % PG) * PX;

  const float* xb = x + (size_t)b * H * W * Cin;
  const float* sb = style + (size_t)b * Cin;

  float acc[PX][4];
#pragma unroll
  for (int j = 0; j < PX; ++j)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[j][k] = 0.f;

  for (int c0 = c_begin; c0 < c_end; c0 += CK) {
    // stage the halo'd input tile, modulated on load; zero outside the image
    for (int i = tid; i < XH * XW * (CK / 4); i += kThreads) {
      const int q = i % (CK / 4);
      const int p = i / (CK / 4);
      const int hh = h0 + p / XW - 1;
      const int ww = w0 + p % XW - 1;
      const int ci = c0 + q * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (hh >= 0 && hh < H && ww >= 0 && ww < W && ci < c_end) {
        v = *reinterpret_cast<const float4*>(xb + ((size_t)hh * W + ww) * Cin + ci);
        const float4 s = *reinterpret_cast<const float4*>(sb + ci);
        v.x *= s.x; v.y *= s.y; v.z *= s.z; v.w *= s.w;
      }
      float* dst = xs + p * CKP + q * 4;
      dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
    }
    // stage this chunk's weights for the block's Cout tile
    for (int i = tid; i < 9 * CK * (CO / 4); i += kThreads) {
      const int q = i % (CO / 4);
      const int r = i / (CO / 4);  // tap * CK + ci
      const int ci = c0 + r % CK;
      const int tap = r / CK;
      const int co = co0 + q * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (ci < c_end && co < Cout)
        v = *reinterpret_cast<const float4*>(wt + ((size_t)tap * Cin + ci) * Cout + co);
      *reinterpret_cast<float4*>(ws + r * CO + q * 4) = v;
    }
    __syncthreads();
#pragma unroll
    for (int ci = 0; ci < CK; ++ci) {
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        const float* xrow = xs + ((row + ky) * XW + col) * CKP + ci;
        float xv[PX + 2];
#pragma unroll
        for (int j = 0; j < PX + 2; ++j) xv[j] = xrow[j * CKP];
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const float4 wv = *reinterpret_cast<const float4*>(
              ws + ((ky * 3 + kx) * CK + ci) * CO + cg * 4);
#pragma unroll
          for (int j = 0; j < PX; ++j) {
            const float xi = xv[j + kx];
            acc[j][0] = fmaf(xi, wv.x, acc[j][0]);
            acc[j][1] = fmaf(xi, wv.y, acc[j][1]);
            acc[j][2] = fmaf(xi, wv.z, acc[j][2]);
            acc[j][3] = fmaf(xi, wv.w, acc[j][3]);
          }
        }
      }
    }
    __syncthreads();
  }

  const int hh = h0 + row;
  const int co = co0 + cg * 4;
  if (hh >= H || co >= Cout) return;
  if (partial != nullptr) {  // split-K: raw sums, the reduce kernel finishes
    float* dst = partial + (size_t)split * (gridDim.z / splits) * H * W * Cout;
#pragma unroll
    for (int j = 0; j < PX; ++j) {
      const int ww = w0 + col + j;
      if (ww >= W) break;
      *reinterpret_cast<float4*>(dst + (((size_t)b * H + hh) * W + ww) * Cout + co) =
          make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
    }
    return;
  }
  const float4 d = load4_or(demod, (size_t)b * Cout + co, 1.f);
  const float4 bi = load4_or(bias, co, 0.f);
  const float nw = noise != nullptr ? *noise_w : 0.f;
#pragma unroll
  for (int j = 0; j < PX; ++j) {
    const int ww = w0 + col + j;
    if (ww >= W) break;
    const float nz = noise != nullptr
        ? nw * noise[(size_t)b * noise_bstride + (size_t)hh * W + ww] : 0.f;
    *reinterpret_cast<float4*>(out + (((size_t)b * H + hh) * W + ww) * Cout + co) =
        finish(make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]), d, bi, nz, act);
  }
}

// Split-K second pass: one thread per 4 output channels of one pixel sums the
// splits in order, then applies the same epilogue as the single-pass kernel.
__global__ void __launch_bounds__(kThreads)
modconv3x3_reduce_kernel(const float* __restrict__ partial, int splits,
                         const float* __restrict__ demod,
                         const float* __restrict__ noise, long long noise_bstride,
                         const float* __restrict__ noise_w,
                         const float* __restrict__ bias, float* __restrict__ out,
                         int B, int HW, int Cout, int act) {
  const size_t n = (size_t)B * HW * Cout;
  const size_t e = ((size_t)blockIdx.x * kThreads + threadIdx.x) * 4;
  if (e >= n) return;
  const int co = (int)(e % Cout);
  const size_t pix = e / Cout;
  const int b = (int)(pix / HW);
  const size_t hw = pix % HW;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int sp = 0; sp < splits; ++sp) {
    const float4 v = *reinterpret_cast<const float4*>(partial + sp * n + e);
    a.x += v.x; a.y += v.y; a.z += v.z; a.w += v.w;
  }
  const float nz = noise != nullptr
      ? *noise_w * noise[(size_t)b * noise_bstride + hw] : 0.f;
  *reinterpret_cast<float4*>(out + e) =
      finish(a, load4_or(demod, (size_t)b * Cout + co, 1.f),
             load4_or(bias, co, 0.f), nz, act);
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

// The two tilings: Cout tiles of 64 over 8x16 pixels, else 32 over 16x16.
bool wide(int Cout) { return Cout % 64 == 0; }

int base_blocks(int B, int H, int W, int Cout) {
  return wide(Cout) ? B * cdiv(H, 8) * cdiv(W, 16) * cdiv(Cout, 64)
                    : B * cdiv(H, 16) * cdiv(W, 16) * cdiv(Cout, 32);
}

template <int CO, int TH, int TW>
void launch(const float* x, const float* style, const float* wt,
            const float* demod, const float* noise, long long noise_bstride,
            const float* noise_w, const float* bias, float* out,
            float* partial, int B, int H, int W, int Cin, int Cout, int splits,
            int act, cudaStream_t stream) {
  const int tiles_w = cdiv(W, TW);
  const dim3 grid(cdiv(H, TH) * tiles_w, cdiv(Cout, CO), B * splits);
  modconv3x3_kernel<CO, TH, TW><<<grid, kThreads, 0, stream>>>(
      x, style, wt, demod, noise, noise_bstride, noise_w, bias, out,
      splits > 1 ? partial : nullptr, H, W, Cin, Cout, tiles_w, splits,
      cdiv(cdiv(Cin, CK), splits), act);
}

}  // namespace

// How many ways K1 splits Cin for this shape on a card with `sms` SMs: 1 when
// the (tile, Cout tile) grid alone fills the SMs, else as many splits as keep
// the grid within one wave of two blocks per SM (128 registers x 256 threads
// fit twice in an SM's 64K), each split at least kMinChunks chunks of CK
// channels.
extern "C" int w2e_modconv3x3_splits(int B, int H, int W, int Cin, int Cout,
                                     int sms) {
  constexpr int kMinChunks = 2;
  const int base = base_blocks(B, H, W, Cout);
  if (base >= sms) return 1;
  const int chunks = cdiv(Cin, CK);
  const int splits = std::min(2 * sms / base, chunks / kMinChunks);
  return splits < 2 ? 1 : cdiv(chunks, cdiv(chunks, splits));
}

// x (B,H,W,Cin), style (B,Cin), wt (3,3,Cin,Cout), demod (B,Cout) or null,
// noise (B or 1,H,W) or null with batch stride noise_bstride, noise_w (1,),
// bias (Cout,) or null, out (B,H,W,Cout); with splits > 1 (from
// w2e_modconv3x3_splits), partial is fp32 scratch of splits*B*H*W*Cout. Cin
// and Cout multiples of 4, all pointers 16-byte aligned (checked by the
// Python wrapper). Returns the launches' cudaGetLastError().
extern "C" int w2e_modconv3x3(const float* x, const float* style,
                              const float* wt, const float* demod,
                              const float* noise, long long noise_bstride,
                              const float* noise_w, const float* bias,
                              float* out, float* partial, int B, int H, int W,
                              int Cin, int Cout, int splits, int act,
                              void* stream) {
  if (splits < 1 || (splits > 1 && partial == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wide(Cout))
    launch<64, 8, 16>(x, style, wt, demod, noise, noise_bstride, noise_w, bias,
                      out, partial, B, H, W, Cin, Cout, splits, act, s);
  else
    launch<32, 16, 16>(x, style, wt, demod, noise, noise_bstride, noise_w,
                       bias, out, partial, B, H, W, Cin, Cout, splits, act, s);
  if (splits > 1) {
    const int rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
    const size_t n4 = (size_t)B * H * W * Cout / 4;
    modconv3x3_reduce_kernel<<<(unsigned)((n4 + kThreads - 1) / kThreads),
                               kThreads, 0, s>>>(
        partial, splits, demod, noise, noise_bstride, noise_w, bias, out, B,
        H * W, Cout, act);
  }
  return static_cast<int>(cudaGetLastError());
}
