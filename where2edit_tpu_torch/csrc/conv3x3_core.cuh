// The 3x3 convolution core shared by K1 (modconv3x3.cu) and K2 (conv3x3.cu):
// fp32, NHWC, stride 1, zero padding 1, for Hopper (sm_90a).
//
//   out[b,h,w,o] = act( scale * demod[b,o] * sum_{ky,kx,i} x[b,h+ky-1,w+kx-1,i]
//                                            * style[b,i] * wt[ky,kx,i,o]
//                       + noise_w * noise[b,h,w] + bias[o] )
//
// with act = lrelu(0.2)*sqrt(2) when `act` is set. style, demod, noise and
// bias are optional (null pointers: style and demod read as 1, noise and
// bias as 0). K1 passes the style and demod of a modulated conv and scale 1;
// K2 passes no style, no demod, no noise and the equalised-lr scale.
//
// Bound on the H100: operations. At every octave from 64^2 up a layer is
// ~19.3 GFLOP per image against at most ~270 MB, so fp32 FMA throughput (67
// TFLOP/s without tensor cores) is the limit. Design: one block per (sample,
// spatial tile, Cout tile); the halo'd input tile of a Cin chunk is staged in
// shared memory already multiplied by the style (the single modulation pass
// of the Pallas kernel), the chunk's 9 taps of weights beside it; each thread
// keeps a PX-pixel x 4-channel register tile, reuses each staged input across
// the three horizontal taps and each float4 of weights across its PX pixels,
// and applies scale, demod, noise, bias and the activation before its one
// store. The staged row stride is CK+1 floats so the pixel groups of a warp
// read distinct banks. Tensor cores (TF32/bf16 wgmma) are left to a later
// change.
//
// Channels: rows whose length (Cin for x and style, Cout for the weights,
// demod, bias and the output) is a multiple of 4 move as float4; any other
// length (the discriminator's final conv takes 512 + 1 minibatch-stddev
// channels, and its input gradient has 513) moves one float at a time,
// masked at the row's end. The choice is uniform across the grid.
//
// Where the (tile, Cout tile) grid alone would not fill the SMs (4^2 to
// 32^2, 512 -> 512) the Cin range is split across blocks (split-K): each
// block sums its share of the chunks into an fp32 scratch (splits, B, H, W,
// Cout) that the wrapper allocates, and a second kernel sums the splits in a
// fixed order and applies the epilogue, so the result does not depend on the
// order the blocks ran in.

#pragma once

#include <cuda_runtime.h>

#include <algorithm>

// Each including source names the namespace (its kernel's name), so a
// profiler tells K1's launches from K2's.
#ifndef W2E_CORE_NS
#error "define W2E_CORE_NS before including conv3x3_core.cuh"
#endif

namespace W2E_CORE_NS {

constexpr int kThreads = 256;
constexpr int CK = 8;        // input channels staged per chunk
constexpr int CKP = CK + 1;  // padded per-pixel stride of the staged input
constexpr int PX = 8;        // consecutive output columns per thread
constexpr float kSqrt2 = 1.4142135623730951f;

// p[i + k] for k < 4 where k0 + k < end, else `fill`; one 16-byte load when
// `vec` (p + i is then 16-byte aligned) and the four are in range.
__device__ __forceinline__ float4 load4(const float* p, size_t i, int k0,
                                        int end, bool vec, float fill) {
  if (vec && k0 + 3 < end) return *reinterpret_cast<const float4*>(p + i);
  return make_float4(k0 < end ? p[i] : fill, k0 + 1 < end ? p[i + 1] : fill,
                     k0 + 2 < end ? p[i + 2] : fill,
                     k0 + 3 < end ? p[i + 3] : fill);
}

__device__ __forceinline__ float4 load4_or(const float* p, size_t i, int k0,
                                           int end, bool vec, float v) {
  return p != nullptr ? load4(p, i, k0, end, vec, v) : make_float4(v, v, v, v);
}

// p[i + k] = v[k] for k < 4 where k0 + k < end.
__device__ __forceinline__ void store4(float* p, size_t i, int k0, int end,
                                       bool vec, float4 v) {
  if (vec && k0 + 3 < end) {
    *reinterpret_cast<float4*>(p + i) = v;
    return;
  }
  if (k0 < end) p[i] = v.x;
  if (k0 + 1 < end) p[i + 1] = v.y;
  if (k0 + 2 < end) p[i + 2] = v.z;
  if (k0 + 3 < end) p[i + 3] = v.w;
}

// act(acc * d + noise + bias), act = lrelu(0.2) * sqrt(2) when set
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

// scale * demod[b, co..co+3] (demod optional)
__device__ __forceinline__ float4 out_scale(const float* demod, int b, int co,
                                            int Cout, bool vec, float scale) {
  float4 d = load4_or(demod, (size_t)b * Cout + co, co, Cout, vec, 1.f);
  return make_float4(d.x * scale, d.y * scale, d.z * scale, d.w * scale);
}

template <int CO, int TH, int TW>
__global__ void __launch_bounds__(kThreads)
conv3x3_kernel(const float* __restrict__ x, const float* __restrict__ style,
               const float* __restrict__ wt, const float* __restrict__ demod,
               float scale, const float* __restrict__ noise,
               long long noise_bstride, const float* __restrict__ noise_w,
               const float* __restrict__ bias, float* __restrict__ out,
               float* __restrict__ partial, int H, int W, int Cin, int Cout,
               int tiles_w, int splits, int chunks_per_split, int act) {
  constexpr int CG = CO / 4;   // thread groups along Cout
  constexpr int PG = TW / PX;  // pixel groups along a tile row
  static_assert(CG * PG * TH == kThreads, "tile does not match block size");
  constexpr int XH = TH + 2, XW = TW + 2;
  __shared__ float xs[XH * XW * CKP];               // [row][col][ci]
  __shared__ __align__(16) float ws[9 * CK * CO];   // [tap][ci][co]

  const bool vin = (Cin & 3) == 0;
  const bool vout = (Cout & 3) == 0;
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
  const float* sb = style != nullptr ? style + (size_t)b * Cin : nullptr;

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
        v = load4(xb, ((size_t)hh * W + ww) * Cin + ci, ci, c_end, vin, 0.f);
        if (sb != nullptr) {
          const float4 s = load4(sb, ci, ci, c_end, vin, 0.f);
          v.x *= s.x; v.y *= s.y; v.z *= s.z; v.w *= s.w;
        }
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
        v = load4(wt, ((size_t)tap * Cin + ci) * Cout + co, co, Cout, vout, 0.f);
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
      store4(dst, (((size_t)b * H + hh) * W + ww) * Cout + co, co, Cout, vout,
             make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]));
    }
    return;
  }
  const float4 d = out_scale(demod, b, co, Cout, vout, scale);
  const float4 bi = load4_or(bias, co, co, Cout, vout, 0.f);
  const float nw = noise != nullptr ? *noise_w : 0.f;
#pragma unroll
  for (int j = 0; j < PX; ++j) {
    const int ww = w0 + col + j;
    if (ww >= W) break;
    const float nz = noise != nullptr
        ? nw * noise[(size_t)b * noise_bstride + (size_t)hh * W + ww] : 0.f;
    store4(out, (((size_t)b * H + hh) * W + ww) * Cout + co, co, Cout, vout,
           finish(make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]), d,
                  bi, nz, act));
  }
}

// Split-K second pass: one thread per 4 output channels of one pixel sums the
// splits in order, then applies the same epilogue as the single-pass kernel.
__global__ void __launch_bounds__(kThreads)
conv3x3_reduce_kernel(const float* __restrict__ partial, int splits,
                      const float* __restrict__ demod, float scale,
                      const float* __restrict__ noise, long long noise_bstride,
                      const float* __restrict__ noise_w,
                      const float* __restrict__ bias, float* __restrict__ out,
                      int B, int HW, int Cout, int act) {
  const bool vout = (Cout & 3) == 0;
  const int groups = (Cout + 3) / 4;
  const size_t t = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (size_t)B * HW * groups) return;
  const size_t pix = t / groups;
  const int co = (int)(t % groups) * 4;
  const int b = (int)(pix / HW);
  const size_t hw = pix % HW;
  const size_t n = (size_t)B * HW * Cout;
  const size_t e = pix * Cout + co;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int sp = 0; sp < splits; ++sp) {
    const float4 v = load4(partial + sp * n, e, co, Cout, vout, 0.f);
    a.x += v.x; a.y += v.y; a.z += v.z; a.w += v.w;
  }
  const float nz = noise != nullptr
      ? *noise_w * noise[(size_t)b * noise_bstride + hw] : 0.f;
  store4(out, e, co, Cout, vout,
         finish(a, out_scale(demod, b, co, Cout, vout, scale),
                load4_or(bias, co, co, Cout, vout, 0.f), nz, act));
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

// The two tilings: Cout tiles of 64 over 8x16 pixels, else 32 over 16x16.
bool wide(int Cout) { return Cout % 64 == 0; }

int base_blocks(int B, int H, int W, int Cout) {
  return wide(Cout) ? B * cdiv(H, 8) * cdiv(W, 16) * cdiv(Cout, 64)
                    : B * cdiv(H, 16) * cdiv(W, 16) * cdiv(Cout, 32);
}

// How many ways to split Cin for this shape on a card with `sms` SMs: 1 when
// the (tile, Cout tile) grid alone fills the SMs, else as many splits as keep
// the grid within one wave of two blocks per SM (128 registers x 256 threads
// fit twice in an SM's 64K), each split at least kMinChunks chunks of CK
// channels.
int conv3x3_splits(int B, int H, int W, int Cin, int Cout, int sms) {
  constexpr int kMinChunks = 2;
  const int base = base_blocks(B, H, W, Cout);
  if (base >= sms) return 1;
  const int chunks = cdiv(Cin, CK);
  const int splits = std::min(2 * sms / base, chunks / kMinChunks);
  return splits < 2 ? 1 : cdiv(chunks, cdiv(chunks, splits));
}

template <int CO, int TH, int TW>
void launch_tiles(const float* x, const float* style, const float* wt,
                  const float* demod, float scale, const float* noise,
                  long long noise_bstride, const float* noise_w,
                  const float* bias, float* out, float* partial, int B, int H,
                  int W, int Cin, int Cout, int splits, int act,
                  cudaStream_t stream) {
  const int tiles_w = cdiv(W, TW);
  const dim3 grid(cdiv(H, TH) * tiles_w, cdiv(Cout, CO), B * splits);
  conv3x3_kernel<CO, TH, TW><<<grid, kThreads, 0, stream>>>(
      x, style, wt, demod, scale, noise, noise_bstride, noise_w, bias, out,
      splits > 1 ? partial : nullptr, H, W, Cin, Cout, tiles_w, splits,
      cdiv(cdiv(Cin, CK), splits), act);
}

// The whole convolution: the tiled kernel and, with splits > 1 (from
// conv3x3_splits), the reduce pass over `partial`, fp32 scratch of
// splits*B*H*W*Cout. Pointers 16-byte aligned (checked by the Python
// wrappers). Returns the launches' cudaGetLastError().
int conv3x3_launch(const float* x, const float* style, const float* wt,
                   const float* demod, float scale, const float* noise,
                   long long noise_bstride, const float* noise_w,
                   const float* bias, float* out, float* partial, int B, int H,
                   int W, int Cin, int Cout, int splits, int act,
                   cudaStream_t s) {
  if (splits < 1 || (splits > 1 && partial == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (wide(Cout))
    launch_tiles<64, 8, 16>(x, style, wt, demod, scale, noise, noise_bstride,
                            noise_w, bias, out, partial, B, H, W, Cin, Cout,
                            splits, act, s);
  else
    launch_tiles<32, 16, 16>(x, style, wt, demod, scale, noise, noise_bstride,
                             noise_w, bias, out, partial, B, H, W, Cin, Cout,
                             splits, act, s);
  if (splits > 1) {
    const int rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
    const size_t threads = (size_t)B * H * W * cdiv(Cout, 4);
    conv3x3_reduce_kernel<<<(unsigned)((threads + kThreads - 1) / kThreads),
                            kThreads, 0, s>>>(
        partial, splits, demod, scale, noise, noise_bstride, noise_w, bias,
        out, B, H * W, Cout, act);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace W2E_CORE_NS
