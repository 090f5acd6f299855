// K3: modulated 1x1 convolution with an optional fused epilogue, fp32, for
// Hopper (sm_90a).
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
// Bound on the H100: bytes. Cout is at most 32 on the path (3 for ToRGB, 32 or
// 1 in the mapper), so a pixel's Cin inputs are read once for at most 32
// multiply-adds each, far below the card's ~20 FLOP/byte balance point in
// fp32. Design: one block per (sample, pixel tile); each Cin chunk of
// style[b,i]*w[i,o] is folded into shared memory once per block and the
// chunk of the pixel tile is staged with coalesced loads (row stride CK+1
// so each thread reads its own pixel without bank conflicts); each thread
// owns one pixel and CO_T output channels in registers and applies the whole
// epilogue before its single store.

#include <cuda_runtime.h>

namespace {

constexpr int CK = 32;  // input channels staged per chunk
constexpr float kSqrt2 = 1.4142135623730951f;

// TPP threads share a pixel, each owning CO_T consecutive output channels.
template <int CO_T, int TPP, int THREADS>
__global__ void __launch_bounds__(THREADS)
modconv1x1_kernel(const float* __restrict__ x, const float* __restrict__ style,
                  const float* __restrict__ w, const float* __restrict__ demod,
                  const float* __restrict__ noise, long long noise_bstride,
                  const float* __restrict__ noise_w,
                  const float* __restrict__ bias,
                  const float* __restrict__ residual, float* __restrict__ out,
                  int P, int Cin, int Cout, int act) {
  constexpr int CO = CO_T * TPP;
  constexpr int TP = THREADS / TPP;  // pixels per block
  __shared__ float xs[TP * (CK + 1)];
  __shared__ float ws[CK * CO];

  const int b = blockIdx.y;
  const int p0 = blockIdx.x * TP;
  const int tid = threadIdx.x;
  const int lp = tid / TPP;           // local pixel
  const int cq = (tid % TPP) * CO_T;  // first output channel of this thread
  const float* xb = x + (size_t)b * P * Cin;
  const float* sb = style + (size_t)b * Cin;

  float acc[CO_T];
#pragma unroll
  for (int k = 0; k < CO_T; ++k) acc[k] = 0.f;

  for (int c0 = 0; c0 < Cin; c0 += CK) {
    for (int i = tid; i < CK * CO; i += THREADS) {
      const int ci = c0 + i / CO;
      const int co = i % CO;
      ws[i] = (ci < Cin && co < Cout) ? sb[ci] * w[(size_t)ci * Cout + co] : 0.f;
    }
    for (int i = tid; i < TP * CK; i += THREADS) {
      const int pl = i / CK;
      const int ci = c0 + i % CK;
      const int pp = p0 + pl;
      xs[pl * (CK + 1) + i % CK] =
          (pp < P && ci < Cin) ? xb[(size_t)pp * Cin + ci] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int ci = 0; ci < CK; ++ci) {
      const float xi = xs[lp * (CK + 1) + ci];
#pragma unroll
      for (int k = 0; k < CO_T; ++k) acc[k] = fmaf(xi, ws[ci * CO + cq + k], acc[k]);
    }
    __syncthreads();
  }

  const int p = p0 + lp;
  if (p >= P) return;
  const float nz = noise != nullptr
      ? *noise_w * noise[(size_t)b * noise_bstride + p] : 0.f;
  const size_t o_base = ((size_t)b * P + p) * Cout;
#pragma unroll
  for (int k = 0; k < CO_T; ++k) {
    const int co = cq + k;
    if (co < Cout) {
      float v = acc[k];
      if (demod != nullptr) v *= demod[(size_t)b * Cout + co];
      v += nz;
      if (bias != nullptr) v += bias[co];
      if (act) v = (v >= 0.f ? v : 0.2f * v) * kSqrt2;
      if (residual != nullptr) v += residual[o_base + co];
      out[o_base + co] = v;
    }
  }
}

template <int CO_T, int TPP, int THREADS>
void launch(const float* x, const float* style, const float* w,
            const float* demod, const float* noise, long long noise_bstride,
            const float* noise_w, const float* bias, const float* residual,
            float* out, int B, int P, int Cin, int Cout, int act,
            cudaStream_t stream) {
  constexpr int TP = THREADS / TPP;
  const dim3 grid((P + TP - 1) / TP, B);
  modconv1x1_kernel<CO_T, TPP, THREADS><<<grid, THREADS, 0, stream>>>(
      x, style, w, demod, noise, noise_bstride, noise_w, bias, residual, out,
      P, Cin, Cout, act);
}

}  // namespace

// x (B,P,Cin), style (B,Cin), w (Cin,Cout), demod (B,Cout) or null, noise
// (B or 1,P) or null with batch stride noise_bstride, noise_w (1,), bias
// (Cout,) or null, residual (B,P,Cout) or null, out (B,P,Cout); Cout <= 32.
// Returns the launch's cudaGetLastError().
extern "C" int w2e_modconv1x1(const float* x, const float* style,
                              const float* w, const float* demod,
                              const float* noise, long long noise_bstride,
                              const float* noise_w, const float* bias,
                              const float* residual, float* out, int B, int P,
                              int Cin, int Cout, int act, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Cout > 32) return static_cast<int>(cudaErrorInvalidValue);
  if (Cout <= 4)
    launch<4, 1, 256>(x, style, w, demod, noise, noise_bstride, noise_w, bias,
                      residual, out, B, P, Cin, Cout, act, s);
  else
    launch<8, 4, 128>(x, style, w, demod, noise, noise_bstride, noise_w, bias,
                      residual, out, B, P, Cin, Cout, act, s);
  return static_cast<int>(cudaGetLastError());
}
