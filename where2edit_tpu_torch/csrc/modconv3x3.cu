// K1: modulated 3x3 convolution with demodulation and a fused epilogue,
// fp32 or bf16, NHWC, for Hopper (sm_90a).
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
// with act = lrelu(0.2)*sqrt(2) when `act` is set; style, demod, noise and
// bias are optional (null pointers). The same entry point with style :=
// demod, demod := style and the flipped, transposed weights is the input
// gradient of the convolution (kernels/modconv3x3.py). Bound on the H100:
// operations, at the tensor cores' 3xTF32 rate. The kernel is the implicit
// GEMM of conv3x3_tc.cuh, shared with K2: the style multiplies each input
// value before its TF32 split, demod and noise ride in the epilogue. The
// weights are prepared (split into two TF32 parts and tiled) by the call
// itself, or once by w2e_modconv3x3_prep for a caller that keeps them.
//
// The bf16 form (w2e_modconv3x3_bf16, w2e_modconv3x3_bf16_prep) is the TPU
// kernel's own arithmetic: bf16 x and out, the style rounded to bf16 and
// multiplied into the staged input with one more rounding, the weights
// rounded to bf16, fp32 sums, and the fp32 epilogue before the single bf16
// store. It runs on the bf16 core, conv3x3_bf16.cuh (shared with K2's bf16
// form: a persistent, warp-specialised TMA + wgmma implicit GEMM; its
// header says what bounds it and what the design does about it).

#include "conv3x3_bf16.cuh"
#include "conv3x3_tc.cuh"

// K1's kernels on the shared cores: names of their own, modulated input
struct modconv3x3_k1 {
  static constexpr bool modulated = true;
};

// How many ways K1 splits its K range for this shape on a card with `sms`
// SMs, in fp32 or (bf16 != 0) bf16.
extern "C" int w2e_modconv3x3_splits(int B, int H, int W, int Cin, int Cout,
                                     int sms, int bf16) {
  return bf16 ? conv3x3_bf16::splits_for(B, H, W, Cin, Cout, sms, true)
              : conv3x3_tc::splits_for(B, H, W, Cin, Cout, sms, true);
}

// fp32 scratch (floats) a call with this shape and split count needs: with
// `prepared` set the caller passes its weights prepared, and the scratch
// holds only the split-K partial sums (0 floats without a split). bf16 !=
// 0: the bf16 form, whose prepared weights (bf16, one part) take a quarter
// of the bytes per weight.
extern "C" long long w2e_modconv3x3_workspace(int B, int H, int W, int Cin,
                                              int Cout, int splits,
                                              int prepared, int bf16) {
  return bf16 ? conv3x3_bf16::workspace_floats(B, H, W, Cin, Cout, splits, prepared != 0)
              : conv3x3_tc::workspace_floats(B, H, W, Cin, Cout, splits, prepared != 0);
}

// The weights wt (3,3,Cin,Cout) prepared into wp, of
// w2e_modconv3x3_workspace(1, 1, 1, Cin, Cout, 1, 0, 0) floats (the scratch of
// an unsplit call that prepares its own). Both 16-byte aligned. Returns
// cudaGetLastError().
extern "C" int w2e_modconv3x3_prep(const float* wt, float* wp, int Cin, int Cout,
                                   void* stream) {
  return conv3x3_tc::prepare<modconv3x3_k1>(wt, 1.f, wp, Cin, Cout,
                                            static_cast<cudaStream_t>(stream));
}

// The bf16 form: wt (3,3,Cin,Cout) fp32 rounded to bf16 and tiled into wp,
// of w2e_modconv3x3_workspace(1, 1, 1, Cin, Cout, 1, 0, 1) floats.
extern "C" int w2e_modconv3x3_bf16_prep(const float* wt, conv3x3_bf16::bf16* wp,
                                        int Cin, int Cout, void* stream) {
  return conv3x3_bf16::prepare<modconv3x3_k1>(wt, 1.f, wp, Cin, Cout,
                                              static_cast<cudaStream_t>(stream));
}

// x (B,H,W,Cin), style (B,Cin) or null, wt (3,3,Cin,Cout), wp: wt prepared
// by w2e_modconv3x3_prep, or null to prepare it in `work`; demod (B,Cout) or
// null, noise (B or 1,H,W) or null with batch stride noise_bstride, noise_w
// (1,), bias (Cout,) or null, out (B,H,W,Cout); work:
// w2e_modconv3x3_workspace(..., wp != null) floats of scratch (null for
// 0), splits from w2e_modconv3x3_splits. All pointers 16-byte aligned
// (checked by the Python wrapper). Returns the launches'
// cudaGetLastError().
extern "C" int w2e_modconv3x3(const float* x, const float* style,
                              const float* wt, const float* wp,
                              const float* demod, const float* noise,
                              long long noise_bstride, const float* noise_w,
                              const float* bias, float* out, float* work, int B,
                              int H, int W, int Cin, int Cout, int splits,
                              int act, void* stream) {
  const conv3x3_tc::Epilogue epi{demod, noise, noise_bstride, noise_w, bias, act};
  return conv3x3_tc::conv3x3_tc_launch<modconv3x3_k1>(
      x, style, wt, wp, 1.f, epi, out, work, B, H, W, Cin, Cout, splits,
      static_cast<cudaStream_t>(stream));
}

// The bf16 form: x (B,H,W,Cx) with Cx = Cin rounded up to 8 (zeros past
// Cin) and out (B,H,W,Cout) bf16, wp prepared by w2e_modconv3x3_bf16_prep
// or null; every other operand fp32, as above.
extern "C" int w2e_modconv3x3_bf16(const conv3x3_bf16::bf16* x, const float* style,
                                   const float* wt, const conv3x3_bf16::bf16* wp,
                                   const float* demod, const float* noise,
                                   long long noise_bstride, const float* noise_w,
                                   const float* bias, conv3x3_bf16::bf16* out,
                                   float* work, int B, int H, int W, int Cin,
                                   int Cout, int splits, int act, void* stream) {
  const conv3x3_tc::Epilogue epi{demod, noise, noise_bstride, noise_w, bias, act};
  return conv3x3_bf16::launch<modconv3x3_k1>(x, style, wt, wp, 1.f, epi, out, work, B, H, W,
                                             Cin, Cout, splits,
                                             static_cast<cudaStream_t>(stream));
}
