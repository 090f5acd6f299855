// K2: equalised-lr 3x3 convolution with a fused bias + activation epilogue,
// fp32 or bf16, NHWC, for Hopper (sm_90a).
//
// Replaces the TPU kernel tools/conv3x3_bench.py::conv3x3_fused (body
// _kernel): the function of every non-downsampling 3x3 ConvLayer of the
// StyleGAN2 discriminator (where2edit_tpu/nn/layers.py ConvLayer, stride 1:
// EqualConv2d + FusedLeakyReLU; ResBlock.conv1 and final_conv):
//
//   out[b,h,w,o] = act( scale * sum_{ky,kx,i} x[b,h+ky-1,w+kx-1,i]
//                                           * wt[ky,kx,i,o] + bias[o] )
//
// with scale = 1/sqrt(9 Cin) of the layer (the equalised learning rate),
// act = lrelu(0.2)*sqrt(2) when `act` is set and bias optional. With the
// flipped, transposed weights and no epilogue it is also its own input
// gradient (kernels/conv3x3.py). Bound on the H100: operations. The kernel
// is an implicit GEMM on the tensor cores in 3xTF32 (conv3x3_tc.cuh, which
// says why that keeps fp32 accuracy); ragged channel counts (final_conv's
// 513 inputs, its input gradient's 513 outputs) are zero-padded in shared
// memory and masked at the stores.
//
// The bf16 form (w2e_conv3x3_bf16) is the TPU kernel's arithmetic: bf16 x
// and out, the weights rounded to bf16 after the scale (round(scale * w), as
// the JAX layer casts them), fp32 sums, bias and activation in fp32, one
// rounding at the store. It runs on the bf16 core, conv3x3_bf16.cuh (shared
// with K1's bf16 form; its header says what bounds it and what the design
// does about it); final_conv's 513 inputs reach it padded to 520.

#include "conv3x3_bf16.cuh"
#include "conv3x3_tc.cuh"

// K2's kernels on the shared cores: names of their own, no modulation
struct conv3x3_k2 {
  static constexpr bool modulated = false;
};

// How many ways K2 splits its K range for this shape on a card with `sms`
// SMs.
extern "C" int w2e_conv3x3_splits(int B, int H, int W, int Cin, int Cout,
                                  int sms, int bf16) {
  return bf16 ? conv3x3_bf16::splits_for(B, H, W, Cin, Cout, sms, false)
              : conv3x3_tc::splits_for(B, H, W, Cin, Cout, sms, false);
}

// fp32 scratch (floats) a call with this shape and split count needs, in
// fp32 or (bf16 != 0) bf16.
extern "C" long long w2e_conv3x3_workspace(int B, int H, int W, int Cin,
                                           int Cout, int splits, int bf16) {
  return bf16 ? conv3x3_bf16::workspace_floats(B, H, W, Cin, Cout, splits, false)
              : conv3x3_tc::workspace_floats(B, H, W, Cin, Cout, splits, false);
}

// x (B,H,W,Cin), wt (3,3,Cin,Cout), bias (Cout,) or null, out (B,H,W,Cout),
// work: w2e_conv3x3_workspace floats of scratch; splits from
// w2e_conv3x3_splits. x, wt and work 16-byte aligned (checked by the Python
// wrapper). Returns the launches' cudaGetLastError().
extern "C" int w2e_conv3x3(const float* x, const float* wt, const float* bias,
                           float* out, float* work, int B, int H, int W,
                           int Cin, int Cout, int splits, int act, float scale,
                           void* stream) {
  const conv3x3_tc::Epilogue epi{nullptr, nullptr, 0, nullptr, bias, act};
  return conv3x3_tc::conv3x3_tc_launch<conv3x3_k2>(
      x, nullptr, wt, nullptr, scale, epi, out, work, B, H, W, Cin, Cout, splits,
      static_cast<cudaStream_t>(stream));
}

// The bf16 form: x (B,H,W,Cx) with Cx = Cin rounded up to 8 (zeros past
// Cin) and out (B,H,W,Cout) bf16, wt and bias fp32; work:
// w2e_conv3x3_workspace(..., 1) floats.
extern "C" int w2e_conv3x3_bf16(const conv3x3_bf16::bf16* x, const float* wt,
                                const float* bias, conv3x3_bf16::bf16* out,
                                float* work, int B, int H, int W, int Cin,
                                int Cout, int splits, int act, float scale,
                                void* stream) {
  const conv3x3_tc::Epilogue epi{nullptr, nullptr, 0, nullptr, bias, act};
  return conv3x3_bf16::launch<conv3x3_k2>(x, nullptr, wt, nullptr, scale, epi, out, work, B,
                                          H, W, Cin, Cout, splits,
                                          static_cast<cudaStream_t>(stream));
}
