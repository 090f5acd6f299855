// K2: equalised-lr 3x3 convolution with a fused bias + activation epilogue,
// fp32, NHWC, for Hopper (sm_90a).
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
// gradient (kernels/conv3x3.py). It is K1's kernel (conv3x3_core.cuh) with
// no style, demod or noise; ragged channel counts (final_conv's 513 inputs,
// its input gradient's 513 outputs) are masked in the kernel.

#define W2E_CORE_NS conv3x3
#include "conv3x3_core.cuh"

using namespace conv3x3;

// How many ways K2 splits Cin for this shape on a card with `sms` SMs.
extern "C" int w2e_conv3x3_splits(int B, int H, int W, int Cin, int Cout,
                                  int sms) {
  return conv3x3_splits(B, H, W, Cin, Cout, sms);
}

// x (B,H,W,Cin), wt (3,3,Cin,Cout), bias (Cout,) or null, out (B,H,W,Cout);
// with splits > 1 (from w2e_conv3x3_splits), partial is fp32 scratch of
// splits*B*H*W*Cout. All pointers 16-byte aligned (checked by the Python
// wrapper). Returns the launches' cudaGetLastError().
extern "C" int w2e_conv3x3(const float* x, const float* wt, const float* bias,
                           float* out, float* partial, int B, int H, int W,
                           int Cin, int Cout, int splits, int act, float scale,
                           void* stream) {
  return conv3x3_launch(x, nullptr, wt, nullptr, scale, nullptr, 0, nullptr,
                        bias, out, partial, B, H, W, Cin, Cout, splits, act,
                        static_cast<cudaStream_t>(stream));
}
