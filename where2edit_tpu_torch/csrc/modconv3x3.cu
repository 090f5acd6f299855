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
// are optional (null pointers). The same entry point with style := demod,
// demod := style and the flipped, transposed weights is the input gradient
// of the convolution (kernels/modconv3x3.py). The kernel, its bound and its
// design are in conv3x3_core.cuh, shared with K2.

#define W2E_CORE_NS modconv3x3
#include "conv3x3_core.cuh"

using namespace modconv3x3;

// How many ways K1 splits Cin for this shape on a card with `sms` SMs.
extern "C" int w2e_modconv3x3_splits(int B, int H, int W, int Cin, int Cout,
                                     int sms) {
  return conv3x3_splits(B, H, W, Cin, Cout, sms);
}

// x (B,H,W,Cin), style (B,Cin), wt (3,3,Cin,Cout), demod (B,Cout) or null,
// noise (B or 1,H,W) or null with batch stride noise_bstride, noise_w (1,),
// bias (Cout,) or null, out (B,H,W,Cout); with splits > 1 (from
// w2e_modconv3x3_splits), partial is fp32 scratch of splits*B*H*W*Cout. All
// pointers 16-byte aligned (checked by the Python wrapper). Returns the
// launches' cudaGetLastError().
extern "C" int w2e_modconv3x3(const float* x, const float* style,
                              const float* wt, const float* demod,
                              const float* noise, long long noise_bstride,
                              const float* noise_w, const float* bias,
                              float* out, float* partial, int B, int H, int W,
                              int Cin, int Cout, int splits, int act,
                              void* stream) {
  return conv3x3_launch(x, style, wt, demod, 1.f, noise, noise_bstride,
                        noise_w, bias, out, partial, B, H, W, Cin, Cout,
                        splits, act, static_cast<cudaStream_t>(stream));
}
