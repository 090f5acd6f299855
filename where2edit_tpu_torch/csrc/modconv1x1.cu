// K3: modulated 1x1 convolution with an optional fused epilogue, fp32 or
// bf16 in, fp32 or bf16 out, for Hopper (sm_90a).
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
// The bf16 form (w2e_modconv1x1_bf16): x is bf16, read as 16-byte octets of
// 8 channels (single values, masked, when Cin is not a multiple of 8), which
// halves the bytes that bound the kernel. The style * weight fold stays fp32
// in shared memory and the sums and the epilogue fp32; the output type is a
// template parameter: fp32 for ToRGB, whose RGB skip chain and residual stay
// fp32 (as the JAX ToRGB's rgb_dtype), bf16 for a 1x1 StyledConv and the
// mapper's convs (residual, when given, in the output's type). The TPU
// kernel rounds x * s to bf16 before its fp32 dot; folding s * w in fp32
// instead differs from it by less than one bf16 step of the output
// (tests/test_torch_kernels_bf16.py holds the two to 8e-3 of the largest
// value).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <type_traits>

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

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }

template <class T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_float<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

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
// VEC: Cin is whole 16-byte units (a multiple of 4 in fp32, of 8 in bf16),
// else single values. TI, TO: the types of x and of out (and residual).
template <int CO, int L, bool VEC, class TI, class TO>
__global__ void __launch_bounds__(kThreads)
modconv1x1_kernel(const TI* __restrict__ x, const float* __restrict__ style,
                  const float* __restrict__ w, const float* __restrict__ demod,
                  const float* __restrict__ noise, long long noise_bstride,
                  const float* __restrict__ noise_w,
                  const float* __restrict__ bias,
                  const TO* __restrict__ residual, TO* __restrict__ out,
                  int P, int Cin, int Cout, int act) {
  constexpr int THREADS = kThreads;
  constexpr int PPG = kPPG<CO>;
  constexpr int GROUPS = THREADS / L;
  constexpr bool BF16 = std::is_same<TI, bf16>::value;
  constexpr int U = VEC ? 16 / (int)sizeof(TI) : 1;  // values per row unit
  constexpr int LINE = 128 / (int)sizeof(TI);       // values per cache line
  extern __shared__ __align__(16) float ws[];  // [CO][stride]

  const int b = blockIdx.y;
  const int stride = fold_stride(Cin);
  const int gl = threadIdx.x % L;
  const int group = threadIdx.x / L;
  const int units = Cin / U;  // whole units; VEC means Cin % U == 0
  const TI* xb = x + (size_t)b * P * Cin;
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
            ? to_float(residual[((size_t)b * P + p) * Cout + c0 + k]) : 0.f;
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
          // a unit: 16 bytes (4 fp32 or 8 bf16 values), or one value
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (q < units && p < P) {
            if constexpr (VEC)
              v = *reinterpret_cast<const float4*>(xb + (size_t)p * Cin + U * q);
            else
              v.x = to_float(xb[(size_t)p * Cin + q]);
          }
          xv[u][j] = v;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll<CO>; ++u) {
        const int q = q0 + u * L;
        if (q >= units) break;
        if constexpr (VEC && BF16) {
          // the unit's 8 bf16 values, each pixel's unpacked once
          float xf[PPG][8];
#pragma unroll
          for (int j = 0; j < PPG; ++j) {
            const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&xv[u][j]);
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const float2 f = __bfloat1622float2(h[k]);
              xf[j][2 * k] = f.x;
              xf[j][2 * k + 1] = f.y;
            }
          }
#pragma unroll
          for (int o = 0; o < CO; ++o) {
            const float4 f0 = *reinterpret_cast<const float4*>(ws + o * stride + 8 * q);
            const float4 f1 = *reinterpret_cast<const float4*>(ws + o * stride + 8 * q + 4);
#pragma unroll
            for (int j = 0; j < PPG; ++j) {
              float a = acc[j][o];
              a = fmaf(xf[j][0], f0.x, a);
              a = fmaf(xf[j][1], f0.y, a);
              a = fmaf(xf[j][2], f0.z, a);
              a = fmaf(xf[j][3], f0.w, a);
              a = fmaf(xf[j][4], f1.x, a);
              a = fmaf(xf[j][5], f1.y, a);
              a = fmaf(xf[j][6], f1.z, a);
              acc[j][o] = fmaf(xf[j][7], f1.w, a);
            }
          }
        } else {
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
        out[o_base + co] = from_float<TO>(v + e_res[j][k]);
      }
    }
  }
}

int cdiv(long long a, long long b) { return static_cast<int>((a + b - 1) / b); }

template <int CO, int L, bool VEC, class TI, class TO>
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
  *fn = reinterpret_cast<const void*>(modconv1x1_kernel<CO, L, VEC, TI, TO>);
}

// The kernel, grid, block and shared memory for a shape with x of type TI
// and out of type TO; false if the shape is outside what the kernel takes
// (Cout > 32, or a fold above kMaxSmem).
template <class TI, class TO>
bool plan(int B, int P, int Cin, int Cout, int sms, dim3* grid, int* threads,
          size_t* smem, const void** fn) {
  if (Cout > 32 || Cin < 1 || P < 1 || B < 1) return false;
  const bool vec = Cin % (16 / (int)sizeof(TI)) == 0;
  const int lanes = Cin >= 128 ? 32 : Cin >= 64 ? 16 : 8;
#define W2E_K3_CASE(CO, L)                                                           \
  if (lanes == L) {                                                                  \
    if (vec) configure<CO, L, true, TI, TO>(B, P, Cin, sms, grid, threads, smem, fn); \
    else configure<CO, L, false, TI, TO>(B, P, Cin, sms, grid, threads, smem, fn);   \
  }
  if (Cout <= 4) {
    W2E_K3_CASE(4, 8) W2E_K3_CASE(4, 16) W2E_K3_CASE(4, 32)
  } else {
    W2E_K3_CASE(32, 8) W2E_K3_CASE(32, 16) W2E_K3_CASE(32, 32)
  }
#undef W2E_K3_CASE
  return *smem <= (size_t)kMaxSmem;
}

}  // namespace

// Blocks the kernel launches for this shape on a card with `sms` SMs, or 0
// when it does not take the shape.
extern "C" int w2e_modconv1x1_blocks(int B, int P, int Cin, int Cout, int sms) {
  dim3 grid;
  int threads;
  size_t smem;
  const void* fn;
  if (!plan<float, float>(B, P, Cin, Cout, sms, &grid, &threads, &smem, &fn)) return 0;
  return static_cast<int>(grid.x * grid.y);  // the same for every type
}

namespace {

template <class TI, class TO>
int launch(const TI* x, const float* style, const float* w, const float* demod,
           const float* noise, long long noise_bstride, const float* noise_w,
           const float* bias, const TO* residual, TO* out, int B, int P, int Cin,
           int Cout, int act, int sms, void* stream) {
  dim3 grid;
  int threads;
  size_t smem;
  const void* fn;
  if (!plan<TI, TO>(B, P, Cin, Cout, sms, &grid, &threads, &smem, &fn))
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
  return launch<float, float>(x, style, w, demod, noise, noise_bstride, noise_w,
                              bias, residual, out, B, P, Cin, Cout, act, sms, stream);
}

// The bf16 form: x bf16; out and residual bf16 when out_bf16, else fp32;
// every other operand fp32, as above.
extern "C" int w2e_modconv1x1_bf16(const bf16* x, const float* style, const float* w,
                                   const float* demod, const float* noise,
                                   long long noise_bstride, const float* noise_w,
                                   const float* bias, const void* residual, void* out,
                                   int B, int P, int Cin, int Cout, int act, int sms,
                                   int out_bf16, void* stream) {
  if (out_bf16)
    return launch<bf16, bf16>(x, style, w, demod, noise, noise_bstride, noise_w, bias,
                              static_cast<const bf16*>(residual), static_cast<bf16*>(out),
                              B, P, Cin, Cout, act, sms, stream);
  return launch<bf16, float>(x, style, w, demod, noise, noise_bstride, noise_w, bias,
                             static_cast<const float*>(residual), static_cast<float*>(out),
                             B, P, Cin, Cout, act, sms, stream);
}
