// K5: upfirdn2d for Hopper (sm_90a): upsample by zero-stuffing, pad (or
// crop), convolve with a 2-D FIR, downsample, on NHWC tensors, fp32 in and
// out, or bf16 in and out with fp32 sums and one rounding at the store.
//
// Replaces no TPU kernel: the JAX package leaves upfirdn2d to XLA
// (where2edit_tpu/ops/upfirdn2d.py). The port ran it as a zero-stuffed copy,
// an F.pad copy and cuDNN's depthwise conv (conv2d_grouped), and its input
// gradient as cuDNN's dgrad; this kernel is every one of them. It serves the
// up-conv's blur (up 1, down 1, pad (1, 1)), the ToRGB skip's Upsample (up
// 2, pad (2, 1), 3 channels), the discriminator's two blurs (pad (2, 2) and
// (1, 1)) and, through the autograd Function of ops/upfirdn2d.py, each of
// their gradients, which are upfirdn2d again with up and down swapped and
// the FIR flipped (so a double backward is this kernel too).
//
//   out[n, oy, ox, c] = sum_{ty, tx} taps[ty][tx] * xs[n, oy*down - py0 + ty, ox*down - px0 + tx, c]
//
// xs is x zero-stuffed by `up` (x[i] at i*up, zeros between and after),
// zero outside [0, H*up) x [0, W*up); `taps` is the FIR flipped (the
// cross-correlation form of upfirdn2d's true convolution), at most 8 x 8,
// passed by value. pad1 only sets the output size (Ho, Wo), which the
// caller passes; a negative pad crops.
//
// What bounds it on the H100: bytes. The models' FIR is [1,3,3,1] x
// [1,3,3,1], so 16 multiply-adds per output value against 8 bytes moved
// (fp32: one input and one output value) is 2 FLOP/byte, a tenth of the
// card's fp32 balance point. The design moves each value across the
// memory bus once and keeps the rest on the chip:
//
// - Channels are innermost (NHWC), so a thread owns one 16-byte channel
//   vector (4 fp32 or 8 bf16 values) of one output column, and neighbouring
//   threads own neighbouring vectors: every load and store is a 16-byte
//   access, coalesced across the warp.
// - The dense form (up 1, down 1, a 4 x 4 FIR: every call of the models and
//   every gradient of the blurs) slides down a run of `rows` output rows.
//   Each input row is loaded once per thread (4 vectors, its 4 columns) and
//   feeds the 4 output rows that use it, whose sums rotate through 4 sets of
//   registers; an output row leaves as soon as its last input row is in.
//   The columns a thread shares with its neighbours come from L1, so a
//   value crosses the memory bus once; the (4 - 1) halo rows of a run come
//   from L2 ((4 - 1) / rows of the reads, <5 % at 64 rows).
// - The borders are zero fill by predicate: a column's validity is fixed
//   per thread, a row's per row, so padding and cropping cost no copy.
// - The grid adapts to the shape: `rows` starts at 64 and halves until the
//   launch has at least 16 blocks a multiprocessor, so the small octaves
//   (4^2-32^2 at 512 channels, batch 8) split their rows down to one a
//   thread and still fill the card.
// - Every other call (up or down > 1, another FIR size, or a C that is not
//   a multiple of the vector: the ToRGB skip's 3 channels and its
//   gradient) takes the general form: one output value a thread, over only
//   the taps that land on real samples (polyphase: the first tap of the
//   right phase, then every up-th), and only the kept outputs when down > 1.
// - Sums are fp32 in one fixed order (taps row by row, then column by
//   column), no atomics: two calls give the same bits, and the dense and
//   general forms give the same bits on the same call.
//
// Grid: (ceil(Wo * vectors (dense) or values (general) a pixel / 256),
// ceil(Ho / rows), N), 256 threads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kMaxTaps = 8;
constexpr int kMaxRows = 64;
constexpr int kMinBlocksPerSm = 16;

struct Params {
  const void* x;
  void* out;
  long long sxn, sxh;  // x's batch and row strides in elements (pixel stride C, channel 1)
  int n, h, w, c;      // input
  int ho, wo;          // output
  int up, down, py0, px0;
  int kh, kw;
  int rows;                          // output rows a thread (the dense form)
  float taps[kMaxTaps * kMaxTaps];  // [ty * kw + tx], flipped
};

enum Form { kGeneral = 0, kDense = 1 };

struct Plan {
  int form, rows;
  dim3 grid;
};

// V values of x at p, as fp32; zeros where !ok (p is then not read).
template <int V>
__device__ __forceinline__ void load(const float* p, bool ok, float (&v)[V]) {
  if constexpr (V == 4) {
    float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
    if (ok) q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
    static_assert(V == 1, "fp32 takes 4-value vectors or single values");
    v[0] = ok ? __ldg(p) : 0.f;
  }
}

template <int V>
__device__ __forceinline__ void load(const bf16* p, bool ok, float (&v)[V]) {
  if constexpr (V == 8) {
    uint4 q = make_uint4(0u, 0u, 0u, 0u);
    if (ok) q = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x, v[2 * i + 1] = f.y;
    }
  } else {
    static_assert(V == 1, "bf16 takes 8-value vectors or single values");
    v[0] = ok ? __bfloat162float(p[0]) : 0.f;
  }
}

template <int V>
__device__ __forceinline__ void store(float* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    p[0] = v[0];
  }
}

template <int V>
__device__ __forceinline__ void store(bf16* p, const float (&v)[V]) {
  if constexpr (V == 8) {
    uint4 q;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = q;
  } else {
    p[0] = __float2bfloat16_rn(v[0]);
  }
}

// The dense form: up 1, down 1, a KH x KW FIR, 16-byte vectors. A thread
// owns (output column, channel vector) and output rows [oy0, oy0 + rows) of
// one image; output row o (relative) sums input rows o .. o + KH - 1, so
// input row r feeds outputs r - ty with tap row ty, into register set
// (r - ty) mod KH. Tap row 0 starts an output's sum (an assignment: what a
// set held before, the tail of an output above the run, is dropped), tap
// row KH - 1 ends it, and the output leaves.
template <typename T, int KH, int KW>
__global__ void __launch_bounds__(kThreads) upfirdn2d_dense(const __grid_constant__ Params p) {
  constexpr int V = 16 / sizeof(T);
  const int vecs = p.c / V;
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const int ox = static_cast<int>(t / vecs);
  if (ox >= p.wo) return;
  const int cv = static_cast<int>(t - static_cast<long long>(ox) * vecs);
  const int n = blockIdx.z;
  const int oy0 = blockIdx.y * p.rows;
  const int n_in = min(p.rows, p.ho - oy0) + KH - 1;
  const int iy0 = oy0 - p.py0, ix0 = ox - p.px0;
  const T* xn = static_cast<const T*>(p.x) + n * p.sxn + cv * V;
  const long long out_row = static_cast<long long>(p.wo) * p.c;
  T* out = static_cast<T*>(p.out) + (static_cast<long long>(n) * p.ho + oy0) * out_row +
           static_cast<long long>(ox) * p.c + cv * V;
  bool col_ok[KW];
  long long col[KW];
#pragma unroll
  for (int tx = 0; tx < KW; ++tx) {
    col_ok[tx] = static_cast<unsigned>(ix0 + tx) < static_cast<unsigned>(p.w);
    col[tx] = static_cast<long long>(ix0 + tx) * p.c;
  }
  float acc[KH][V] = {};
  for (int r0 = 0; r0 < n_in; r0 += KH) {
#pragma unroll
    for (int u = 0; u < KH; ++u) {
      const int r = r0 + u;
      if (r >= n_in) break;
      const int iy = iy0 + r;
      const bool row_ok = static_cast<unsigned>(iy) < static_cast<unsigned>(p.h);
      const T* row = xn + static_cast<long long>(iy) * p.sxh;
      float v[KW][V];
#pragma unroll
      for (int tx = 0; tx < KW; ++tx) load<V>(row + col[tx], row_ok && col_ok[tx], v[tx]);
#pragma unroll
      for (int ty = 0; ty < KH; ++ty) {
        float(&a)[V] = acc[(u - ty + KH) % KH];
#pragma unroll
        for (int tx = 0; tx < KW; ++tx) {
          const float k = p.taps[ty * KW + tx];
#pragma unroll
          for (int e = 0; e < V; ++e)
            a[e] = (ty == 0 && tx == 0) ? k * v[tx][e] : fmaf(k, v[tx][e], a[e]);
        }
      }
      if (r >= KH - 1) store<V>(out + (r - (KH - 1)) * out_row, acc[(u + 1) % KH]);
    }
  }
}

// The general form: one output value a thread, any up, down, pad and FIR
// up to 8 x 8. In each axis the first tap that lands on a real sample is the
// one of the output's phase; the next are every up-th.
template <typename T>
__global__ void __launch_bounds__(kThreads) upfirdn2d_any(const __grid_constant__ Params p) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const int ox = static_cast<int>(t / p.c);
  if (ox >= p.wo) return;
  const int ch = static_cast<int>(t - static_cast<long long>(ox) * p.c);
  const int oy = blockIdx.y, n = blockIdx.z;
  const int sy = oy * p.down - p.py0, sx = ox * p.down - p.px0;
  // first tap of the phase: (s + t0) a multiple of up, s + t0 = up * i0
  const int ty0 = ((-sy) % p.up + p.up) % p.up, tx0 = ((-sx) % p.up + p.up) % p.up;
  const int iy0 = (sy + ty0) / p.up, ix0 = (sx + tx0) / p.up;
  const T* xn = static_cast<const T*>(p.x) + n * p.sxn + ch;
  float acc[1] = {0.f};
  for (int ty = ty0, iy = iy0; ty < p.kh; ty += p.up, ++iy) {
    if (static_cast<unsigned>(iy) >= static_cast<unsigned>(p.h)) continue;
    const T* row = xn + static_cast<long long>(iy) * p.sxh;
    for (int tx = tx0, ix = ix0; tx < p.kw; tx += p.up, ++ix) {
      if (static_cast<unsigned>(ix) >= static_cast<unsigned>(p.w)) continue;
      float v[1];
      load<1>(row + static_cast<long long>(ix) * p.c, true, v);
      acc[0] = fmaf(p.taps[ty * p.kw + tx], v[0], acc[0]);
    }
  }
  T* out = static_cast<T*>(p.out) +
           ((static_cast<long long>(n) * p.ho + oy) * p.wo + ox) * p.c + ch;
  store<1>(out, acc);
}

Plan make_plan(const Params& p, int elem_size, bool aligned, int sms) {
  const int v = 16 / elem_size;
  const bool vec = aligned && p.c % v == 0 && p.sxn % v == 0 && p.sxh % v == 0;
  Plan pl;
  pl.form = vec && p.up == 1 && p.down == 1 && p.kh == 4 && p.kw == 4 ? kDense : kGeneral;
  const long long per_row =
      (static_cast<long long>(p.wo) * (pl.form == kDense ? p.c / v : p.c) + kThreads - 1) /
      kThreads;
  pl.rows = 1;
  if (pl.form == kDense) {
    pl.rows = kMaxRows;
    while (pl.rows > 1 && static_cast<long long>(p.n) * ((p.ho + pl.rows - 1) / pl.rows) * per_row <
                              static_cast<long long>(kMinBlocksPerSm) * sms)
      pl.rows /= 2;
  }
  pl.grid = dim3(static_cast<unsigned>(per_row), (p.ho + pl.rows - 1) / pl.rows, p.n);
  return pl;
}

template <typename T>
int launch(Params p, int sms, cudaStream_t stream) {
  const bool aligned = reinterpret_cast<uintptr_t>(p.x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(p.out) % 16 == 0;
  const Plan pl = make_plan(p, sizeof(T), aligned, sms);
  p.rows = pl.rows;
  if (pl.form == kDense)
    upfirdn2d_dense<T, 4, 4><<<pl.grid, kThreads, 0, stream>>>(p);
  else
    upfirdn2d_any<T><<<pl.grid, kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

Params params(const void* x, void* out, long long sxn, long long sxh, int n, int h, int w, int c,
              int ho, int wo, int up, int down, int py0, int px0, int kh, int kw,
              const float* taps) {
  Params p{};
  p.x = x, p.out = out, p.sxn = sxn, p.sxh = sxh;
  p.n = n, p.h = h, p.w = w, p.c = c, p.ho = ho, p.wo = wo;
  p.up = up, p.down = down, p.py0 = py0, p.px0 = px0, p.kh = kh, p.kw = kw;
  for (int i = 0; i < kh * kw; ++i) p.taps[i] = taps[i];
  return p;
}

}  // namespace

// x (N, H, W, C) with batch stride sxn and row stride sxh (elements; pixel
// stride C, channel stride 1), fp32 or, with bf16 set, bf16; out (N, Ho, Wo,
// C) contiguous, x's dtype; taps (kh * kw) fp32, the FIR flipped, row-major;
// 1 <= up, down; 1 <= kh, kw <= 8; N, Ho <= 65535. Returns the launch's
// cudaGetLastError(), or -1 for arguments outside that contract.
extern "C" int w2e_upfirdn2d(const void* x, void* out, int bf16_io, long long sxn, long long sxh,
                             int n, int h, int w, int c, int ho, int wo, int up, int down, int py0,
                             int px0, int kh, int kw, const float* taps, int sms, void* stream) {
  if (up < 1 || down < 1 || kh < 1 || kw < 1 || kh > kMaxTaps || kw > kMaxTaps || n < 1 ||
      n > 65535 || ho < 1 || ho > 65535 || wo < 1 || c < 1)
    return -1;
  const Params p = params(x, out, sxn, sxh, n, h, w, c, ho, wo, up, down, py0, px0, kh, kw, taps);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16_io ? launch<bf16>(p, sms, s) : launch<float>(p, sms, s);
}

// The plan of such a call: fields = {form (0 general, one value a thread;
// 1 dense), rows a thread, grid.x, grid.y, grid.z}. x_aligned and out_aligned: whether those pointers are
// 16-byte aligned.
extern "C" void w2e_upfirdn2d_plan(int bf16_io, long long sxn, long long sxh, int n, int h, int w,
                                   int c, int ho, int wo, int up, int down, int kh, int kw,
                                   int aligned, int sms, int* fields) {
  const float zeros[kMaxTaps * kMaxTaps] = {};
  const Params p = params(nullptr, nullptr, sxn, sxh, n, h, w, c, ho, wo, up, down, 0, 0, kh, kw,
                          zeros);
  const Plan pl = make_plan(p, bf16_io ? 2 : 4, aligned != 0, sms);
  const int f[] = {pl.form, pl.rows, static_cast<int>(pl.grid.x), static_cast<int>(pl.grid.y),
                   static_cast<int>(pl.grid.z)};
  for (int i = 0; i < 5; ++i) fields[i] = f[i];
}
