// The fused DenseLayer's 3x3 convolution for Hopper (sm_90a), in float32.
//
// It replaces no Pallas kernel: the JAX package leaves this convolution to
// XLA.  It is the inference path of models/layers.py's DenseBlock, which
// grows in place in one NHWC buffer [N, H, W, P] (P a multiple of 4).  A
// layer reads the channel prefix [0, cin) of every pixel and writes its
// `g` new channels at [cin, cin + g) of the same buffer:
//
//   out[m, n] = act(sum over taps t and channels c of
//                   x[m + tap offset t, c] * w[t, c, n]  (zero outside)
//                   + T[m, n])
//   T[m, n]   = b3[n] + sum over the taps t in bounds at m of a[n, t]
//
// with w = W1 . W3 (the 1x1 folded into the 3x3) stored [9, cin, g],
// a = W3 . b1 [g, 9], and act = max(v, 0) + slope * min(v, 0) (ReLU with
// slope 0, LeakyReLU with 0.01).
//
// What bounds it on this card.  A layer is an implicit GEMM of M = N*H*W
// pixels by g = 42..64 output channels by K = 9 * cin (cin 2 to ~520):
// float32 FMA on the SIMT cores (TF32 is off for this codec, so the tensor
// cores are out), 67 TFLOP/s.  Each input value feeds 9 x g products, so
// it is compute-bound once cin passes a few channels; what stands between
// it and the FMA rate is shared memory's bandwidth (a thread's operands
// come from shared memory), FMAs spent on masked pixels and channels, and
// that M * g is small (16384 x 48 outputs on imagenet64, 39,744 x 64 on the
// two-level codec's 4x4 tiles) against 132 SMs.  What the design does:
//   - a thread owns a segment of 8 consecutive pixels by kBN / 4 output
//     channels (kBN / 4 * 8 sums in registers).  For one input channel and
//     one tap row it loads the segment's pixels once and multiplies them
//     into all three horizontal taps.  A warp holds 8 segments by the 4
//     channel groups; a block of 4 warps 32 segments (256 pixels) by kBN
//     channels.  Two blocks share an SM, so a thread may hold 255
//     registers and spills none (three blocks of 168 registers spilled and
//     ran 16% slower on the bulk's layers).
//   - Two geometries, chosen by the wrapper from the launch shape alone
//     (template parameters of this one kernel):
//       wide (kRowW = 0, W >= 8 or W not dividing 8; kBN = 48): a segment
//       is 8 pixels of one image row; it loads its 10 pixels with the left
//       and right halo (288 FMAs a thread for 10 scalar and 9 16-byte
//       shared-memory loads).  Segments tile each image row, the last one
//       of a row masked, so any width works.
//       narrow (kRowW = W, W in {1, 2, 4}): a segment is 8 / W whole
//       consecutive rows of the stacked N*H rows, so no pixel is masked
//       (a 4-wide row in a wide segment leaves half of it masked).  Each
//       pixel keeps its own image row for its tap-row bounds and the bias
//       field, so a segment may cross an image boundary.  The horizontal
//       halo always lies outside the image: it is not loaded, and the taps
//       that would read it are skipped at compile time (10 of 12 at W = 4;
//       fmaf(0, w, acc) is acc, so the arithmetic is the same).  kBN is 64
//       where g > 48, so g = 64 is one tile with no masked channel (two
//       48-channel tiles spent 96 channels of FMAs on 64); 16 channels by
//       8 pixels is 128 sums a thread, under the 255-register budget.
//   - K runs as stages of (8 input channels, one tap row): cp.async copies
//     the segments' rows (zero-filled outside the image and past cin) and
//     the three taps' weights into a ring of 3 shared-memory stages.  A
//     segment's row sits at a stride of 84 floats (wide) or 68 (narrow),
//     which puts the 8 segments of a warp in distinct banks.
//   - K is split over `splits` blocks per tile (chosen by the wrapper from
//     the launch shape alone), so that small M still fills the card; each
//     split writes its partial tile to scratch, and
//     dense_conv3x3_splitk_reduce_kernel sums the splits in a fixed order
//     and applies the epilogue.  No atomics: the same shape gives the same
//     bits on every launch, which is what keeps the codec's compress and
//     decompress bit-exact.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC.  Each entry point launches on the stream it is
//        given, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kSegPx = 8;      // pixels of a segment
constexpr int kSegs = 32;      // segments of a block tile
constexpr int kKC = 8;         // input channels of a stage
constexpr int kStages = 3;     // cp.async ring depth
constexpr int kTaps = 9;
constexpr int kWideBN = 48;    // output channels of a wide block tile

// The shape of a geometry: kRowW 0 is wide (a segment of one row, loaded
// with its halo), else narrow (8 / kRowW whole rows of kRowW pixels).
template <int kRowW, int kBN>
struct Geo {
  static constexpr bool kNarrow = kRowW > 0;
  static constexpr int kRowDiv = kNarrow ? kRowW : 1;  // a nonzero kRowW
  static constexpr int kPx = kNarrow ? kSegPx : kSegPx + 2;  // loaded
  static constexpr int kTN = kBN / 4;  // output channels of a thread
  static constexpr int kSegStride = kPx * kKC + 4;  // floats a segment
  static constexpr int kALoads = kSegs * kPx * (kKC / 4) / kThreads;
  static constexpr int kBLoads = 3 * kKC * kBN / kThreads;
  // input channels of a stage unrolled together in the main loop: one in
  // the narrow geometry, whose 128 sums a thread leave no registers to
  // overlap two (1-2% faster on the 4x4 tiles than two)
  static constexpr int kUnrollK = kNarrow ? 1 : 2;
  static_assert(!kNarrow || kSegPx % kRowW == 0, "whole rows a segment");
  static_assert(kSegs * kPx * (kKC / 4) % kThreads == 0, "A loads");
  static_assert(3 * kKC * kBN % kThreads == 0, "B loads");
  static_assert(kSegs == 4 * 8 && kTN % 4 == 0 && kBN <= kThreads,
                "a warp: 8 segments x 4 channel groups");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// cp.async of 16 or 4 bytes, of which the first `valid` come from src and
// the rest are zero-filled (valid 0: src is not read).
__device__ __forceinline__ void cp16(void* dst, const void* src, int valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid));
}

__device__ __forceinline__ void cp4(void* dst, const void* src, int valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float activate(float v, float slope) {
  return fmaxf(v, 0.0f) + slope * fminf(v, 0.0f);
}

// T[m, n] less b3: the sum of a[n, t] over the taps t in bounds at (y, x),
// in tap order.
__device__ __forceinline__ float bias_field(const float* a9, int y, int x,
                                            int H, int W) {
  float t = 0.0f;
#pragma unroll
  for (int ky = 0; ky < 3; ++ky) {
    const bool ry = (unsigned)(y + ky - 1) < (unsigned)H;
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) {
      const bool rx = (unsigned)(x + kx - 1) < (unsigned)W;
      if (ry && rx) t += a9[ky * 3 + kx];
    }
  }
  return t;
}

template <int kRowW, int kBN>
struct Smem {
  using G = Geo<kRowW, kBN>;
  float a[kStages][kSegs * G::kSegStride];  // [segment][pixel][8 channels]
  float b[kStages][3 * kKC * kBN];          // [tap column][channel][kBN]
  float bias[kBN * kTaps];                  // a[n, t] of the tile's channels
  float b3[kBN];
};

// grid (ceil(segments / 32), ceil(g / kBN), splits); segments: rows * ceil(W
// / 8) (wide, rows = N * H) or ceil(M / 8) (narrow).  splits == 1: the
// epilogue writes the layer's channels; else each split writes its partial
// tile to part[split, m, n] (n over ceil(g / kBN) * kBN) for the reduce
// kernel.
template <int kRowW, int kBN>
__global__ void __launch_bounds__(kThreads, 2)
dense_conv3x3_fprop_kernel(float* buf, const float* __restrict__ w,
                           const float* __restrict__ bias_a,
                           const float* __restrict__ b3,
                           float* __restrict__ part, int M, int H, int W,
                           int P, int cin, int g, float slope) {
  using G = Geo<kRowW, kBN>;
  constexpr int kPx = G::kPx, kTN = G::kTN, kSegStride = G::kSegStride;
  __shared__ __align__(16) Smem<kRowW, kBN> sm;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int rows = M / W;
  const int xb_row = (W + kSegPx - 1) / kSegPx;  // segments of a wide row
  const int seg0 = blockIdx.x * kSegs;
  const int n0 = blockIdx.y * kBN;
  const int splits = gridDim.z;
  const int total = (cin + kKC - 1) / kKC * 3;  // stages: chunk x tap row
  const int s_begin = (int)((int64_t)total * blockIdx.z / splits);
  const int s_end = (int)((int64_t)total * (blockIdx.z + 1) / splits);
  const int nst = s_end - s_begin;

  // this thread's cp16 copies of a stage (segment, pixel, quad): the
  // pixel's index, and bit 3 u + dy + 1 of `lrows` set where the pixel
  // exists and its row y + dy is inside the image
  int lpix[G::kALoads];
  unsigned lrows = 0;
#pragma unroll
  for (int u = 0; u < G::kALoads; ++u) {
    const int e = tid + kThreads * u;
    const int s = e / (2 * kPx), j = (e % (2 * kPx)) >> 1;
    bool exists;
    int y;
    if (G::kNarrow) {
      const int m = (seg0 + s) * kSegPx + j;
      lpix[u] = m;
      exists = m < M;
      y = m / G::kRowDiv % H;
    } else {
      const int gs = seg0 + s, r = gs / xb_row;
      const int x = (gs % xb_row) * kSegPx + j - 1;
      lpix[u] = r * W + x;
      exists = r < rows && (unsigned)x < (unsigned)W;
      y = r % H;
    }
    if (exists) {
#pragma unroll
      for (int dy = -1; dy <= 1; ++dy)
        if ((unsigned)(y + dy) < (unsigned)H) lrows |= 1u << (3 * u + dy + 1);
    }
  }

  auto load_stage = [&](int st, int slot) {
    const int chunk = st / 3;
    const int dy = st - chunk * 3 - 1;
    const int c0 = chunk * kKC;
#pragma unroll
    for (int u = 0; u < G::kALoads; ++u) {
      const int e = tid + kThreads * u;
      const int s = e / (2 * kPx), rem = e % (2 * kPx);
      const int q = rem & 1;
      int valid = cin - (c0 + 4 * q);
      valid = valid < 0 ? 0 : (valid > 4 ? 4 : valid);
      if (!(lrows >> (3 * u + dy + 1) & 1u)) valid = 0;
      const float* src =
          valid ? buf + ((ptrdiff_t)lpix[u] + (ptrdiff_t)dy * W) * P + c0 +
                      4 * q
                : buf;
      cp16(&sm.a[slot][s * kSegStride + (rem >> 1) * kKC + 4 * q], src,
           valid * 4);
    }
    // weights w[(dy + 1) * 3 + dx, c0 + k, n0 + n] -> b[dx][k][n]
#pragma unroll
    for (int v = 0; v < G::kBLoads; ++v) {
      const int e = tid + kThreads * v;
      const int dx = e / (kKC * kBN), rem = e % (kKC * kBN);
      const int k = rem / kBN, n = rem % kBN;
      const bool ok = c0 + k < cin && n0 + n < g;
      const float* ws =
          ok ? w + ((size_t)((dy + 1) * 3 + dx) * cin + c0 + k) * g + n0 + n
             : w;
      cp4(&sm.b[slot][e], ws, ok ? 4 : 0);
    }
  };

  for (int e = tid; e < kBN * kTaps; e += kThreads) {
    const int n = n0 + e / kTaps;
    sm.bias[e] = n < g ? bias_a[(size_t)n * kTaps + e % kTaps] : 0.0f;
  }
  if (tid < kBN) sm.b3[tid] = n0 + tid < g ? b3[n0 + tid] : 0.0f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nst) load_stage(s_begin + s, s);
    cp_commit();
  }

  // this thread's outputs: segment seg, channels ns .. ns + kTN - 1
  const int seg = (tid >> 5) * 8 + (lane & 7);
  const int ns = (lane >> 3) * kTN;
  float acc[kSegPx][kTN];
#pragma unroll
  for (int j = 0; j < kSegPx; ++j)
#pragma unroll
    for (int n = 0; n < kTN; ++n) acc[j][n] = 0.0f;

  for (int it = 0; it < nst; ++it) {
    cp_wait<kStages - 2>();
    __syncthreads();
    const int pre = it + kStages - 1;
    if (pre < nst) load_stage(s_begin + pre, pre % kStages);
    cp_commit();
    const float* as = sm.a[it % kStages] + seg * kSegStride;
    const float* bs = sm.b[it % kStages] + ns;
#pragma unroll(G::kUnrollK)
    for (int k = 0; k < kKC; ++k) {
      float a[kPx];
#pragma unroll
      for (int j = 0; j < kPx; ++j) a[j] = as[j * kKC + k];
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const float4* br =
            reinterpret_cast<const float4*>(bs + (dx * kKC + k) * kBN);
        float b[kTN];
#pragma unroll
        for (int q = 0; q < kTN / 4; ++q) {
          const float4 v = br[q];
          b[4 * q] = v.x;
          b[4 * q + 1] = v.y;
          b[4 * q + 2] = v.z;
          b[4 * q + 3] = v.w;
        }
#pragma unroll
        for (int j = 0; j < kSegPx; ++j) {
          // narrow: pixel j reads x + dx - 1 of its own row, skipped where
          // that lies outside the row (the zero padding)
          if (G::kNarrow &&
              (unsigned)(j % G::kRowDiv + dx - 1) >= (unsigned)kRowW)
            continue;
          const float av = a[G::kNarrow ? j + dx - 1 : j + dx];
#pragma unroll
          for (int n = 0; n < kTN; ++n) acc[j][n] = fmaf(av, b[n], acc[j][n]);
        }
      }
    }
  }
  cp_wait<0>();

  // the segment's first pixel, its pixels that exist, and for the wide
  // geometry its row and first column
  int m0, npx, r = 0, x0 = 0;
  if (G::kNarrow) {
    m0 = (seg0 + seg) * kSegPx;
    if (m0 >= M) return;
    npx = M - m0 < kSegPx ? M - m0 : kSegPx;
  } else {
    const int gs = seg0 + seg;
    r = gs / xb_row;
    x0 = (gs % xb_row) * kSegPx;
    if (r >= rows) return;
    m0 = r * W + x0;
    npx = W - x0 < kSegPx ? W - x0 : kSegPx;
  }
  if (splits > 1) {
    const int np = gridDim.y * kBN;
#pragma unroll
    for (int j = 0; j < kSegPx; ++j) {
      if (j >= npx) break;
      float4* dst = reinterpret_cast<float4*>(
          part + ((size_t)blockIdx.z * M + m0 + j) * np + n0 + ns);
#pragma unroll
      for (int q = 0; q < kTN / 4; ++q)
        dst[q] = make_float4(acc[j][4 * q], acc[j][4 * q + 1],
                             acc[j][4 * q + 2], acc[j][4 * q + 3]);
    }
    return;
  }
  // the bias tables were written before the main loop's first barrier
#pragma unroll
  for (int j = 0; j < kSegPx; ++j) {
    if (j >= npx) break;
    const int y = G::kNarrow ? (m0 + j) / G::kRowDiv % H : r % H;
    const int x = G::kNarrow ? j % G::kRowDiv : x0 + j;
    float* out = buf + ((size_t)m0 + j) * P + cin + n0 + ns;
#pragma unroll
    for (int n = 0; n < kTN; ++n) {
      if (n0 + ns + n >= g) break;
      const float t = sm.b3[ns + n] +
                      bias_field(&sm.bias[(ns + n) * kTaps], y, x, H, W);
      out[n] = activate(acc[j][n] + t, slope);
    }
  }
}

// One thread per output (m, n < g): the splits' partials summed in split
// order, then the same epilogue as the fprop kernel's.
__global__ void dense_conv3x3_splitk_reduce_kernel(
    float* buf, const float* __restrict__ part,
    const float* __restrict__ bias_a, const float* __restrict__ b3, int M,
    int H, int W, int P, int cin, int g, int np, int splits, float slope) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (int64_t)M * g) return;
  const int m = (int)(e / g), n = (int)(e - (int64_t)m * g);
  float v = 0.0f;
  for (int s = 0; s < splits; ++s) v += part[((size_t)s * M + m) * np + n];
  const int x = m % W, y = (m / W) % H;
  float a9[kTaps];
#pragma unroll
  for (int t = 0; t < kTaps; ++t) a9[t] = bias_a[(size_t)n * kTaps + t];
  const float t = b3[n] + bias_field(a9, y, x, H, W);
  buf[(size_t)m * P + cin + n] = activate(v + t, slope);
}

template <int kRowW, int kBN>
void launch_fprop(float* buf, const float* w, const float* bias_a,
                  const float* b3, float* part, int M, int H, int W, int P,
                  int cin, int g, int splits, float slope,
                  cudaStream_t stream) {
  const int64_t segs = kRowW > 0 ? ((int64_t)M + kSegPx - 1) / kSegPx
                                 : (int64_t)(M / W) *
                                       ((W + kSegPx - 1) / kSegPx);
  const dim3 grid((unsigned)((segs + kSegs - 1) / kSegs),
                  (g + kBN - 1) / kBN, splits);
  dense_conv3x3_fprop_kernel<kRowW, kBN><<<grid, kThreads, 0, stream>>>(
      buf, w, bias_a, b3, part, M, H, W, P, cin, g, slope);
}

template <int kRowW>
bool launch_narrow(int tile_n, float* buf, const float* w,
                   const float* bias_a, const float* b3, float* part, int M,
                   int H, int W, int P, int cin, int g, int splits,
                   float slope, cudaStream_t stream) {
  if (tile_n == kWideBN)
    launch_fprop<kRowW, kWideBN>(buf, w, bias_a, b3, part, M, H, W, P, cin,
                                 g, splits, slope, stream);
  else if (tile_n == 64)
    launch_fprop<kRowW, 64>(buf, w, bias_a, b3, part, M, H, W, P, cin, g,
                            splits, slope, stream);
  else
    return false;
  return true;
}

}  // namespace

extern "C" {

// buf: [M = N*H*W, P] float32 (P % 4 == 0, 16-byte aligned); w [9, cin, g];
// bias_a [g, 9]; b3 [g]; part: splits * M * ceil(g / tile_n) * tile_n
// floats when splits > 1 (else unused).  row_w 0 with tile_n 48: the wide
// geometry; row_w == W in {1, 2, 4} with tile_n 48 or 64: the narrow one.
// Any other geometry returns cudaErrorInvalidValue and launches nothing.
int dense_conv3x3_launch(float* buf, const float* w, const float* bias_a,
                         const float* b3, float* part, int M, int H, int W,
                         int P, int cin, int g, int row_w, int tile_n,
                         int splits, float slope, void* stream) {
  if (M <= 0 || g <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  bool ok = false;
  if (row_w == 0) {
    ok = tile_n == kWideBN;
    if (ok)
      launch_fprop<0, kWideBN>(buf, w, bias_a, b3, part, M, H, W, P, cin, g,
                               splits, slope, s);
  } else if (row_w == W) {
    if (W == 4)
      ok = launch_narrow<4>(tile_n, buf, w, bias_a, b3, part, M, H, W, P,
                            cin, g, splits, slope, s);
    else if (W == 2)
      ok = launch_narrow<2>(tile_n, buf, w, bias_a, b3, part, M, H, W, P,
                            cin, g, splits, slope, s);
    else if (W == 1)
      ok = launch_narrow<1>(tile_n, buf, w, bias_a, b3, part, M, H, W, P,
                            cin, g, splits, slope, s);
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

int dense_conv3x3_reduce_launch(float* buf, const float* part,
                                const float* bias_a, const float* b3, int M,
                                int H, int W, int P, int cin, int g,
                                int tile_n, int splits, float slope,
                                void* stream) {
  const int threads = 256;
  const int64_t n = (int64_t)M * g;
  const int np = (g + tile_n - 1) / tile_n * tile_n;
  if (n > 0)
    dense_conv3x3_splitk_reduce_kernel<<<(unsigned)((n + threads - 1) /
                                                    threads),
                                         threads, 0, (cudaStream_t)stream>>>(
        buf, part, bias_a, b3, M, H, W, P, cin, g, np, splits, slope);
  return (int)cudaGetLastError();
}

}  // extern "C"
