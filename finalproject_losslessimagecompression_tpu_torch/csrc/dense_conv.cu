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
// pixels by g = 42..48 output channels by K = 9 * cin (cin 9 to ~520):
// float32 FMA on the SIMT cores (TF32 is off for this codec, so the tensor
// cores are out), 67 TFLOP/s.  Each input value feeds 9 x 48 products, so
// it is compute-bound once cin passes a few channels; what stands between
// it and the FMA rate is shared memory's bandwidth (a thread's operands
// come from shared memory) and that M * g is small (16384 x 48 outputs at
// most) against 132 SMs.  What the design does about it:
//   - a thread owns a row segment of 8 pixels by 12 output channels (96
//     sums in registers).  For one input channel and one tap row it loads
//     the segment's 10 pixels (with the left and right halo) once and
//     multiplies them into all three horizontal taps: 288 FMAs for 10
//     scalar and 9 16-byte shared-memory loads.  A warp holds 8 segments
//     by the 4 channel groups; a block of 4 warps 32 segments (256 pixels
//     of whole rows) by 48 channels.  Segments tile each image row (the
//     last one of a row masked), so any width works.  Two blocks share an
//     SM, so a thread may hold 255 registers and spills none (three blocks
//     of 168 registers spilled and ran 16% slower on the bulk's layers).
//   - K runs as stages of (8 input channels, one tap row): cp.async copies
//     the segments' halo rows (zero-filled outside the image and past cin)
//     and the three taps' weights into a ring of 3 shared-memory stages.
//     A segment's halo row sits at a stride of 84 floats, which puts the
//     8 segments of a warp in distinct banks.
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
constexpr int kSegPx = 8;      // pixels of a row segment
constexpr int kHalo = kSegPx + 2;
constexpr int kSegs = 32;      // segments of a block tile
constexpr int kBN = 48;        // output channels of a block tile
constexpr int kTN = 12;        // output channels of a thread
constexpr int kKC = 8;         // input channels of a stage
constexpr int kSegStride = kHalo * kKC + 4;  // floats between segments
constexpr int kStages = 3;     // cp.async ring depth
constexpr int kTaps = 9;
constexpr int kALoads = kSegs * kHalo * (kKC / 4) / kThreads;
constexpr int kBLoads = 3 * kKC * kBN / kThreads;

static_assert(kSegs * kHalo * (kKC / 4) % kThreads == 0, "A loads");
static_assert(3 * kKC * kBN % kThreads == 0, "B loads");
static_assert(kSegs == 4 * 8 && kBN == 4 * kTN,
              "a warp: 8 segments x 4 channel groups");

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

struct Smem {
  float a[kStages][kSegs * kSegStride];  // [segment][10 pixels][8 channels]
  float b[kStages][3 * kKC * kBN];       // [tap column][channel][48 outputs]
  float bias[kBN * kTaps];               // a[n, t] of the tile's channels
  float b3[kBN];
};

// grid (ceil(rows * segments a row / 32), ceil(g / 48), splits), rows =
// N * H.  splits == 1: the epilogue writes the layer's channels; else each
// split writes its partial tile to part[split, m, n] (n over ceil(g / 48)
// * 48) for the reduce kernel.
__global__ void __launch_bounds__(kThreads, 2)
dense_conv3x3_fprop_kernel(float* buf, const float* __restrict__ w,
                           const float* __restrict__ bias_a,
                           const float* __restrict__ b3,
                           float* __restrict__ part, int M, int H, int W,
                           int P, int cin, int g, float slope) {
  __shared__ __align__(16) Smem sm;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int rows = M / W;
  const int xb_row = (W + kSegPx - 1) / kSegPx;  // segments of a row
  const int seg0 = blockIdx.x * kSegs;
  const int n0 = blockIdx.y * kBN;
  const int splits = gridDim.z;
  const int total = (cin + kKC - 1) / kKC * 3;  // stages: chunk x tap row
  const int s_begin = (int)((int64_t)total * blockIdx.z / splits);
  const int s_end = (int)((int64_t)total * (blockIdx.z + 1) / splits);
  const int nst = s_end - s_begin;

  // this thread's cp16 copies of a stage (segment, halo pixel, quad): the
  // pixel's index, and bit 3 u + dy + 1 of `lrows` set where the pixel
  // exists and its row y + dy is inside the image
  int lpix[kALoads];
  unsigned lrows = 0;
#pragma unroll
  for (int u = 0; u < kALoads; ++u) {
    const int e = tid + kThreads * u;
    const int s = e / (2 * kHalo), j = (e % (2 * kHalo)) >> 1;
    const int gs = seg0 + s, r = gs / xb_row;
    const int x = (gs % xb_row) * kSegPx + j - 1;
    lpix[u] = r * W + x;
    if (r < rows && (unsigned)x < (unsigned)W) {
      const int y = r % H;
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
    for (int u = 0; u < kALoads; ++u) {
      const int e = tid + kThreads * u;
      const int s = e / (2 * kHalo), rem = e % (2 * kHalo);
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
    for (int v = 0; v < kBLoads; ++v) {
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

  // this thread's outputs: segment seg, channels ns .. ns + 11
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
#pragma unroll 2
    for (int k = 0; k < kKC; ++k) {
      float a[kHalo];
#pragma unroll
      for (int j = 0; j < kHalo; ++j) a[j] = as[j * kKC + k];
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const float4* br =
            reinterpret_cast<const float4*>(bs + (dx * kKC + k) * kBN);
        const float4 q0 = br[0], q1 = br[1], q2 = br[2];
        const float b[kTN] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y,
                              q1.z, q1.w, q2.x, q2.y, q2.z, q2.w};
#pragma unroll
        for (int j = 0; j < kSegPx; ++j)
#pragma unroll
          for (int n = 0; n < kTN; ++n)
            acc[j][n] = fmaf(a[j + dx], b[n], acc[j][n]);
      }
    }
  }
  cp_wait<0>();

  const int gs = seg0 + seg, r = gs / xb_row;
  const int x0 = (gs % xb_row) * kSegPx;
  if (r >= rows) return;
  if (splits > 1) {
    const int np = gridDim.y * kBN;
#pragma unroll
    for (int j = 0; j < kSegPx; ++j) {
      if (x0 + j >= W) break;
      const int m = r * W + x0 + j;
      float4* dst = reinterpret_cast<float4*>(
          part + ((size_t)blockIdx.z * M + m) * np + n0 + ns);
#pragma unroll
      for (int q = 0; q < kTN / 4; ++q)
        dst[q] = make_float4(acc[j][4 * q], acc[j][4 * q + 1],
                             acc[j][4 * q + 2], acc[j][4 * q + 3]);
    }
    return;
  }
  // the bias tables were written before the main loop's first barrier
  const int y = r % H;
#pragma unroll
  for (int j = 0; j < kSegPx; ++j) {
    if (x0 + j >= W) break;
    float* out = buf + ((size_t)r * W + x0 + j) * P + cin + n0 + ns;
#pragma unroll
    for (int n = 0; n < kTN; ++n) {
      if (n0 + ns + n >= g) break;
      const float t = sm.b3[ns + n] +
                      bias_field(&sm.bias[(ns + n) * kTaps], y, x0 + j, H, W);
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

}  // namespace

extern "C" {

// buf: [M = N*H*W, P] float32 (P % 4 == 0, 16-byte aligned); w [9, cin, g];
// bias_a [g, 9]; b3 [g]; part: splits * M * ceil(g / 48) * 48 floats when
// splits > 1 (else unused).
int dense_conv3x3_launch(float* buf, const float* w, const float* bias_a,
                         const float* b3, float* part, int M, int H, int W,
                         int P, int cin, int g, int splits, float slope,
                         void* stream) {
  const int64_t segs = (int64_t)(M / W) * ((W + kSegPx - 1) / kSegPx);
  const dim3 grid((unsigned)((segs + kSegs - 1) / kSegs),
                  (g + kBN - 1) / kBN, splits);
  if (M > 0 && g > 0)
    dense_conv3x3_fprop_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        buf, w, bias_a, b3, part, M, H, W, P, cin, g, slope);
  return (int)cudaGetLastError();
}

int dense_conv3x3_reduce_launch(float* buf, const float* part,
                                const float* bias_a, const float* b3, int M,
                                int H, int W, int P, int cin, int g,
                                int splits, float slope, void* stream) {
  const int threads = 256;
  const int64_t n = (int64_t)M * g;
  const int np = (g + kBN - 1) / kBN * kBN;
  if (n > 0)
    dense_conv3x3_splitk_reduce_kernel<<<(unsigned)((n + threads - 1) /
                                                    threads),
                                         threads, 0, (cudaStream_t)stream>>>(
        buf, part, bias_a, b3, M, H, W, P, cin, g, np, splits, slope);
  return (int)cudaGetLastError();
}

}  // extern "C"
