// Interleaved rANS encode and decode kernels for Hopper (sm_90a).
//
// They replace the JAX package's Pallas TPU kernels in
// codec/pallas_rans.py:
//   rans_encode_kernel  <- _encode_kernel (launched by pallas_encode_core)
//   rans_decode_kernel  <- _decode_kernel (pallas_decode_core, resident)
//                          and _decode_chunk_kernel (_pallas_decode_windowed):
//                          the word buffer simply stays in global memory,
//                          so one kernel covers every message length.
// The TPU kernels emulate the 64-bit state with uint32 limbs and realise the
// refill gather with lane shifts; here the state is a native uint64_t, the
// refill rank is a block-wide scan (warp shuffles + shared memory) and the
// words are read from global memory directly.
//
// What bounds them on this card: the k steps of each stream are a serial
// dependence chain (a 64-bit division per encode step, 13 dependent CDF
// evaluations per decode step), and a container offers only S streams of
// parallelism (S <= 768 at the flagship levels), so both kernels are bound
// by latency and occupancy, not by bytes or peak arithmetic rate.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC (no fast math: IEEE expf, '/'
//        and rintf, no contraction, so the CDF keeps the op order of
//        codec/cdf.py).  Each entry point launches on the stream it is given,
//        does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNbins = 2048;
constexpr float kInvGrid = 1.0f / 256.0f;
constexpr float kHalfBin = 0.5f / 256.0f;
constexpr float kPmax = 16775168.0f;  // 2^24 - 2048
constexpr uint64_t kMask32 = 0xFFFFFFFFull;
constexpr uint32_t kMask24 = 0xFFFFFFu;

// codec/cdf.py: CDF(v) in [0, 2^24].  One definition serves both kernels,
// so kernel-encoded messages decode with the kernel.
__device__ __forceinline__ uint32_t cdf_bits(int v, float mean, float scale,
                                             int lower) {
  float vf = (float)v * kInvGrid;
  float t = (vf + kHalfBin - mean) / scale;
  float sig = 1.0f / (1.0f + expf(-t));
  int part1 = (int)rintf(sig * kPmax);
  int part2 = v - lower + 1;
  return (uint32_t)(part1 + part2);
}

// One thread per stream; the thread walks the k steps.  Loads and stores
// of step t are contiguous across s, so they coalesce.
__global__ void rans_encode_kernel(const int32_t* __restrict__ v,
                                   const float* __restrict__ mean,
                                   const float* __restrict__ scale,
                                   const int32_t* __restrict__ lower,
                                   const int64_t* __restrict__ seeds,
                                   int64_t* __restrict__ words,
                                   int32_t* __restrict__ flags,
                                   int64_t* __restrict__ hi_out,
                                   int64_t* __restrict__ lo_out, int S,
                                   int k) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  // initial state 2^32 | seed (bits-back seeding; seed 0 when unseeded)
  uint64_t st = (1ull << 32) | (seeds ? ((uint64_t)seeds[s] & kMask32) : 0);
  for (int t = 0; t < k; ++t) {
    const size_t i = (size_t)t * S + s;
    const int vv = v[i];
    const float m = mean[i], sc = scale[i];
    const int lw = lower[i];
    const uint32_t c0 = cdf_bits(vv - 1, m, sc, lw);
    const uint64_t f = (uint64_t)(cdf_bits(vv, m, sc, lw) - c0);
    // renormalise: emit the low 32 bits when state >= f << 40
    const bool emit = (st >> 32) >= (f << 8);
    words[i] = emit ? (int64_t)(st & kMask32) : 0;
    flags[i] = emit ? 1 : 0;
    if (emit) st >>= 32;
    st = ((st / f) << 24) + (st % f) + c0;
  }
  hi_out[s] = (int64_t)(st >> 32);
  lo_out[s] = (int64_t)(st & kMask32);
}

// One CTA decodes one container.  Thread j owns streams
// [j * PER, (j + 1) * PER), so a block-wide exclusive scan over threads
// ranks the refilling streams in ascending stream order.
template <int PER>
__global__ void __launch_bounds__(1024) rans_decode_kernel(const int64_t* __restrict__ buf,
                                   int64_t nbuf,
                                   const int64_t* __restrict__ num_words,
                                   const int64_t* __restrict__ hi0,
                                   const int64_t* __restrict__ lo0,
                                   const float* __restrict__ mean,
                                   const float* __restrict__ scale,
                                   const int32_t* __restrict__ lower,
                                   int32_t* __restrict__ vals,
                                   int64_t* __restrict__ hi_out,
                                   int64_t* __restrict__ lo_out, int S,
                                   int k) {
  // double-buffered by step parity: a warp that runs ahead into step t - 1
  // writes the other buffer, and no warp can reach step t - 2 before every
  // warp has passed step t - 1's first barrier
  __shared__ int warp_sums[2][32];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;

  uint64_t st[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int s = tid * PER + i;
    st[i] = s < S ? (((uint64_t)hi0[s] & kMask32) << 32) |
                        ((uint64_t)lo0[s] & kMask32)
                  : (1ull << 32);  // padding streams never refill
  }
  int64_t ptr = *num_words;

  for (int t = k - 1; t >= 0; --t) {
    const int par = t & 1;
    // ---- refill: streams whose state fell below 2^32 pop one word each
    // from the tail of the buffer, in ascending stream order
    int local = 0;
#pragma unroll
    for (int i = 0; i < PER; ++i) local += (st[i] >> 32) == 0 ? 1 : 0;
    int incl = local;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31) warp_sums[par][warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int w = lane < nwarps ? warp_sums[par][lane] : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, w, o);
        if (lane >= o) w += y;
      }
      if (lane < nwarps) warp_sums[par][lane] = w;
    }
    __syncthreads();
    const int total = warp_sums[par][nwarps - 1];
    int rank = (warp > 0 ? warp_sums[par][warp - 1] : 0) + incl - local;
    const int64_t base = ptr - total;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      if ((st[i] >> 32) == 0) {
        const int64_t idx = base + rank;
        const uint64_t w =
            (idx >= 0 && idx < nbuf) ? ((uint64_t)buf[idx] & kMask32) : 0;
        st[i] = (st[i] << 32) | w;
        ++rank;
      }
    }
    ptr = base;

    // ---- symbol search and state update
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int s = tid * PER + i;
      if (s >= S) continue;
      const size_t j = (size_t)t * S + s;
      const float m = mean[j], sc = scale[j];
      const int lw = lower[j];
      const uint32_t mod = (uint32_t)(st[i] & kMask24);
      // smallest v with CDF(v) > mod: anchor a has CDF(a) <= mod and the
      // answer lies in (a, a + span]; 1 + 11 + 1 = 13 CDF evaluations
      int a = lw - 1;
      uint32_t c_a = cdf_bits(a, m, sc, lw);
      for (int span = kNbins / 2; span >= 1; span >>= 1) {
        const int p = a + span;
        const uint32_t cd = cdf_bits(p, m, sc, lw);
        if (cd <= mod) {
          a = p;
          c_a = cd;
        }
      }
      const int sym = a + 1;
      const uint32_t f = cdf_bits(sym, m, sc, lw) - c_a;
      vals[j] = sym;
      st[i] = (st[i] >> 24) * (uint64_t)f + (uint64_t)mod - (uint64_t)c_a;
    }
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int s = tid * PER + i;
    if (s < S) {
      hi_out[s] = (int64_t)(st[i] >> 32);
      lo_out[s] = (int64_t)(st[i] & kMask32);
    }
  }
}

__global__ void cdf_eval_kernel(const int32_t* __restrict__ v,
                                const float* __restrict__ mean,
                                const float* __restrict__ scale,
                                const int32_t* __restrict__ lower,
                                int64_t* __restrict__ out, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = cdf_bits(v[i], mean[i], scale[i], lower[i]);
}

}  // namespace

extern "C" {

int rans_encode_launch(const int32_t* v, const float* mean,
                       const float* scale, const int32_t* lower,
                       const int64_t* seeds, int64_t* words, int32_t* flags,
                       int64_t* hi, int64_t* lo, int S, int k, void* stream) {
  const int threads = 128;
  const int blocks = (S + threads - 1) / threads;
  rans_encode_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      v, mean, scale, lower, seeds, words, flags, hi, lo, S, k);
  return (int)cudaGetLastError();
}

// streams_per_thread is 1, 2, 4 or 8 and threads a multiple of 32 <= 1024
// with threads * streams_per_thread >= S (the wrapper picks them).
int rans_decode_launch(const int64_t* buf, int64_t nbuf,
                       const int64_t* num_words, const int64_t* hi0,
                       const int64_t* lo0, const float* mean,
                       const float* scale, const int32_t* lower,
                       int32_t* vals, int64_t* hi, int64_t* lo, int S, int k,
                       int threads, int streams_per_thread, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define LAUNCH(PER)                                                      \
  rans_decode_kernel<PER><<<1, threads, 0, st>>>(                        \
      buf, nbuf, num_words, hi0, lo0, mean, scale, lower, vals, hi, lo, S, \
      k)
  switch (streams_per_thread) {
    case 1: LAUNCH(1); break;
    case 2: LAUNCH(2); break;
    case 4: LAUNCH(4); break;
    case 8: LAUNCH(8); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef LAUNCH
  return (int)cudaGetLastError();
}

int cdf_eval_launch(const int32_t* v, const float* mean, const float* scale,
                    const int32_t* lower, int64_t* out, int64_t n,
                    void* stream) {
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  if (blocks > 0)
    cdf_eval_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        v, mean, scale, lower, out, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
