// Interleaved rANS encode and decode kernels for Hopper (sm_90a).
//
// They replace the JAX package's Pallas TPU kernels in
// codec/pallas_rans.py:
//   rans_cdf_prepass_kernel <- the CDF evaluation inside _encode_kernel
//                              (:214-216, launched by pallas_encode_core)
//   rans_encode_kernel      <- the state loop of _encode_kernel
//   rans_decode_kernel      <- _decode_kernel (pallas_decode_core, resident)
//                              and _decode_chunk_kernel
//                              (_pallas_decode_windowed): the word buffer
//                              is windowed through shared memory, so one
//                              kernel covers every message length.
// One launch takes C containers of the same (S, k): a serving queue codes
// one level of all its batches in one launch of each kernel.
//
// What bounds them on this card.  They move few bytes; each stream is a
// chain of k dependent steps, so latency bounds the small containers and
// issue rate the large ones (one container is one CTA on one SM).
//   encode: the CDF is taken out of the chain by a fully parallel prepass
//     that writes (float64 1/f, c_start, f) per symbol.  The chain is then
//     compare, emit, divide, multiply-add per step, on records prefetched
//     kEncAhead steps ahead; the 64-bit division is a float64 estimate of
//     x / f corrected by one integer step (exact: q < 2^40, so the
//     estimate is off by less than one).  64 threads per CTA spread the
//     chains over SMs.
//   decode: the symbol search starts from an inverse-CDF guess
//     (fast-math logit, a hint only, clamped to the bounds the CDF's form
//     gives) and verifies the bracket CDF(g - 1) <= mod < CDF(g) with two
//     independent evaluations; a miss takes one more round of three
//     parallel evaluations and, rarely, a bisection.  That replaces 13
//     dependent evaluations with ~2 parallel ones per step; since every
//     step ends at a barrier, a miss in any warp stalls the CTA, so the
//     guess must hit nearly always.  No global load is on the per-step
//     chain: means, scales and lower bounds are prefetched into registers
//     AHEAD steps ahead, and the tail of the word buffer is kept in a
//     shared-memory ring refilled by cp.async DEPTH steps before the words
//     are popped.  Refills are ranked by warp ballots plus one
//     parity-buffered shared array and one barrier per step.  Streams are
//     strided across threads, so every global access is coalesced.

// The search is exact: for every mod in [0, 2^24) it returns what the
// bitwise binary search of codec/interleaved.py:_search returns,
// sym = clamp(smallest v with CDF(v) > mod, lower, lower + 2047),
// c_lo = CDF(sym - 1), f = CDF(sym) - c_lo, because CDF increases over the
// window (every bin has frequency >= 1; neighbouring bins' exp arguments
// differ by 2^-8 / scale, far above expf's error for any scale below 2^12).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC (no fast math: IEEE expf, '/'
//        and rintf, no contraction, so the CDF keeps the op order of
//        codec/cdf.py; only the search's guess uses __logf).  Each entry
//        point launches on the stream it is given, does not synchronise,
//        and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNbins = 2048;
constexpr float kInvGrid = 1.0f / 256.0f;
constexpr float kHalfBin = 0.5f / 256.0f;
constexpr float kPmax = 16775168.0f;  // 2^24 - 2048
constexpr uint64_t kMask32 = 0xFFFFFFFFull;
constexpr uint32_t kMask24 = 0xFFFFFFu;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kEncThreads = 64;
constexpr int kEncAhead = 4;
constexpr int kDecMaxThreads = 1024;

// codec/cdf.py: CDF(v) in [0, 2^24].  One definition serves every kernel,
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

// ---------------------------------------------------------------------------
// encode
// ---------------------------------------------------------------------------

// One symbol's coding record: 16 bytes, read by one vector load.
struct __align__(16) SymRec {
  double recip;  // 1.0 / freq, correctly rounded
  uint32_t c_start;
  uint32_t freq;
};

__global__ void rans_cdf_prepass_kernel(const int32_t* __restrict__ v,
                                        const float* __restrict__ mean,
                                        const float* __restrict__ scale,
                                        const int32_t* __restrict__ lower,
                                        SymRec* __restrict__ rec, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int vv = v[i];
  const float m = mean[i], sc = scale[i];
  const int lw = lower[i];
  const uint32_t c0 = cdf_bits(vv - 1, m, sc, lw);
  const uint32_t f = cdf_bits(vv, m, sc, lw) - c0;
  SymRec r;
  r.recip = 1.0 / (double)f;
  r.c_start = c0;
  r.freq = f;
  rec[i] = r;
}

// floor(x / f) and x % f for x < f * 2^40, 1 <= f < 2^24: the float64
// product has relative error < 3 * 2^-53, so with q < 2^40 it is off by
// less than one and one integer step corrects it
// (codec/interleaved.py:recip_divmod is the same arithmetic in Python).
__device__ __forceinline__ uint64_t div_recip(uint64_t x, uint64_t f,
                                              double recip, uint64_t& r) {
  uint64_t q = (uint64_t)((double)x * recip);
  int64_t rem = (int64_t)(x - q * f);
  if (rem < 0) {
    --q;
    rem += (int64_t)f;
  } else if (rem >= (int64_t)f) {
    ++q;
    rem -= (int64_t)f;
  }
  r = (uint64_t)rem;
  return q;
}

// One thread per stream of C containers of [k, S]; the thread walks the k
// steps on records prefetched kEncAhead steps ahead.  Loads and stores of
// step t are contiguous across s, so they coalesce.
__global__ void __launch_bounds__(kEncThreads)
    rans_encode_kernel(const SymRec* __restrict__ rec,
                       const int64_t* __restrict__ seeds,
                       int64_t* __restrict__ words,
                       int32_t* __restrict__ flags,
                       int64_t* __restrict__ hi_out,
                       int64_t* __restrict__ lo_out, int C, int S, int k) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= C * S) return;
  const int c = g / S;
  const size_t base = (size_t)c * k * S + (g - c * S);
  // initial state 2^32 | seed (bits-back seeding; seed 0 when unseeded)
  uint64_t st = (1ull << 32) | (seeds ? ((uint64_t)seeds[g] & kMask32) : 0);
  SymRec ahead[kEncAhead];
#pragma unroll
  for (int u = 0; u < kEncAhead; ++u)
    if (u < k) ahead[u] = rec[base + (size_t)u * S];
  for (int t0 = 0; t0 < k; t0 += kEncAhead) {
#pragma unroll
    for (int u = 0; u < kEncAhead; ++u) {
      const int t = t0 + u;
      if (t >= k) break;
      const SymRec r = ahead[u];
      if (t + kEncAhead < k) ahead[u] = rec[base + (size_t)(t + kEncAhead) * S];
      const uint64_t f = r.freq;
      const size_t i = base + (size_t)t * S;
      // renormalise: emit the low 32 bits when state >= f << 40
      const bool emit = (st >> 32) >= (f << 8);
      words[i] = emit ? (int64_t)(st & kMask32) : 0;
      flags[i] = emit ? 1 : 0;
      if (emit) st >>= 32;
      uint64_t rem;
      const uint64_t q = div_recip(st, f, r.recip, rem);
      st = (q << 24) + rem + r.c_start;
    }
  }
  hi_out[g] = (int64_t)(st >> 32);
  lo_out[g] = (int64_t)(st & kMask32);
}

// ---------------------------------------------------------------------------
// decode
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// 4-byte asynchronous copy into shared memory; zero-fills when !valid.
__device__ __forceinline__ void cp_async4(uint32_t* dst, const void* src,
                                          bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(__cvta_generic_to_global(src)), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Inverse-CDF guess of the smallest v with CDF(v) > mod, in
// [lower, lower + 2047]: 256 * (mean + scale * logit(p)) - 1/2 with
// p = (mod + 1/2 - (v - lower + 1)) / (2^24 - 2048), the linear term taken
// at the window's centre and then at the first guess.  Only a hint, but
// clamped to where the answer must lie: the sigmoid term of CDF is in
// [0, 2^24 - 2048], so the answer is in [lower + mod - (2^24 - 2048),
// lower + mod], and exactly at an end where the sigmoid is saturated (the
// window's flat tails, where the logit guess is far off).
__device__ __forceinline__ int guess_bin(uint32_t mod, float m, float sc,
                                         int lw) {
  const float u = (float)mod + 0.5f;
  const float centre = 256.0f * m - (float)lw;
  float lin = 1025.0f, d = 0.0f;
#pragma unroll
  for (int it = 0; it < 2; ++it) {
    const float p = fminf(fmaxf((u - lin) * (1.0f / kPmax), 0x1p-40f),
                          1.0f - 0x1p-24f);
    const float lg = __logf(p) - __logf(1.0f - p);
    // the guess relative to lower, clamped (a NaN becomes -1)
    d = fminf(fmaxf(centre + 256.0f * sc * lg - 0.5f, -1.0f), 2047.0f);
    lin = floorf(d) + 2.0f;
  }
  const int ramp_lo = (int)mod - (int)kPmax, ramp_hi = (int)mod;
  return lw + min(max((int)floorf(d) + 1, max(ramp_lo, 0)),
                  min(ramp_hi, kNbins - 1));
}

struct Found {
  int sym;
  uint32_t c_lo, c_hi;  // CDF(sym - 1), CDF(sym)
};

// The guess g missed: ca = CDF(g - 1), cb = CDF(g), up = the answer lies
// above g.  CDF rises by at least one per bin, so the answer lies within
// mod - cb + 1 bins above g (or ca - mod below g - 1): one round evaluates
// the next bin past the bracket and the pair at that bound together, which
// closes a near miss and a miss in the window's flat tails (where CDF rises
// by exactly one per bin and the logit guess is far off); bisection closes
// the rest.  lo keeps "lo == lower - 1 or CDF(lo) <= mod", hi keeps
// "hi == lower + 2047 or CDF(hi) > mod", each with its evaluated CDF.
__device__ __forceinline__ Found search_miss(uint32_t mod, float m, float sc,
                                             int lw, int g, uint32_t ca,
                                             uint32_t cb, bool up) {
  const int top = lw + kNbins - 1, bot = lw - 1;
  int lo, hi;
  uint32_t clo, chi;
  if (up) {
    const int far = g + (int)min((uint32_t)(top - g), mod - cb + 1);
    const uint32_t cn = cdf_bits(g + 1, m, sc, lw);
    const uint32_t cf0 = cdf_bits(far - 1, m, sc, lw);
    const uint32_t cf = cdf_bits(far, m, sc, lw);
    if (g + 1 == top || cn > mod) return Found{g + 1, cb, cn};
    lo = g + 1;
    clo = cn;
    hi = far;
    chi = cf;
    if (far - 1 > lo) {
      if (cf0 > mod) {
        hi = far - 1;
        chi = cf0;
      } else {
        lo = far - 1;
        clo = cf0;
      }
    }
  } else {
    const int far = g - 1 - (int)min((uint32_t)(g - 1 - bot), ca - mod);
    const uint32_t cn = cdf_bits(g - 2, m, sc, lw);
    const uint32_t cf = cdf_bits(far, m, sc, lw);
    const uint32_t cf1 = cdf_bits(far + 1, m, sc, lw);
    if (g - 2 == bot || cn <= mod) return Found{g - 1, cn, ca};
    hi = g - 2;
    chi = cn;
    lo = far;
    clo = cf;
    if (far + 1 < hi) {
      if (cf1 > mod) {
        hi = far + 1;
        chi = cf1;
      } else {
        lo = far + 1;
        clo = cf1;
      }
    }
  }
  while (hi - lo > 1) {
    const int p = lo + ((hi - lo) >> 1);
    const uint32_t cp = cdf_bits(p, m, sc, lw);
    if (cp > mod) {
      hi = p;
      chi = cp;
    } else {
      lo = p;
      clo = cp;
    }
  }
  return Found{hi, clo, chi};
}

// Out of line for small PER, where the call keeps the unrolled steps short;
// inlined for PER >= 4, where saving the many live registers around a call
// costs more than the code.
__device__ __noinline__ Found search_miss_call(uint32_t mod, float m,
                                               float sc, int lw, int g,
                                               uint32_t ca, uint32_t cb,
                                               bool up) {
  return search_miss(mod, m, sc, lw, g, ca, cb, up);
}

// One CTA decodes one container; blockIdx.x picks it among C.  Thread j
// owns streams j + i * blockDim.x for i < PER (slot i), so every load and
// store of a slot is contiguous across the warp, and streams ascend slot by
// slot, then by thread: a refill's rank is the refills of earlier slots
// plus those of earlier threads in its slot.
// AHEAD: steps of (mean, scale, lower) held in registers ahead of use.
// DEPTH: steps between a ring refill's cp.async and the words' first use.
// The ring holds RING = 2^k > (DEPTH + 2) * S words; at each step the
// words [ptr - (DEPTH + 1) * S, ptr) are resident or in flight.
template <int PER, int AHEAD, int DEPTH>
__global__ void __launch_bounds__(kDecMaxThreads)
    rans_decode_kernel(const int64_t* __restrict__ buf, int64_t nbuf,
                       const int64_t* __restrict__ num_words,
                       const int64_t* __restrict__ hi0,
                       const int64_t* __restrict__ lo0,
                       const float* __restrict__ mean,
                       const float* __restrict__ scale,
                       const int32_t* __restrict__ lower,
                       int32_t* __restrict__ vals,
                       int64_t* __restrict__ hi_out,
                       int64_t* __restrict__ lo_out, int S, int k,
                       int ring_mask) {
  extern __shared__ uint32_t ring[];
  // refills per warp and slot, parity-buffered by step: a warp that runs
  // ahead into step t - 1 writes the other half, and no warp reaches step
  // t - 2 before every warp has read step t's half and arrived at step
  // t - 1's barrier
  __shared__ int warp_cnt[2][PER][32];
  const int c = blockIdx.x;
  buf += (size_t)c * nbuf;
  hi0 += (size_t)c * S;
  lo0 += (size_t)c * S;
  hi_out += (size_t)c * S;
  lo_out += (size_t)c * S;
  const size_t tile = (size_t)c * k * S;
  mean += tile;
  scale += tile;
  lower += tile;
  vals += tile;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nthreads = blockDim.x;
  const int nwarps = nthreads >> 5;
  const unsigned lt = lanemask_lt();
  const int64_t lead = (int64_t)(DEPTH + 1) * S;

  uint64_t st[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int s = tid + i * nthreads;
    st[i] = s < S ? (((uint64_t)hi0[s] & kMask32) << 32) |
                        ((uint64_t)lo0[s] & kMask32)
                  : (1ull << 32);  // padding streams never refill
  }
  int64_t ptr = num_words[c];
  // words outside [0, nbuf) read as 0
  for (int64_t j = tid; j < lead; j += nthreads) {
    const int64_t idx = ptr - lead + j;
    ring[idx & ring_mask] =
        (idx >= 0 && idx < nbuf) ? (uint32_t)buf[idx] : 0u;
  }

  float pm[AHEAD][PER], ps[AHEAD][PER];
  int pl[AHEAD][PER];
#pragma unroll
  for (int u = 0; u < AHEAD; ++u) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int s = tid + i * nthreads, t = k - 1 - u;
      if (s < S && t >= 0) {
        const size_t j = (size_t)t * S + s;
        pm[u][i] = mean[j];
        ps[u][i] = scale[j];
        pl[u][i] = lower[j];
      }
    }
  }

  for (int t0 = k - 1; t0 >= 0; t0 -= AHEAD) {
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) {
      const int t = t0 - u;
      if (t < 0) break;
      const int par = t & 1;
      // ---- refill: streams whose state fell below 2^32 pop one word each
      // from the tail of the buffer, in ascending stream order
      int rank[PER];
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const unsigned b = __ballot_sync(kFull, (st[i] >> 32) == 0);
        rank[i] = __popc(b & lt);
        if (lane == 0) warp_cnt[par][i][warp] = __popc(b);
      }
      // this thread's ring copies issued DEPTH + 1 or more steps ago have
      // landed; the barrier publishes them and the warp counts
      cp_async_wait<DEPTH>();
      __syncthreads();
      int total = 0;
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int x = lane < nwarps ? warp_cnt[par][i][lane] : 0;
        rank[i] += __reduce_add_sync(kFull, lane < warp ? x : 0) + total;
        total += __reduce_add_sync(kFull, x);
      }
      const int64_t base = ptr - total;
#pragma unroll
      for (int i = 0; i < PER; ++i)
        if ((st[i] >> 32) == 0)
          st[i] = (st[i] << 32) | ring[(base + rank[i]) & ring_mask];
      // keep the next words below the resident window in flight
      for (int j = tid; j < total; j += nthreads) {
        const int64_t idx = base - lead + j;
        const bool in = idx >= 0 && idx < nbuf;
        cp_async4(&ring[idx & ring_mask], in ? (const void*)(buf + idx) : buf,
                  in);
      }
      cp_async_commit();
      ptr = base;

      // ---- symbol search (guess, then a verified bracket) and update
      constexpr int CH = PER < 2 ? PER : 2;  // searches interleaved at once
#pragma unroll
      for (int i0 = 0; i0 < PER; i0 += CH) {
        uint32_t mod[CH], ca[CH], cb[CH];
        int g[CH];
#pragma unroll
        for (int q = 0; q < CH; ++q) {
          const int i = i0 + q;
          mod[q] = (uint32_t)(st[i] & kMask24);
          if (tid + i * nthreads < S) {
            g[q] = guess_bin(mod[q], pm[u][i], ps[u][i], pl[u][i]);
            ca[q] = cdf_bits(g[q] - 1, pm[u][i], ps[u][i], pl[u][i]);
            cb[q] = cdf_bits(g[q], pm[u][i], ps[u][i], pl[u][i]);
          }
        }
#pragma unroll
        for (int q = 0; q < CH; ++q) {
          const int i = i0 + q;
          const int s = tid + i * nthreads;
          if (s >= S) continue;
          const int lw = pl[u][i];
          const bool ok_b = g[q] == lw + kNbins - 1 || cb[q] > mod[q];
          const bool nok_a = g[q] == lw || ca[q] <= mod[q];
          Found r{g[q], ca[q], cb[q]};
          if (!(ok_b && nok_a)) {
            if constexpr (PER >= 4)
              r = search_miss(mod[q], pm[u][i], ps[u][i], lw, g[q], ca[q],
                              cb[q], !ok_b);
            else
              r = search_miss_call(mod[q], pm[u][i], ps[u][i], lw, g[q],
                                   ca[q], cb[q], !ok_b);
          }
          vals[(size_t)t * S + s] = r.sym;
          st[i] = (st[i] >> 24) * (uint64_t)(r.c_hi - r.c_lo) +
                  (uint64_t)mod[q] - (uint64_t)r.c_lo;
          if (t - AHEAD >= 0) {
            const size_t j = (size_t)(t - AHEAD) * S + s;
            pm[u][i] = mean[j];
            ps[u][i] = scale[j];
            pl[u][i] = lower[j];
          }
        }
      }
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int s = tid + i * nthreads;
    if (s < S) {
      hi_out[s] = (int64_t)(st[i] >> 32);
      lo_out[s] = (int64_t)(st[i] & kMask32);
    }
  }
}

template <int PER, int AHEAD, int DEPTH>
cudaError_t launch_decode(const int64_t* buf, int64_t nbuf,
                          const int64_t* num_words, const int64_t* hi0,
                          const int64_t* lo0, const float* mean,
                          const float* scale, const int32_t* lower,
                          int32_t* vals, int64_t* hi, int64_t* lo, int C,
                          int S, int k, int threads, cudaStream_t stream) {
  int ring = 1;
  while (ring <= (DEPTH + 2) * S) ring <<= 1;
  const size_t smem = (size_t)ring * sizeof(uint32_t);
  auto kern = rans_decode_kernel<PER, AHEAD, DEPTH>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kern<<<C, threads, smem, stream>>>(buf, nbuf, num_words, hi0, lo0, mean,
                                     scale, lower, vals, hi, lo, S, k,
                                     ring - 1);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// measurement only (no launch counters): the kernels' CDF, and the latency
// of one step's irreducible chain
// ---------------------------------------------------------------------------

__global__ void cdf_eval_kernel(const int32_t* __restrict__ v,
                                const float* __restrict__ mean,
                                const float* __restrict__ scale,
                                const int32_t* __restrict__ lower,
                                int64_t* __restrict__ out, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = cdf_bits(v[i], mean[i], scale[i], lower[i]);
}

// One warp runs `steps` dependent steps of a coder's irreducible chain:
// decode (kind 0): one CDF evaluation at a bin taken from the state, then
// the 64-bit multiply-add; encode (kind 1): the renormalisation compare,
// the reciprocal division and the multiply-add.
__global__ void depth_probe_kernel(int kind, int steps, float mean,
                                   float scale, int lower, uint32_t freq,
                                   int64_t* __restrict__ out) {
  uint64_t st = (1ull << 32) | (threadIdx.x * 2654435761u);
  if (kind == 0) {
    for (int i = 0; i < steps; ++i) {
      const uint32_t mod = (uint32_t)(st & kMask24);
      const uint32_t c = cdf_bits(lower + (int)(mod & (kNbins - 1)), mean,
                                  scale, lower);
      st = (st >> 24) * (uint64_t)((c & 0xFFFFu) | 1u) + mod + c;
    }
  } else {
    const double recip = 1.0 / (double)freq;
    for (int i = 0; i < steps; ++i) {
      if ((st >> 32) >= ((uint64_t)freq << 8)) st >>= 32;
      uint64_t rem;
      const uint64_t q = div_recip(st, freq, recip, rem);
      st = (q << 24) + rem + (freq >> 1);
    }
  }
  out[threadIdx.x] = (int64_t)st;
}

}  // namespace

extern "C" {

// v, mean, scale, lower: n symbols; rec: n 16-byte records.
int rans_cdf_prepass_launch(const int32_t* v, const float* mean,
                            const float* scale, const int32_t* lower,
                            void* rec, int64_t n, void* stream) {
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  if (blocks > 0)
    rans_cdf_prepass_kernel<<<(unsigned)blocks, threads, 0,
                              (cudaStream_t)stream>>>(
        v, mean, scale, lower, (SymRec*)rec, n);
  return (int)cudaGetLastError();
}

// rec: [C, k, S] records; seeds [C, S] or null; outputs words, flags
// [C, k, S], hi, lo [C, S].
int rans_encode_launch(const void* rec, const int64_t* seeds, int64_t* words,
                       int32_t* flags, int64_t* hi, int64_t* lo, int C,
                       int S, int k, void* stream) {
  const int blocks = (C * S + kEncThreads - 1) / kEncThreads;
  rans_encode_kernel<<<blocks, kEncThreads, 0, (cudaStream_t)stream>>>(
      (const SymRec*)rec, seeds, words, flags, hi, lo, C, S, k);
  return (int)cudaGetLastError();
}

// buf [C, nbuf]; num_words [C]; hi0, lo0, hi, lo [C, S]; mean, scale,
// lower, vals [C, k, S].  streams_per_thread is 1, 2, 4 or 8 and threads a
// multiple of 32 <= 1024 with threads * streams_per_thread >= S (the
// wrapper picks them).
int rans_decode_launch(const int64_t* buf, int64_t nbuf,
                       const int64_t* num_words, const int64_t* hi0,
                       const int64_t* lo0, const float* mean,
                       const float* scale, const int32_t* lower,
                       int32_t* vals, int64_t* hi, int64_t* lo, int C, int S,
                       int k, int threads, int streams_per_thread,
                       void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define LAUNCH(PER, AHEAD, DEPTH)                                           \
  return (int)launch_decode<PER, AHEAD, DEPTH>(buf, nbuf, num_words, hi0,   \
                                               lo0, mean, scale, lower,     \
                                               vals, hi, lo, C, S, k,       \
                                               threads, st)
  switch (streams_per_thread) {
    case 1: LAUNCH(1, 8, 2);
    case 2: LAUNCH(2, 2, 2);
    case 4: LAUNCH(4, 1, 1);
    case 8: LAUNCH(8, 1, 1);
    default: return (int)cudaErrorInvalidValue;
  }
#undef LAUNCH
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

// out: 32 int64 (the final states, so the chain is not optimised away).
int depth_probe_launch(int kind, int steps, float mean, float scale,
                       int lower, int freq, int64_t* out, void* stream) {
  depth_probe_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(
      kind, steps, mean, scale, lower, (uint32_t)freq, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
