// Host-side rANS coder (C++): single-stream and interleaved, the port's
// own copy of the JAX package's native coder (native/rans.cpp), bound with
// ctypes by codec/host_rans.py.  The LIC2 state chain is csrc/chain.cpp.
//
//  - single-stream: 64-bit state in [2^32, 2^64), 32-bit word emission,
//    M = 2^24 quantized-logistic CDF over a 2048-bin window, binary-search
//    decode -- the coder of codec/oracle.py.
//  - interleaved: S streams round-robin over the symbols (symbol i ->
//    stream i % S) with one global word buffer in (step, stream) emission
//    order, serial per call.
//
// The CDF is evaluated in float32 with the host libm's expf, so a stream
// decodes on a host whose libm encoded it (the self-consistency contract of
// codec/cdf.py).
//
// Build: g++ -O3 -fPIC -shared -std=c++17 rans_host.cpp -o librans_host.so

#include <cmath>
#include <cstdint>
#include <vector>

namespace {

constexpr uint64_t kM = 1ull << 24;
constexpr int kPrecBits = 24;
constexpr int kNbins = 2048;
constexpr uint64_t kL = 1ull << 32;
constexpr uint64_t kMask32 = 0xffffffffull;
constexpr uint64_t kMask24 = 0xffffffull;

inline float logistic(float x) { return 1.0f / (1.0f + std::exp(-x)); }

inline int32_t lower_bin(float mean) {
  return (int32_t)std::nearbyintf(mean * 256.0f) - 1024;
}

// CDF(v) for integer bin v given (mean, scale, lower); codec/cdf.py's
// formula: rint(sigmoid((v/256 + 1/512 - mean)/scale) *
// (M - 2048)) + (v - lower) + 1, evaluated in float32.
inline uint32_t cdf_bits(int32_t v, float mean, float scale, int32_t lower) {
  float vf = (float)v * (1.0f / 256.0f);
  float t = (vf + 0.001953125f - mean) / scale;
  int32_t part1 = (int32_t)std::nearbyintf(logistic(t) * (float)(kM - kNbins));
  int32_t part2 = v - lower + 1;
  return (uint32_t)(part1 + part2);
}

}  // namespace

extern "C" {

// Encode n symbols with one stream starting from *state_io (usually 2^32).
// Emits 32-bit words into out_words (capacity cap). Returns word count, or
// -1 on overflow/invalid frequency.
int rans_encode_single(int n, const int32_t* v, const float* mean,
                       const float* scale, uint32_t* out_words, int cap,
                       uint64_t* state_io) {
  uint64_t state = *state_io;
  int nw = 0;
  for (int i = 0; i < n; ++i) {
    int32_t lo = lower_bin(mean[i]);
    uint64_t c0 = cdf_bits(v[i] - 1, mean[i], scale[i], lo);
    uint64_t c1 = cdf_bits(v[i], mean[i], scale[i], lo);
    uint64_t f = c1 - c0;
    if (f == 0 || f > kM) return -1;
    if (state >= (f << 40)) {
      if (nw >= cap) return -1;
      out_words[nw++] = (uint32_t)(state & kMask32);
      state >>= 32;
    }
    state = ((state / f) << kPrecBits) + (state % f) + c0;
  }
  *state_io = state;
  return nw;
}

// Decode n symbols (means/scales given in DECODE order = reverse of encode
// order); words consumed newest-first from the tail of (words, nwords).
// Returns remaining word count; final state written to state_io.
int rans_decode_single(int n, const float* mean, const float* scale,
                       const uint32_t* words, int nwords, int32_t* out_v,
                       uint64_t* state_io) {
  uint64_t state = *state_io;
  int pos = nwords;
  for (int i = 0; i < n; ++i) {
    if (state < kL) {
      if (pos <= 0) return -1;
      state = (state << 32) | (uint64_t)words[--pos];
    }
    uint64_t mod = state & kMask24;
    int32_t lo = lower_bin(mean[i]);
    int32_t hi = lo + kNbins - 1;
    int32_t lf = lo;
    while (lo <= hi) {
      int32_t mid = (lo + hi) >> 1;
      uint64_t c = cdf_bits(mid, mean[i], scale[i], lf);
      if (c > mod) hi = mid - 1; else lo = mid + 1;
    }
    int32_t s = lo;
    uint64_t c0 = cdf_bits(s - 1, mean[i], scale[i], lf);
    uint64_t c1 = cdf_bits(s, mean[i], scale[i], lf);
    uint64_t f = c1 - c0;
    state = (state >> kPrecBits) * f + mod - c0;
    out_v[i] = s;
  }
  *state_io = state;
  return pos;
}

// Interleaved multi-stream encode over S streams (symbol i -> stream i%S,
// inputs pre-padded to steps*S).  Emits one global word buffer in (step,
// stream) order; writes final states (hi, lo u32 pairs).  Returns word
// count or -1.
int rans_encode_interleaved(int steps, int S, const int32_t* v,
                            const float* mean, const float* scale,
                            uint32_t* out_words, int cap,
                            uint32_t* state_hi, uint32_t* state_lo) {
  std::vector<uint64_t> st(S, kL);
  int nw = 0;
  for (int t = 0; t < steps; ++t) {
    const int base = t * S;
    for (int s = 0; s < S; ++s) {
      const int i = base + s;
      int32_t lo = lower_bin(mean[i]);
      uint64_t c0 = cdf_bits(v[i] - 1, mean[i], scale[i], lo);
      uint64_t c1 = cdf_bits(v[i], mean[i], scale[i], lo);
      uint64_t f = c1 - c0;
      if (f == 0 || f > kM) return -1;
      uint64_t x = st[s];
      if (x >= (f << 40)) {
        if (nw >= cap) return -1;
        out_words[nw++] = (uint32_t)(x & kMask32);
        x >>= 32;
      }
      st[s] = ((x / f) << kPrecBits) + (x % f) + c0;
    }
  }
  for (int s = 0; s < S; ++s) {
    state_hi[s] = (uint32_t)(st[s] >> 32);
    state_lo[s] = (uint32_t)(st[s] & kMask32);
  }
  return nw;
}

// Interleaved decode: inputs in ENCODE order (steps*S means/scales); walks
// steps backwards popping refill words from the global buffer tail.
int rans_decode_interleaved(int steps, int S, const float* mean,
                            const float* scale, const uint32_t* words,
                            int nwords, int32_t* out_v, uint32_t* state_hi,
                            uint32_t* state_lo) {
  std::vector<uint64_t> st(S);
  for (int s = 0; s < S; ++s)
    st[s] = ((uint64_t)state_hi[s] << 32) | (uint64_t)state_lo[s];
  int pos = nwords;
  for (int t = steps - 1; t >= 0; --t) {
    const int base = t * S;
    // refill set must pop in reverse (stream-descending) order
    int need = 0;
    for (int s = 0; s < S; ++s) need += (st[s] < kL) ? 1 : 0;
    if (need > pos) return -1;
    int take = pos - need;
    pos -= need;
    for (int s = 0; s < S; ++s) {
      if (st[s] < kL) st[s] = (st[s] << 32) | (uint64_t)words[take++];
    }
    for (int s = 0; s < S; ++s) {
      const int i = base + s;
      uint64_t mod = st[s] & kMask24;
      int32_t lo = lower_bin(mean[i]);
      int32_t hi = lo + kNbins - 1;
      int32_t lf = lo;
      while (lo <= hi) {
        int32_t mid = (lo + hi) >> 1;
        uint64_t c = cdf_bits(mid, mean[i], scale[i], lf);
        if (c > mod) hi = mid - 1; else lo = mid + 1;
      }
      int32_t sym = lo;
      uint64_t c0 = cdf_bits(sym - 1, mean[i], scale[i], lf);
      uint64_t c1 = cdf_bits(sym, mean[i], scale[i], lf);
      uint64_t f = c1 - c0;
      st[s] = (st[s] >> kPrecBits) * f + mod - c0;
      out_v[i] = sym;
    }
  }
  for (int s = 0; s < S; ++s) {
    state_hi[s] = (uint32_t)(st[s] >> 32);
    state_lo[s] = (uint32_t)(st[s] & kMask32);
  }
  return pos;
}

}  // extern "C"
