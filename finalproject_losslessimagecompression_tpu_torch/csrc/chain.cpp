// Variable-length state chaining for the LIC2 container
// (codec/container.py): the final states of streams 1..S-1 are coded into
// stream 0's state as uniform bit chunks (16 + 16 [+ top] + 5 bits per
// stream) with shift-only rANS ops.  These are bit-identical C++ forms of
// the Python `_uniform_push` / `_uniform_pop` loops in codec/container.py,
// which chain thousands of streams in a serial loop.
//
// Build: g++ -O3 -fPIC -shared -std=c++17 chain.cpp -o libchain.so

#include <stdint.h>

namespace {
constexpr uint64_t kMask32 = 0xFFFFFFFFull;
constexpr uint64_t kL = 1ull << 32;
}  // namespace

extern "C" {

// words[0:nw] already holds the encode output; chained words are appended.
// Returns the new word count, or -1 if cap is exceeded.
int chain_pack(int S, const uint64_t* states, uint32_t* words, int nw,
               int cap, uint64_t* state0_out) {
  uint64_t st = states[0];
  bool ok = true;
  auto push = [&](uint64_t chunk, int bits) {
    if (st >= (1ull << (64 - bits))) {
      if (nw >= cap) {
        ok = false;
        return;
      }
      words[nw++] = (uint32_t)(st & kMask32);
      st >>= 32;
    }
    st = (st << bits) | chunk;
  };
  for (int j = 1; j < S && ok; ++j) {
    const uint64_t sj = states[j];
    const int nb = 64 - __builtin_clzll(sj);  // states are >= 2^32: nb >= 33
    const int top = nb - 33;  // bits above the low 32, minus the leading 1
    push(sj & 0xFFFFull, 16);
    push((sj >> 16) & 0xFFFFull, 16);
    if (top > 0) push((sj >> 32) & ((1ull << top) - 1), top);
    push((uint64_t)(nb - 33), 5);
  }
  if (!ok) return -1;
  *state0_out = st;
  return nw;
}

// Inverse: recover S final states from the chained state0 and the word
// tail.  words[0:nw] is consumed from the tail; returns the remaining word
// count (the encode payload), or -1 on underflow.
int chain_unpack(int S, uint64_t state0, const uint32_t* words, int nw,
                 uint64_t* states_out) {
  uint64_t st = state0;
  bool ok = true;
  auto pop = [&](int bits) -> uint64_t {
    if (st < kL) {
      if (nw <= 0) {
        ok = false;
        return 0;
      }
      st = (st << 32) | (uint64_t)words[--nw];
    }
    const uint64_t chunk = st & ((1ull << bits) - 1);
    st >>= bits;
    return chunk;
  };
  for (int j = S - 1; j >= 1 && ok; --j) {
    const int nb = (int)pop(5) + 33;
    const int top_bits = nb - 33;
    const uint64_t top = top_bits > 0 ? pop(top_bits) : 0;
    const uint64_t c1 = pop(16);
    const uint64_t c0 = pop(16);
    states_out[j] = (1ull << (nb - 1)) | (top << 32) | (c1 << 16) | c0;
  }
  if (!ok) return -1;
  states_out[0] = st;
  return nw;
}

}  // extern "C"
