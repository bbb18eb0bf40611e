// serde — native Base64 + ciphertext-blob framing codec.
//
// C++ replacement for the reference's OpenSSL-BIO Base64 helpers
// (reference: lib/base64_utils.h:10,30) on the encrypted-weights hot path
// (~38 MB of Base64 ciphertext per client per round, SURVEY.md §6).
// Exposed as a C ABI for ctypes (ppqsflhe/runtime/native.py); the
// Python stdlib codec remains the fallback.
//
// Build: make -C ppqsflhe/runtime  →  lib/libserde.so

#include <cstddef>
#include <cstdint>
#include <cstring>

namespace {

const char kEnc[] =
    "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789+/";

int8_t kDec[256];
bool init_dec() {
  memset(kDec, -1, sizeof kDec);
  for (int i = 0; i < 64; ++i) kDec[(uint8_t)kEnc[i]] = (int8_t)i;
  kDec[(uint8_t)'='] = -2;
  return true;
}
const bool kInit = init_dec();

}  // namespace

extern "C" {

// Returns encoded length (no newlines, '=' padded). out must hold
// 4*ceil(n/3) bytes.
size_t b64_encode(const uint8_t* in, size_t n, char* out) {
  size_t o = 0, i = 0;
  for (; i + 3 <= n; i += 3) {
    uint32_t v = (uint32_t)in[i] << 16 | (uint32_t)in[i + 1] << 8 | in[i + 2];
    out[o++] = kEnc[(v >> 18) & 63];
    out[o++] = kEnc[(v >> 12) & 63];
    out[o++] = kEnc[(v >> 6) & 63];
    out[o++] = kEnc[v & 63];
  }
  size_t rem = n - i;
  if (rem == 1) {
    uint32_t v = (uint32_t)in[i] << 16;
    out[o++] = kEnc[(v >> 18) & 63];
    out[o++] = kEnc[(v >> 12) & 63];
    out[o++] = '=';
    out[o++] = '=';
  } else if (rem == 2) {
    uint32_t v = (uint32_t)in[i] << 16 | (uint32_t)in[i + 1] << 8;
    out[o++] = kEnc[(v >> 18) & 63];
    out[o++] = kEnc[(v >> 12) & 63];
    out[o++] = kEnc[(v >> 6) & 63];
    out[o++] = '=';
  }
  return o;
}

// Returns decoded length, or (size_t)-1 on malformed input. out must hold
// 3*ceil(n/4) bytes.
size_t b64_decode(const char* in, size_t n, uint8_t* out) {
  size_t o = 0;
  uint32_t acc = 0;
  int bits = 0;
  for (size_t i = 0; i < n; ++i) {
    int8_t d = kDec[(uint8_t)in[i]];
    if (d == -2) break;          // padding
    if (d < 0) return (size_t)-1;
    acc = (acc << 6) | (uint32_t)d;
    bits += 6;
    if (bits >= 8) {
      bits -= 8;
      out[o++] = (uint8_t)(acc >> bits);
    }
  }
  return o;
}

}  // extern "C"
