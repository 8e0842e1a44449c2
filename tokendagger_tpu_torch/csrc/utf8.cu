// K9: per-byte UTF-8 decode, bytes -> (codepoint at the byte, lead flag).
//
// Replaces the Pallas kernel of tokendagger_tpu/ops/pallas_scan.py:91
// (utf8_decode_block, kernel `_kernel` at :45-66). Per byte b with its
// next three bytes b1..b3 (0 past the end of the row, as the kernel's zero
// halo rows give them):
//   cp_at    = b < 0x80 ? b : b < 0xE0 ? 2-byte form : b < 0xF0 ? 3-byte
//              form : 4-byte form, clipped to 0x10FFFF (a 0xF8-0xFF lead
//              takes the 4-byte form, a stray continuation the 2-byte one);
//   is_start = (b & 0xC0) != 0x80.
// The TPU kernel worked on (64, 128) byte tiles with column rolls and an
// 8-row halo block because Mosaic has no misaligned neighbour loads; here
// each thread reads its byte and the next three directly.
//
// What bounds it on the H100: bytes. It reads 1 byte and writes 8 per
// input byte; the four neighbouring loads of a warp share cache lines.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void utf8_decode_kernel(const uint8_t* data, long long total,
                                   long long n, int32_t* cp_at,
                                   int32_t* is_start) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long left = n - 1 - i % n;  // bytes after i in its row
  const uint32_t b = data[i];
  const uint32_t b1 = left >= 1 ? data[i + 1] : 0u;
  const uint32_t b2 = left >= 2 ? data[i + 2] : 0u;
  const uint32_t b3 = left >= 3 ? data[i + 3] : 0u;
  uint32_t cp;
  if (b < 0x80u) {
    cp = b;
  } else if (b < 0xE0u) {
    cp = ((b & 0x1Fu) << 6) | (b1 & 0x3Fu);
  } else if (b < 0xF0u) {
    cp = ((b & 0x0Fu) << 12) | ((b1 & 0x3Fu) << 6) | (b2 & 0x3Fu);
  } else {
    cp = ((b & 0x07u) << 18) | ((b1 & 0x3Fu) << 12) | ((b2 & 0x3Fu) << 6) |
         (b3 & 0x3Fu);
  }
  cp_at[i] = (int32_t)(cp < 0x10FFFFu ? cp : 0x10FFFFu);
  is_start[i] = (b & 0xC0u) != 0x80u;
}

}  // namespace

extern "C" {

// data (B, N) uint8; cp_at and is_start (B, N) int32. Rows are decoded
// independently: neighbours past the end of a row read as 0.
int td_utf8_decode_block(const void* data, int B, long long N, void* cp_at,
                         void* is_start, void* stream) {
  const long long total = (long long)B * N;
  if (total == 0) return 0;
  const long long blocks = (total + kThreads - 1) / kThreads;
  utf8_decode_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)data, total, N, (int32_t*)cp_at, (int32_t*)is_start);
  return (int)cudaGetLastError();
}

}  // extern "C"
