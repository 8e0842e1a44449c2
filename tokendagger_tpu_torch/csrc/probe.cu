// The whole-piece probe: each piece's key words and length -> its rank in
// the vhash8 table, or -1.
//
// Replaces the XLA program of tokendagger_tpu/ops/join.py:339
// (vocab_probe8t_chunks, body _probe8t_core at :287; vocab_probe8 at :252
// is the same function untransposed). There is no pallas_call: XLA fuses
// the bucket hash, a row gather materialized transposed in 16 chunks, and
// 40 slice compares. Per piece (k0..k3, len) of any leading shape:
//   row = rows[mix(a, b)], a = k0 * 0x85EBCA77 + k2 * 31 + len * 131,
//   b = k1 * 0xC2B2AE3D + k3 * 31 (uint32);
//   out = the largest rank of the row's slots whose four words and length
//   equal the piece's, -1 if none does.
// Bit-identical to vocab_probe8_plain in ops/join.py. The per-piece
// routines live in probe_row.cuh, which the CPU tests also build for the
// host (probe_host.cpp).
//
// What bounds it on the H100: one dependent gather a piece into a table of
// 2^18 rows of 192 B (50.3 MB, about the size of the L2), keyed by a hash
// of 20 B of streamed keys, and 4 B out. The bytes bound counts the keys,
// the output and each table row the data touches, once. The plain torch
// version writes the gathered (P, 48) rows to memory (537 MB at
// 8 x 349,568 pieces) and reads them back in five strided compares.
//
// The design:
// * One thread a piece: it reads the piece's len sector in two 16-byte
//   loads, then the key words of each slot of the piece's length, then
//   the rank of a slot whose words all match. A piece of no length in its
//   row reads one sector of the row; a hit reads six.
// * The keys and the output stream past the table with evict-first hints
//   (__ldcs, __stcs), so that the keys do not push the table out of L2.
//   Table reads go through the read-only cache (__ldg): hot tokens hit L1.
// * Dead slots (len 0) take the same path. Their keys are 0, so they all
//   read one row, whose len sector no vocabulary slot matches (empty slots
//   hold -1). There is no shortcut for them, so the kernel equals the
//   plain version on any table, one with an empty token too.
// Measured on the H100 (tools/probe_variants.py, at 8 x 349,568 pieces of
// ASCII and multi-script text and a 4 MB window's 1,398,144; PERF.md
// section 6): one thread a piece takes 0.044 ms where 8 lanes a piece
// (lane s reading slot s) take 0.107, since 8 lanes hash and load each
// query 8 times; reading the row whole costs 1.6x; a persisting L2 window
// on the table 1.2-1.4x; the evict-first hints gain 0-4%, 128-thread
// blocks 1-3%; loading the rank with the keys gains nothing. With no read
// past the len sector it takes 0.022 ms, with no table read 0.020 ms,
// about the bytes bound of its streamed keys and output: the hits' key
// and rank reads are the rest.
#include <cuda_runtime.h>

#include "probe_row.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
vocab_probe8_kernel(const int* __restrict__ k0, const int* __restrict__ k1,
                    const int* __restrict__ k2, const int* __restrict__ k3,
                    const int* __restrict__ len, long long P,
                    const int* __restrict__ rows, unsigned mask,
                    int* __restrict__ out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= P) return;
  const td_probe::Query q{__ldcs(k0 + i), __ldcs(k1 + i), __ldcs(k2 + i),
                          __ldcs(k3 + i), __ldcs(len + i)};
  __stcs(out + i, td_probe::probe_piece(rows, mask, q));
}

}  // namespace

extern "C" {

// k0..k3 and len: P int32 each (key words as uint32 bits; a shape of any
// rank, flattened); rows the (mask + 1, 48) int32 vhash8 table, 16-byte
// aligned; writes out, P int32.
int td_vocab_probe8(const void* k0, const void* k1, const void* k2,
                    const void* k3, const void* len, long long P,
                    const void* rows, unsigned mask, void* out,
                    void* stream) {
  if (P <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const long long blocks = (P + kThreads - 1) / kThreads;
  vocab_probe8_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
      (const int*)k0, (const int*)k1, (const int*)k2, (const int*)k3,
      (const int*)len, P, (const int*)rows, mask, (int*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
