// Host build of the whole-piece probe's routine (probe_row.cuh).
//
// The CPU tests compile this with the system C++ compiler and hold its
// output against the plain version of ops/join.py and the JAX package. It
// runs each piece as probe.cu's threads do (probe_piece: the hash, the len
// sector, the key words and rank of each slot of the piece's length), so
// the hash, the read order and the slot compares are checked on a machine
// without a card.
#include "probe_row.cuh"

extern "C" {

// The contract of td_vocab_probe8 (probe.cu) on host memory.
void td_vocab_probe8_host(const int* k0, const int* k1, const int* k2,
                          const int* k3, const int* len, long long P,
                          const int* rows, unsigned mask, int* out) {
  for (long long i = 0; i < P; ++i)
    out[i] = td_probe::probe_piece(
        rows, mask, td_probe::Query{k0[i], k1[i], k2[i], k3[i], len[i]});
}

}  // extern "C"
