// Host build of the device merge's row routines (merge_row.cuh).
//
// The CPU tests compile this with the system C++ compiler and hold its
// output against the plain loop of ops/merge.py. It runs each row as
// merge.cu's merge_rows_group runs it on G lanes, the lanes one after
// another: init_row, every lane's lane_min, then until no pair is left the
// first of the lanes' minima (what the card's shuffles or reductions
// find), read_step, the two lookups, splice and lane_min on the lanes the
// step touched. So the lookups, the first round, the byte links, the
// column ownership, the tie order and the splice are checked on a machine
// without a card; the shuffles and reductions are checked on the card.
#include <stdint.h>

#include <vector>

#include "merge_row.cuh"

extern "C" {

// The contract of td_merge_rows (merge.cu) on host memory, each row on G
// lanes (1..32); returns 0, or 1 for a width outside 1..256 or a G
// outside 1..32.
int td_merge_rows_host(const uint8_t* bytes, const int* lengths, int R,
                       int C, const int* byte_rank, const int* rows,
                       unsigned mask, const int* lut, int* tok, int* counts,
                       int G) {
  if (C < 1 || C > 256 || G < 1 || G > 32) return 1;
  std::vector<int> t(C), p(C), mr(G), mc(G);
  std::vector<uint8_t> nxt(C), prv(C);
  const td_merge::Row<1> row{t.data(), p.data(), nxt.data(), prv.data()};
  for (long long r = 0; r < R; ++r) {
    const uint8_t* src = bytes + r * C;
    const int L = lengths[r] < 0 ? 0 : (lengths[r] > C ? C : lengths[r]);
    td_merge::init_row(row, src, L, C, 0, 1, byte_rank, rows, mask, lut,
                       [] {});
    for (int j = 0; j < G; ++j)
      td_merge::lane_min<256>(row, j, G, C, mr[j], mc[j]);
    while (true) {
      int v = mr[0], b = mc[0];
      for (int j = 1; j < G; ++j)
        if (td_merge::before(mr[j], mc[j], v, b)) {
          v = mr[j];
          b = mc[j];
        }
      if (v == td_merge::kMaxRank) break;
      const td_merge::Step s = td_merge::read_step(row, b, v);
      const int right = td_merge::lookup(rows, mask, v, s.t3);
      const int left = td_merge::lookup(rows, mask, s.tp, v);
      td_merge::splice(row, s, right);
      if (s.p >= 0) row.p(s.p) = left;
      for (int j = 0; j < G; ++j)
        if (td_merge::touched(s, j, G))
          td_merge::lane_min<256>(row, j, G, C, mr[j], mc[j]);
    }
    int live = 0;
    for (int c = 0; c < C; ++c) {
      tok[r * C + c] = t[c];
      live += t[c] >= 0;
    }
    counts[r] = live;
  }
  return 0;
}

}  // extern "C"
