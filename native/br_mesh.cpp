// Berger-Rigoutsos tag clustering + Morton-order load balancing.
//
// Native (C++) grid-builder of the solver: the equivalent of the
// Chombo machinery the reference drives in SetGrids.cpp:54-132 —
// BRMeshRefine::regrid (tag clustering into boxes), domainSplit (base-level
// decomposition) and LoadBalance (box -> rank/device assignment). The
// reference gets these from the external Chombo library; here they are
// implemented from the published Berger-Rigoutsos (1991) clustering scheme:
// recursively split a tag bounding box at signature holes / steepest
// inflection points until every box meets the fill ratio, then align to the
// blocking factor and enforce the maximum box size.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in the image).

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <vector>

namespace {

struct Box {
  int lo[3];
  int hi[3];  // inclusive

  int size(int d) const { return hi[d] - lo[d] + 1; }
  long volume() const {
    return (long)size(0) * (long)size(1) * (long)size(2);
  }
};

struct Grid {
  const uint8_t* tags;
  int n[3];

  bool tag(int i, int j, int k) const {
    return tags[((long)i * n[1] + j) * n[2] + k] != 0;
  }
};

long count_tags(const Grid& g, const Box& b) {
  long c = 0;
  for (int i = b.lo[0]; i <= b.hi[0]; ++i)
    for (int j = b.lo[1]; j <= b.hi[1]; ++j)
      for (int k = b.lo[2]; k <= b.hi[2]; ++k)
        if (g.tag(i, j, k)) ++c;
  return c;
}

// shrink to the bounding box of the tags inside b; returns false if empty
bool bound_tags(const Grid& g, Box& b) {
  int lo[3] = {INT32_MAX, INT32_MAX, INT32_MAX};
  int hi[3] = {INT32_MIN, INT32_MIN, INT32_MIN};
  for (int i = b.lo[0]; i <= b.hi[0]; ++i)
    for (int j = b.lo[1]; j <= b.hi[1]; ++j)
      for (int k = b.lo[2]; k <= b.hi[2]; ++k)
        if (g.tag(i, j, k)) {
          int iv[3] = {i, j, k};
          for (int d = 0; d < 3; ++d) {
            lo[d] = std::min(lo[d], iv[d]);
            hi[d] = std::max(hi[d], iv[d]);
          }
        }
  if (hi[0] < lo[0]) return false;
  std::memcpy(b.lo, lo, sizeof lo);
  std::memcpy(b.hi, hi, sizeof hi);
  return true;
}

// tag signature (projection count) along direction d
std::vector<long> signature(const Grid& g, const Box& b, int d) {
  std::vector<long> sig(b.size(d), 0);
  for (int i = b.lo[0]; i <= b.hi[0]; ++i)
    for (int j = b.lo[1]; j <= b.hi[1]; ++j)
      for (int k = b.lo[2]; k <= b.hi[2]; ++k)
        if (g.tag(i, j, k)) {
          int iv[3] = {i, j, k};
          sig[iv[d] - b.lo[d]] += 1;
        }
  return sig;
}

// Find a split index in [lo+1, hi] (cut before the returned offset).
// Prefers a signature hole; falls back to the strongest Laplacian
// inflection of the signature; -1 if none usable.
int find_split(const std::vector<long>& sig) {
  const int nsig = (int)sig.size();
  // 1. holes (zero signature planes)
  int best_hole = -1, best_dist = -1;
  for (int s = 1; s < nsig - 1; ++s) {
    if (sig[s] == 0) {
      int dist = std::min(s, nsig - s);
      if (dist > best_dist) {
        best_dist = dist;
        best_hole = s;
      }
    }
  }
  if (best_hole >= 0) return best_hole;

  // 2. inflection: maximize |delta^2 sig| sign change magnitude
  long best_mag = 0;
  int best_inf = -1;
  std::vector<long> d2(nsig, 0);
  for (int s = 1; s < nsig - 1; ++s)
    d2[s] = sig[s - 1] - 2 * sig[s] + sig[s + 1];
  for (int s = 1; s < nsig - 2; ++s) {
    if ((d2[s] > 0 && d2[s + 1] < 0) || (d2[s] < 0 && d2[s + 1] > 0)) {
      long mag = std::abs(d2[s] - d2[s + 1]);
      int idx = s + 1;
      if (mag > best_mag) {
        best_mag = mag;
        best_inf = idx;
      }
    }
  }
  return best_inf;
}

void align_box(Box& b, int block, const Box& domain) {
  for (int d = 0; d < 3; ++d) {
    b.lo[d] = (b.lo[d] / block) * block;
    if (b.lo[d] < 0) b.lo[d] -= block;  // floor for negatives
    b.hi[d] = ((b.hi[d] + block) / block) * block - 1;
    b.lo[d] = std::max(b.lo[d], domain.lo[d]);
    b.hi[d] = std::min(b.hi[d], domain.hi[d]);
  }
}

void split_to_max_size(const Box& b, int max_size, std::vector<Box>& out) {
  int nchunks[3], base[3];
  for (int d = 0; d < 3; ++d)
    nchunks[d] = (b.size(d) + max_size - 1) / max_size;
  for (int ci = 0; ci < nchunks[0]; ++ci)
    for (int cj = 0; cj < nchunks[1]; ++cj)
      for (int ck = 0; ck < nchunks[2]; ++ck) {
        int c[3] = {ci, cj, ck};
        Box sub;
        bool ok = true;
        for (int d = 0; d < 3; ++d) {
          int len = b.size(d);
          int step = (len + nchunks[d] - 1) / nchunks[d];
          sub.lo[d] = b.lo[d] + c[d] * step;
          sub.hi[d] = std::min(b.lo[d] + (c[d] + 1) * step - 1, b.hi[d]);
          if (sub.hi[d] < sub.lo[d]) ok = false;
        }
        if (ok) out.push_back(sub);
      }
}

void br_recurse(const Grid& g, Box b, double fill_ratio, int max_depth,
                std::vector<Box>& out) {
  if (!bound_tags(g, b)) return;
  long ntags = count_tags(g, b);
  double fill = (double)ntags / (double)b.volume();
  if (fill >= fill_ratio || max_depth <= 0 || b.volume() <= 8) {
    out.push_back(b);
    return;
  }
  // split along the longest direction with a usable split point
  int order[3] = {0, 1, 2};
  std::sort(order, order + 3,
            [&](int a, int c) { return b.size(a) > b.size(c); });
  for (int t = 0; t < 3; ++t) {
    int d = order[t];
    if (b.size(d) < 4) continue;
    std::vector<long> sig = signature(g, b, d);
    int cut = find_split(sig);
    if (cut < 0) cut = b.size(d) / 2;  // median fallback
    Box left = b, right = b;
    left.hi[d] = b.lo[d] + cut - 1;
    right.lo[d] = b.lo[d] + cut;
    if (left.hi[d] < left.lo[d] || right.hi[d] < right.lo[d]) continue;
    br_recurse(g, left, fill_ratio, max_depth - 1, out);
    br_recurse(g, right, fill_ratio, max_depth - 1, out);
    return;
  }
  out.push_back(b);
}

// Morton (Z-order) key of a box centre for locality-preserving balancing
uint64_t morton_key(const Box& b) {
  uint64_t key = 0;
  uint32_t c[3];
  for (int d = 0; d < 3; ++d) c[d] = (uint32_t)((b.lo[d] + b.hi[d]) / 2);
  for (int bit = 0; bit < 21; ++bit)
    for (int d = 0; d < 3; ++d)
      key |= ((uint64_t)((c[d] >> bit) & 1)) << (3 * bit + d);
  return key;
}

}  // namespace

extern "C" {

// Cluster tags into boxes. tags: nx*ny*nz uint8 (C order, k fastest).
// out_boxes: capacity max_out * 6 ints (lo_i lo_j lo_k hi_i hi_j hi_k).
// Returns number of boxes produced, or -1 if capacity exceeded.
int br_cluster(const uint8_t* tags, int nx, int ny, int nz,
               double fill_ratio, int max_box_size, int block_factor,
               int* out_boxes, int max_out) {
  Grid g{tags, {nx, ny, nz}};
  Box whole{{0, 0, 0}, {nx - 1, ny - 1, nz - 1}};
  std::vector<Box> raw;
  br_recurse(g, whole, fill_ratio, 64, raw);

  std::vector<Box> boxes;
  for (Box b : raw) {
    align_box(b, block_factor, whole);
    if (b.size(0) > max_box_size || b.size(1) > max_box_size ||
        b.size(2) > max_box_size) {
      split_to_max_size(b, max_box_size, boxes);
    } else {
      boxes.push_back(b);
    }
  }

  // aligned boxes may overlap; keep deterministic order, drop exact dups
  std::sort(boxes.begin(), boxes.end(), [](const Box& a, const Box& b) {
    return std::memcmp(&a, &b, sizeof(Box)) < 0;
  });
  boxes.erase(std::unique(boxes.begin(), boxes.end(),
                          [](const Box& a, const Box& b) {
                            return std::memcmp(&a, &b, sizeof(Box)) == 0;
                          }),
              boxes.end());

  if ((int)boxes.size() > max_out) return -1;
  for (size_t i = 0; i < boxes.size(); ++i) {
    out_boxes[i * 6 + 0] = boxes[i].lo[0];
    out_boxes[i * 6 + 1] = boxes[i].lo[1];
    out_boxes[i * 6 + 2] = boxes[i].lo[2];
    out_boxes[i * 6 + 3] = boxes[i].hi[0];
    out_boxes[i * 6 + 4] = boxes[i].hi[1];
    out_boxes[i * 6 + 5] = boxes[i].hi[2];
  }
  return (int)boxes.size();
}

// Assign boxes to `n_ranks` shards: Morton-sort for locality, then greedy
// longest-processing-time balance on box volume (the role of Chombo's
// LoadBalance, SetGrids.cpp:57,126). out_assign: one rank id per box.
void morton_load_balance(const int* boxes, int n_boxes, int n_ranks,
                         int* out_assign) {
  std::vector<std::pair<uint64_t, int>> keyed(n_boxes);
  for (int i = 0; i < n_boxes; ++i) {
    Box b;
    for (int d = 0; d < 3; ++d) {
      b.lo[d] = boxes[i * 6 + d];
      b.hi[d] = boxes[i * 6 + 3 + d];
    }
    keyed[i] = {morton_key(b), i};
  }
  std::sort(keyed.begin(), keyed.end());

  std::vector<long> load(n_ranks, 0);
  // contiguous Morton chunks per rank, balanced by volume
  long total = 0;
  std::vector<long> vol(n_boxes);
  for (int i = 0; i < n_boxes; ++i) {
    Box b;
    for (int d = 0; d < 3; ++d) {
      b.lo[d] = boxes[i * 6 + d];
      b.hi[d] = boxes[i * 6 + 3 + d];
    }
    vol[i] = b.volume();
    total += vol[i];
  }
  double per_rank = (double)total / n_ranks;
  int rank = 0;
  long acc = 0;
  for (auto& kv : keyed) {
    int i = kv.second;
    if (acc > per_rank * (rank + 1) && rank + 1 < n_ranks) ++rank;
    out_assign[i] = rank;
    acc += vol[i];
  }
}

}  // extern "C"
