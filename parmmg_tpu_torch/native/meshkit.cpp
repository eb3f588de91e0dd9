// meshkit: host-side mesh kernels of the PyTorch/CUDA port (C++17, no deps).
//
// The port's own copy of the JAX package's native/meshkit.cpp, entry for
// entry and line for line in the code, so that both packages compute the
// same partitions and read the same arrays.  One difference: scan_medit
// returns 1 on a section it does not read, where the JAX copy stops there
// and returns what it read so far.  The entries:
//   - tet-tet adjacency via face hashing (MMG3D_hashTetra role,
//     used by the reference at libparmmg1.c:733);
//   - BFS greedy graph-growing partitioner (the METIS slot,
//     metis_pmmg.c:1271 role) with element weights;
//   - Medit ASCII fast scanner (inout_pmmg.c role): single pass,
//     manual float parsing;
//   - connected-component labelling over the dual graph.
//
// Plain C ABI for ctypes.  Built by parmmg_tpu_torch/native/__init__.py:
//   g++ -O3 -std=c++17 -shared -fPIC meshkit.cpp -o build/libmeshkit.so
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <queue>
#include <unordered_map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// adjacency: adja[4*t+f] = 4*t'+f' of the twin face, or -1
// ---------------------------------------------------------------------------
static inline uint64_t face_key(int64_t a, int64_t b, int64_t c) {
  // sort the triple, pack 21 bits each
  if (a > b) { int64_t t = a; a = b; b = t; }
  if (b > c) { int64_t t = b; b = c; c = t; }
  if (a > b) { int64_t t = a; a = b; b = t; }
  return (uint64_t(a) << 42) | (uint64_t(b) << 21) | uint64_t(c);
}

// faces of tet (IDIR convention: face f opposite vertex f)
static const int FDIR[4][3] = {{1, 2, 3}, {0, 3, 2}, {0, 1, 3}, {0, 2, 1}};

int build_adjacency(int64_t ne, const int32_t* tet, int32_t* adja) {
  std::unordered_map<uint64_t, int64_t> open;  // key -> 4*t+f of 1st side
  open.reserve(size_t(ne) * 2);
  for (int64_t s = 0; s < 4 * ne; ++s) adja[s] = -1;
  for (int64_t t = 0; t < ne; ++t) {
    const int32_t* v = tet + 4 * t;
    for (int f = 0; f < 4; ++f) {
      uint64_t k = face_key(v[FDIR[f][0]], v[FDIR[f][1]], v[FDIR[f][2]]);
      auto it = open.find(k);
      if (it == open.end()) {
        open.emplace(k, 4 * t + f);
      } else {
        int64_t other = it->second;
        adja[4 * t + f] = int32_t(other);
        adja[other] = int32_t(4 * t + f);
        open.erase(it);
      }
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// greedy graph-growing partitioner over the dual graph
// ---------------------------------------------------------------------------
int greedy_partition(int64_t ne, const int32_t* adja, const double* weights,
                     int32_t nparts, const int64_t* seeds, int32_t* part) {
  std::vector<std::queue<int64_t>> q(nparts);
  std::vector<double> load(nparts, 0.0);
  double total = 0.0;
  for (int64_t t = 0; t < ne; ++t) total += weights ? weights[t] : 1.0;
  for (int64_t t = 0; t < ne; ++t) part[t] = -1;
  for (int p = 0; p < nparts; ++p) q[p].push(seeds[p]);
  int64_t remaining = ne;
  while (remaining > 0) {
    // pick the least-loaded part with a non-empty queue
    int best = -1;
    for (int p = 0; p < nparts; ++p)
      if (!q[p].empty() && (best < 0 || load[p] < load[best])) best = p;
    if (best < 0) {
      // disconnected leftovers -> least-loaded part
      int lp = 0;
      for (int p = 1; p < nparts; ++p) if (load[p] < load[lp]) lp = p;
      for (int64_t t = 0; t < ne; ++t)
        if (part[t] == -1) { part[t] = lp; load[lp] += weights ? weights[t] : 1.0; --remaining; }
      break;
    }
    bool took = false;
    while (!q[best].empty()) {
      int64_t t = q[best].front(); q[best].pop();
      if (part[t] != -1) continue;
      part[t] = best;
      load[best] += weights ? weights[t] : 1.0;
      --remaining;
      for (int f = 0; f < 4; ++f) {
        int32_t a = adja[4 * t + f];
        if (a >= 0 && part[a / 4] == -1) q[best].push(a / 4);
      }
      took = true;
      break;
    }
    (void)took;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Medit ASCII fast scanner.
// Pass 1 (mode=0): returns counts in out_counts[0..2] = (np, ne, nt).
// Pass 2 (mode=1): fills vert[3*np], vref[np], tet[4*ne], tref[ne],
//                  tria[3*nt], triaref[nt] (tet/tria 1-based as in file).
// ---------------------------------------------------------------------------
static const char* skip_ws(const char* p, const char* end) {
  while (p < end) {
    if (*p == '#') { while (p < end && *p != '\n') ++p; }
    else if (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r') ++p;
    else break;
  }
  return p;
}

static const char* read_tok(const char* p, const char* end, const char** s,
                            int64_t* len) {
  p = skip_ws(p, end);
  *s = p;
  while (p < end && *p != ' ' && *p != '\t' && *p != '\n' && *p != '\r' &&
         *p != '#') ++p;
  *len = p - *s;
  return p;
}

int scan_medit(const char* buf, int64_t n, int mode, int64_t* out_counts,
               double* vert, int32_t* vref, int32_t* tet, int32_t* tref,
               int32_t* tria, int32_t* triaref) {
  const char* p = buf;
  const char* end = buf + n;
  int64_t np = 0, ne = 0, nt = 0;
  const char* s; int64_t L;
  while (p < end) {
    p = read_tok(p, end, &s, &L);
    if (L == 0) break;
    if (L == 3 && !strncmp(s, "End", 3)) break;
    if ((L == 20 && !strncmp(s, "MeshVersionFormatted", 20)) ||
        (L == 9 && !strncmp(s, "Dimension", 9))) {
      p = read_tok(p, end, &s, &L);
    } else if (L == 8 && !strncmp(s, "Vertices", 8)) {
      p = read_tok(p, end, &s, &L); np = strtoll(s, nullptr, 10);
      if (mode == 0) { // skip np * 4 tokens
        for (int64_t i = 0; i < np * 4; ++i) p = read_tok(p, end, &s, &L);
      } else {
        char* q;
        for (int64_t i = 0; i < np; ++i) {
          p = skip_ws(p, end);
          vert[3 * i]     = strtod(p, &q); p = q;
          vert[3 * i + 1] = strtod(p, &q); p = q;
          vert[3 * i + 2] = strtod(p, &q); p = q;
          vref[i] = int32_t(strtol(p, &q, 10)); p = q;
        }
      }
    } else if (L == 10 && !strncmp(s, "Tetrahedra", 10)) {
      p = read_tok(p, end, &s, &L); ne = strtoll(s, nullptr, 10);
      if (mode == 0) {
        for (int64_t i = 0; i < ne * 5; ++i) p = read_tok(p, end, &s, &L);
      } else {
        char* q;
        for (int64_t i = 0; i < ne; ++i) {
          p = skip_ws(p, end);
          for (int k = 0; k < 4; ++k) {
            tet[4 * i + k] = int32_t(strtol(p, &q, 10)); p = q;
          }
          tref[i] = int32_t(strtol(p, &q, 10)); p = q;
        }
      }
    } else if (L == 9 && !strncmp(s, "Triangles", 9)) {
      p = read_tok(p, end, &s, &L); nt = strtoll(s, nullptr, 10);
      if (mode == 0) {
        for (int64_t i = 0; i < nt * 4; ++i) p = read_tok(p, end, &s, &L);
      } else {
        char* q;
        for (int64_t i = 0; i < nt; ++i) {
          p = skip_ws(p, end);
          for (int k = 0; k < 3; ++k) {
            tria[3 * i + k] = int32_t(strtol(p, &q, 10)); p = q;
          }
          triaref[i] = int32_t(strtol(p, &q, 10)); p = q;
        }
      }
    } else {
      // a section this scanner does not read: the file is not one it can
      // size, so it says so and the caller reads the file another way
      return 1;
    }
  }
  out_counts[0] = np; out_counts[1] = ne; out_counts[2] = nt;
  return 0;
}

// connected-component labeling over the dual graph (contiguity checks,
// PMMG_check_contiguity role, moveinterfaces_pmmg.c:309)
int color_components(int64_t ne, const int32_t* adja, const int32_t* part,
                     int32_t* comp) {
  for (int64_t t = 0; t < ne; ++t) comp[t] = -1;
  int32_t nc = 0;
  std::vector<int64_t> stack;
  for (int64_t s0 = 0; s0 < ne; ++s0) {
    if (comp[s0] != -1) continue;
    comp[s0] = nc;
    stack.push_back(s0);
    while (!stack.empty()) {
      int64_t t = stack.back(); stack.pop_back();
      for (int f = 0; f < 4; ++f) {
        int32_t a = adja[4 * t + f];
        if (a >= 0) {
          int64_t u = a / 4;
          if (comp[u] == -1 && part[u] == part[t]) {
            comp[u] = nc;
            stack.push_back(u);
          }
        }
      }
    }
    ++nc;
  }
  return nc;
}

}  // extern "C"
