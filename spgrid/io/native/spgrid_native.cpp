// spgrid native host library: parallel matrix parsing, COO->CSR, features.
//
// Native rebuild of the reference's compute-heavy host components:
//   - .mtx reader with symmetry expansion & field types
//     (ref: lib/storage_formats/matrix_market/matrix_market.c:249-342)
//   - .smtx (DLMC CSR text) reader
//     (ref: lib/storage_formats/dlcm_matrices/dlcm_matrix.c)
//   - COO->CSR conversion (ref: lib/aux/csr_converter_double.h)
//   - structural feature extraction
//     (ref: lib/storage_formats/csr_util/csr_util_gen.c:269-611)
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this image).
// Parallelism: OpenMP chunked parsing over newline-aligned file splits,
// mirroring the reference's lib/parallel_io.c design.

#include <algorithm>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#else
static int omp_get_max_threads() { return 1; }
static int omp_get_thread_num() { return 0; }
#endif

extern "C" {

typedef struct {
  int64_t m, k, nnz;
  int32_t *row_ptr;   // m+1
  int32_t *col_idx;   // nnz
  double *values;     // nnz
  int32_t field;      // 0 real / 1 integer / 2 pattern / 3 complex
  int32_t symmetry;   // 0 general / 1 symmetric / 2 skew / 3 hermitian
  char error[256];
} sg_csr;

static sg_csr *sg_alloc() {
  sg_csr *r = (sg_csr *)calloc(1, sizeof(sg_csr));
  return r;
}

void sg_free(sg_csr *r) {
  if (!r) return;
  free(r->row_ptr);
  free(r->col_idx);
  free(r->values);
  free(r);
}

// ---------------------------------------------------------------------------
// File slurp
// ---------------------------------------------------------------------------

static char *read_file(const char *path, size_t *len_out) {
  FILE *f = fopen(path, "rb");
  if (!f) return nullptr;
  fseek(f, 0, SEEK_END);
  long len = ftell(f);
  fseek(f, 0, SEEK_SET);
  char *buf = (char *)malloc((size_t)len + 1);
  if (!buf) { fclose(f); return nullptr; }
  size_t rd = fread(buf, 1, (size_t)len, f);
  fclose(f);
  buf[rd] = '\0';
  *len_out = rd;
  return buf;
}

// Fast inline parsers (no locale, no strtod overhead for ints).
static inline const char *skip_ws(const char *p, const char *end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
  return p;
}

static inline const char *parse_i64(const char *p, const char *end,
                                    int64_t *out) {
  p = skip_ws(p, end);
  bool neg = false;
  if (p < end && (*p == '-' || *p == '+')) neg = (*p++ == '-');
  int64_t v = 0;
  while (p < end && *p >= '0' && *p <= '9') v = v * 10 + (*p++ - '0');
  *out = neg ? -v : v;
  return p;
}

static inline const char *parse_f64(const char *p, const char *end,
                                    double *out) {
  p = skip_ws(p, end);
  char *q;
  *out = strtod(p, &q);
  return q > p ? q : p;
}

// ---------------------------------------------------------------------------
// COO -> CSR (counting sort by row; column sort within rows)
// ref: lib/aux/csr_converter_double.h used at spmv_bench.cpp:823
// ---------------------------------------------------------------------------

static void coo_to_csr_fill(int64_t m, int64_t nnz, const int32_t *rows,
                            const int32_t *cols, const double *vals,
                            int32_t *row_ptr, int32_t *col_idx,
                            double *values) {
  std::vector<int64_t> cnt((size_t)m + 1, 0);
  for (int64_t i = 0; i < nnz; ++i) cnt[(size_t)rows[i] + 1]++;
  for (int64_t i = 0; i < m; ++i) cnt[(size_t)i + 1] += cnt[(size_t)i];
  for (int64_t i = 0; i <= m; ++i) row_ptr[i] = (int32_t)cnt[(size_t)i];
  std::vector<int64_t> fill(cnt.begin(), cnt.end() - 1);
  for (int64_t i = 0; i < nnz; ++i) {
    int64_t p = fill[(size_t)rows[i]]++;
    col_idx[p] = cols[i];
    values[p] = vals[i];
  }
  // sort columns within each row (insertion for short rows, else qsort pair)
#pragma omp parallel for schedule(dynamic, 1024)
  for (int64_t r = 0; r < m; ++r) {
    int64_t s = row_ptr[r], e = row_ptr[r + 1];
    for (int64_t i = s + 1; i < e; ++i) {
      int32_t c = col_idx[i];
      double v = values[i];
      int64_t j = i - 1;
      while (j >= s && col_idx[j] > c) {
        col_idx[j + 1] = col_idx[j];
        values[j + 1] = values[j];
        --j;
      }
      col_idx[j + 1] = c;
      values[j + 1] = v;
    }
  }
}

// ---------------------------------------------------------------------------
// MatrixMarket reader
// ---------------------------------------------------------------------------

sg_csr *sg_read_mtx(const char *path, int expand_symmetry,
                    double pattern_dummy) {
  sg_csr *r = sg_alloc();
  size_t len = 0;
  char *buf = read_file(path, &len);
  if (!buf) {
    snprintf(r->error, sizeof r->error, "cannot open %s", path);
    return r;
  }
  const char *p = buf, *end = buf + len;

  // header line
  if (strncmp(p, "%%MatrixMarket", 14) != 0) {
    snprintf(r->error, sizeof r->error, "not a MatrixMarket file");
    free(buf);
    return r;
  }
  const char *nl = (const char *)memchr(p, '\n', (size_t)(end - p));
  std::string header(p, nl ? nl : end);
  for (auto &c : header) c = (char)tolower(c);
  int field = 0, symmetry = 0;
  if (header.find("integer") != std::string::npos) field = 1;
  else if (header.find("pattern") != std::string::npos) field = 2;
  else if (header.find("complex") != std::string::npos) field = 3;
  if (header.find("skew-symmetric") != std::string::npos) symmetry = 2;
  else if (header.find("symmetric") != std::string::npos) symmetry = 1;
  else if (header.find("hermitian") != std::string::npos) symmetry = 3;
  if (header.find("coordinate") == std::string::npos) {
    snprintf(r->error, sizeof r->error, "only coordinate format supported");
    free(buf);
    return r;
  }
  r->field = field;
  r->symmetry = symmetry;
  p = nl ? nl + 1 : end;

  // comments
  while (p < end && *p == '%') {
    nl = (const char *)memchr(p, '\n', (size_t)(end - p));
    p = nl ? nl + 1 : end;
  }
  int64_t m, k, nnz;
  p = parse_i64(p, end, &m);
  p = parse_i64(p, end, &k);
  p = parse_i64(p, end, &nnz);
  nl = (const char *)memchr(p, '\n', (size_t)(end - p));
  p = nl ? nl + 1 : end;

  // Parallel body parse: split remaining buffer into newline-aligned chunks.
  int nt = omp_get_max_threads();
  std::vector<const char *> starts(nt + 1);
  size_t body = (size_t)(end - p);
  for (int t = 0; t <= nt; ++t) {
    const char *q = p + body * (size_t)t / (size_t)nt;
    if (t > 0 && t < nt) {
      const char *nl2 = (const char *)memchr(q, '\n', (size_t)(end - q));
      q = nl2 ? nl2 + 1 : end;
    }
    starts[t] = (t == nt) ? end : q;
  }

  std::vector<int32_t> rows((size_t)nnz), cols((size_t)nnz);
  std::vector<double> vals((size_t)nnz);
  std::vector<int64_t> counts(nt, 0);

  // pass 1: count entries per chunk
#pragma omp parallel num_threads(nt)
  {
    int t = omp_get_thread_num();
    int64_t c = 0;
    for (const char *q = starts[t]; q < starts[t + 1]; ++q)
      if (*q == '\n') ++c;
    if (starts[t + 1] == end && starts[t] < end && end[-1] != '\n') ++c;
    counts[t] = c;
  }
  std::vector<int64_t> offs(nt + 1, 0);
  for (int t = 0; t < nt; ++t) offs[t + 1] = offs[t] + counts[t];

#pragma omp parallel num_threads(nt)
  {
    int t = omp_get_thread_num();
    const char *q = starts[t];
    int64_t idx = offs[t];
    while (q < starts[t + 1]) {
      const char *line_end =
          (const char *)memchr(q, '\n', (size_t)(starts[t + 1] - q));
      if (!line_end) line_end = starts[t + 1];
      if (line_end > q && idx < nnz) {
        int64_t i, j;
        double v = pattern_dummy, vi = 0.0;
        const char *c = parse_i64(q, line_end, &i);
        c = parse_i64(c, line_end, &j);
        if (field == 0 || field == 1) c = parse_f64(c, line_end, &v);
        else if (field == 3) {
          c = parse_f64(c, line_end, &v);
          c = parse_f64(c, line_end, &vi);
          v = std::hypot(v, vi);  // magnitude for complex
        }
        rows[(size_t)idx] = (int32_t)(i - 1);
        cols[(size_t)idx] = (int32_t)(j - 1);
        vals[(size_t)idx] = v;
        ++idx;
      }
      q = line_end + 1;
    }
  }
  free(buf);

  // symmetry expansion (ref mtx_read expand_symmetry arg)
  int64_t total = nnz;
  if (symmetry != 0 && expand_symmetry) {
    int64_t extra = 0;
    for (int64_t i = 0; i < nnz; ++i)
      if (rows[(size_t)i] != cols[(size_t)i]) ++extra;
    rows.resize((size_t)(nnz + extra));
    cols.resize((size_t)(nnz + extra));
    vals.resize((size_t)(nnz + extra));
    int64_t w = nnz;
    double sign = (symmetry == 2) ? -1.0 : 1.0;
    for (int64_t i = 0; i < nnz; ++i) {
      if (rows[(size_t)i] != cols[(size_t)i]) {
        rows[(size_t)w] = cols[(size_t)i];
        cols[(size_t)w] = rows[(size_t)i];
        vals[(size_t)w] = sign * vals[(size_t)i];
        ++w;
      }
    }
    total = w;
  }

  r->m = m;
  r->k = k;
  r->nnz = total;
  r->row_ptr = (int32_t *)malloc(sizeof(int32_t) * (size_t)(m + 1));
  r->col_idx = (int32_t *)malloc(sizeof(int32_t) * (size_t)total);
  r->values = (double *)malloc(sizeof(double) * (size_t)total);
  coo_to_csr_fill(m, total, rows.data(), cols.data(), vals.data(),
                  r->row_ptr, r->col_idx, r->values);
  return r;
}

// ---------------------------------------------------------------------------
// DLMC .smtx reader: "m, k, nnz\n<row_ptr...>\n<col_idx...>\n"
// ---------------------------------------------------------------------------

sg_csr *sg_read_smtx(const char *path) {
  sg_csr *r = sg_alloc();
  size_t len = 0;
  char *buf = read_file(path, &len);
  if (!buf) {
    snprintf(r->error, sizeof r->error, "cannot open %s", path);
    return r;
  }
  const char *p = buf, *end = buf + len;
  int64_t m, k, nnz;
  p = parse_i64(p, end, &m);
  p = skip_ws(p, end);
  if (p < end && *p == ',') ++p;
  p = parse_i64(p, end, &k);
  p = skip_ws(p, end);
  if (p < end && *p == ',') ++p;
  p = parse_i64(p, end, &nnz);

  r->m = m;
  r->k = k;
  r->nnz = nnz;
  r->row_ptr = (int32_t *)malloc(sizeof(int32_t) * (size_t)(m + 1));
  r->col_idx = (int32_t *)malloc(sizeof(int32_t) * (size_t)nnz);
  r->values = (double *)malloc(sizeof(double) * (size_t)nnz);
  for (int64_t i = 0; i <= m; ++i) {
    int64_t v;
    p = parse_i64(p, end, &v);
    r->row_ptr[i] = (int32_t)v;
  }
  for (int64_t i = 0; i < nnz; ++i) {
    int64_t v;
    p = parse_i64(p, end, &v);
    r->col_idx[i] = (int32_t)v;
    r->values[i] = 1.0;
  }
  free(buf);
  if (r->row_ptr[m] != nnz) {
    snprintf(r->error, sizeof r->error, "nnz mismatch: %d vs %lld",
             r->row_ptr[m], (long long)nnz);
  }
  return r;
}

// ---------------------------------------------------------------------------
// Structural features (ref csr_util_gen.c:269-611, SURVEY A.1)
// out[0..11]: avg_deg std_deg min_deg max_deg avg_bw std_bw avg_sc std_sc
//             num_neigh_avg cross_row_sim ngroups_total avg_group_size
// ---------------------------------------------------------------------------

void sg_features(int64_t m, int64_t k, const int32_t *row_ptr,
                 const int32_t *col_idx, double *out) {
  double sum_d = 0, sum_d2 = 0, min_d = 1e300, max_d = 0;
  double sum_bw = 0, sum_bw2 = 0, sum_sc = 0, sum_sc2 = 0;
  int64_t neigh = 0, groups = 0;
  int64_t nnz = row_ptr[m];

#pragma omp parallel for reduction(+:sum_d,sum_d2,sum_bw,sum_bw2,sum_sc,sum_sc2,neigh,groups) \
    reduction(min:min_d) reduction(max:max_d) schedule(static)
  for (int64_t i = 0; i < m; ++i) {
    int64_t s = row_ptr[i], e = row_ptr[i + 1];
    double d = (double)(e - s);
    sum_d += d;
    sum_d2 += d * d;
    if (d < min_d) min_d = d;
    if (d > max_d) max_d = d;
    double bw = 0, sc = 0;
    if (e > s) {
      int32_t cmin = col_idx[s], cmax = col_idx[s];
      for (int64_t j = s + 1; j < e; ++j) {
        if (col_idx[j] < cmin) cmin = col_idx[j];
        if (col_idx[j] > cmax) cmax = col_idx[j];
      }
      bw = (double)(cmax - cmin);
      sc = bw > 0 ? d / bw : 0.0;
      ++groups;
      for (int64_t j = s + 1; j < e; ++j) {
        // window-1 neighbours, symmetric double count (:459-490)
        if (col_idx[j] - col_idx[j - 1] <= 1) neigh += 2;
        if (col_idx[j] - col_idx[j - 1] > 1) ++groups;
      }
    }
    sum_bw += bw;
    sum_bw2 += bw * bw;
    sum_sc += sc;
    sum_sc2 += sc * sc;
  }

  // cross-row similarity: fraction of a row's nnz matched +-1 in the next
  // non-empty row, averaged over rows with a successor (:553-611)
  double crs_sum = 0;
  int64_t crs_rows = 0;
  int64_t prev = -1;
#ifdef _OPENMP
#endif
  // serial scan (cheap: one pass over nnz)
  for (int64_t i = 0; i < m; ++i) {
    if (row_ptr[i + 1] == row_ptr[i]) continue;
    if (prev >= 0) {
      int64_t s1 = row_ptr[prev], e1 = row_ptr[prev + 1];
      int64_t s2 = row_ptr[i], e2 = row_ptr[i + 1];
      int64_t matched = 0, j2 = s2;
      for (int64_t j1 = s1; j1 < e1; ++j1) {
        int32_t c = col_idx[j1];
        while (j2 < e2 && col_idx[j2] < c - 1) ++j2;
        if (j2 < e2 && col_idx[j2] <= c + 1) ++matched;
      }
      crs_sum += (double)matched / (double)(e1 - s1);
      ++crs_rows;
    }
    prev = i;
  }

  double md = m ? sum_d / (double)m : 0;
  out[0] = md;
  out[1] = m ? std::sqrt(std::max(0.0, sum_d2 / (double)m - md * md)) : 0;
  out[2] = m ? min_d : 0;
  out[3] = max_d;
  double mbw = m ? sum_bw / (double)m : 0;
  out[4] = mbw;
  out[5] = m ? std::sqrt(std::max(0.0, sum_bw2 / (double)m - mbw * mbw)) : 0;
  double msc = m ? sum_sc / (double)m : 0;
  out[6] = msc;
  out[7] = m ? std::sqrt(std::max(0.0, sum_sc2 / (double)m - msc * msc)) : 0;
  out[8] = nnz ? (double)neigh / (double)nnz : 0;
  out[9] = crs_rows ? crs_sum / (double)crs_rows : 0;
  out[10] = (double)groups;
  out[11] = groups ? (double)nnz / (double)groups : 0;
}

// ---------------------------------------------------------------------------
// CSR -> BSR block build (ref: MKL BSR targets, Makefile_in mkl_bsr 2-64;
// host-side layout construction for the Pallas block kernels).  Parallel
// over block rows: per-thread column-mark arrays find the nonempty
// (block_row, block_col) tiles, then values scatter into dense blocks.
// ---------------------------------------------------------------------------

typedef struct {
  int64_t mb, kb, nb;
  int32_t bm, bk;
  int32_t *block_row_ptr;  // (mb+1)
  int32_t *block_cols;     // (nb)
  float *blocks;           // (nb, bm, bk)
} sg_bsr;

void sg_bsr_free(sg_bsr *r) {
  if (!r) return;
  free(r->block_row_ptr);
  free(r->block_cols);
  free(r->blocks);
  free(r);
}

sg_bsr *sg_csr_to_bsr_f32(int64_t m, int64_t k, const int32_t *row_ptr,
                          const int32_t *col_idx, const float *vals,
                          int32_t bm, int32_t bk) {
  int64_t mb = (m + bm - 1) / bm;
  int64_t kb = (k + bk - 1) / bk;
  sg_bsr *r = (sg_bsr *)calloc(1, sizeof(sg_bsr));
  if (!r) return nullptr;
  r->mb = mb; r->kb = kb; r->bm = bm; r->bk = bk;
  r->block_row_ptr = (int32_t *)malloc((mb + 1) * sizeof(int32_t));

  // pass 1: per block row, count distinct block cols
  int32_t *counts = (int32_t *)calloc(mb, sizeof(int32_t));
  if (!r->block_row_ptr || !counts) {
    free(counts); sg_bsr_free(r); return nullptr;
  }
#pragma omp parallel
  {
    std::vector<int64_t> mark(kb, -1);
#pragma omp for schedule(dynamic, 16)
    for (int64_t bi = 0; bi < mb; ++bi) {
      int64_t r0 = bi * bm, r1 = std::min<int64_t>(m, r0 + bm);
      int32_t c = 0;
      for (int64_t i = r0; i < r1; ++i)
        for (int64_t j = row_ptr[i]; j < row_ptr[i + 1]; ++j) {
          int64_t bc = col_idx[j] / bk;
          if (mark[bc] != bi) { mark[bc] = bi; ++c; }
        }
      counts[bi] = c;
    }
  }
  r->block_row_ptr[0] = 0;
  for (int64_t bi = 0; bi < mb; ++bi)
    r->block_row_ptr[bi + 1] = r->block_row_ptr[bi] + counts[bi];
  free(counts);
  int64_t nb = r->block_row_ptr[mb];
  r->nb = nb;
  r->block_cols = (int32_t *)malloc(std::max<int64_t>(nb, 1) * sizeof(int32_t));
  r->blocks = (float *)calloc(std::max<int64_t>(nb, 1) * bm * bk,
                              sizeof(float));
  if (!r->block_cols || !r->blocks) { sg_bsr_free(r); return nullptr; }

  // pass 2: assign sorted block-col slots per block row, scatter values
#pragma omp parallel
  {
    std::vector<int64_t> mark(kb, -1);   // epoch = block row id
    std::vector<int64_t> slot(kb, 0);
    std::vector<int32_t> cols_local;
#pragma omp for schedule(dynamic, 16)
    for (int64_t bi = 0; bi < mb; ++bi) {
      int64_t r0 = bi * bm, r1 = std::min<int64_t>(m, r0 + bm);
      int64_t base = r->block_row_ptr[bi];
      cols_local.clear();
      for (int64_t i = r0; i < r1; ++i)
        for (int64_t j = row_ptr[i]; j < row_ptr[i + 1]; ++j) {
          int64_t bc = col_idx[j] / bk;
          if (mark[bc] != bi) { mark[bc] = bi; cols_local.push_back((int32_t)bc); }
        }
      std::sort(cols_local.begin(), cols_local.end());
      for (size_t s = 0; s < cols_local.size(); ++s) {
        slot[cols_local[s]] = base + (int64_t)s;
        r->block_cols[base + s] = cols_local[s];
      }
      for (int64_t i = r0; i < r1; ++i)
        for (int64_t j = row_ptr[i]; j < row_ptr[i + 1]; ++j) {
          int64_t bc = col_idx[j] / bk;
          int64_t b = slot[bc];
          r->blocks[(b * bm + (i - r0)) * bk + (col_idx[j] % bk)] = vals[j];
        }
    }
  }
  return r;
}

}  // extern "C"
