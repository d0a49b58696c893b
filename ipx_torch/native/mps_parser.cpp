// Native MPS parser (SURVEY.md layer L5 host-side IO; the framework's
// CPU-bound path for large Netlib-scale inputs).
//
// Scope: tokenizing + section parsing into flat arrays.  The semantic
// post-processing (L/G/E -> inequality conversion, RANGES expansion, bound
// application order, netlib UP-negative convention) stays in Python
// (ipx_torch/problem/mps.py) and is applied identically to both parsers, so the
// native path cannot drift from the reference semantics.
//
// C API (ctypes-friendly, two-phase: parse -> query sizes -> fill buffers):
//   ipx_mps_parse(text, len, errbuf, errlen) -> handle | NULL
//   ipx_mps_counts(h, int64 out[6])   // rows, cols, entries, obj_entries,
//                                     // bound_records, flags(maximize bit0)
//   ipx_mps_fill(h, row_types, rhs, has_range, ranges,
//                ent_row, ent_col, ent_val, obj_col, obj_val,
//                bnd_type, bnd_col, bnd_val)
//   ipx_mps_name(h) -> const char*
//   ipx_mps_free(h)
//
// Build: g++ -O2 -shared -fPIC (see ipx_torch/native/__init__.py).

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Mps {
  std::string name;
  bool maximize = false;
  double obj_rhs = 0.0;  // RHS entry on the objective (N) row, if any
  // constraint rows (objective excluded)
  std::vector<char> row_types;                    // 'L', 'G', 'E'
  std::unordered_map<std::string, int32_t> row_idx;
  std::string obj_row;                            // first N row
  // columns
  std::unordered_map<std::string, int32_t> col_idx;
  int32_t n_cols = 0;
  std::vector<int32_t> ent_row, ent_col;
  std::vector<double> ent_val;
  std::vector<int32_t> obj_col;
  std::vector<double> obj_val;
  // rhs / ranges by row index
  std::vector<double> rhs;
  std::vector<uint8_t> has_range;
  std::vector<double> ranges;
  // bound records in file order: type code, col, value
  // codes: 0 LO, 1 UP, 2 FX, 3 FR, 4 MI, 5 PL  (LI->LO, UI->UP)
  std::vector<int32_t> bnd_type, bnd_col;
  std::vector<double> bnd_val;
};

struct Tok {
  const char* p;
  size_t n;
  std::string str() const { return std::string(p, n); }
  bool eq(const char* s) const {
    size_t l = std::strlen(s);
    if (l != n) return false;
    for (size_t i = 0; i < n; i++) {
      char a = p[i], b = s[i];
      if (a >= 'a' && a <= 'z') a -= 32;
      if (a != b) return false;
    }
    return true;
  }
};

static size_t tokenize(const char* line, size_t len, Tok* out, size_t cap) {
  size_t nt = 0, i = 0;
  while (i < len && nt < cap) {
    while (i < len && (line[i] == ' ' || line[i] == '\t' || line[i] == '\r'))
      i++;
    if (i >= len) break;
    size_t start = i;
    while (i < len && line[i] != ' ' && line[i] != '\t' && line[i] != '\r')
      i++;
    out[nt].p = line + start;
    out[nt].n = i - start;
    nt++;
  }
  return nt;
}

static bool to_double(const Tok& t, double* out) {
  std::string s = t.str();
  char* end = nullptr;
  *out = std::strtod(s.c_str(), &end);
  return end && *end == '\0';
}

enum Section { S_NONE, S_NAME, S_OBJSENSE, S_ROWS, S_COLUMNS, S_RHS,
               S_RANGES, S_BOUNDS, S_DONE };

}  // namespace

extern "C" {

void* ipx_mps_parse(const char* text, int64_t len, char* errbuf,
                    int64_t errlen) {
  auto fail = [&](const std::string& msg) -> void* {
    if (errbuf && errlen > 0) {
      std::snprintf(errbuf, (size_t)errlen, "%s", msg.c_str());
    }
    return nullptr;
  };
  Mps* m = new Mps();
  Section sec = S_NONE;
  size_t pos = 0;
  int lineno = 0;
  Tok toks[64];

  while (pos < (size_t)len) {
    size_t eol = pos;
    while (eol < (size_t)len && text[eol] != '\n') eol++;
    const char* line = text + pos;
    size_t ll = eol - pos;
    pos = eol + 1;
    lineno++;
    if (ll == 0) continue;
    if (line[0] == '*') continue;
    size_t nt = tokenize(line, ll, toks, 64);
    if (nt == 0) continue;
    bool header = !(line[0] == ' ' || line[0] == '\t');

    if (header) {
      if (toks[0].eq("NAME")) {
        if (nt > 1) m->name = toks[1].str();
        sec = S_NAME;
      } else if (toks[0].eq("OBJSENSE")) {
        sec = S_OBJSENSE;
        if (nt > 1) {
          std::string v = toks[1].str();
          m->maximize = (v.size() >= 3 && (v[0]=='M'||v[0]=='m')
                         && (v[1]=='A'||v[1]=='a'));
        }
      } else if (toks[0].eq("ROWS")) sec = S_ROWS;
      else if (toks[0].eq("COLUMNS")) sec = S_COLUMNS;
      else if (toks[0].eq("RHS")) sec = S_RHS;
      else if (toks[0].eq("RANGES")) sec = S_RANGES;
      else if (toks[0].eq("BOUNDS")) sec = S_BOUNDS;
      else if (toks[0].eq("ENDATA")) { sec = S_DONE; break; }
      else { delete m; return fail("unknown section at line "
                                   + std::to_string(lineno)); }
      continue;
    }

    switch (sec) {
      case S_OBJSENSE: {
        std::string v = toks[0].str();
        m->maximize = (v.size() >= 3 && (v[0]=='M'||v[0]=='m')
                       && (v[1]=='A'||v[1]=='a'));
        break;
      }
      case S_ROWS: {
        if (nt < 2) { delete m; return fail("bad ROWS line "
                                            + std::to_string(lineno)); }
        char rt = toks[0].p[0];
        if (rt >= 'a') rt -= 32;
        std::string rn = toks[1].str();
        if (rt == 'N') {
          if (m->obj_row.empty()) m->obj_row = rn;
          // extra free rows ignored
        } else if (rt == 'L' || rt == 'G' || rt == 'E') {
          m->row_idx.emplace(rn, (int32_t)m->row_types.size());
          m->row_types.push_back(rt);
        } else {
          delete m; return fail("bad row type at line "
                                + std::to_string(lineno));
        }
        break;
      }
      case S_COLUMNS: {
        if (nt >= 3 && toks[1].eq("'MARKER'")) {
          for (size_t i = 0; i < nt; i++) {
            if (toks[i].eq("'INTORG'")) {
              delete m;
              return fail("integer variables not supported (LP only)");
            }
          }
          break;
        }
        if (nt < 3 || (nt - 1) % 2) {
          delete m; return fail("bad COLUMNS line "
                                + std::to_string(lineno));
        }
        std::string cn = toks[0].str();
        auto it = m->col_idx.find(cn);
        int32_t cj;
        if (it == m->col_idx.end()) {
          cj = m->n_cols++;
          m->col_idx.emplace(cn, cj);
        } else {
          cj = it->second;
        }
        for (size_t i = 1; i + 1 < nt; i += 2) {
          double v;
          if (!to_double(toks[i + 1], &v)) {
            delete m; return fail("bad number at line "
                                  + std::to_string(lineno));
          }
          std::string rn = toks[i].str();
          if (rn == m->obj_row) {
            m->obj_col.push_back(cj);
            m->obj_val.push_back(v);
          } else {
            auto rit = m->row_idx.find(rn);
            if (rit != m->row_idx.end()) {
              m->ent_row.push_back(rit->second);
              m->ent_col.push_back(cj);
              m->ent_val.push_back(v);
            }
            // coefficients in ignored free rows are dropped
          }
        }
        break;
      }
      case S_RHS:
      case S_RANGES: {
        // optional set name: odd token count means a set name leads the
        // pairs (identical rule to the python parser in problem/mps.py)
        size_t start = (nt % 2) ? 1 : 0;
        if (m->rhs.size() < m->row_types.size()) {
          m->rhs.resize(m->row_types.size(), 0.0);
          m->has_range.resize(m->row_types.size(), 0);
          m->ranges.resize(m->row_types.size(), 0.0);
        }
        for (size_t i = start; i + 1 < nt; i += 2) {
          auto rit = m->row_idx.find(toks[i].str());
          double v;
          if (!to_double(toks[i + 1], &v)) {
            delete m; return fail("bad number at line "
                                  + std::to_string(lineno));
          }
          if (rit == m->row_idx.end()) {
            // RHS on the objective row = objective constant (negated by
            // MPS convention); RANGES on N/free rows are meaningless
            if (sec == S_RHS && toks[i].str() == m->obj_row)
              m->obj_rhs = v;
            continue;
          }
          if (sec == S_RHS) {
            m->rhs[rit->second] = v;
          } else {
            m->has_range[rit->second] = 1;
            m->ranges[rit->second] = v;
          }
        }
        break;
      }
      case S_BOUNDS: {
        if (nt < 3) { delete m; return fail("bad BOUNDS line "
                                            + std::to_string(lineno)); }
        Tok bt = toks[0];
        int32_t code;
        bool has_val = true;
        if (bt.eq("LO") || bt.eq("LI")) code = 0;
        else if (bt.eq("UP") || bt.eq("UI")) code = 1;
        else if (bt.eq("FX")) code = 2;
        else if (bt.eq("FR")) { code = 3; has_val = false; }
        else if (bt.eq("MI")) { code = 4; has_val = false; }
        else if (bt.eq("PL")) { code = 5; has_val = false; }
        else if (bt.eq("BV")) {
          delete m; return fail("binary variables not supported (LP only)");
        } else {
          delete m; return fail("bad bound type at line "
                                + std::to_string(lineno));
        }
        if (has_val && nt < 4) {
          delete m; return fail("bad bound line " + std::to_string(lineno));
        }
        auto cit = m->col_idx.find(toks[2].str());
        if (cit == m->col_idx.end()) {
          delete m; return fail("bound on unknown column at line "
                                + std::to_string(lineno));
        }
        double v = 0.0;
        if (has_val && !to_double(toks[3], &v)) {
          delete m; return fail("bad number at line "
                                + std::to_string(lineno));
        }
        m->bnd_type.push_back(code);
        m->bnd_col.push_back(cit->second);
        m->bnd_val.push_back(v);
        break;
      }
      case S_NAME:
      case S_NONE:
        break;
      default:
        delete m; return fail("data outside a section at line "
                              + std::to_string(lineno));
    }
  }
  if (m->obj_row.empty()) {
    delete m; return fail("no objective (N) row");
  }
  m->rhs.resize(m->row_types.size(), 0.0);
  m->has_range.resize(m->row_types.size(), 0);
  m->ranges.resize(m->row_types.size(), 0.0);
  return m;
}

void ipx_mps_counts(void* h, int64_t out[6]) {
  Mps* m = (Mps*)h;
  out[0] = (int64_t)m->row_types.size();
  out[1] = (int64_t)m->n_cols;
  out[2] = (int64_t)m->ent_val.size();
  out[3] = (int64_t)m->obj_val.size();
  out[4] = (int64_t)m->bnd_val.size();
  out[5] = m->maximize ? 1 : 0;
}

const char* ipx_mps_name(void* h) { return ((Mps*)h)->name.c_str(); }

double ipx_mps_obj_rhs(void* h) { return ((Mps*)h)->obj_rhs; }

void ipx_mps_fill(void* h, int32_t* row_types, double* rhs,
                  uint8_t* has_range, double* ranges,
                  int32_t* ent_row, int32_t* ent_col, double* ent_val,
                  int32_t* obj_col, double* obj_val,
                  int32_t* bnd_type, int32_t* bnd_col, double* bnd_val) {
  Mps* m = (Mps*)h;
  for (size_t i = 0; i < m->row_types.size(); i++)
    row_types[i] = (int32_t)m->row_types[i];
  std::memcpy(rhs, m->rhs.data(), m->rhs.size() * sizeof(double));
  std::memcpy(has_range, m->has_range.data(), m->has_range.size());
  std::memcpy(ranges, m->ranges.data(), m->ranges.size() * sizeof(double));
  std::memcpy(ent_row, m->ent_row.data(),
              m->ent_row.size() * sizeof(int32_t));
  std::memcpy(ent_col, m->ent_col.data(),
              m->ent_col.size() * sizeof(int32_t));
  std::memcpy(ent_val, m->ent_val.data(),
              m->ent_val.size() * sizeof(double));
  std::memcpy(obj_col, m->obj_col.data(),
              m->obj_col.size() * sizeof(int32_t));
  std::memcpy(obj_val, m->obj_val.data(),
              m->obj_val.size() * sizeof(double));
  std::memcpy(bnd_type, m->bnd_type.data(),
              m->bnd_type.size() * sizeof(int32_t));
  std::memcpy(bnd_col, m->bnd_col.data(),
              m->bnd_col.size() * sizeof(int32_t));
  std::memcpy(bnd_val, m->bnd_val.data(),
              m->bnd_val.size() * sizeof(double));
}

void ipx_mps_free(void* h) { delete (Mps*)h; }

}  // extern "C"
