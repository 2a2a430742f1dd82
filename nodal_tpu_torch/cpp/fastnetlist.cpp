// fastnetlist: native CSV netlist parser + MNA stamp compiler.
//
// The reference implementation's measured bottleneck is its host-side
// Python stamping loop (9.25 s vs 0.79 s solve at 40k nodes — SURVEY.md
// §2.3); nodal_tpu's Python front-end removes the per-element matrix
// writes but still pays Python dict/object costs per component.  This
// module does CSV text -> stamp tensors entirely in C++: tokenize, intern
// node/component names, elect ground, expand OPMODEL macromodels, number
// nodes/branches, and emit the same COO stamp template arrays as
// nodal_tpu_torch/models/stamps.py (array for array; cross-validated by
// tests/test_torch_native.py against the Python lowering on every fixture
// and on random grids).  A copy of nodal_tpu's cpp/fastnetlist.cpp.
//
// Exposed through a C ABI consumed by ctypes
// (nodal_tpu_torch/utils/native.py).

#include <cctype>
#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <string>
#include <string_view>
#include <unordered_map>
#include <vector>

// Heterogeneous string lookup (avoids a std::string allocation per field
// on the hot interning path — matters at 1M-component netlists).
struct SvHash {
  using is_transparent = void;
  size_t operator()(std::string_view s) const {
    return std::hash<std::string_view>{}(s);
  }
  size_t operator()(const std::string& s) const {
    return std::hash<std::string_view>{}(s);
  }
};
struct SvEq {
  using is_transparent = void;
  bool operator()(std::string_view a, std::string_view b) const {
    return a == b;
  }
};
template <typename V>
using StringMap = std::unordered_map<std::string, V, SvHash, SvEq>;

namespace {

enum Type : int32_t { T_R = 0, T_A, T_E, T_VCVS, T_VCCS, T_CCVS, T_CCCS };

struct Comp {
  std::string name;
  int32_t type;
  double value;
  int32_t anode, bnode;        // node ids (interning order)
  int32_t cnode = -1, dnode = -1;
  int32_t driver = -1;         // component index
  std::string driver_name;
};

struct GEntry {
  int32_t row, col;
  double coeff;
  int32_t p1;
  int8_t e1;
  int32_t p2;
  int8_t e2;
};
struct REntry {
  int32_t row;
  double coeff;
  int32_t p1;
  int8_t e1;
  int32_t p2;
  int8_t e2;
};

struct Result {
  std::string error;
  std::vector<Comp> comps;
  std::vector<std::string> node_names;   // interning order
  StringMap<int32_t> node_lookup;
  StringMap<int32_t> comp_lookup;
  std::vector<int32_t> degrees;
  int32_t ground = -1;
  std::vector<int32_t> nodenum;          // node id -> row index or -1 (ground)
  std::vector<int32_t> anom_of_comp;     // comp idx -> anom index or -1
  int32_t n_kcl = 0, n_be = 0;
  std::vector<GEntry> g;
  std::vector<REntry> r;
  std::vector<double> params;
};

struct Field {
  const char* p;
  size_t len;
  std::string str() const { return std::string(p, len); }
  bool eq(const char* s) const {
    return std::strlen(s) == len && std::memcmp(p, s, len) == 0;
  }
};

// Split one CSV line; skipinitialspace semantics (strip blanks after the
// delimiter) plus RFC-4180 quoting, matching csv.reader(...,
// skipinitialspace=True): a field starting with '"' runs to the closing
// quote (commas inside are literal), '""' inside escapes one quote, and
// text after the closing quote is appended verbatim.  Unquoted fields are
// zero-copy views into the source buffer; quoted fields are unescaped into
// `scratch` (a deque so earlier Field pointers stay valid).  Multi-line
// quoted fields (embedded newlines) are not supported: the closing quote
// must be on the same line, else `err` is set so callers can fail loudly
// instead of mis-parsing (round-1 advisor finding: the old splitter kept
// quotes as literal bytes, silently changing the topology of
// reference-valid quoted netlists).
static void split_line(const char* b, const char* e, std::vector<Field>& out,
                       std::deque<std::string>& scratch, std::string* err) {
  out.clear();
  const char* p = b;
  bool any_quoted = false;
  while (p <= e) {
    while (p < e && (*p == ' ' || *p == '\t')) ++p;
    if (p < e && *p == '"') {  // quoted field
      any_quoted = true;
      ++p;
      std::string s;
      bool closed = false;
      while (p < e) {
        if (*p == '"') {
          if (p + 1 < e && p[1] == '"') {
            s += '"';
            p += 2;
          } else {
            ++p;
            closed = true;
            break;
          }
        } else {
          s += *p++;
        }
      }
      if (!closed) {
        if (err && err->empty())
          *err = "Unterminated quoted field (multi-line quoted fields are "
                 "not supported by the native parser)";
        return;
      }
      while (p < e && *p != ',') s += *p++;  // text after closing quote
      scratch.push_back(std::move(s));
      out.push_back({scratch.back().data(), scratch.back().size()});
    } else {
      const char* start = p;
      while (p < e && *p != ',') ++p;
      out.push_back({start, static_cast<size_t>(p - start)});
    }
    if (p >= e) break;
    ++p;  // skip comma
    if (p == e) {  // trailing comma -> empty field
      out.push_back({p, 0});
      break;
    }
  }
  // Blank line (but '""' is a quoted empty field, not a blank line — the
  // Python front-end errors on it, so the native path must too).
  if (out.size() == 1 && out[0].len == 0 && !any_quoted) out.clear();
}

// Quirk bits for fn_parse (must match nodal_tpu.models.stamps.Quirks).
enum QuirkFlags : int32_t { QUIRK_VCCS_AS_VCVS = 1 };

struct Builder {
  Result res;
  StringMap<int32_t> node_id;
  StringMap<int32_t> comp_id;
  std::vector<std::vector<std::string>> opmodel_rows;
  int32_t quirks = 0;
  // The Python front-end registers only *terminal* (anode/bnode) nodes in
  // its degree table (netlist.py:255-256), so node row numbering follows
  // first-*terminal*-appearance order and a node used only as a control
  // reference is an error (KeyError), not a silent floating unknown.
  // Track terminal-ness separately from interning (round-1 advisor
  // finding: interning control nodes into the numbering permuted G vs the
  // Python lowering and accepted dangling control nodes).
  std::vector<char> is_terminal;         // parallel to node_names
  std::vector<int32_t> terminal_order;   // first-terminal-appearance order

  int32_t intern_node(std::string_view label, bool terminal) {
    auto it = node_id.find(label);
    int32_t id;
    if (it != node_id.end()) {
      id = it->second;
    } else {
      id = static_cast<int32_t>(res.node_names.size());
      node_id.emplace(std::string(label), id);
      res.node_names.push_back(std::string(label));
      res.degrees.push_back(0);
      is_terminal.push_back(0);
    }
    if (terminal && !is_terminal[id]) {
      is_terminal[id] = 1;
      terminal_order.push_back(id);
    }
    return id;
  }

  void reserve_hint(const char* text, int64_t text_len) {
    // Exact line count (one memchr sweep, ~ms at 66 MB) instead of a
    // bytes/row guess: the old text_len/20 heuristic over-reserved ~40%
    // on grid netlists, and the wasted pages were all first-touch page
    // faults — measured 10.3 s first call vs 2.0 s steady-state at 2M
    // components.  Comment/blank lines only make this an upper bound.
    size_t rows = 16;
    for (const char* p = text; (p = static_cast<const char*>(
             memchr(p, '\n', text + text_len - p))) != nullptr; ++p)
      ++rows;
    if (text_len > 0 && text[text_len - 1] != '\n') ++rows;
    res.comps.reserve(rows);
    node_id.reserve(rows);
    comp_id.reserve(rows);
    res.node_names.reserve(rows);
    res.degrees.reserve(rows);
    res.g.reserve(rows * 4);
    res.r.reserve(rows / 4 + 16);
  }

  bool fail(const std::string& msg) {
    if (res.error.empty()) res.error = msg;
    return false;
  }

  static bool parse_double(const Field& f, double* out) {
    // std::from_chars: locale-independent and ~3x faster than strtod on
    // the 1M-component parse path; also rejects hex floats ("0x1p3"),
    // which Python's float() rejects too (strtod accepted them).
    const char* p = f.p;
    const char* stop = f.p + f.len;
    // Python's float() accepts a leading '+' and surrounding blanks.
    while (p < stop && (*p == ' ' || *p == '\t')) ++p;
    if (p < stop && *p == '+' && p + 1 < stop && p[1] != '+' && p[1] != '-')
      ++p;
    auto r = std::from_chars(p, stop, *out);
    if (r.ec != std::errc()) return false;
    const char* end = r.ptr;
    while (end < stop && (*end == ' ' || *end == '\t')) ++end;
    return end == stop;
  }

  static int32_t type_of(const Field& f) {
    if (f.eq("R")) return T_R;
    if (f.eq("A")) return T_A;
    if (f.eq("E")) return T_E;
    if (f.eq("VCVS")) return T_VCVS;
    if (f.eq("VCCS")) return T_VCCS;
    if (f.eq("CCVS")) return T_CCVS;
    if (f.eq("CCCS")) return T_CCCS;
    return -1;
  }

  bool process_row(const std::vector<Field>& f) {
    if (f.empty() || (f[0].len > 0 && f[0].p[0] == '#')) return true;
    if (f.size() < 5)
      return fail("Missing arguments for component " + f[0].str());
    std::string name = f[0].str();

    if (f[1].eq("OPMODEL")) {
      if (f.size() != 7)
        return fail("Wrong number of arguments for component " + name);
      double rf_num;
      if (!parse_double(f[2], &rf_num))
        return fail("Bad input: expected a number for component value of " +
                    name);
      // [name, OPMODEL, rf, out, ground, pos, neg]  (reference
      // nodal.py:45-85): Ri pos-neg, Ro phony-out, VCVS gain phony-ground
      // controlled by (pos, neg), feedback R iff rf != "0".
      std::string rf = f[2].str(), out = f[3].str(), gnd = f[4].str(),
                  pos = f[5].str(), neg = f[6].str();
      std::string phony = name + "_internal_node";
      opmodel_rows.push_back({name + "_ri", "R", "10000000.0", pos, neg});
      opmodel_rows.push_back({name + "_ro", "R", "10.0", phony, out});
      opmodel_rows.push_back(
          {name + "_vcvs", "VCVS", "100000.0", phony, gnd, pos, neg});
      if (rf != "0") {
        opmodel_rows.push_back({name + "_rf", "R", rf, neg, out});
      } else if (neg != out) {
        return fail("OPMODEL " + name +
                    ": direct feedback (rf=0) requires the inverting "
                    "terminal to coincide with the output");
      }
      return true;
    }
    if (f[1].eq("OPAMP")) return fail("OPAMP has no device model; use OPMODEL");

    int32_t t = type_of(f[1]);
    if (t < 0)
      return fail("Unknown type " + f[1].str() + " for component " + name);
    size_t arity = (t == T_R || t == T_A || t == T_E)  ? 5
                   : (t == T_VCVS || t == T_VCCS)      ? 7
                                                        : 8;
    if (f.size() != arity)
      return fail("Wrong number of arguments for component " + name);
    Comp c;
    c.name = name;
    c.type = t;
    if (!parse_double(f[2], &c.value))
      return fail("Bad input: expected a number for component value of " +
                  name);
    c.anode = intern_node(std::string_view(f[3].p, f[3].len), true);
    c.bnode = intern_node(std::string_view(f[4].p, f[4].len), true);
    if (arity >= 7) {
      // Control references do NOT make a node part of the circuit graph
      // (no degree, no row) — matching the Python front-end.
      c.cnode = intern_node(std::string_view(f[5].p, f[5].len), false);
      c.dnode = intern_node(std::string_view(f[6].p, f[6].len), false);
    }
    if (arity == 8) c.driver_name = f[7].str();
    if (comp_id.count(name))
      return fail("Duplicate component name " + name);
    comp_id.emplace(name, static_cast<int32_t>(res.comps.size()));
    res.degrees[c.anode] += 1;
    res.degrees[c.bnode] += 1;
    res.comps.push_back(std::move(c));
    return true;
  }

  bool process_string_row(const std::vector<std::string>& row) {
    std::vector<Field> f;
    f.reserve(row.size());
    for (const auto& s : row) f.push_back({s.data(), s.size()});
    return process_row(f);
  }

  bool finalize() {
    // Deferred OPMODEL rows (may themselves intern new nodes).
    auto pending = std::move(opmodel_rows);
    opmodel_rows.clear();
    for (const auto& row : pending)
      if (!process_string_row(row)) return false;
    if (res.comps.empty()) return fail("Empty netlist: no components found");

    // Ground: explicit "g" wins iff it is a terminal node (the Python
    // front-end checks the degree table, which holds terminals only),
    // else max degree with first-*terminal*-appearance tie-break.
    auto git = node_id.find(std::string_view("g"));
    if (git != node_id.end() && is_terminal[git->second]) {
      res.ground = git->second;
    } else {
      int32_t best = terminal_order[0];
      for (int32_t id : terminal_order)
        if (res.degrees[id] > res.degrees[best]) best = id;
      res.ground = best;
    }

    // Row numbering follows first-terminal-appearance order (matches the
    // Python degrees-dict insertion order); control-only nodes get no row.
    res.nodenum.assign(res.node_names.size(), -1);
    int32_t k = 0;
    for (int32_t id : terminal_order)
      if (id != res.ground) res.nodenum[id] = k++;
    res.n_kcl = k;

    res.anom_of_comp.assign(res.comps.size(), -1);
    int32_t a = 0;
    for (size_t i = 0; i < res.comps.size(); ++i) {
      int32_t t = res.comps[i].type;
      if (t == T_E || t == T_VCVS || t == T_VCCS || t == T_CCVS || t == T_CCCS)
        res.anom_of_comp[i] = a++;
    }
    res.n_be = a;

    // Resolve drivers.
    for (auto& c : res.comps) {
      if (c.type == T_CCVS || c.type == T_CCCS) {
        auto it = comp_id.find(c.driver_name);
        if (it == comp_id.end())
          return fail("Driving component " + c.driver_name + " not found");
        c.driver = it->second;
      }
    }
    return stamp();
  }

  // --- stamp templates: must match nodal_tpu_torch/models/stamps.py exactly ---

  int32_t N(int32_t node) const {  // row index or -1 for ground
    return res.nodenum[node];
  }
  int32_t BR(size_t comp_idx) const {
    return res.n_kcl + res.anom_of_comp[comp_idx];
  }
  void G(int32_t row, int32_t col, double coeff, int32_t p1 = 0,
         int8_t e1 = 0, int32_t p2 = 0, int8_t e2 = 0) {
    if (row < 0 || col < 0) return;
    res.g.push_back({row, col, coeff, p1, e1, p2, e2});
  }
  void RHS(int32_t row, double coeff, int32_t p1 = 0, int8_t e1 = 0,
           int32_t p2 = 0, int8_t e2 = 0) {
    if (row < 0) return;
    res.r.push_back({row, coeff, p1, e1, p2, e2});
  }
  void couple(const Comp& c, int32_t br) {
    G(br, N(c.anode), 1.0);
    G(N(c.anode), br, -1.0);
    G(br, N(c.bnode), -1.0);
    G(N(c.bnode), br, 1.0);
  }

  // Control nodes of voltage-controlled sources must exist in the circuit
  // graph (appear as a terminal somewhere); the Python lowering raises
  // KeyError from its nodenum lookup (models/stamps.py node()).
  bool require_terminal(int32_t node, const std::string& cname) {
    if (is_terminal[node]) return true;
    return fail("Node `" + res.node_names[node] + "` (control node of " +
                cname + ") not found in netlist");
  }

  bool check_control(const Comp& c, const Comp& d, bool* aligned) {
    if (c.cnode == d.anode && c.dnode == d.bnode) {
      *aligned = true;
      return true;
    }
    if (c.cnode == d.bnode && c.dnode == d.anode) {
      *aligned = false;
      return true;
    }
    return fail("Control nodes of " + c.name +
                " do not coincide with terminals of driver " + d.name);
  }

  bool stamp() {
    res.params.reserve(res.comps.size());
    for (const auto& c : res.comps) res.params.push_back(c.value);

    for (size_t i = 0; i < res.comps.size(); ++i) {
      const Comp& c = res.comps[i];
      int32_t s = static_cast<int32_t>(i);
      switch (c.type) {
        case T_R: {
          if (c.value == 0.0)
            return fail("Model error: resistors can't have null resistance");
          int32_t a = N(c.anode), b = N(c.bnode);
          G(a, a, 1.0, s, -1);
          G(b, b, 1.0, s, -1);
          G(a, b, -1.0, s, -1);
          G(b, a, -1.0, s, -1);
          break;
        }
        case T_A:
          RHS(N(c.anode), 1.0, s, 1);
          RHS(N(c.bnode), -1.0, s, 1);
          break;
        case T_E: {
          int32_t br = BR(i);
          RHS(br, 1.0, s, 1);
          couple(c, br);
          break;
        }
        case T_VCVS: {
          if (!require_terminal(c.cnode, c.name) ||
              !require_terminal(c.dnode, c.name))
            return false;
          int32_t br = BR(i);
          couple(c, br);
          G(br, N(c.cnode), -1.0, s, 1);
          G(br, N(c.dnode), 1.0, s, 1);
          break;
        }
        case T_VCCS: {
          if (!require_terminal(c.cnode, c.name) ||
              !require_terminal(c.dnode, c.name))
            return false;
          int32_t br = BR(i);
          if (quirks & QUIRK_VCCS_AS_VCVS) {
            // Reference bit-compat (quirk Q1, reference nodal.py:377-378):
            // the upstream dispatcher stamps VCCS rows as VCVS.
            couple(c, br);
          } else {
            G(N(c.anode), br, -1.0);
            G(N(c.bnode), br, 1.0);
            G(br, br, 1.0);
          }
          G(br, N(c.cnode), -1.0, s, 1);
          G(br, N(c.dnode), 1.0, s, 1);
          break;
        }
        case T_CCVS:
        case T_CCCS: {
          int32_t br = BR(i);
          const Comp& d = res.comps[c.driver];
          bool aligned = true;
          if (c.type == T_CCVS) {
            if (!check_control(c, d, &aligned)) return false;
            couple(c, br);
          } else {
            G(N(c.anode), br, -1.0);
            G(N(c.bnode), br, 1.0);
            G(br, br, 1.0);
          }
          int32_t sd = c.driver;
          if (d.type == T_R) {
            if (c.type == T_CCCS && !check_control(c, d, &aligned))
              return false;
            G(br, N(c.cnode), 1.0, s, 1, sd, -1);
            G(br, N(c.dnode), -1.0, s, 1, sd, -1);
          } else if (d.type == T_A) {
            RHS(br, 1.0, s, 1, sd, 1);
          } else {  // anomalous driver
            if (c.type == T_CCCS && !check_control(c, d, &aligned))
              return false;
            G(br, BR(c.driver), aligned ? -1.0 : 1.0, s, 1);
          }
          break;
        }
      }
    }
    return true;
  }
};

Result* parse_impl(const char* text, int64_t len, int32_t quirks) {
  auto* out = new Result();
  Builder b;
  b.res.error.clear();
  b.quirks = quirks;
  b.reserve_hint(text, len);
  const char* p = text;
  const char* end = text + len;
  std::vector<Field> fields;
  std::deque<std::string> scratch;
  bool ok = true;
  while (ok && p < end) {
    const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
    const char* line_end = nl ? nl : end;
    // Trim trailing \r.
    const char* le = line_end;
    if (le > p && le[-1] == '\r') --le;
    if (!scratch.empty()) scratch.clear();
    split_line(p, le, fields, scratch, &b.res.error);
    ok = b.res.error.empty() && b.process_row(fields);
    p = nl ? nl + 1 : end;
  }
  if (ok) ok = b.finalize();
  b.res.node_lookup = std::move(b.node_id);
  b.res.comp_lookup = std::move(b.comp_id);
  *out = std::move(b.res);
  return out;
}

}  // namespace

extern "C" {

void* fn_parse(const char* text, int64_t len, int32_t quirks) {
  return parse_impl(text, len, quirks);
}

const char* fn_error(void* h) {
  auto* r = static_cast<Result*>(h);
  return r->error.empty() ? nullptr : r->error.c_str();
}

// Sizes: [n_components, n_nodes, n_kcl, n_be, nnz_g, nnz_rhs, ground_id]
void fn_sizes(void* h, int64_t* out) {
  auto* r = static_cast<Result*>(h);
  out[0] = static_cast<int64_t>(r->comps.size());
  out[1] = static_cast<int64_t>(r->node_names.size());
  out[2] = r->n_kcl;
  out[3] = r->n_be;
  out[4] = static_cast<int64_t>(r->g.size());
  out[5] = static_cast<int64_t>(r->r.size());
  out[6] = r->ground;
}

void fn_fill_stamps(void* h, int32_t* g_rows, int32_t* g_cols, double* g_coeff,
                    int32_t* g_p1, int8_t* g_e1, int32_t* g_p2, int8_t* g_e2,
                    int32_t* r_rows, double* r_coeff, int32_t* r_p1,
                    int8_t* r_e1, int32_t* r_p2, int8_t* r_e2, double* params) {
  auto* r = static_cast<Result*>(h);
  for (size_t i = 0; i < r->g.size(); ++i) {
    const auto& e = r->g[i];
    g_rows[i] = e.row;
    g_cols[i] = e.col;
    g_coeff[i] = e.coeff;
    g_p1[i] = e.p1;
    g_e1[i] = e.e1;
    g_p2[i] = e.p2;
    g_e2[i] = e.e2;
  }
  for (size_t i = 0; i < r->r.size(); ++i) {
    const auto& e = r->r[i];
    r_rows[i] = e.row;
    r_coeff[i] = e.coeff;
    r_p1[i] = e.p1;
    r_e1[i] = e.e1;
    r_p2[i] = e.p2;
    r_e2[i] = e.e2;
  }
  for (size_t i = 0; i < r->params.size(); ++i) params[i] = r->params[i];
}

// Name table access: kind 0 = node name (by node id), 1 = component name.
int64_t fn_name(void* h, int32_t kind, int64_t idx, char* buf, int64_t cap) {
  auto* r = static_cast<Result*>(h);
  const std::string* s = nullptr;
  if (kind == 0 && idx >= 0 && idx < (int64_t)r->node_names.size())
    s = &r->node_names[idx];
  else if (kind == 1 && idx >= 0 && idx < (int64_t)r->comps.size())
    s = &r->comps[idx].name;
  if (!s) return -1;
  int64_t n = static_cast<int64_t>(s->size());
  if (n > cap) return -n;
  std::memcpy(buf, s->data(), n);
  return n;
}

// Per-component: nodenum row of anode/bnode (-1 ground), anom index (-1).
void fn_fill_tables(void* h, int32_t* nodenum, int32_t* anom_of_comp,
                    int32_t* comp_type) {
  auto* r = static_cast<Result*>(h);
  for (size_t i = 0; i < r->nodenum.size(); ++i) nodenum[i] = r->nodenum[i];
  for (size_t i = 0; i < r->comps.size(); ++i) {
    anom_of_comp[i] = r->anom_of_comp[i];
    comp_type[i] = r->comps[i].type;
  }
}

// Lookup node ids by name without materializing Python dicts
// (matters for 1M-node generated netlists).
int64_t fn_node_id(void* h, const char* name) {
  auto* r = static_cast<Result*>(h);
  auto it = r->node_lookup.find(std::string_view(name));
  return it == r->node_lookup.end() ? -1 : it->second;
}

// Component name -> index (= its parameter slot, netlist order).  Backs
// the lazy param_slot mapping so native-parsed stamps compose with
// BatchedSolver.params_with / monte_carlo without building Python dicts.
int64_t fn_comp_id(void* h, const char* name) {
  auto* r = static_cast<Result*>(h);
  auto it = r->comp_lookup.find(std::string_view(name));
  return it == r->comp_lookup.end() ? -1 : it->second;
}

void fn_free(void* h) { delete static_cast<Result*>(h); }

}  // extern "C"
