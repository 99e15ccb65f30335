// metafilter: columnar metadata store + vectorized filter evaluation.
//
// The native substrate of the filter/hybrid query path.  The reference's only native
// component was third-party hnswlib (C++ distance kernels); here the distance path runs
// on the accelerator, and the native layer instead owns the host-side hot loop the
// accelerator cannot help with: compiling a metadata filter into a slot-aligned bitmask
// over millions of rows without a per-row Python walk.
//
// Data model (mirrors mlvectordb_tpu/filters.py semantics EXACTLY — tests compare):
//   * metadata dicts are flattened to dotted paths ("a.b.c")
//   * leaf values are typed: null / bool / number / string; bools compare numerically
//     (Python True == 1), strings compare lexicographically, cross-type ordering
//     comparisons are false (Python TypeError -> False), cross-type equality is false
//     (except bool/number)
//   * non-leaf values (arrays / nested objects used as values) are stored as canonical
//     JSON strings: equality works, ordering is string-lexicographic like Python would
//     raise -> we mark them CJSON and make ordering false
//   * filter grammar: {"f": v}, {"f": {"$eq"/"$ne"/"$gt"/"$gte"/"$lt"/"$lte"/"$in"/
//     "$nin"/"$exists": ...}}, {"$and"/"$or": [...]}, {"$not": {...}}
//
// C ABI (ctypes):
//   void*  mf_create(int64 capacity);
//   void   mf_destroy(void*);
//   void   mf_resize(void*, int64 new_capacity);
//   int    mf_set(void*, int64 slot, const char* json, int64 len);   // 0 ok, <0 error
//   void   mf_clear(void*, int64 slot);
//   int64  mf_eval(void*, const char* filter_json, int64 len, uint8_t* out_mask,
//                  int64 capacity);   // writes 0/1 per slot; returns matches or <0
//
// Build: native/Makefile -> libmetafilter.so (loaded via ctypes by
// mlvectordb_tpu/native/__init__.py, which auto-builds on first use).

#include <cstdint>
#include <cstring>
#include <cmath>
#include <map>
#include <memory>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

// ----------------------------------------------------------------------------- values

enum class Tag : uint8_t { Missing = 0, Null, Bool, Num, Str, CJson };

struct Value {
  Tag tag = Tag::Missing;
  double num = 0.0;   // Bool/Num
  int32_t str = -1;   // interned string id (Str/CJson)
};

// ----------------------------------------------------------------------------- JSON

struct Parser {
  const char* p;
  const char* end;
  bool ok = true;

  explicit Parser(const char* s, size_t n) : p(s), end(s + n) {}

  void ws() {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r')) ++p;
  }
  bool lit(const char* s) {
    size_t n = std::strlen(s);
    if (size_t(end - p) >= n && std::memcmp(p, s, n) == 0) { p += n; return true; }
    return false;
  }
  bool parse_string(std::string& out) {
    if (p >= end || *p != '"') return false;
    ++p;
    out.clear();
    while (p < end && *p != '"') {
      char c = *p++;
      if (c == '\\' && p < end) {
        char e = *p++;
        switch (e) {
          case 'n': out.push_back('\n'); break;
          case 't': out.push_back('\t'); break;
          case 'r': out.push_back('\r'); break;
          case 'b': out.push_back('\b'); break;
          case 'f': out.push_back('\f'); break;
          case '/': out.push_back('/'); break;
          case '\\': out.push_back('\\'); break;
          case '"': out.push_back('"'); break;
          case 'u': {  // \uXXXX -> UTF-8
            if (end - p < 4) return false;
            unsigned cp = 0;
            for (int i = 0; i < 4; i++) {
              char h = *p++;
              cp <<= 4;
              if (h >= '0' && h <= '9') cp |= h - '0';
              else if (h >= 'a' && h <= 'f') cp |= h - 'a' + 10;
              else if (h >= 'A' && h <= 'F') cp |= h - 'A' + 10;
              else return false;
            }
            if (cp < 0x80) out.push_back(char(cp));
            else if (cp < 0x800) {
              out.push_back(char(0xC0 | (cp >> 6)));
              out.push_back(char(0x80 | (cp & 0x3F)));
            } else {
              out.push_back(char(0xE0 | (cp >> 12)));
              out.push_back(char(0x80 | ((cp >> 6) & 0x3F)));
              out.push_back(char(0x80 | (cp & 0x3F)));
            }
            break;
          }
          default: return false;
        }
      } else {
        out.push_back(c);
      }
    }
    if (p >= end) return false;
    ++p;  // closing quote
    return true;
  }
  bool parse_number(double& out) {
    char* endp = nullptr;
    out = std::strtod(p, &endp);
    if (endp == p) return false;
    p = endp;
    return true;
  }
  // skip any JSON value, appending its canonical text to `canon` if non-null
  bool skip_value(std::string* canon);
};

// canonical-JSON writer used for complex values (arrays/objects) so equality matches
// Python's dict/list equality for identical structures serialized the same way
// (json.dumps with sort_keys in the Python wrapper guarantees canonical input).
bool Parser::skip_value(std::string* canon) {
  ws();
  if (p >= end) return false;
  char c = *p;
  if (c == '"') {
    std::string s;
    if (!parse_string(s)) return false;
    if (canon) {
      canon->push_back('"');
      *canon += s;
      canon->push_back('"');
    }
    return true;
  }
  if (c == '{') {
    ++p;
    if (canon) canon->push_back('{');
    ws();
    bool first = true;
    while (p < end && *p != '}') {
      if (!first) {
        if (*p != ',') return false;
        ++p;
        if (canon) canon->push_back(',');
        ws();
      }
      first = false;
      std::string key;
      if (!parse_string(key)) return false;
      if (canon) { canon->push_back('"'); *canon += key; canon->push_back('"'); }
      ws();
      if (p >= end || *p != ':') return false;
      ++p;
      if (canon) canon->push_back(':');
      if (!skip_value(canon)) return false;
      ws();
    }
    if (p >= end) return false;
    ++p;
    if (canon) canon->push_back('}');
    return true;
  }
  if (c == '[') {
    ++p;
    if (canon) canon->push_back('[');
    ws();
    bool first = true;
    while (p < end && *p != ']') {
      if (!first) {
        if (*p != ',') return false;
        ++p;
        if (canon) canon->push_back(',');
      }
      first = false;
      if (!skip_value(canon)) return false;
      ws();
    }
    if (p >= end) return false;
    ++p;
    if (canon) canon->push_back(']');
    return true;
  }
  if (lit("true")) { if (canon) *canon += "true"; return true; }
  if (lit("false")) { if (canon) *canon += "false"; return true; }
  if (lit("null")) { if (canon) *canon += "null"; return true; }
  double d;
  const char* start = p;
  if (!parse_number(d)) return false;
  if (canon) canon->append(start, p);
  return true;
}

// ----------------------------------------------------------------------------- store

struct Column {
  std::vector<Value> vals;  // indexed by slot
  explicit Column(int64_t cap) : vals(cap) {}
};

struct Store {
  int64_t capacity;
  std::unordered_map<std::string, std::unique_ptr<Column>> columns;
  std::unordered_map<std::string, int32_t> intern;
  std::vector<std::string> strings;
  // fields present per slot (to clear on overwrite without scanning all columns)
  std::vector<std::vector<std::string>> slot_fields;

  explicit Store(int64_t cap) : capacity(cap), slot_fields(cap) {}

  int32_t intern_str(const std::string& s) {
    auto it = intern.find(s);
    if (it != intern.end()) return it->second;
    int32_t id = int32_t(strings.size());
    strings.push_back(s);
    intern.emplace(s, id);
    return id;
  }

  Column& column(const std::string& name) {
    auto it = columns.find(name);
    if (it != columns.end()) return *it->second;
    auto col = std::make_unique<Column>(capacity);
    Column& ref = *col;
    columns.emplace(name, std::move(col));
    return ref;
  }

  void clear_slot(int64_t slot) {
    if (slot < 0 || slot >= capacity) return;
    for (const auto& f : slot_fields[slot]) {
      auto it = columns.find(f);
      if (it != columns.end()) it->second->vals[slot] = Value{};
    }
    slot_fields[slot].clear();
  }

  void resize(int64_t new_cap) {
    for (auto& kv : columns) kv.second->vals.resize(new_cap);
    slot_fields.resize(new_cap);
    capacity = new_cap;
  }

  void set_field(int64_t slot, const std::string& path, const Value& v) {
    column(path).vals[slot] = v;
    slot_fields[slot].push_back(path);
  }

  // parse one metadata object, flattening nested dicts into dotted paths
  bool set_meta(int64_t slot, const char* json, size_t len) {
    if (slot < 0 || slot >= capacity) return false;
    clear_slot(slot);
    Parser ps(json, len);
    ps.ws();
    if (ps.p >= ps.end || *ps.p != '{') return false;
    return parse_object(ps, slot, "");
  }

  bool parse_object(Parser& ps, int64_t slot, const std::string& prefix) {
    ++ps.p;  // '{'
    ps.ws();
    bool first = true;
    while (ps.p < ps.end && *ps.p != '}') {
      if (!first) {
        if (*ps.p != ',') return false;
        ++ps.p;
        ps.ws();
      }
      first = false;
      std::string key;
      if (!ps.parse_string(key)) return false;
      ps.ws();
      if (ps.p >= ps.end || *ps.p != ':') return false;
      ++ps.p;
      ps.ws();
      std::string path = prefix.empty() ? key : prefix + "." + key;
      char c = ps.p < ps.end ? *ps.p : 0;
      Value v;
      if (c == '{') {
        // nested object: recurse for dotted access AND store canonical JSON for equality
        const char* start = ps.p;
        Parser probe(ps.p, ps.end - ps.p);
        std::string canon;
        if (!probe.skip_value(&canon)) return false;
        v.tag = Tag::CJson;
        v.str = intern_str(canon);
        set_field(slot, path, v);
        if (!parse_object(ps, slot, path)) return false;
        (void)start;
      } else if (c == '[') {
        std::string canon;
        if (!ps.skip_value(&canon)) return false;
        v.tag = Tag::CJson;
        v.str = intern_str(canon);
        set_field(slot, path, v);
      } else if (c == '"') {
        std::string s;
        if (!ps.parse_string(s)) return false;
        v.tag = Tag::Str;
        v.str = intern_str(s);
        set_field(slot, path, v);
      } else if (ps.lit("true")) {
        v.tag = Tag::Bool; v.num = 1.0;
        set_field(slot, path, v);
      } else if (ps.lit("false")) {
        v.tag = Tag::Bool; v.num = 0.0;
        set_field(slot, path, v);
      } else if (ps.lit("null")) {
        v.tag = Tag::Null;
        set_field(slot, path, v);
      } else {
        double d;
        if (!ps.parse_number(d)) return false;
        v.tag = Tag::Num; v.num = d;
        set_field(slot, path, v);
      }
      ps.ws();
    }
    if (ps.p >= ps.end) return false;
    ++ps.p;  // '}'
    return true;
  }
};

// ----------------------------------------------------------------------------- filters

struct FilterVal {  // a literal appearing in a filter
  Tag tag = Tag::Null;
  double num = 0.0;
  std::string str;       // raw string or canonical JSON
};

enum class Op { Eq, Ne, Gt, Gte, Lt, Lte, In, Nin, Exists };

struct Pred {
  std::string field;
  Op op;
  std::vector<FilterVal> args;  // In/Nin: many; others: one
  bool exists_arg = false;
};

struct Node {
  enum class Kind { And, Or, Not, Pred } kind;
  std::vector<Node> children;
  Pred pred;
};

bool num_like(Tag t) { return t == Tag::Num || t == Tag::Bool; }

bool val_eq(const Store& st, const Value& v, const FilterVal& a) {
  if (v.tag == Tag::Missing) return false;
  if (num_like(v.tag) && num_like(a.tag)) return v.num == a.num;  // Python True == 1
  if (v.tag != a.tag) return false;
  switch (v.tag) {
    case Tag::Null: return true;
    case Tag::Str:
    case Tag::CJson: return st.strings[v.str] == a.str;
    default: return v.num == a.num;
  }
}

// ordering: Python raises TypeError on cross-type -> False; num/bool interoperate;
// strings compare lexicographically
int val_cmp(const Store& st, const Value& v, const FilterVal& a, bool& comparable) {
  comparable = false;
  if (v.tag == Tag::Missing) return 0;
  if (num_like(v.tag) && num_like(a.tag)) {
    comparable = true;
    return v.num < a.num ? -1 : (v.num > a.num ? 1 : 0);
  }
  if (v.tag == Tag::Str && a.tag == Tag::Str) {
    comparable = true;
    return st.strings[v.str].compare(a.str);
  }
  return 0;
}

bool eval_pred(const Store& st, const Pred& pr, const Value& v) {
  switch (pr.op) {
    case Op::Exists:
      return (v.tag != Tag::Missing) == pr.exists_arg;
    case Op::Eq:
      return val_eq(st, v, pr.args[0]);
    case Op::Ne:
      if (v.tag == Tag::Missing) return true;  // Python: missing != x
      return !val_eq(st, v, pr.args[0]);
    case Op::In: {
      if (v.tag == Tag::Missing) return false;
      for (const auto& a : pr.args) if (val_eq(st, v, a)) return true;
      return false;
    }
    case Op::Nin: {
      if (v.tag == Tag::Missing) return true;
      for (const auto& a : pr.args) if (val_eq(st, v, a)) return false;
      return true;
    }
    default: {
      if (v.tag == Tag::Missing) return false;
      bool comparable;
      int c = val_cmp(st, v, pr.args[0], comparable);
      if (!comparable) return false;
      switch (pr.op) {
        case Op::Gt: return c > 0;
        case Op::Gte: return c >= 0;
        case Op::Lt: return c < 0;
        case Op::Lte: return c <= 0;
        default: return false;
      }
    }
  }
}

// ---- filter JSON -> Node tree

bool parse_filter_val(Parser& ps, FilterVal& out) {
  ps.ws();
  if (ps.p >= ps.end) return false;
  char c = *ps.p;
  if (c == '"') {
    out.tag = Tag::Str;
    return ps.parse_string(out.str);
  }
  if (c == '{' || c == '[') {
    out.tag = Tag::CJson;
    out.str.clear();
    return ps.skip_value(&out.str);
  }
  if (ps.lit("true")) { out.tag = Tag::Bool; out.num = 1.0; return true; }
  if (ps.lit("false")) { out.tag = Tag::Bool; out.num = 0.0; return true; }
  if (ps.lit("null")) { out.tag = Tag::Null; return true; }
  out.tag = Tag::Num;
  return ps.parse_number(out.num);
}

bool parse_filter_node(Parser& ps, Node& out);

bool parse_filter_list(Parser& ps, std::vector<Node>& out) {
  ps.ws();
  if (ps.p >= ps.end || *ps.p != '[') return false;
  ++ps.p;
  ps.ws();
  bool first = true;
  while (ps.p < ps.end && *ps.p != ']') {
    if (!first) {
      if (*ps.p != ',') return false;
      ++ps.p;
      ps.ws();
    }
    first = false;
    out.emplace_back();
    if (!parse_filter_node(ps, out.back())) return false;
    ps.ws();
  }
  if (ps.p >= ps.end) return false;
  ++ps.p;
  return true;
}

bool op_from_name(const std::string& s, Op& op) {
  if (s == "$eq") op = Op::Eq;
  else if (s == "$ne") op = Op::Ne;
  else if (s == "$gt") op = Op::Gt;
  else if (s == "$gte") op = Op::Gte;
  else if (s == "$lt") op = Op::Lt;
  else if (s == "$lte") op = Op::Lte;
  else if (s == "$in") op = Op::In;
  else if (s == "$nin") op = Op::Nin;
  else if (s == "$exists") op = Op::Exists;
  else return false;
  return true;
}

// one {...} filter object -> implicit AND over entries
bool parse_filter_node(Parser& ps, Node& out) {
  ps.ws();
  if (ps.p >= ps.end || *ps.p != '{') return false;
  ++ps.p;
  out.kind = Node::Kind::And;
  ps.ws();
  bool first = true;
  while (ps.p < ps.end && *ps.p != '}') {
    if (!first) {
      if (*ps.p != ',') return false;
      ++ps.p;
      ps.ws();
    }
    first = false;
    std::string key;
    if (!ps.parse_string(key)) return false;
    ps.ws();
    if (ps.p >= ps.end || *ps.p != ':') return false;
    ++ps.p;
    ps.ws();
    if (key == "$and" || key == "$or") {
      Node child;
      child.kind = key == "$and" ? Node::Kind::And : Node::Kind::Or;
      if (!parse_filter_list(ps, child.children)) return false;
      out.children.push_back(std::move(child));
    } else if (key == "$not") {
      Node child;
      child.kind = Node::Kind::Not;
      child.children.emplace_back();
      if (!parse_filter_node(ps, child.children.back())) return false;
      out.children.push_back(std::move(child));
    } else if (!key.empty() && key[0] == '$') {
      return false;  // unknown top-level operator
    } else {
      // field: either an operator object or a literal (equality shorthand)
      ps.ws();
      bool is_op_obj = false;
      if (ps.p < ps.end && *ps.p == '{') {
        // peek: operator object iff any key starts with '$' (mirrors filters.py)
        Parser probe(ps.p, ps.end - ps.p);
        ++probe.p;
        probe.ws();
        if (probe.p < probe.end && *probe.p == '"') {
          std::string k2;
          if (probe.parse_string(k2) && !k2.empty() && k2[0] == '$') is_op_obj = true;
        }
      }
      if (is_op_obj) {
        ++ps.p;  // '{'
        ps.ws();
        bool f2 = true;
        while (ps.p < ps.end && *ps.p != '}') {
          if (!f2) {
            if (*ps.p != ',') return false;
            ++ps.p;
            ps.ws();
          }
          f2 = false;
          std::string opname;
          if (!ps.parse_string(opname)) return false;
          ps.ws();
          if (ps.p >= ps.end || *ps.p != ':') return false;
          ++ps.p;
          Node leaf;
          leaf.kind = Node::Kind::Pred;
          leaf.pred.field = key;
          if (!op_from_name(opname, leaf.pred.op)) return false;
          if (leaf.pred.op == Op::In || leaf.pred.op == Op::Nin) {
            ps.ws();
            if (ps.p >= ps.end || *ps.p != '[') return false;
            ++ps.p;
            ps.ws();
            bool f3 = true;
            while (ps.p < ps.end && *ps.p != ']') {
              if (!f3) {
                if (*ps.p != ',') return false;
                ++ps.p;
              }
              f3 = false;
              FilterVal fv;
              if (!parse_filter_val(ps, fv)) return false;
              leaf.pred.args.push_back(std::move(fv));
              ps.ws();
            }
            if (ps.p >= ps.end) return false;
            ++ps.p;
          } else if (leaf.pred.op == Op::Exists) {
            FilterVal fv;
            if (!parse_filter_val(ps, fv)) return false;
            leaf.pred.exists_arg = fv.num != 0.0;  // Python truthiness of the $exists arg
          } else {
            FilterVal fv;
            if (!parse_filter_val(ps, fv)) return false;
            // Python supports sequence-vs-sequence ordering ([1,2] <= [1,3]); this
            // engine does not encode it — reject so the caller falls back to Python.
            bool ordering = leaf.pred.op == Op::Gt || leaf.pred.op == Op::Gte ||
                            leaf.pred.op == Op::Lt || leaf.pred.op == Op::Lte;
            if (ordering && fv.tag == Tag::CJson) return false;
            leaf.pred.args.push_back(std::move(fv));
          }
          out.children.push_back(std::move(leaf));
          ps.ws();
        }
        if (ps.p >= ps.end) return false;
        ++ps.p;
      } else {
        Node leaf;
        leaf.kind = Node::Kind::Pred;
        leaf.pred.field = key;
        leaf.pred.op = Op::Eq;
        FilterVal fv;
        if (!parse_filter_val(ps, fv)) return false;
        leaf.pred.args.push_back(std::move(fv));
        out.children.push_back(std::move(leaf));
      }
    }
    ps.ws();
  }
  if (ps.p >= ps.end) return false;
  ++ps.p;
  return true;
}

// vectorized evaluation: leaf predicates loop over their column once; And/Or combine
// child masks with a per-level temporary
void eval_node_safe(const Store& st, const Node& n, uint8_t* mask, int64_t cap) {
  switch (n.kind) {
    case Node::Kind::Pred: {
      auto it = st.columns.find(n.pred.field);
      const Column* col = it == st.columns.end() ? nullptr : it->second.get();
      static const Value missing{};
      for (int64_t i = 0; i < cap; i++) {
        const Value& v = col ? col->vals[i] : missing;
        mask[i] = eval_pred(st, n.pred, v) ? 1 : 0;
      }
      break;
    }
    case Node::Kind::And: {
      std::memset(mask, 1, size_t(cap));
      std::vector<uint8_t> tmp(cap);
      for (const auto& c : n.children) {
        eval_node_safe(st, c, tmp.data(), cap);
        for (int64_t i = 0; i < cap; i++) mask[i] &= tmp[i];
      }
      break;
    }
    case Node::Kind::Or: {
      std::memset(mask, 0, size_t(cap));
      std::vector<uint8_t> tmp(cap);
      for (const auto& c : n.children) {
        eval_node_safe(st, c, tmp.data(), cap);
        for (int64_t i = 0; i < cap; i++) mask[i] |= tmp[i];
      }
      break;
    }
    case Node::Kind::Not: {
      eval_node_safe(st, n.children[0], mask, cap);
      for (int64_t i = 0; i < cap; i++) mask[i] = mask[i] ? 0 : 1;
      break;
    }
  }
}

}  // namespace

// ----------------------------------------------------------------------------- C ABI

extern "C" {

void* mf_create(int64_t capacity) { return new Store(capacity); }

void mf_destroy(void* h) { delete static_cast<Store*>(h); }

void mf_resize(void* h, int64_t new_cap) { static_cast<Store*>(h)->resize(new_cap); }

int mf_set(void* h, int64_t slot, const char* json, int64_t len) {
  return static_cast<Store*>(h)->set_meta(slot, json, size_t(len)) ? 0 : -1;
}

void mf_clear(void* h, int64_t slot) { static_cast<Store*>(h)->clear_slot(slot); }

int mf_set_many(void* h, const int64_t* slots, const char* concat_json,
                const int64_t* offsets, int64_t n) {
  // offsets has n+1 entries delimiting each slot's JSON blob in concat_json
  Store* st = static_cast<Store*>(h);
  for (int64_t i = 0; i < n; i++) {
    const char* p = concat_json + offsets[i];
    size_t len = size_t(offsets[i + 1] - offsets[i]);
    if (!st->set_meta(slots[i], p, len)) return -int(i) - 1;
  }
  return 0;
}

int64_t mf_eval(void* h, const char* filter_json, int64_t len, uint8_t* out_mask,
                int64_t capacity) {
  Store* st = static_cast<Store*>(h);
  if (capacity > st->capacity) return -2;
  Parser ps(filter_json, size_t(len));
  Node root;
  if (!parse_filter_node(ps, root)) return -1;
  eval_node_safe(*st, root, out_mask, capacity);
  int64_t count = 0;
  for (int64_t i = 0; i < capacity; i++) count += out_mask[i];
  return count;
}

}  // extern "C"
