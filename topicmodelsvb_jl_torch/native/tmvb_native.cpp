// Native host-side corpus parser.
//
// The port's copy of the JAX package's native/tmvb_native.cpp, parse
// half: where TopicModelsVB.jl parses delimited doc blocks in Julia
// (readcorp, Corpus.jl:277-325), this does the byte-level work in C++.
// Loaded through ctypes by native/__init__.py, which builds it with g++
// at first use; corpus.readcorp keeps a pure-Python parser beside it.
//
// Build: g++ -O3 -shared -fPIC tmvb_native.cpp -o libtmvb_native.so

#include <cstdint>
#include <cstring>

extern "C" {

// Count lines and integer tokens in a delimited text buffer.
// A line is terminated by '\n' (a trailing unterminated line counts);
// '\r' before '\n' is ignored.  Empty lines contribute zero values.
void tmvb_count(const char* buf, int64_t n, char delim,
                int64_t* n_lines, int64_t* n_vals) {
    int64_t lines = 0, vals = 0;
    bool in_tok = false;
    int64_t i = 0;
    while (i < n) {
        char c = buf[i];
        if (c == '\n' || c == '\r') {
            if (in_tok) { ++vals; in_tok = false; }
            ++lines;
            if (c == '\r' && i + 1 < n && buf[i + 1] == '\n') ++i;
        } else if (c == delim) {
            if (in_tok) { ++vals; in_tok = false; }
        } else {
            in_tok = true;
        }
        ++i;
    }
    if (in_tok) ++vals;
    if (n > 0 && buf[n - 1] != '\n' && buf[n - 1] != '\r') ++lines;
    *n_lines = lines;
    *n_vals = vals;
}

// Parse every integer in the buffer.  Fills vals[n_vals] and
// line_off[n_lines + 1] (value-offset of each line; CSR layout).
// Returns 0 on success, or 1 + byte index of the first bad character.
//
// Strict by design — exactly the strings Python's
// ``[int(p) for p in line.split(delim)]`` accepts: a non-empty line is
// delim-separated decimal integers (optional leading '-'); empty tokens
// (",," / trailing ","), bare '-', whitespace, and any other byte are
// errors, so corpus loading behaves identically with or without the
// native library.
int64_t tmvb_parse(const char* buf, int64_t n, char delim,
                   int64_t* vals, int64_t* line_off) {
    int64_t vi = 0, li = 0;
    line_off[0] = 0;
    int64_t cur = 0;
    bool digits = false, neg = false, pending = false;
    for (int64_t i = 0; i < n; ++i) {
        char c = buf[i];
        if (c >= '0' && c <= '9') {
            int64_t d = c - '0';
            if (cur > (INT64_MAX - d) / 10)
                return 1 + i;                   // int64 overflow: fail loudly
            cur = cur * 10 + d;
            digits = true;
        } else if (c == '-' && !digits && !neg) {
            neg = true;
        } else if (c == delim) {
            if (!digits) return 1 + i;          // empty token or bare '-'
            vals[vi++] = neg ? -cur : cur;
            cur = 0; digits = false; neg = false;
            pending = true;
        } else if (c == '\n' || c == '\r') {
            if (digits) {
                vals[vi++] = neg ? -cur : cur;
                cur = 0; digits = false; neg = false;
            } else if (pending || neg) {
                return 1 + i;                   // trailing delim / bare '-'
            }
            pending = false;
            line_off[++li] = vi;                // \r, \n, \r\n: one break
            if (c == '\r' && i + 1 < n && buf[i + 1] == '\n') ++i;
        } else {
            return 1 + i;                       // bad character
        }
    }
    if (digits) vals[vi++] = neg ? -cur : cur;
    else if (pending || neg) return 1 + n - 1;
    if (n > 0 && buf[n - 1] != '\n' && buf[n - 1] != '\r') line_off[++li] = vi;
    return 0;
}

}  // extern "C"
