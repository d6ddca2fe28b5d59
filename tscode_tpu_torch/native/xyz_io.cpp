// Native multi-frame .xyz ensemble parser / formatter.
//
// Host-side IO runtime for the TPU framework: at 100k-pose ensemble
// scale the Python line-by-line reader (io_xyz.py) dominates wall time
// around the device pipeline, so parsing and formatting are done here
// in a single pass over the raw buffer. Semantics mirror io_xyz.read_xyz
// exactly (which itself replaces the reference's cclib ccread,
// reference utils.py:128-135): blank lines between frames are skipped,
// the atom-count line may carry trailing tokens, element symbols may be
// numeric, frames must agree on the atom sequence.
//
// C ABI (ctypes): all functions return 0 on success or a negative
// error code; *err_line reports the 1-based offending line.
//   -1 bad/missing atom count        -2 truncated frame
//   -3 bad atom line                 -4 unknown element symbol
//   -5 inconsistent atoms            -6 no frames
//   -7 output buffer too small

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>

namespace {

// IUPAC element symbols, index = atomic number (Z), 0 unused.
const char* SYMBOLS[] = {
    "X",  "H",  "He", "Li", "Be", "B",  "C",  "N",  "O",  "F",  "Ne",
    "Na", "Mg", "Al", "Si", "P",  "S",  "Cl", "Ar", "K",  "Ca", "Sc",
    "Ti", "V",  "Cr", "Mn", "Fe", "Co", "Ni", "Cu", "Zn", "Ga", "Ge",
    "As", "Se", "Br", "Kr", "Rb", "Sr", "Y",  "Zr", "Nb", "Mo", "Tc",
    "Ru", "Rh", "Pd", "Ag", "Cd", "In", "Sn", "Sb", "Te", "I",  "Xe",
    "Cs", "Ba", "La", "Ce", "Pr", "Nd", "Pm", "Sm", "Eu", "Gd", "Tb",
    "Dy", "Ho", "Er", "Tm", "Yb", "Lu", "Hf", "Ta", "W",  "Re", "Os",
    "Ir", "Pt", "Au", "Hg", "Tl", "Pb", "Bi", "Po", "At", "Rn", "Fr",
    "Ra", "Ac", "Th", "Pa", "U",  "Np", "Pu", "Am", "Cm", "Bk", "Cf",
    "Es", "Fm", "Md", "No", "Lr", "Rf", "Db", "Sg", "Bh", "Hs", "Mt",
    "Ds", "Rg", "Cn", "Nh", "Fl", "Mc", "Lv", "Ts", "Og",
};
const int N_SYMBOLS = sizeof(SYMBOLS) / sizeof(SYMBOLS[0]);

inline bool is_space(char c) { return c == ' ' || c == '\t' || c == '\r'; }
inline bool is_digit(char c) { return c >= '0' && c <= '9'; }

// Z from an element symbol token (case-normalised like io_xyz._parse_symbol)
// or a numeric string; -1 if unknown.
int symbol_to_z(const char* tok, int len) {
    bool all_digits = len > 0;
    for (int i = 0; i < len; i++) all_digits = all_digits && is_digit(tok[i]);
    if (all_digits) {
        int z = 0;
        for (int i = 0; i < len; i++) z = z * 10 + (tok[i] - '0');
        return z;
    }
    if (len < 1 || len > 2) return -1;
    char norm[3] = {0, 0, 0};
    norm[0] = (tok[0] >= 'a' && tok[0] <= 'z') ? char(tok[0] - 32) : tok[0];
    if (len == 2)
        norm[1] = (tok[1] >= 'A' && tok[1] <= 'Z') ? char(tok[1] + 32) : tok[1];
    for (int z = 1; z < N_SYMBOLS; z++)
        if (strcmp(SYMBOLS[z], norm) == 0) return z;
    return -1;
}

struct Cursor {
    const char* buf;
    int64_t len;
    int64_t pos;
    int64_t line;     // 1-based line number of the NEXT line to read
};

// Advance to the next line; returns [start, end) of the line content
// (without the newline) or false at EOF.
bool next_line(Cursor& c, int64_t& start, int64_t& end) {
    if (c.pos >= c.len) return false;
    start = c.pos;
    while (c.pos < c.len && c.buf[c.pos] != '\n') c.pos++;
    end = c.pos;
    if (c.pos < c.len) c.pos++;     // skip '\n'
    if (end > start && c.buf[end - 1] == '\r') end--;
    c.line++;
    return true;
}

bool line_blank(const char* buf, int64_t s, int64_t e) {
    for (int64_t i = s; i < e; i++)
        if (!is_space(buf[i])) return false;
    return true;
}

// Parse the leading integer token of a line; false if not an integer.
bool parse_count(const char* buf, int64_t s, int64_t e, int64_t& out) {
    while (s < e && is_space(buf[s])) s++;
    int64_t t = s;
    while (t < e && !is_space(buf[t])) t++;
    if (t == s) return false;
    int64_t v = 0;
    for (int64_t i = s; i < t; i++) {
        if (!is_digit(buf[i])) return false;
        v = v * 10 + (buf[i] - '0');
    }
    out = v;
    return true;
}

// strtod over a token span (tokens are short; copy to a bounded buffer).
bool parse_double(const char* buf, int64_t s, int64_t e, double& out) {
    char tmp[64];
    int64_t n = e - s;
    if (n <= 0 || n >= 63) return false;
    memcpy(tmp, buf + s, n);
    tmp[n] = 0;
    char* endp = nullptr;
    out = strtod(tmp, &endp);
    return endp == tmp + n;
}

// Split an atom line into up to 4 leading tokens; returns token count.
int tokenize4(const char* buf, int64_t s, int64_t e, int64_t ts[4],
              int64_t te[4]) {
    int k = 0;
    int64_t i = s;
    while (i < e && k < 4) {
        while (i < e && is_space(buf[i])) i++;
        if (i >= e) break;
        ts[k] = i;
        while (i < e && !is_space(buf[i])) i++;
        te[k] = i;
        k++;
    }
    return k;
}

}  // namespace

extern "C" {

// First pass: frame/atom counts so the caller can allocate.
int64_t xyz_scan(const char* buf, int64_t len, int64_t* n_frames,
                 int64_t* n_atoms, int64_t* err_line) {
    Cursor c{buf, len, 0, 0};
    int64_t s, e, frames = 0, atoms = -1;
    while (next_line(c, s, e)) {
        if (line_blank(buf, s, e)) continue;
        int64_t n;
        if (!parse_count(buf, s, e, n)) { *err_line = c.line; return -1; }
        // need the comment line + n atom lines to exist
        int64_t need = n + 1;
        int64_t head_line = c.line;
        for (int64_t k = 0; k < need; k++) {
            if (!next_line(c, s, e)) { *err_line = head_line; return -2; }
        }
        if (atoms < 0) atoms = n;
        else if (atoms != n) { *err_line = head_line; return -5; }
        frames++;
    }
    if (frames == 0) { *err_line = 0; return -6; }
    *n_frames = frames;
    *n_atoms = atoms;
    return 0;
}

// Second pass: fill coords (n_frames*n_atoms*3), atomnos (n_atoms),
// comment spans (n_frames*2: byte offset, byte length).
int64_t xyz_parse(const char* buf, int64_t len, double* coords,
                  int64_t* atomnos, int64_t* comment_spans,
                  int64_t* err_line) {
    Cursor c{buf, len, 0, 0};
    int64_t s, e, frame = 0;
    bool first_frame = true;
    while (next_line(c, s, e)) {
        if (line_blank(buf, s, e)) continue;
        int64_t n;
        if (!parse_count(buf, s, e, n)) { *err_line = c.line; return -1; }
        if (!next_line(c, s, e)) { *err_line = c.line; return -2; }
        comment_spans[2 * frame] = s;
        comment_spans[2 * frame + 1] = e - s;
        for (int64_t j = 0; j < n; j++) {
            if (!next_line(c, s, e)) { *err_line = c.line; return -2; }
            int64_t ts[4], te[4];
            if (tokenize4(buf, s, e, ts, te) < 4) {
                *err_line = c.line; return -3;
            }
            int z = symbol_to_z(buf + ts[0], int(te[0] - ts[0]));
            if (z < 0) { *err_line = c.line; return -4; }
            if (first_frame) atomnos[j] = z;
            else if (atomnos[j] != z) { *err_line = c.line; return -5; }
            double* out = coords + (frame * n + j) * 3;
            for (int k = 0; k < 3; k++) {
                if (!parse_double(buf, ts[k + 1], te[k + 1], out[k])) {
                    *err_line = c.line; return -3;
                }
            }
        }
        first_frame = false;
        frame++;
    }
    return frame == 0 ? -6 : 0;
}

// Format an ensemble in the io_xyz.write_xyz layout:
//   "<n>\n<title>\n<Sym>     % .6f % .6f % .6f\n" x n, per frame.
// titles: concatenated NUL-separated frame titles. Returns bytes
// written, or -7 if out_cap is too small (call again with the returned
// |value| as capacity after a probe with out == nullptr is NOT
// supported — size generously: 64 bytes/atom + title lengths).
int64_t xyz_format(const double* coords, const int64_t* atomnos,
                   int64_t n_frames, int64_t n_atoms, const char* titles,
                   char* out, int64_t out_cap) {
    int64_t w = 0;
    const char* title = titles;
    for (int64_t f = 0; f < n_frames; f++) {
        int64_t tl = int64_t(strlen(title));
        // count + title lines
        if (w + tl + 32 > out_cap) return -7;
        w += snprintf(out + w, out_cap - w, "%lld\n", (long long)n_atoms);
        memcpy(out + w, title, tl);
        w += tl;
        out[w++] = '\n';
        title += tl + 1;
        for (int64_t j = 0; j < n_atoms; j++) {
            if (w + 80 > out_cap) return -7;
            int64_t z = atomnos[j];
            const char* sym = (z > 0 && z < N_SYMBOLS) ? SYMBOLS[z] : "X";
            const double* p = coords + (f * n_atoms + j) * 3;
            w += snprintf(out + w, out_cap - w,
                          "%s     % .6f % .6f % .6f\n", sym,
                          p[0], p[1], p[2]);
        }
    }
    return w;
}

}  // extern "C"
