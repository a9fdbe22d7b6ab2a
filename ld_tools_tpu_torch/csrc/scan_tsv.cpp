// The ld_scan TSV's hit lines, rendered from numbers straight to bytes.
//
// Host code (g++, not nvcc): built by io/scan_tsv.py into _build/ and
// bound with ctypes.  One line per hit k:
//
//   pos[i[k]] \t rsid[i[k]] \t pos[j[k]] \t rsid[j[k]] \t
//   pos[i[k]] - pos[j[k]] \t r2 \t D' \n
//
// Each LD value comes as its 4-place integer m = rint(round4(v) * 1e4)
// and a flag: FLAG_INT_ZERO prints "0" (the reference's int 0),
// FLAG_NEG_ZERO "-0.0", anything else the sign, |m| / 10000, ".", and the
// four fraction digits with trailing zeros stripped, keeping one.  That
// is str(round(v, 4)) for every |m| < 10^15 (the caller checks the
// bound).  The rsIDs are read from a numpy '<U' array (UCS4, NUL-padded
// to the itemsize); a code point above 127 stops the rendering, since the
// file's text is then the locale's encoding and not ASCII.

#include <cstdint>
#include <cstring>

namespace {

constexpr uint8_t FLAG_INT_ZERO = 1;
constexpr uint8_t FLAG_NEG_ZERO = 2;

// "00" to "99", two characters each
constexpr char kPairs[] =
    "00010203040506070809101112131415161718192021222324252627282930313233"
    "34353637383940414243444546474849505152535455565758596061626364656667"
    "6869707172737475767778798081828384858687888990919293949596979899";

// decimal digits of u, most significant first; returns the end of them
inline char* put_uint(char* out, uint64_t u) {
    char tmp[20];
    char* t = tmp + sizeof tmp;
    while (u >= 100) {
        t -= 2;
        std::memcpy(t, kPairs + 2 * (u % 100), 2);
        u /= 100;
    }
    if (u >= 10) {
        t -= 2;
        std::memcpy(t, kPairs + 2 * u, 2);
    } else {
        *--t = static_cast<char>('0' + u);
    }
    const size_t n = tmp + sizeof tmp - t;
    std::memcpy(out, t, n);
    return out + n;
}

inline char* put_int(char* out, int64_t v) {
    if (v < 0) {
        *out++ = '-';
        return put_uint(out, 0 - static_cast<uint64_t>(v));
    }
    return put_uint(out, static_cast<uint64_t>(v));
}

inline char* put_value(char* out, int64_t m, uint8_t flag) {
    if (flag == FLAG_INT_ZERO) {
        *out++ = '0';
        return out;
    }
    if (flag == FLAG_NEG_ZERO) {
        std::memcpy(out, "-0.0", 4);
        return out + 4;
    }
    uint64_t a = static_cast<uint64_t>(m);
    if (m < 0) {
        *out++ = '-';
        a = 0 - a;
    }
    out = put_uint(out, a / 10000);
    *out++ = '.';
    unsigned frac = static_cast<unsigned>(a % 10000);
    int digits = 4;
    while (digits > 1 && frac % 10 == 0) {
        frac /= 10;
        --digits;
    }
    for (int d = digits - 1; d >= 0; --d) {
        out[d] = static_cast<char>('0' + frac % 10);
        frac /= 10;
    }
    return out + digits;
}

// the rsID at row r without its NUL padding; false past ASCII
inline bool put_rsid(char** out, const uint32_t* rsid, int64_t width,
                     int64_t r) {
    const uint32_t* s = rsid + r * width;
    int64_t n = width;
    while (n > 0 && s[n - 1] == 0) --n;
    char* o = *out;
    for (int64_t c = 0; c < n; ++c) {
        if (s[c] > 127) return false;
        o[c] = static_cast<char>(s[c]);
    }
    *out = o + n;
    return true;
}

}  // namespace

extern "C" {

// The longest line of a row, in bytes: three integers of at most 20
// digits and a sign, two values of at most 17 characters (|m| < 10^15),
// the two rsIDs and seven separators, rounded up.
int64_t st_line_max(int64_t rsid_width) { return 128 + 2 * rsid_width; }

// Renders rows begin, begin + 1, ... of end into buf while a whole line
// still fits in cap bytes; *n_bytes is what was written.  Returns the row
// after the last one rendered, or -1 where an rsID holds a code point
// above 127 (nothing of that row counts).
int64_t st_render(const int64_t* pos, const uint32_t* rsid,
                  int64_t rsid_width, const int64_t* i, const int64_t* j,
                  const int64_t* m_r2, const uint8_t* f_r2,
                  const int64_t* m_dp, const uint8_t* f_dp, int64_t begin,
                  int64_t end, char* buf, int64_t cap, int64_t* n_bytes) {
    const int64_t line_max = st_line_max(rsid_width);
    char* out = buf;
    int64_t k = begin;
    for (; k < end && (out - buf) + line_max <= cap; ++k) {
        const int64_t a = i[k], b = j[k];
        out = put_int(out, pos[a]);
        *out++ = '\t';
        if (!put_rsid(&out, rsid, rsid_width, a)) return -1;
        *out++ = '\t';
        out = put_int(out, pos[b]);
        *out++ = '\t';
        if (!put_rsid(&out, rsid, rsid_width, b)) return -1;
        *out++ = '\t';
        out = put_int(out, pos[a] - pos[b]);
        *out++ = '\t';
        out = put_value(out, m_r2[k], f_r2[k]);
        *out++ = '\t';
        out = put_value(out, m_dp[k], f_dp[k]);
        *out++ = '\n';
    }
    *n_bytes = out - buf;
    return k;
}

}  // extern "C"
