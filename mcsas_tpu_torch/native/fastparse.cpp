// fastparse.cpp — native tolerant ASCII table tokenizer for the SAS
// data loader.
//
// Implements the same dialect semantics as
// mcsas_tpu_torch.io.ascii.read_array (and the reference parser it
// mirrors, src/mcsas/datafile/asciifile.py:99-143): per line, a '.'
// anywhere makes ',' a field separator, otherwise ',' is a decimal
// separator; ';' and whitespace separate fields; blank
// lines are skipped anywhere; non-numeric lines are skipped before data
// starts and terminate the table after; a row with a different column
// count terminates the table.
//
// Built at first use by mcsas_tpu_torch/io/native.py into build/native/:
//   g++ -O3 -fPIC -std=c++17 -shared -o fastparse_<hash>.so fastparse.cpp
//
// C ABI for ctypes:
//   handle = mc_parse(text, len, skip_lines)
//   mc_rows(handle) / mc_cols(handle) / mc_copy(handle, out) / mc_free(handle)

#include <cstdlib>
#include <cstring>
#include <cctype>
#include <vector>

namespace {

struct ParseResult {
    std::vector<double> values;
    long rows = 0;
    long cols = 0;
};

// parses one line into vals; returns false if any token fails to convert
bool parse_line(const char* begin, const char* end,
                std::vector<double>& vals) {
    vals.clear();
    bool has_point = false;
    for (const char* p = begin; p < end; ++p) {
        if (*p == '.') { has_point = true; break; }
    }
    // working copy with dialect normalization
    std::vector<char> buf(begin, end);
    for (char& c : buf) {
        if (c == ';') c = ' ';
        else if (c == ',') c = has_point ? ' ' : '.';
        else if (c == '\t') c = ' ';
    }
    buf.push_back('\0');
    const char* s = buf.data();
    while (*s) {
        while (*s == ' ') ++s;
        if (!*s) break;
        char* endptr = nullptr;
        double v = std::strtod(s, &endptr);
        if (endptr == s) return false;            // non-numeric token
        if (*endptr && *endptr != ' ') return false;
        vals.push_back(v);
        s = endptr;
    }
    return !vals.empty();
}

bool is_blank(const char* begin, const char* end) {
    for (const char* p = begin; p < end; ++p) {
        if (!std::isspace(static_cast<unsigned char>(*p))) return false;
    }
    return true;
}

}  // namespace

extern "C" {

void* mc_parse(const char* text, long len, long skip_lines) {
    ParseResult* res = new ParseResult();
    std::vector<double> vals;
    const char* p = text;
    const char* textend = text + len;
    long lineno = 0;
    while (p < textend) {
        // find end of line: \n, \r\n or bare \r
        const char* eol = p;
        while (eol < textend && *eol != '\n' && *eol != '\r') ++eol;
        const char* next = eol;
        if (next < textend) {
            if (*next == '\r' && next + 1 < textend && next[1] == '\n')
                next += 2;
            else
                next += 1;
        }
        if (lineno++ < skip_lines) { p = next; continue; }
        if (is_blank(p, eol)) { p = next; continue; }
        bool ok = parse_line(p, eol, vals);
        if (!ok) {
            if (res->rows == 0) { p = next; continue; }  // header
            break;                                        // footer
        }
        if (res->rows > 0 && (long)vals.size() != res->cols) break;
        if (res->rows == 0) res->cols = (long)vals.size();
        res->values.insert(res->values.end(), vals.begin(), vals.end());
        res->rows += 1;
        p = next;
    }
    return res;
}

long mc_rows(void* h) { return static_cast<ParseResult*>(h)->rows; }
long mc_cols(void* h) { return static_cast<ParseResult*>(h)->cols; }

void mc_copy(void* h, double* out) {
    ParseResult* res = static_cast<ParseResult*>(h);
    std::memcpy(out, res->values.data(),
                res->values.size() * sizeof(double));
}

void mc_free(void* h) { delete static_cast<ParseResult*>(h); }

}  // extern "C"
