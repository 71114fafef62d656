// Native ASCII-PLY row parser — the read-side twin of ply_writer.cpp.
//
// The Python fallback (numpy.loadtxt) burns seconds on the ~500k-vertex
// clouds the pipeline writes (utils/render_ply, utils/outlier_removal read
// them back); this parses the numeric rows with strtod in one pass.
// Python keeps header parsing (tiny, and layout-flexible): it passes the
// byte offset where rows start and the expected row/column counts.
//
// Returns the number of rows parsed (== n_rows on success), or -1 on I/O
// error. Short files return the partial count; callers treat != n_rows as
// failure and fall back.

#include <charconv>
#include <cstdio>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" int64_t read_ply_rows(const char* path, int64_t header_bytes,
                                 double* out, int64_t n_rows, int32_t n_cols) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    if (std::fseek(f, static_cast<long>(header_bytes), SEEK_SET) != 0) {
        std::fclose(f);
        return -1;
    }
    // Read the remainder in one gulp: ASCII rows are ~50 bytes each; even a
    // 2M-point cloud is ~100 MB, well within host RAM, and one read beats
    // per-line getline by a wide margin.
    long row_start = std::ftell(f);
    std::fseek(f, 0, SEEK_END);
    long end = std::ftell(f);
    std::fseek(f, row_start, SEEK_SET);
    size_t len = static_cast<size_t>(end - row_start);
    std::vector<char> buf(len + 1);
    size_t got = std::fread(buf.data(), 1, len, f);
    std::fclose(f);
    buf[got] = '\0';

    const char* p = buf.data();
    const char* end_p = buf.data() + got;
    int64_t total = n_rows * n_cols;
    int64_t i = 0;
    // std::from_chars: locale-free, no errno, ~2x strtod on number-dense text
    while (i < total) {
        while (p < end_p && (*p == ' ' || *p == '\n' || *p == '\r' || *p == '\t'))
            ++p;
        if (p >= end_p) break;
        double v;
        auto res = std::from_chars(p, end_p, v);
        if (res.ec != std::errc()) break;  // not a number
        out[i++] = v;
        p = res.ptr;
    }
    return i / n_cols;
}
