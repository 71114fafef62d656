// Fast ASCII PLY writer — native replacement for the numpy-savetxt row
// formatting in io/ply.py (the reference formatted 100k+ rows per frame
// through Python, point_cloud_2_ply.py:70). Emits byte-identical output:
// '%f %f %f %d %d %d' rows under the reference header.
//
// Built on demand by native/build.py (g++ -O3); bound with ctypes by
// io/ply.py.

#include <cstdint>
#include <cstdio>
#include <cstring>

namespace {

// printf("%f") semantics: fixed 6 decimals, matching numpy's '%f'.
inline int fmt_row(char* out, const double* p, const double* c) {
    return std::sprintf(out, "%f %f %f %d %d %d\n", p[0], p[1], p[2],
                        static_cast<int>(c[0]), static_cast<int>(c[1]),
                        static_cast<int>(c[2]));
}

}  // namespace

extern "C" {

// Write an ASCII PLY. points/colors: row-major (n, 3) float64. header: the
// fully formatted header string (vertex count already substituted).
// Returns 0 on success, nonzero errno-style code on failure.
int write_ply_ascii(const char* path, const char* header, const double* points,
                    const double* colors, int64_t n) {
    std::FILE* f = std::fopen(path, "w");
    if (!f) return 1;
    if (std::fputs(header, f) == EOF) {
        std::fclose(f);
        return 2;
    }
    // 6-decimal doubles can reach ~25 chars each; 3 ints ~12 each. 256 is
    // comfortably above any row this format can produce.
    constexpr int kRowMax = 256;
    constexpr int kRowsPerChunk = 4096;
    char* buf = new char[kRowMax * kRowsPerChunk];
    int64_t i = 0;
    int rc = 0;
    while (i < n) {
        char* w = buf;
        int64_t end = i + kRowsPerChunk < n ? i + kRowsPerChunk : n;
        for (; i < end; ++i) {
            w += fmt_row(w, points + 3 * i, colors + 3 * i);
        }
        if (std::fwrite(buf, 1, w - buf, f) != static_cast<size_t>(w - buf)) {
            rc = 3;
            break;
        }
    }
    delete[] buf;
    if (std::fclose(f) != 0 && rc == 0) rc = 4;
    return rc;
}

}  // extern "C"
