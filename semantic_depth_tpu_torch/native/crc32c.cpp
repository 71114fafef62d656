// CRC-32C (Castagnoli, reflected polynomial 0x82F63B78): the checksum of
// TensorFlow checkpoint tables and tensor data, read by
// models/tf_checkpoint.py. The plain Python version there computes the same
// value byte by byte; this one runs the SSE4.2 crc32 instruction 8 bytes at
// a time where the CPU has it, and a byte table on the tail (and on every
// byte where the CPU lacks SSE4.2).
//
// crc32c_extend(crc, data, n) continues a checksum as TensorFlow's
// crc32c::Extend does: crc32c_extend(0, data, n) is the checksum of data.
//
// Built on demand by native/build.py (g++ -O3); bound with ctypes.

#include <cstdint>
#include <cstring>

#if defined(__x86_64__)
#include <nmmintrin.h>
#endif

namespace {

struct Table {
    uint32_t t[256];
    Table() {
        for (uint32_t i = 0; i < 256; ++i) {
            uint32_t c = i;
            for (int k = 0; k < 8; ++k) c = (c >> 1) ^ ((c & 1u) ? 0x82F63B78u : 0u);
            t[i] = c;
        }
    }
};

// c: the running register (already inverted)
uint32_t crc_bytes(uint32_t c, const uint8_t* p, int64_t n) {
    static const Table tab;
    while (n-- > 0) c = (c >> 8) ^ tab.t[(c ^ *p++) & 0xFF];
    return c;
}

#if defined(__x86_64__)
// the 8-byte words; the tail goes through crc_bytes
__attribute__((target("sse4.2"))) uint32_t crc_sse42(uint32_t c, const uint8_t* p, int64_t n) {
    uint64_t c64 = c;
    for (; n >= 8; p += 8, n -= 8) {
        uint64_t v;
        std::memcpy(&v, p, 8);
        c64 = _mm_crc32_u64(c64, v);
    }
    return crc_bytes(static_cast<uint32_t>(c64), p, n);
}
#endif

}  // namespace

extern "C" uint32_t crc32c_extend(uint32_t crc, const uint8_t* data, int64_t n) {
    uint32_t c = ~crc;
    if (n <= 0) return crc;
#if defined(__x86_64__)
    if (__builtin_cpu_supports("sse4.2")) return ~crc_sse42(c, data, n);
#endif
    return ~crc_bytes(c, data, n);
}
