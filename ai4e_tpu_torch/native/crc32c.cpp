// CRC-32C (Castagnoli, reflected, init and final xor 0xFFFFFFFF) of a byte
// buffer: the task-store journal's record checksum
// (ai4e_tpu_torch/taskstore/journal.py), the same value as that module's
// table loop and the JAX package's. A land-cover task's journal record
// carries its 196 KB tile twice as hex, so the checksum runs over about
// 800 KB a create; the SSE4.2 crc32 instruction does that in well under a
// millisecond where the table loop in Python takes a quarter of a second.
// CPUs without SSE4.2 get the byte-at-a-time table.
#include <cstddef>
#include <cstdint>
#include <cstring>

namespace {

struct Table {
  uint32_t t[256];
  Table() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t crc = i;
      for (int k = 0; k < 8; ++k)
        crc = (crc & 1) ? (crc >> 1) ^ 0x82F63B78u : crc >> 1;
      t[i] = crc;
    }
  }
};

uint32_t crc_table(uint32_t crc, const uint8_t* p, uint64_t n) {
  static const Table table;  // built once, thread-safe
  while (n--) crc = table.t[(crc ^ *p++) & 0xFF] ^ (crc >> 8);
  return crc;
}

#if defined(__x86_64__)
__attribute__((target("sse4.2")))
uint32_t crc_sse42(uint32_t crc, const uint8_t* p, uint64_t n) {
  uint64_t c = crc;
  while (n >= 8) {
    uint64_t word;
    std::memcpy(&word, p, 8);
    c = __builtin_ia32_crc32di(c, word);
    p += 8;
    n -= 8;
  }
  uint32_t c32 = static_cast<uint32_t>(c);
  while (n--) c32 = __builtin_ia32_crc32qi(c32, *p++);
  return c32;
}
#endif

}  // namespace

extern "C" uint32_t ai4e_crc32c(const uint8_t* data, uint64_t n) {
#if defined(__x86_64__)
  if (__builtin_cpu_supports("sse4.2"))
    return ~crc_sse42(0xFFFFFFFFu, data, n);
#endif
  return ~crc_table(0xFFFFFFFFu, data, n);
}
