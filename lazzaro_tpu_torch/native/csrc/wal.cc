// Write-ahead log of the PyTorch/CUDA port's host runtime.
//
// A copy of the WAL part of lazzaro_tpu/native/csrc/lazzaro_native.cc, with
// the same on-disk framing, so a log written by either package replays in
// the other. MemorySystem journals its short-term turns and its extracted
// fact batches here, so a process crash loses neither.
//
// Plain C ABI (extern "C") consumed via ctypes; built by ../build.py.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#include <fcntl.h>
#include <sys/stat.h>
#include <unistd.h>

extern "C" {

// ---------------------------------------------------------------------------
// Write-ahead log.
//
// On-disk framing per record: u32 magic 'LZW1' | u32 payload_len |
// u32 crc32(payload) | payload bytes. Append is a single write(2) followed by
// fdatasync, so a crash mid-append leaves at most one torn tail record, which
// replay detects (bad magic/len/crc) and discards.
// ---------------------------------------------------------------------------

static const uint32_t LZ_WAL_MAGIC = 0x4c5a5731u;  // "LZW1" little-endian

static uint32_t crc32_update(uint32_t crc, const uint8_t* p, size_t len) {
  static uint32_t table[256];
  static std::atomic<bool> ready{false};
  if (!ready.load(std::memory_order_acquire)) {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int j = 0; j < 8; j++) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      table[i] = c;
    }
    ready.store(true, std::memory_order_release);
  }
  crc = ~crc;
  for (size_t i = 0; i < len; i++) crc = table[(crc ^ p[i]) & 0xff] ^ (crc >> 8);
  return ~crc;
}

uint32_t lz_crc32(const uint8_t* p, int64_t len) {
  return crc32_update(0, p, (size_t)len);
}

// Appends one record; returns 0 on success, negative errno-style code on
// failure. do_fsync=1 makes the record durable before returning.
int64_t lz_wal_append(const char* path, const uint8_t* data, int64_t len,
                      int32_t do_fsync) {
  int fd = open(path, O_WRONLY | O_CREAT | O_APPEND, 0644);
  if (fd < 0) return -1;
  uint32_t header[3] = {LZ_WAL_MAGIC, (uint32_t)len,
                        crc32_update(0, data, (size_t)len)};
  std::vector<uint8_t> buf(sizeof(header) + (size_t)len);
  memcpy(buf.data(), header, sizeof(header));
  if (len > 0) memcpy(buf.data() + sizeof(header), data, (size_t)len);
  const uint8_t* p = buf.data();
  size_t remaining = buf.size();
  while (remaining > 0) {
    ssize_t w = write(fd, p, remaining);
    if (w < 0) {
      close(fd);
      return -2;
    }
    p += w;
    remaining -= (size_t)w;
  }
  int rc = 0;
  if (do_fsync && fdatasync(fd) != 0) rc = -3;
  close(fd);
  return rc;
}

// Loads all valid records. Returns a malloc'd buffer of concatenated
// (u32 len | payload) entries and sets *out_len to its size; caller frees via
// lz_free. Returns nullptr with *out_len = -1 if the file doesn't exist,
// *out_len = 0 for an empty/fully-torn log. Scanning stops at the first
// invalid record (torn tail).
uint8_t* lz_wal_load(const char* path, int64_t* out_len) {
  *out_len = -1;
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  fseek(f, 0, SEEK_END);
  long fsize = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> raw((size_t)fsize);
  if (fsize > 0 && fread(raw.data(), 1, (size_t)fsize, f) != (size_t)fsize) {
    fclose(f);
    *out_len = 0;
    return nullptr;
  }
  fclose(f);

  std::vector<uint8_t> out;
  size_t pos = 0;
  while (pos + 12 <= raw.size()) {
    uint32_t magic, len, crc;
    memcpy(&magic, raw.data() + pos, 4);
    memcpy(&len, raw.data() + pos + 4, 4);
    memcpy(&crc, raw.data() + pos + 8, 4);
    if (magic != LZ_WAL_MAGIC || pos + 12 + len > raw.size()) break;
    if (crc32_update(0, raw.data() + pos + 12, len) != crc) break;
    uint32_t len_le = len;
    out.insert(out.end(), (uint8_t*)&len_le, (uint8_t*)&len_le + 4);
    out.insert(out.end(), raw.data() + pos + 12, raw.data() + pos + 12 + len);
    pos += 12 + len;
  }
  *out_len = (int64_t)out.size();
  if (out.empty()) return nullptr;
  uint8_t* ret = (uint8_t*)malloc(out.size());
  memcpy(ret, out.data(), out.size());
  return ret;
}

void lz_free(uint8_t* p) { free(p); }

// Truncates (resets) the log; returns 0 on success.
int64_t lz_wal_reset(const char* path) {
  int fd = open(path, O_WRONLY | O_CREAT | O_TRUNC, 0644);
  if (fd < 0) return -1;
  close(fd);
  return 0;
}

}  // extern "C"
