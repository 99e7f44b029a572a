// libevlog: append-only binary event log codec.
//
// The native storage engine behind the port's "evlog" event store
// (predictionio_tpu_torch/storage/evlog_backend.py), bound with ctypes by
// predictionio_tpu_torch/native/evlog.py, which compiles this file alone
// with g++ on first use. It plays the role HBase plays in PredictionIO as
// the scalable event store (storage/hbase/.../HBEventsUtil.scala:49-408):
// where HBase keys rows by MD5(entityType-entityId) ++ eventTime ++ uuid
// for prefix scans, evlog frames each record with (eventTime millis,
// FNV-1a entity hash, event id) so scans can filter by time range and
// entity without touching the JSON payload. Deletions are tombstone frames
// carrying the original record's id/time/hash.
//
// File layout (little-endian), byte for byte the JAX package's:
//   header : magic "PIOEVLG1" | u32 version=1 | u32 reserved
//   record : u32 payload_len | u32 crc32 | i64 time_ms | u64 entity_hash
//          | u8 flags (bit0 = tombstone) | u8[16] event id | payload bytes
//   crc32 (zlib polynomial) covers time_ms..payload.
//
// The Python side has a bit-identical pure-Python codec (PyCodec in
// native/evlog.py) for hosts without a compiler.

#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

#include <fcntl.h>
#include <sys/file.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr char kMagic[8] = {'P', 'I', 'O', 'E', 'V', 'L', 'G', '1'};
constexpr uint32_t kVersion = 1;
constexpr size_t kHeaderSize = 16;
constexpr size_t kRecHeadSize = 4 + 4 + 8 + 8 + 1 + 16;  // 41 bytes

// zlib-polynomial CRC32. The table is a function-local static: built
// once, thread-safe (ctypes drops the GIL, so scans may run at once).
struct CrcTable {
  uint32_t v[256];
  CrcTable() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k)
        c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      v[i] = c;
    }
  }
};

uint32_t crc32_of(const uint8_t* buf, size_t len, uint32_t crc = 0) {
  static const CrcTable table;
  crc = crc ^ 0xFFFFFFFFu;
  for (size_t i = 0; i < len; ++i)
    crc = table.v[(crc ^ buf[i]) & 0xFF] ^ (crc >> 8);
  return crc ^ 0xFFFFFFFFu;
}

void put_u32(uint8_t* p, uint32_t v) { memcpy(p, &v, 4); }
void put_i64(uint8_t* p, int64_t v) { memcpy(p, &v, 8); }
void put_u64(uint8_t* p, uint64_t v) { memcpy(p, &v, 8); }
uint32_t get_u32(const uint8_t* p) { uint32_t v; memcpy(&v, p, 4); return v; }
int64_t get_i64(const uint8_t* p) { int64_t v; memcpy(&v, p, 8); return v; }
uint64_t get_u64(const uint8_t* p) { uint64_t v; memcpy(&v, p, 8); return v; }

// Growable output buffer.
struct OutBuf {
  uint8_t* data = nullptr;
  uint64_t len = 0;
  uint64_t cap = 0;

  bool append(const uint8_t* src, uint64_t n) {
    if (len + n > cap) {
      uint64_t ncap = cap ? cap * 2 : 1 << 16;
      while (ncap < len + n) ncap *= 2;
      uint8_t* nd = static_cast<uint8_t*>(realloc(data, ncap));
      if (!nd) return false;
      data = nd;
      cap = ncap;
    }
    memcpy(data + len, src, n);
    len += n;
    return true;
  }
};

struct MappedFile {
  int fd = -1;
  uint8_t* data = nullptr;
  uint64_t size = 0;

  int open_ro(const char* path) {
    fd = ::open(path, O_RDONLY);
    if (fd < 0) { fd = -1; return -errno; }
    struct stat st;
    if (fstat(fd, &st) != 0) {
      int e = -errno;
      ::close(fd);
      fd = -1;  // keep the destructor from double-closing a reused fd
      return e;
    }
    size = static_cast<uint64_t>(st.st_size);
    if (size == 0) { data = nullptr; return 0; }
    void* m = mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0);
    if (m == MAP_FAILED) {
      int e = -errno;
      ::close(fd);
      fd = -1;
      size = 0;
      return e;
    }
    data = static_cast<uint8_t*>(m);
    return 0;
  }

  ~MappedFile() {
    if (data) munmap(data, size);
    if (fd >= 0) ::close(fd);
  }
};

}  // namespace

extern "C" {

// FNV-1a 64-bit: must match entity_hash in native/evlog.py.
uint64_t evlog_entity_hash(const uint8_t* data, uint64_t len) {
  uint64_t h = 1469598103934665603ull;
  for (uint64_t i = 0; i < len; ++i) {
    h ^= data[i];
    h *= 1099511628211ull;
  }
  if (h == 0) h = 1;  // 0 is the "no filter" sentinel
  return h;
}

// Create the file with a header if it does not exist. 0 ok, <0 -errno.
int64_t evlog_create(const char* path) {
  int fd = ::open(path, O_WRONLY | O_CREAT | O_EXCL, 0644);
  if (fd < 0) return errno == EEXIST ? 0 : -errno;
  uint8_t hdr[kHeaderSize] = {0};
  memcpy(hdr, kMagic, 8);
  put_u32(hdr + 8, kVersion);
  ssize_t w = write(fd, hdr, kHeaderSize);
  int64_t rc = (w == static_cast<ssize_t>(kHeaderSize)) ? 0 : -EIO;
  ::close(fd);
  return rc;
}

// Append n records in one O_APPEND write. Returns 0, or <0 -errno.
//   payloads : concatenated payload bytes
//   lens     : n payload lengths
//   times    : n eventTime millis
//   hashes   : n entity hashes
//   flags    : n flag bytes
//   ids      : n * 16 id bytes
int64_t evlog_append(const char* path, const uint8_t* payloads,
                     const uint32_t* lens, const int64_t* times,
                     const uint64_t* hashes, const uint8_t* flags,
                     const uint8_t* ids, uint32_t n) {
  uint64_t total = 0;
  for (uint32_t i = 0; i < n; ++i) total += kRecHeadSize + lens[i];
  uint8_t* buf = static_cast<uint8_t*>(malloc(total ? total : 1));
  if (!buf) return -ENOMEM;
  uint8_t* p = buf;
  const uint8_t* payload = payloads;
  for (uint32_t i = 0; i < n; ++i) {
    put_u32(p, lens[i]);
    uint8_t* crc_at = p + 4;
    uint8_t* body = p + 8;
    put_i64(body, times[i]);
    put_u64(body + 8, hashes[i]);
    body[16] = flags[i];
    memcpy(body + 17, ids + 16ull * i, 16);
    memcpy(body + 33, payload, lens[i]);
    put_u32(crc_at, crc32_of(body, 33 + lens[i]));
    p += kRecHeadSize + lens[i];
    payload += lens[i];
  }
  int fd = ::open(path, O_WRONLY | O_APPEND);
  if (fd < 0) { free(buf); return -errno; }
  // flock serializes writer processes: O_APPEND already keeps whole writes
  // from interleaving, the lock additionally makes the torn-write cleanup
  // below safe (no concurrent record can land mid-error-handling)
  int64_t rc = 0;
  if (::flock(fd, LOCK_EX) != 0) rc = -errno;
  uint64_t off = 0;
  while (rc == 0 && off < total) {
    ssize_t w = write(fd, buf + off, total - off);
    if (w < 0) { rc = -errno; break; }
    off += static_cast<uint64_t>(w);
  }
  if (rc != 0 && off > 0) {
    // torn write (ENOSPC, signal): drop the half-frame so later appends
    // don't land after it and desync the framing; safe under flock
    off_t end = lseek(fd, 0, SEEK_CUR);
    if (end >= 0 && static_cast<uint64_t>(end) >= off) {
      (void)!ftruncate(fd, end - static_cast<off_t>(off));
    }
  }
  ::close(fd);  // releases the flock
  free(buf);
  return rc;
}

// Scan records matching [t_lo, t_hi) and filters into a malloc'd buffer of
// records in the on-disk format (without the file header). hash_filter == 0
// means no entity filter; id_filter == nullptr means no id filter.
// Returns matched record count >= 0, or <0 on error (-EBADMSG = corrupt).
int64_t evlog_scan(const char* path, int64_t t_lo, int64_t t_hi,
                   uint64_t hash_filter, const uint8_t* id_filter,
                   uint8_t** out_buf, uint64_t* out_len) {
  *out_buf = nullptr;
  *out_len = 0;
  MappedFile mf;
  int rc = mf.open_ro(path);
  if (rc < 0) return rc;
  if (mf.size < kHeaderSize || memcmp(mf.data, kMagic, 8) != 0)
    return -EBADMSG;
  OutBuf out;
  int64_t count = 0;
  uint64_t off = kHeaderSize;
  while (off + kRecHeadSize <= mf.size) {
    const uint8_t* rec = mf.data + off;
    uint32_t plen = get_u32(rec);
    uint64_t rlen = kRecHeadSize + plen;
    if (off + rlen > mf.size) break;  // truncated tail write: stop cleanly
    const uint8_t* body = rec + 8;
    int64_t t = get_i64(body);
    uint64_t h = get_u64(body + 8);
    bool match = t >= t_lo && t < t_hi &&
                 (hash_filter == 0 || h == hash_filter) &&
                 (id_filter == nullptr || memcmp(body + 17, id_filter, 16) == 0);
    if (match) {
      if (get_u32(rec + 4) != crc32_of(body, 33 + plen)) {
        free(out.data);
        return -EBADMSG;
      }
      if (!out.append(rec, rlen)) { free(out.data); return -ENOMEM; }
      ++count;
    }
    off += rlen;
  }
  *out_buf = out.data;
  *out_len = out.len;
  return count;
}

// Validate every record's CRC. Returns record count, or <0 on error.
int64_t evlog_verify(const char* path) {
  MappedFile mf;
  int rc = mf.open_ro(path);
  if (rc < 0) return rc;
  if (mf.size < kHeaderSize || memcmp(mf.data, kMagic, 8) != 0)
    return -EBADMSG;
  int64_t count = 0;
  uint64_t off = kHeaderSize;
  while (off + kRecHeadSize <= mf.size) {
    const uint8_t* rec = mf.data + off;
    uint32_t plen = get_u32(rec);
    uint64_t rlen = kRecHeadSize + plen;
    if (off + rlen > mf.size) return -EBADMSG;
    if (get_u32(rec + 4) != crc32_of(rec + 8, 33 + plen)) return -EBADMSG;
    ++count;
    off += rlen;
  }
  return count;
}

void evlog_free(uint8_t* buf) { free(buf); }

}  // extern "C"
