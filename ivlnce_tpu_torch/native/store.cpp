// Append-only keyed record store — the trajectory database backing the
// DAgger trainers (replaces py-lmdb, reference dagger_trainer.py:148-155).
//
// File format (little-endian):
//   magic "IVTS" u32 version
//   records: [u32 keylen][key bytes][u64 vallen][val bytes]
// The in-memory index is rebuilt by scanning on open; later puts of an
// existing key shadow earlier ones (last write wins), matching LMDB
// semantics for the trainers' usage. Readers use pread so many handles
// (data-loader workers) can read one store concurrently with a writer
// that syncs between commits.
//
// C ABI for ctypes (see native/__init__.py); a pure-Python
// fallback implements the identical format.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

#include <fcntl.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint32_t kMagic = 0x53545649;  // "IVTS"
constexpr uint32_t kVersion = 1;

struct Entry {
  uint64_t offset;  // offset of value bytes
  uint64_t length;
};

struct Store {
  int fd = -1;
  bool writable = false;
  uint64_t end = 0;  // append position
  std::unordered_map<std::string, Entry> index;
};

bool read_exact(int fd, uint64_t off, void* buf, size_t n) {
  size_t done = 0;
  while (done < n) {
    ssize_t r = pread(fd, static_cast<char*>(buf) + done, n - done, off + done);
    if (r <= 0) return false;
    done += static_cast<size_t>(r);
  }
  return true;
}

bool scan_index(Store* s) {
  struct stat st;
  if (fstat(s->fd, &st) != 0) return false;
  uint64_t size = static_cast<uint64_t>(st.st_size);
  uint64_t off = 8;  // header
  std::vector<char> keybuf;
  while (off + 12 <= size) {
    uint32_t keylen;
    if (!read_exact(s->fd, off, &keylen, 4)) return false;
    off += 4;
    if (off + keylen + 8 > size) break;  // truncated tail: ignore
    keybuf.resize(keylen);
    if (!read_exact(s->fd, off, keybuf.data(), keylen)) return false;
    off += keylen;
    uint64_t vallen;
    if (!read_exact(s->fd, off, &vallen, 8)) return false;
    off += 8;
    if (off + vallen > size) break;
    s->index[std::string(keybuf.data(), keylen)] = Entry{off, vallen};
    off += vallen;
  }
  s->end = off;
  return true;
}

}  // namespace

extern "C" {

void* ts_open(const char* path, int writable) {
  int flags = writable ? (O_RDWR | O_CREAT) : O_RDONLY;
  int fd = open(path, flags, 0644);
  if (fd < 0) return nullptr;

  Store* s = new Store();
  s->fd = fd;
  s->writable = writable != 0;

  struct stat st;
  fstat(fd, &st);
  if (st.st_size == 0) {
    if (!writable) {
      close(fd);
      delete s;
      return nullptr;
    }
    uint32_t header[2] = {kMagic, kVersion};
    if (pwrite(fd, header, 8, 0) != 8) {
      close(fd);
      delete s;
      return nullptr;
    }
    s->end = 8;
  } else {
    uint32_t header[2];
    if (!read_exact(fd, 0, header, 8) || header[0] != kMagic) {
      close(fd);
      delete s;
      return nullptr;
    }
    if (!scan_index(s)) {
      close(fd);
      delete s;
      return nullptr;
    }
  }
  return s;
}

int ts_put(void* handle, const char* key, uint32_t keylen, const char* val,
           uint64_t vallen) {
  Store* s = static_cast<Store*>(handle);
  if (!s->writable) return -1;
  uint64_t off = s->end;
  std::vector<char> rec(4 + keylen + 8);
  memcpy(rec.data(), &keylen, 4);
  memcpy(rec.data() + 4, key, keylen);
  memcpy(rec.data() + 4 + keylen, &vallen, 8);
  if (pwrite(s->fd, rec.data(), rec.size(), off) !=
      static_cast<ssize_t>(rec.size()))
    return -1;
  uint64_t val_off = off + rec.size();
  uint64_t done = 0;
  while (done < vallen) {
    ssize_t w = pwrite(s->fd, val + done, vallen - done, val_off + done);
    if (w <= 0) return -1;
    done += static_cast<uint64_t>(w);
  }
  s->index[std::string(key, keylen)] = Entry{val_off, vallen};
  s->end = val_off + vallen;
  return 0;
}

// returns value length, or -1 if missing. Two-phase: call with buf=null to
// size, then with a buffer.
int64_t ts_get(void* handle, const char* key, uint32_t keylen, char* buf,
               uint64_t buflen) {
  Store* s = static_cast<Store*>(handle);
  auto it = s->index.find(std::string(key, keylen));
  if (it == s->index.end()) return -1;
  const Entry& e = it->second;
  if (buf == nullptr) return static_cast<int64_t>(e.length);
  if (buflen < e.length) return -2;
  if (!read_exact(s->fd, e.offset, buf, e.length)) return -3;
  return static_cast<int64_t>(e.length);
}

uint64_t ts_count(void* handle) {
  return static_cast<Store*>(handle)->index.size();
}

int ts_sync(void* handle) {
  return fsync(static_cast<Store*>(handle)->fd);
}

// refresh the index to see records appended by another handle
int ts_refresh(void* handle) {
  Store* s = static_cast<Store*>(handle);
  s->index.clear();
  return scan_index(s) ? 0 : -1;
}

void ts_close(void* handle) {
  Store* s = static_cast<Store*>(handle);
  if (s->fd >= 0) close(s->fd);
  delete s;
}

}  // extern "C"
