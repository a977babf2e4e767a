// Native DAF (Double-precision Array File) reader.
//
// C++ implementation of the binary kernel file layer (the performance- and
// IO-critical part of SPK ingestion): parses the DAF file record, walks the
// summary-record linked list, and exposes the double-word array with
// endianness conversion. Loaded from Python via ctypes
// (planetmapper_tpu_torch/kernels/daf_native.py, which builds it into
// build/ at first use); the pure-Python parser remains as a fallback and as
// the reference implementation for parity tests.
//
// Build:  g++ -O2 -shared -fPIC -std=c++17 -o libdafreader.so daf_reader.cpp

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr size_t kRecordSize = 1024;
constexpr size_t kWordsPerRecord = 128;

inline uint64_t bswap64(uint64_t v) {
#if defined(__GNUC__) || defined(__clang__)
  return __builtin_bswap64(v);
#else
  v = ((v & 0x00000000FFFFFFFFull) << 32) | ((v & 0xFFFFFFFF00000000ull) >> 32);
  v = ((v & 0x0000FFFF0000FFFFull) << 16) | ((v & 0xFFFF0000FFFF0000ull) >> 16);
  v = ((v & 0x00FF00FF00FF00FFull) << 8) | ((v & 0xFF00FF00FF00FF00ull) >> 8);
  return v;
#endif
}

inline uint32_t bswap32(uint32_t v) {
#if defined(__GNUC__) || defined(__clang__)
  return __builtin_bswap32(v);
#else
  v = ((v & 0x0000FFFFu) << 16) | ((v & 0xFFFF0000u) >> 16);
  v = ((v & 0x00FF00FFu) << 8) | ((v & 0xFF00FF00u) >> 8);
  return v;
#endif
}

struct Segment {
  std::vector<double> doubles;
  std::vector<int32_t> ints;
};

struct DafFile {
  std::vector<uint8_t> raw;
  bool big_endian = false;
  int nd = 0;
  int ni = 0;
  std::vector<Segment> segments;

  double word(size_t index1) const {  // 1-indexed double word
    uint64_t bits;
    std::memcpy(&bits, raw.data() + (index1 - 1) * 8, 8);
    if (big_endian) bits = bswap64(bits);
    double out;
    std::memcpy(&out, &bits, 8);
    return out;
  }

  int32_t int_at(size_t byte_offset) const {
    uint32_t bits;
    std::memcpy(&bits, raw.data() + byte_offset, 4);
    if (big_endian) bits = bswap32(bits);
    int32_t out;
    std::memcpy(&out, &bits, 4);
    return out;
  }

  size_t num_words() const { return raw.size() / 8; }
};

bool parse(DafFile* daf) {
  if (daf->raw.size() < kRecordSize) return false;
  const char* id = reinterpret_cast<const char*>(daf->raw.data());
  if (std::strncmp(id, "DAF/", 4) != 0 && std::strncmp(id, "NAIF/DAF", 8) != 0)
    return false;

  // LOCFMT at bytes 88-96 for modern files; sniff ND plausibility otherwise
  std::string locfmt(reinterpret_cast<const char*>(daf->raw.data() + 88), 8);
  if (locfmt.find("BIG") != std::string::npos) {
    daf->big_endian = true;
  } else if (locfmt.find("LTL") != std::string::npos) {
    daf->big_endian = false;
  } else {
    daf->big_endian = false;
    int nd_le = daf->int_at(8);
    if (!(nd_le > 0 && nd_le < 125)) daf->big_endian = true;
  }

  daf->nd = daf->int_at(8);
  daf->ni = daf->int_at(12);
  int fward = daf->int_at(76);
  if (!(daf->nd > 0 && daf->nd < 125 && daf->ni > 0 && daf->ni < 251))
    return false;

  const int ss = daf->nd + (daf->ni + 1) / 2;  // summary size in words
  int record = fward;
  while (record > 0) {
    const size_t base = static_cast<size_t>(record - 1) * kWordsPerRecord + 1;
    if ((base + kWordsPerRecord - 1) > daf->num_words()) break;
    int next = static_cast<int>(daf->word(base));
    int nsum = static_cast<int>(daf->word(base + 2));
    for (int i = 0; i < nsum; ++i) {
      const size_t sum_base = base + 3 + static_cast<size_t>(i) * ss;
      Segment seg;
      seg.doubles.reserve(daf->nd);
      for (int j = 0; j < daf->nd; ++j)
        seg.doubles.push_back(daf->word(sum_base + j));
      // Packed integers follow the doubles, two per double word
      const size_t int_byte_base = (sum_base + daf->nd - 1) * 8;
      for (int j = 0; j < daf->ni; ++j) {
        size_t offset = int_byte_base + static_cast<size_t>(j) * 4;
        if (daf->big_endian) {
          // Big-endian packing: each pair of ints lives in one 8-byte word
          // in order, but each int is individually big-endian
          seg.ints.push_back(daf->int_at(offset));
        } else {
          seg.ints.push_back(daf->int_at(offset));
        }
      }
      daf->segments.push_back(std::move(seg));
    }
    record = next;
  }
  return true;
}

}  // namespace

extern "C" {

void* daf_open(const char* path) {
  std::FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  auto* daf = new DafFile();
  daf->raw.resize(static_cast<size_t>(size));
  size_t read = std::fread(daf->raw.data(), 1, daf->raw.size(), f);
  std::fclose(f);
  if (read != daf->raw.size() || !parse(daf)) {
    delete daf;
    return nullptr;
  }
  return daf;
}

int daf_nd(void* handle) { return static_cast<DafFile*>(handle)->nd; }
int daf_ni(void* handle) { return static_cast<DafFile*>(handle)->ni; }
int daf_big_endian(void* handle) {
  return static_cast<DafFile*>(handle)->big_endian ? 1 : 0;
}

int daf_num_segments(void* handle) {
  return static_cast<int>(static_cast<DafFile*>(handle)->segments.size());
}

long daf_num_words(void* handle) {
  return static_cast<long>(static_cast<DafFile*>(handle)->num_words());
}

// Copy segment summary idx into caller-provided buffers (sized nd and ni).
int daf_segment(void* handle, int idx, double* doubles_out, int* ints_out) {
  auto* daf = static_cast<DafFile*>(handle);
  if (idx < 0 || idx >= static_cast<int>(daf->segments.size())) return -1;
  const Segment& seg = daf->segments[static_cast<size_t>(idx)];
  for (size_t j = 0; j < seg.doubles.size(); ++j) doubles_out[j] = seg.doubles[j];
  for (size_t j = 0; j < seg.ints.size(); ++j) ints_out[j] = seg.ints[j];
  return 0;
}

// Copy double words start..end (1-indexed, inclusive) into out.
int daf_read_words(void* handle, long start, long end, double* out) {
  auto* daf = static_cast<DafFile*>(handle);
  if (start < 1 || end > static_cast<long>(daf->num_words()) || end < start)
    return -1;
  if (!daf->big_endian) {
    std::memcpy(out, daf->raw.data() + (start - 1) * 8,
                static_cast<size_t>(end - start + 1) * 8);
  } else {
    for (long i = start; i <= end; ++i) out[i - start] = daf->word(i);
  }
  return 0;
}

void daf_close(void* handle) { delete static_cast<DafFile*>(handle); }

}  // extern "C"
