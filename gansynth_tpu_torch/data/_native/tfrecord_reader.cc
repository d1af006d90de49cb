// Native NSynth TFRecord reader (C++, no TensorFlow dependency).
//
// The reference framework delegates its input pipeline to tf.data's C++
// runtime (SURVEY.md §2.9); this is the first-party equivalent: TFRecord
// framing with masked-CRC32C verification plus a minimal protobuf
// wire-format parser that extracts the full NSynth schema (SURVEY.md §2.1
// D1) — "audio" (FloatList) plus the Int64List fields "pitch",
// "velocity", "instrument_family", "instrument_source" and the 10-element
// "qualities" vector — from tf.train.Example messages.
//
// Exposed as a C ABI for ctypes (no pybind11 in this image). Build:
//   g++ -O3 -shared -fPIC -o libtfrecord.so tfrecord_reader.cc
//
// TFRecord framing: { uint64 length; uint32 masked_crc32c(length);
//                     byte data[length]; uint32 masked_crc32c(data); }
// masked_crc(x) = rotr15(crc32c(x)) + 0xa282ead8.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// CRC32C (Castagnoli), table-driven software implementation.
// ---------------------------------------------------------------------------

uint32_t g_crc_table[256];
bool g_crc_init = false;

void crc_init() {
  if (g_crc_init) return;
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = i;
    for (int k = 0; k < 8; ++k) {
      c = (c & 1) ? (0x82f63b78u ^ (c >> 1)) : (c >> 1);
    }
    g_crc_table[i] = c;
  }
  g_crc_init = true;
}

uint32_t crc32c(const uint8_t* data, size_t n) {
  uint32_t c = 0xffffffffu;
  for (size_t i = 0; i < n; ++i) {
    c = g_crc_table[(c ^ data[i]) & 0xff] ^ (c >> 8);
  }
  return c ^ 0xffffffffu;
}

uint32_t masked_crc(const uint8_t* data, size_t n) {
  uint32_t crc = crc32c(data, n);
  return ((crc >> 15) | (crc << 17)) + 0xa282ead8u;
}

// ---------------------------------------------------------------------------
// Protobuf wire-format primitives.
// ---------------------------------------------------------------------------

struct Cursor {
  const uint8_t* p;
  const uint8_t* end;
  bool ok = true;

  uint64_t varint() {
    uint64_t v = 0;
    int shift = 0;
    while (p < end && shift < 64) {
      uint8_t b = *p++;
      v |= static_cast<uint64_t>(b & 0x7f) << shift;
      if (!(b & 0x80)) return v;
      shift += 7;
    }
    ok = false;
    return 0;
  }

  // Returns (field_number, wire_type); field 0 on exhaustion.
  bool tag(uint32_t* field, uint32_t* wire) {
    if (p >= end) return false;
    uint64_t key = varint();
    if (!ok) return false;
    *field = static_cast<uint32_t>(key >> 3);
    *wire = static_cast<uint32_t>(key & 7);
    return true;
  }

  // Advance by n bytes, clamping at end (n may come from a hostile
  // varint; unchecked `p += n` is pointer-overflow UB and would move the
  // cursor past the buffer).
  void advance(uint64_t n) {
    uint64_t avail = static_cast<uint64_t>(end - p);
    if (!ok || n > avail) {
      ok = false;
      p = end;
    } else {
      p += n;
    }
  }

  void skip(uint32_t wire) {
    switch (wire) {
      case 0: varint(); break;
      case 1: advance(8); break;
      case 2: advance(varint()); break;
      case 5: advance(4); break;
      default: ok = false;
    }
  }

  // Length-delimited child cursor. The child's end is CLAMPED to the
  // parent's buffer: a malformed/oversized length varint must never hand
  // downstream parsing an end pointer past the allocation (out-of-bounds
  // reads even with valid record CRCs, or whenever verify_crc=0).
  Cursor sub() {
    uint64_t n = varint();
    uint64_t avail = static_cast<uint64_t>(end - p);
    bool fits = ok && n <= avail;
    Cursor c{p, fits ? p + n : end, fits};
    if (fits) {
      p += n;
    } else {
      ok = false;
      p = end;
    }
    return c;
  }
};

// ---------------------------------------------------------------------------
// Reader state.
// ---------------------------------------------------------------------------

struct Reader {
  FILE* f = nullptr;
  std::vector<uint8_t> buf;
  std::string error;
  bool verify_crc = true;
};

// All parsed fields of one Example. The four Int64List scalars share one
// output array (slot order is part of the C ABI, mirrored in
// native_tfrecord.py): 0 pitch, 1 velocity, 2 instrument_family,
// 3 instrument_source; -1 = absent. "qualities" is a short Int64List
// vector written up to qual_cap.
struct Fields {
  float* audio;
  int audio_cap;
  int* audio_len;
  int64_t* scalars;  // [4]
  int64_t* qual;
  int qual_cap;
  int* qual_len;
};

// Slot for a scalar Int64List feature name; -1 for non-scalar/unknown.
int scalar_slot(const std::string& name) {
  if (name == "pitch") return 0;
  if (name == "velocity") return 1;
  if (name == "instrument_family") return 2;
  if (name == "instrument_source") return 3;
  return -1;
}

// Parse one Feature message given its name, filling the outputs.
// Returns false when the message overran its framing (clamped, not read
// out of bounds — but the record is malformed and must be reported).
bool parse_feature(Cursor feat, const std::string& name, Fields* out) {
  int slot = scalar_slot(name);
  bool want_qual = name == "qualities";
  uint32_t field, wire;
  while (feat.tag(&field, &wire)) {
    if (field == 2 && wire == 2 && name == "audio") {  // FloatList
      Cursor fl = feat.sub();
      uint32_t f2, w2;
      int count = 0;
      while (fl.tag(&f2, &w2)) {
        if (f2 == 1 && w2 == 2) {  // packed floats
          Cursor packed = fl.sub();
          size_t n = (packed.end - packed.p) / 4;
          for (size_t i = 0; i < n && count < out->audio_cap; ++i, ++count) {
            std::memcpy(&out->audio[count], packed.p + 4 * i, 4);
          }
        } else if (f2 == 1 && w2 == 5) {  // unpacked float
          if (count < out->audio_cap && fl.end - fl.p >= 4) {
            std::memcpy(&out->audio[count++], fl.p, 4);
          }
          fl.skip(w2);
        } else {
          fl.skip(w2);
        }
      }
      *out->audio_len = count;
      if (!fl.ok) feat.ok = false;
    } else if (field == 3 && wire == 2 && (slot >= 0 || want_qual)) {
      Cursor il = feat.sub();  // Int64List
      uint32_t f2, w2;
      while (il.tag(&f2, &w2)) {
        if (f2 == 1 && w2 == 2) {  // packed varints
          Cursor packed = il.sub();
          while (packed.p < packed.end && packed.ok) {
            int64_t v = static_cast<int64_t>(packed.varint());
            if (!packed.ok) break;
            if (slot >= 0) {
              out->scalars[slot] = v;
            } else if (*out->qual_len < out->qual_cap) {
              out->qual[(*out->qual_len)++] = v;
            }
          }
          if (!packed.ok) il.ok = false;
        } else if (f2 == 1 && w2 == 0) {
          int64_t v = static_cast<int64_t>(il.varint());
          if (slot >= 0) {
            out->scalars[slot] = v;
          } else if (*out->qual_len < out->qual_cap) {
            out->qual[(*out->qual_len)++] = v;
          }
        } else {
          il.skip(w2);
        }
      }
      if (!il.ok) feat.ok = false;
    } else {
      feat.skip(wire);
    }
  }
  return feat.ok;
}

// Parse a serialized tf.train.Example.
bool parse_example(const uint8_t* data, size_t n, Fields* out) {
  Cursor ex{data, data + n};
  uint32_t field, wire;
  while (ex.tag(&field, &wire)) {
    if (field == 1 && wire == 2) {  // Features
      Cursor feats = ex.sub();
      uint32_t f1, w1;
      while (feats.tag(&f1, &w1)) {
        if (f1 == 1 && w1 == 2) {  // map entry
          Cursor entry = feats.sub();
          std::string name;
          Cursor value{nullptr, nullptr};
          bool have_value = false;
          uint32_t fe, we;
          while (entry.tag(&fe, &we)) {
            if (fe == 1 && we == 2) {
              Cursor k = entry.sub();
              name.assign(reinterpret_cast<const char*>(k.p), k.end - k.p);
            } else if (fe == 2 && we == 2) {
              value = entry.sub();
              have_value = true;
            } else {
              entry.skip(we);
            }
          }
          if (!entry.ok) return false;
          if (have_value &&
              (name == "audio" || name == "qualities" ||
               scalar_slot(name) >= 0)) {
            if (!parse_feature(value, name, out)) {
              return false;
            }
          }
        } else {
          feats.skip(w1);
        }
      }
      if (!feats.ok) return false;
    } else {
      ex.skip(wire);
    }
  }
  return ex.ok;
}

}  // namespace

extern "C" {

void* tfr_open(const char* path, int verify_crc) {
  crc_init();
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  Reader* r = new Reader;
  r->f = f;
  r->verify_crc = verify_crc != 0;
  return r;
}

// Returns 1 on a record, 0 at clean EOF, -1 on framing/CRC/parse error.
// ``scalars`` is int64[4] in slot order (pitch, velocity,
// instrument_family, instrument_source); absent fields read -1.
// ``qualities`` receives up to qualities_cap Int64List entries with the
// count in *qualities_len.
int tfr_next(void* handle, float* audio, int audio_cap, int* audio_len,
             int64_t* scalars, int64_t* qualities, int qualities_cap,
             int* qualities_len) {
  Reader* r = static_cast<Reader*>(handle);
  uint8_t header[12];
  size_t got = std::fread(header, 1, 12, r->f);
  if (got == 0) return 0;  // EOF
  if (got != 12) {
    r->error = "truncated record header";
    return -1;
  }
  uint64_t len;
  std::memcpy(&len, header, 8);
  if (r->verify_crc) {
    uint32_t want;
    std::memcpy(&want, header + 8, 4);
    if (masked_crc(header, 8) != want) {
      r->error = "length CRC mismatch";
      return -1;
    }
  }
  if (len > (1ull << 30)) {
    r->error = "unreasonable record length";
    return -1;
  }
  r->buf.resize(len + 4);
  if (std::fread(r->buf.data(), 1, len + 4, r->f) != len + 4) {
    r->error = "truncated record body";
    return -1;
  }
  if (r->verify_crc) {
    uint32_t want;
    std::memcpy(&want, r->buf.data() + len, 4);
    if (masked_crc(r->buf.data(), len) != want) {
      r->error = "data CRC mismatch";
      return -1;
    }
  }
  *audio_len = 0;
  *qualities_len = 0;
  for (int i = 0; i < 4; ++i) scalars[i] = -1;
  Fields out{audio,     audio_cap,    audio_len,
             scalars,   qualities,    qualities_cap,
             qualities_len};
  if (!parse_example(r->buf.data(), len, &out)) {
    r->error = "malformed Example proto";
    return -1;
  }
  return 1;
}

const char* tfr_error(void* handle) {
  return static_cast<Reader*>(handle)->error.c_str();
}

void tfr_close(void* handle) {
  Reader* r = static_cast<Reader*>(handle);
  if (r->f) std::fclose(r->f);
  delete r;
}

}  // extern "C"
