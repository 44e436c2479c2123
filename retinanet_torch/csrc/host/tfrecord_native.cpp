// TFRecord framing and the detection tf.train.Example, read in C++ for the
// host input pipeline (the port's own copy of native/tfrecord_native.cpp,
// rewritten to follow the port's Python codec, data/tfrecord.py, in every
// case that codec defines):
//
//   * records are indexed in chunks from any offset, so a file of any
//     record count needs no bound; an implausible length (> 2^31) stops the
//     scan with a status, as the codec raises there; a truncated tail ends
//     the stream quietly, as in the codec;
//   * a float or int64 list is every value the feature holds, packed or
//     not, in order, as the codec concatenates them;
//   * each of the five lists is counted on its own and nothing is capped:
//     the caller sizes its outputs from the counts and decides, in the
//     codec's order, which missing key or unequal corner list to raise on.
//
// Exposed by a plain C interface for ctypes
// (retinanet_torch/data/host_codec.py); every call runs outside the GIL.
//
// Build (host_codec.py does it at first use):
//   g++ -O3 -march=native -shared -fPIC -o libtfrecord_native.so \
//       tfrecord_native.cpp

#include <cstdint>
#include <cstring>

namespace {

// ---------------------------------------------------------------------------
// crc32c (Castagnoli), 8-slice table driven
// ---------------------------------------------------------------------------

struct CrcTables {
  uint32_t t[8][256];
  CrcTables() {
    const uint32_t poly = 0x82F63B78u;
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t crc = i;
      for (int j = 0; j < 8; ++j) crc = (crc >> 1) ^ ((crc & 1) ? poly : 0);
      t[0][i] = crc;
    }
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t crc = t[0][i];
      for (int k = 1; k < 8; ++k) {
        crc = t[0][crc & 0xFF] ^ (crc >> 8);
        t[k][i] = crc;
      }
    }
  }
};

// built once when the library loads, before any thread can call in
const CrcTables kCrc;

uint32_t crc32c(const uint8_t* data, int64_t n) {
  const auto& t = kCrc.t;
  uint32_t crc = 0xFFFFFFFFu;
  while (n >= 8) {
    uint64_t v;
    std::memcpy(&v, data, 8);
    v ^= crc;
    crc = t[7][v & 0xFF] ^ t[6][(v >> 8) & 0xFF] ^ t[5][(v >> 16) & 0xFF] ^
          t[4][(v >> 24) & 0xFF] ^ t[3][(v >> 32) & 0xFF] ^
          t[2][(v >> 40) & 0xFF] ^ t[1][(v >> 48) & 0xFF] ^ t[0][v >> 56];
    data += 8;
    n -= 8;
  }
  while (n--) crc = t[0][(crc ^ *data++) & 0xFF] ^ (crc >> 8);
  return crc ^ 0xFFFFFFFFu;
}

uint32_t masked_crc32c(const uint8_t* data, int64_t n) {
  const uint32_t crc = crc32c(data, n);
  return ((crc >> 15) | (crc << 17)) + 0xA282EAD8u;
}

// ---------------------------------------------------------------------------
// protobuf wire format
// ---------------------------------------------------------------------------

bool read_varint(const uint8_t* buf, int64_t size, int64_t* pos,
                 uint64_t* out) {
  uint64_t result = 0;
  for (int shift = 0; *pos < size && shift < 64; shift += 7) {
    const uint8_t b = buf[(*pos)++];
    result |= static_cast<uint64_t>(b & 0x7F) << shift;
    if (!(b & 0x80)) {
      *out = result;
      return true;
    }
  }
  return false;
}

struct Field {
  uint32_t number = 0;
  uint32_t wire_type = 0;
  const uint8_t* data = nullptr;  // payload of a length-delimited or fixed
  int64_t len = 0;
  uint64_t varint = 0;            // wire type 0
};

// The fields of the message [buf, buf + size). `next` returns false at the
// end; `bad` tells a malformed message from its end.
struct MessageReader {
  const uint8_t* buf;
  int64_t size;
  int64_t pos = 0;
  bool bad = false;

  bool next(Field* f) {
    if (pos >= size) return false;
    uint64_t tag;
    if (!read_varint(buf, size, &pos, &tag)) return fail();
    f->number = static_cast<uint32_t>(tag >> 3);
    f->wire_type = static_cast<uint32_t>(tag & 7);
    int64_t len;
    switch (f->wire_type) {
      case 0:
        return read_varint(buf, size, &pos, &f->varint) || fail();
      case 1:
        len = 8;
        break;
      case 2: {
        uint64_t n;
        if (!read_varint(buf, size, &pos, &n)) return fail();
        if (n > static_cast<uint64_t>(size - pos)) return fail();
        len = static_cast<int64_t>(n);
        break;
      }
      case 5:
        len = 4;
        break;
      default:
        return fail();
    }
    if (len > size - pos) return fail();
    f->data = buf + pos;
    f->len = len;
    pos += len;
    return true;
  }

  bool fail() {
    bad = true;
    return false;
  }
};

// what a Feature holds, as data/tfrecord.py:_decode_feature reads it: the
// first field numbered 1 (bytes_list), 2 (float_list) or 3 (int64_list)
enum Kind : int32_t {
  kMissing = -1,  // the key is not in the example
  kNoValue = -2,  // a map entry with the key and no value
  kEmpty = 0,     // a Feature without a list
  kBytes = 1,
  kFloat = 2,
  kInt64 = 3,
};

struct FeatureView {
  int32_t kind = kMissing;
  const uint8_t* list = nullptr;  // the list message
  int64_t list_len = 0;
};

bool view_feature(const uint8_t* buf, int64_t size, FeatureView* out) {
  MessageReader feature{buf, size};
  Field f;
  out->kind = kEmpty;
  while (feature.next(&f)) {
    if (f.number < 1 || f.number > 3) continue;
    if (f.wire_type != 2) return false;
    out->kind = static_cast<int32_t>(f.number);
    out->list = f.data;
    out->list_len = f.len;
    return true;
  }
  return !feature.bad;
}

// Walks the values of a list message: counts them and writes the first
// `cap` of them to out[0], out[stride], ... Returns false on a malformed
// list.
bool float_values(const FeatureView& fv, int64_t* count, float* out,
                  int64_t stride, int64_t cap) {
  MessageReader list{fv.list, fv.list_len};
  Field v;
  int64_t n = 0;
  while (list.next(&v)) {
    if (v.wire_type == 2) {  // packed
      if (v.len % 4) return false;
    } else if (v.wire_type != 5) {  // 5: one unpacked float
      return false;
    }
    for (int64_t i = 0; i < v.len / 4; ++i, ++n)
      if (n < cap) std::memcpy(out + n * stride, v.data + 4 * i, 4);
  }
  *count = n;
  return !list.bad;
}

bool int64_values(const FeatureView& fv, int64_t* count, int64_t* out,
                  int64_t cap) {
  MessageReader list{fv.list, fv.list_len};
  Field v;
  int64_t n = 0;
  while (list.next(&v)) {
    if (v.wire_type == 0) {  // one unpacked value
      if (n < cap) out[n] = static_cast<int64_t>(v.varint);
      ++n;
    } else if (v.wire_type == 2) {  // packed varints
      int64_t pos = 0;
      while (pos < v.len) {
        uint64_t x;
        if (!read_varint(v.data, v.len, &pos, &x)) return false;
        if (n < cap) out[n] = static_cast<int64_t>(x);
        ++n;
      }
    } else {
      return false;
    }
  }
  *count = n;
  return !list.bad;
}

// the first value of a bytes list and the number of values
bool bytes_values(const FeatureView& fv, int64_t* count,
                  const uint8_t** first, int64_t* first_len) {
  MessageReader list{fv.list, fv.list_len};
  Field v;
  int64_t n = 0;
  while (list.next(&v)) {
    if (v.wire_type != 2) return false;
    if (n == 0) {
      *first = v.data;
      *first_len = v.len;
    }
    ++n;
  }
  *count = n;
  return !list.bad;
}

bool key_equals(const uint8_t* data, int64_t len, const char* name) {
  const int64_t want = static_cast<int64_t>(std::strlen(name));
  return len == want && std::memcmp(data, name, len) == 0;
}

// the schema's keys, in the order of `kinds` and of the counts in `info`
const char* const kKeys[7] = {"image", "image_id", "xmins", "ymins",
                              "xmaxs", "ymaxs", "classes"};

}  // namespace

extern "C" {

// Index the records of a TFRecord buffer from byte `start`: fills
// offsets / lengths (payload offset and length) for at most `cap` records
// and returns how many it filled. *next is the offset where the scan
// stopped, *status why:
//   0  `cap` records filled: call again from *next;
//   1  the end: no bytes left, or a truncated tail;
//   2  an implausible length (> 2^31) in the header at *next;
//   3  (verify != 0) the header's masked crc32c is wrong at *next;
//   4  (verify != 0) the data's masked crc32c is wrong at *next.
int64_t tfr_index(const uint8_t* data, int64_t size, int64_t start,
                  int64_t* offsets, int64_t* lengths, int64_t cap,
                  int verify, int64_t* next, int32_t* status) {
  int64_t pos = start, n = 0;
  *status = 0;
  while (n < cap) {
    if (size - pos < 8) {
      *status = 1;
      break;
    }
    uint64_t len;
    std::memcpy(&len, data + pos, 8);
    if (len > (uint64_t{1} << 31)) {
      *status = 2;
      break;
    }
    const int64_t rec_len = static_cast<int64_t>(len);
    if (size - pos < 12 + rec_len + 4) {
      *status = 1;
      break;
    }
    if (verify) {
      uint32_t crc_h, crc_d;
      std::memcpy(&crc_h, data + pos + 8, 4);
      std::memcpy(&crc_d, data + pos + 12 + rec_len, 4);
      if (crc_h != masked_crc32c(data + pos, 8)) {
        *status = 3;
        break;
      }
      if (crc_d != masked_crc32c(data + pos + 12, rec_len)) {
        *status = 4;
        break;
      }
    }
    offsets[n] = pos + 12;
    lengths[n] = rec_len;
    ++n;
    pos += 12 + rec_len + 4;
  }
  *next = pos;
  return n;
}

// Parse one detection tf.train.Example (the schema of
// data/tfrecord.py:parse_detection_example).
//   kinds[7]  the Kind of image, image_id, xmins, ymins, xmaxs, ymaxs,
//             classes;
//   info[10]  image offset in `rec` and length (first bytes value), number
//             of image values, image_id (first value), number of image_id
//             values, then the counts of xmins, ymins, xmaxs, ymaxs and
//             classes;
//   boxes     [cap, 4] rows x1, y1, x2, y2, written when the four corner
//             lists are float lists of one count n with 0 < n <= cap;
//   classes   [cap], written when the classes are an int64 list of at most
//             cap values.
// Returns 0; 1 when a list that would be written holds more than `cap`
// values (nothing is written; call again with cap = the largest count);
// -1 on a malformed message or list.
int tfr_parse_detection(const uint8_t* rec, int64_t len, int32_t* kinds,
                        int64_t* info, float* boxes, int64_t* classes,
                        int64_t cap) {
  FeatureView feats[7];
  MessageReader example{rec, len};
  Field f;
  while (example.next(&f)) {
    if (f.number != 1 || f.wire_type != 2) continue;  // Example.features
    MessageReader features{f.data, f.len};
    Field entry;
    while (features.next(&entry)) {
      if (entry.number != 1 || entry.wire_type != 2) continue;  // map entry
      MessageReader kv{entry.data, entry.len};
      Field part;
      const uint8_t* key = nullptr;
      int64_t key_len = 0;
      FeatureView value;
      value.kind = kNoValue;
      while (kv.next(&part)) {
        if (part.wire_type != 2) continue;
        if (part.number == 1) {
          key = part.data;
          key_len = part.len;
        } else if (part.number == 2) {
          if (!view_feature(part.data, part.len, &value)) return -1;
        }
      }
      if (kv.bad) return -1;
      if (!key) continue;
      // a later entry of the same key replaces an earlier one
      for (int k = 0; k < 7; ++k)
        if (key_equals(key, key_len, kKeys[k])) feats[k] = value;
    }
    if (features.bad) return -1;
  }
  if (example.bad) return -1;

  for (int k = 0; k < 7; ++k) kinds[k] = feats[k].kind;
  for (int k = 0; k < 10; ++k) info[k] = 0;
  info[3] = -1;

  if (feats[0].kind == kBytes) {
    const uint8_t* first = nullptr;
    int64_t first_len = 0;
    if (!bytes_values(feats[0], &info[2], &first, &first_len)) return -1;
    if (info[2] > 0) {
      info[0] = first - rec;
      info[1] = first_len;
    }
  }
  if (feats[1].kind == kInt64 &&
      !int64_values(feats[1], &info[4], &info[3], 1))
    return -1;
  bool all_float = true;
  for (int k = 2; k < 6; ++k) {
    if (feats[k].kind != kFloat) {
      all_float = false;
    } else if (!float_values(feats[k], &info[3 + k], nullptr, 0, 0)) {
      return -1;
    }
  }
  if (feats[6].kind == kInt64 &&
      !int64_values(feats[6], &info[9], nullptr, 0))
    return -1;

  const int64_t n = info[5];
  const bool write_boxes = all_float && n > 0 && info[6] == n &&
                           info[7] == n && info[8] == n;
  const bool write_classes = feats[6].kind == kInt64;
  if ((write_boxes && n > cap) || (write_classes && info[9] > cap)) return 1;
  int64_t count;
  if (write_boxes)
    for (int k = 0; k < 4; ++k)
      float_values(feats[2 + k], &count, boxes + k, 4, cap);
  if (write_classes) int64_values(feats[6], &count, classes, cap);
  return 0;
}

uint32_t tfr_masked_crc32c(const uint8_t* data, int64_t n) {
  return masked_crc32c(data, n);
}

}  // extern "C"
