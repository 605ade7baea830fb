// Native FLAC decoder for tokenize_audio_tpu_torch.
//
// The reference pipeline decodes FLAC via librosa/soundfile on the host
// (yodas2-mimi/process_shard.py:389); neither ships in GPU images, so the
// framework carries its own decoder. Implements the full fixed-blocksize
// FLAC subset emitted by every mainstream encoder: CONSTANT / VERBATIM /
// FIXED(0-4) / LPC(1-32) subframes, RICE and RICE2 residual partitions with
// escape codes, left-side / right-side / mid-side stereo decorrelation,
// wasted bits, 8/12/16/20/24/32-bit samples.
//
// C ABI (ctypes-friendly):
//   flac_probe(data, len, &sample_rate, &channels, &bits, &total_samples)
//   flac_decode(data, len, out_i32, out_capacity_samples)  -> samples written
// Both return negative error codes on malformed input.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct BitReader {
  const uint8_t* data;
  size_t len;
  size_t byte = 0;
  int bit = 0;  // bits consumed in current byte (0..7)

  bool eof() const { return byte >= len; }

  // read n bits (n <= 32) MSB-first; returns false on EOF
  bool read(uint32_t n, uint64_t* out) {
    uint64_t v = 0;
    while (n > 0) {
      if (byte >= len) return false;
      uint32_t avail = 8 - bit;
      uint32_t take = n < avail ? n : avail;
      uint32_t chunk = (data[byte] >> (avail - take)) & ((1u << take) - 1);
      v = (v << take) | chunk;
      bit += take;
      if (bit == 8) {
        bit = 0;
        ++byte;
      }
      n -= take;
    }
    *out = v;
    return true;
  }

  bool read_signed(uint32_t n, int64_t* out) {
    uint64_t v;
    if (!read(n, &v)) return false;
    if (n > 0 && (v >> (n - 1)) & 1) {
      *out = (int64_t)(v | (~0ULL << n));
    } else {
      *out = (int64_t)v;
    }
    return true;
  }

  // unary: count 0 bits until a 1
  bool read_unary(uint32_t* out) {
    uint32_t q = 0;
    while (true) {
      if (byte >= len) return false;
      uint32_t avail = 8 - bit;
      uint8_t cur = (uint8_t)(data[byte] << bit);
      if (cur == 0) {
        q += avail;
        bit = 0;
        ++byte;
        continue;
      }
      // position of highest set bit in cur
      int lead = __builtin_clz((uint32_t)cur) - 24;
      q += lead;
      bit += lead + 1;
      if (bit >= 8) {
        bit -= 8;
        ++byte;
      }
      *out = q;
      return true;
    }
  }

  void align() {
    if (bit) {
      bit = 0;
      ++byte;
    }
  }
};

struct StreamInfo {
  uint32_t sample_rate = 0;
  uint32_t channels = 0;
  uint32_t bits = 0;
  uint64_t total_samples = 0;
};

bool parse_streaminfo(const uint8_t* data, size_t len, StreamInfo* si,
                      size_t* frames_offset) {
  if (len < 4 || memcmp(data, "fLaC", 4) != 0) return false;
  size_t pos = 4;
  bool last = false;
  bool seen_si = false;
  while (!last) {
    if (pos + 4 > len) return false;
    last = (data[pos] & 0x80) != 0;
    uint32_t type = data[pos] & 0x7f;
    uint32_t blen = ((uint32_t)data[pos + 1] << 16) | ((uint32_t)data[pos + 2] << 8) |
                    data[pos + 3];
    pos += 4;
    if (pos + blen > len) return false;
    if (type == 0 && blen >= 34) {
      const uint8_t* b = data + pos;
      si->sample_rate = ((uint32_t)b[10] << 12) | ((uint32_t)b[11] << 4) | (b[12] >> 4);
      si->channels = ((b[12] >> 1) & 0x7) + 1;
      si->bits = (((b[12] & 1) << 4) | (b[13] >> 4)) + 1;
      si->total_samples = (((uint64_t)(b[13] & 0x0f)) << 32) | ((uint64_t)b[14] << 24) |
                          ((uint64_t)b[15] << 16) | ((uint64_t)b[16] << 8) | b[17];
      seen_si = true;
    }
    pos += blen;
  }
  *frames_offset = pos;
  return seen_si;
}

// skip the UTF-8-style coded frame/sample number
bool skip_utf8(BitReader* br) {
  uint64_t first;
  if (!br->read(8, &first)) return false;
  uint32_t follow = 0;
  uint8_t f = (uint8_t)first;
  if (f < 0x80) follow = 0;
  else if ((f & 0xE0) == 0xC0) follow = 1;
  else if ((f & 0xF0) == 0xE0) follow = 2;
  else if ((f & 0xF8) == 0xF0) follow = 3;
  else if ((f & 0xFC) == 0xF8) follow = 4;
  else if ((f & 0xFE) == 0xFC) follow = 5;
  else if (f == 0xFE) follow = 6;
  else return false;
  for (uint32_t i = 0; i < follow; ++i) {
    uint64_t c;
    if (!br->read(8, &c)) return false;
  }
  return true;
}

bool decode_residual(BitReader* br, uint32_t blocksize, uint32_t order,
                     int64_t* out /* blocksize-sized, first `order` skipped */) {
  uint64_t method, porder;
  if (!br->read(2, &method)) return false;
  if (method > 1) return false;
  uint32_t pbits = method == 0 ? 4 : 5;
  uint32_t escape = method == 0 ? 0xF : 0x1F;
  if (!br->read(4, &porder)) return false;
  uint32_t partitions = 1u << porder;
  if (blocksize % partitions != 0) return false;
  uint32_t psize = blocksize >> porder;
  if (order > psize) return false;  // malformed: would underflow count below
  uint32_t idx = order;
  for (uint32_t p = 0; p < partitions; ++p) {
    uint32_t count = psize - (p == 0 ? order : 0);
    uint64_t param;
    if (!br->read(pbits, &param)) return false;
    if (param == escape) {
      uint64_t raw_bits;
      if (!br->read(5, &raw_bits)) return false;
      for (uint32_t i = 0; i < count; ++i) {
        int64_t v = 0;
        if (raw_bits > 0) {
          if (!br->read_signed((uint32_t)raw_bits, &v)) return false;
        }
        out[idx++] = v;
      }
    } else {
      for (uint32_t i = 0; i < count; ++i) {
        uint32_t q;
        uint64_t lo = 0;
        if (!br->read_unary(&q)) return false;
        if (param > 0 && !br->read((uint32_t)param, &lo)) return false;
        uint64_t u = ((uint64_t)q << param) | lo;
        out[idx++] = (int64_t)(u >> 1) ^ -(int64_t)(u & 1);
      }
    }
  }
  return true;
}

bool decode_subframe(BitReader* br, uint32_t blocksize, uint32_t bps,
                     std::vector<int64_t>* out) {
  uint64_t pad, type_code, wasted_flag;
  if (!br->read(1, &pad) || pad != 0) return false;
  if (!br->read(6, &type_code)) return false;
  if (!br->read(1, &wasted_flag)) return false;
  uint32_t wasted = 0;
  if (wasted_flag) {
    uint32_t u;
    if (!br->read_unary(&u)) return false;
    wasted = u + 1;
  }
  // wasted >= bps would underflow ebps (huge read_signed widths) and make
  // the final `<<= wasted` undefined behavior; no valid stream does this.
  if (wasted >= bps) return false;
  uint32_t ebps = bps - wasted;
  out->assign(blocksize, 0);
  int64_t* s = out->data();

  if (type_code == 0) {  // CONSTANT
    int64_t v;
    if (!br->read_signed(ebps, &v)) return false;
    for (uint32_t i = 0; i < blocksize; ++i) s[i] = v;
  } else if (type_code == 1) {  // VERBATIM
    for (uint32_t i = 0; i < blocksize; ++i) {
      if (!br->read_signed(ebps, &s[i])) return false;
    }
  } else if ((type_code & 0x38) == 0x08 && (type_code & 0x07) <= 4) {  // FIXED
    uint32_t order = type_code & 0x07;
    if (order > blocksize) return false;  // warm-up would overflow the block
    for (uint32_t i = 0; i < order; ++i) {
      if (!br->read_signed(ebps, &s[i])) return false;
    }
    if (!decode_residual(br, blocksize, order, s)) return false;
    switch (order) {
      case 0: break;
      case 1:
        for (uint32_t i = 1; i < blocksize; ++i) s[i] += s[i - 1];
        break;
      case 2:
        for (uint32_t i = 2; i < blocksize; ++i) s[i] += 2 * s[i - 1] - s[i - 2];
        break;
      case 3:
        for (uint32_t i = 3; i < blocksize; ++i)
          s[i] += 3 * s[i - 1] - 3 * s[i - 2] + s[i - 3];
        break;
      case 4:
        for (uint32_t i = 4; i < blocksize; ++i)
          s[i] += 4 * s[i - 1] - 6 * s[i - 2] + 4 * s[i - 3] - s[i - 4];
        break;
    }
  } else if (type_code & 0x20) {  // LPC
    uint32_t order = (uint32_t)(type_code & 0x1F) + 1;
    if (order > blocksize) return false;  // warm-up would overflow the block
    for (uint32_t i = 0; i < order; ++i) {
      if (!br->read_signed(ebps, &s[i])) return false;
    }
    uint64_t prec_m1;
    int64_t shift;
    if (!br->read(4, &prec_m1) || prec_m1 == 0xF) return false;
    uint32_t precision = (uint32_t)prec_m1 + 1;
    if (!br->read_signed(5, &shift) || shift < 0) return false;
    std::vector<int64_t> coef(order);
    for (uint32_t i = 0; i < order; ++i) {
      if (!br->read_signed(precision, &coef[i])) return false;
    }
    if (!decode_residual(br, blocksize, order, s)) return false;
    for (uint32_t i = order; i < blocksize; ++i) {
      int64_t acc = 0;
      for (uint32_t j = 0; j < order; ++j) acc += coef[j] * s[i - 1 - j];
      s[i] += acc >> shift;
    }
  } else {
    return false;  // reserved subframe type
  }
  if (wasted) {
    for (uint32_t i = 0; i < blocksize; ++i) s[i] <<= wasted;
  }
  return true;
}

}  // namespace

extern "C" {

int flac_probe(const uint8_t* data, size_t len, int32_t* sample_rate,
               int32_t* channels, int32_t* bits, int64_t* total_samples) {
  StreamInfo si;
  size_t off;
  if (!parse_streaminfo(data, len, &si, &off)) return -1;
  *sample_rate = (int32_t)si.sample_rate;
  *channels = (int32_t)si.channels;
  *bits = (int32_t)si.bits;
  *total_samples = (int64_t)si.total_samples;
  return 0;
}

// Decode into interleaved int32. Returns per-channel sample count, or <0.
int64_t flac_decode(const uint8_t* data, size_t len, int32_t* out,
                    int64_t out_capacity /* total int32 slots */) {
  StreamInfo si;
  size_t off;
  if (!parse_streaminfo(data, len, &si, &off)) return -1;
  BitReader br{data, len};
  br.byte = off;

  int64_t written = 0;  // per-channel samples written
  std::vector<std::vector<int64_t>> ch(si.channels);

  while (br.byte + 2 <= len) {
    // frame sync
    uint64_t sync;
    if (!br.read(14, &sync)) break;
    if (sync != 0x3FFE) return -2;
    uint64_t reserved, blocking;
    if (!br.read(1, &reserved) || !br.read(1, &blocking)) return -3;
    uint64_t bs_code, sr_code, ch_code, ss_code, pad;
    if (!br.read(4, &bs_code) || !br.read(4, &sr_code) || !br.read(4, &ch_code) ||
        !br.read(3, &ss_code) || !br.read(1, &pad))
      return -3;
    if (!skip_utf8(&br)) return -3;

    uint32_t blocksize;
    if (bs_code == 1) blocksize = 192;
    else if (bs_code >= 2 && bs_code <= 5) blocksize = 576u << (bs_code - 2);
    else if (bs_code == 6) {
      uint64_t v;
      if (!br.read(8, &v)) return -3;
      blocksize = (uint32_t)v + 1;
    } else if (bs_code == 7) {
      uint64_t v;
      if (!br.read(16, &v)) return -3;
      blocksize = (uint32_t)v + 1;
    } else if (bs_code >= 8) blocksize = 256u << (bs_code - 8);
    else return -4;

    if (sr_code == 12) {
      uint64_t v;
      if (!br.read(8, &v)) return -3;
    } else if (sr_code == 13 || sr_code == 14) {
      uint64_t v;
      if (!br.read(16, &v)) return -3;
    }

    uint32_t bps;
    switch (ss_code) {
      case 0: bps = si.bits; break;
      case 1: bps = 8; break;
      case 2: bps = 12; break;
      case 4: bps = 16; break;
      case 5: bps = 20; break;
      case 6: bps = 24; break;
      case 7: bps = 32; break;
      default: return -5;
    }

    uint64_t crc8;
    if (!br.read(8, &crc8)) return -3;

    uint32_t nch;
    enum { INDEP, LEFT_SIDE, RIGHT_SIDE, MID_SIDE } assign = INDEP;
    if (ch_code <= 7) {
      nch = (uint32_t)ch_code + 1;
    } else if (ch_code == 8) {
      nch = 2;
      assign = LEFT_SIDE;
    } else if (ch_code == 9) {
      nch = 2;
      assign = RIGHT_SIDE;
    } else if (ch_code == 10) {
      nch = 2;
      assign = MID_SIDE;
    } else {
      return -6;
    }
    if (nch != si.channels) return -6;

    for (uint32_t c = 0; c < nch; ++c) {
      uint32_t sub_bps = bps;
      if ((assign == LEFT_SIDE && c == 1) || (assign == RIGHT_SIDE && c == 0) ||
          (assign == MID_SIDE && c == 1))
        sub_bps += 1;  // side channel carries one extra bit
      if (!decode_subframe(&br, blocksize, sub_bps, &ch[c])) return -7;
    }
    br.align();
    uint64_t crc16;
    if (!br.read(16, &crc16)) return -3;

    // stereo decorrelation
    if (assign == LEFT_SIDE) {
      for (uint32_t i = 0; i < blocksize; ++i) ch[1][i] = ch[0][i] - ch[1][i];
    } else if (assign == RIGHT_SIDE) {
      for (uint32_t i = 0; i < blocksize; ++i) ch[0][i] = ch[0][i] + ch[1][i];
    } else if (assign == MID_SIDE) {
      for (uint32_t i = 0; i < blocksize; ++i) {
        int64_t mid = ch[0][i];
        int64_t side = ch[1][i];
        mid = (mid << 1) | (side & 1);
        ch[0][i] = (mid + side) >> 1;
        ch[1][i] = (mid - side) >> 1;
      }
    }

    if ((written + blocksize) * si.channels > (uint64_t)out_capacity) return -8;
    for (uint32_t i = 0; i < blocksize; ++i) {
      for (uint32_t c = 0; c < si.channels; ++c) {
        out[(written + i) * si.channels + c] = (int32_t)ch[c][i];
      }
    }
    written += blocksize;
    if (si.total_samples && (uint64_t)written >= si.total_samples) break;
  }
  if (si.total_samples && (uint64_t)written > si.total_samples)
    written = (int64_t)si.total_samples;
  return written;
}

}  // extern "C"
