// Native audio IO of the port: FLAC + WAV decoders and a threaded batch loader.
//
// A copy of adfmsl's decoder (adfmsl/io_native/src/audio_decode.cc), with the
// same functions and C API, built by adfmsl_torch/ops/_build.py with the host's
// g++ into its own library, libadfmsl_torch_io.so, so that both libraries can
// load in one process. It is a FLAC subset decoder (the subset every ASVspoof
// distribution uses: 16-bit, constant/verbatim/fixed/LPC subframes, Rice
// residuals, all stereo decorrelation modes) plus a minimal RIFF/WAVE reader,
// and a std::thread pool that decodes+pads a whole batch per call, so Python
// touches the data exactly once, as a filled numpy buffer.
//
// C ABI (see adfmsl_torch/io_native.py):
//   adfmsl_decode_len(path)            -> total mono samples (or -errno-like <0)
//   adfmsl_decode(path, out, cap, &sr) -> samples written (channels averaged)
//   adfmsl_batch_decode_pad(paths, n, out[n*max_len], max_len, srs[n], lens[n],
//                           pad_mode, n_threads) -> corrupt files zero-filled

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------- bit reader ----
class BitReader {
 public:
  BitReader(const uint8_t* data, size_t size) : data_(data), size_(size) {}

  bool ok() const { return !error_; }
  size_t byte_pos() const { return pos_ >> 3; }

  void align_byte() { pos_ = (pos_ + 7) & ~size_t(7); }

  uint64_t bits(int n) {
    uint64_t v = 0;
    for (int i = 0; i < n; ++i) {
      size_t byte = pos_ >> 3;
      if (byte >= size_) { error_ = true; return 0; }
      v = (v << 1) | ((data_[byte] >> (7 - (pos_ & 7))) & 1);
      ++pos_;
    }
    return v;
  }

  int64_t sbits(int n) {
    uint64_t v = bits(n);
    if (n > 0 && (v >> (n - 1)) & 1) return int64_t(v) - (int64_t(1) << n);
    return int64_t(v);
  }

  uint32_t unary() {
    uint32_t q = 0;
    while (ok() && bits(1) == 0) {
      if (++q > 1u << 24) { error_ = true; return 0; }  // corrupt stream guard
    }
    return q;
  }

  void seek_bytes(size_t byte) { pos_ = byte << 3; }

 private:
  const uint8_t* data_;
  size_t size_;
  size_t pos_ = 0;
  bool error_ = false;
};

struct StreamInfo {
  uint32_t sample_rate = 0;
  uint32_t channels = 0;
  uint32_t bits_per_sample = 0;
  uint64_t total_samples = 0;
};

// ------------------------------------------------------------- flac decoding ----
bool parse_stream_info(const uint8_t* p, size_t n, StreamInfo* si,
                       size_t* frames_offset) {
  if (n < 4 || memcmp(p, "fLaC", 4) != 0) return false;
  size_t pos = 4;
  bool last = false;
  while (!last) {
    if (pos + 4 > n) return false;
    last = p[pos] & 0x80;
    uint32_t type = p[pos] & 0x7f;
    uint32_t len = (uint32_t(p[pos + 1]) << 16) | (uint32_t(p[pos + 2]) << 8) |
                   p[pos + 3];
    pos += 4;
    if (pos + len > n) return false;
    if (type == 0) {  // STREAMINFO
      if (len < 34) return false;
      const uint8_t* s = p + pos;
      si->sample_rate = (uint32_t(s[10]) << 12) | (uint32_t(s[11]) << 4) |
                        (s[12] >> 4);
      si->channels = ((s[12] >> 1) & 0x7) + 1;
      si->bits_per_sample = (((s[12] & 1) << 4) | (s[13] >> 4)) + 1;
      si->total_samples = (uint64_t(s[13] & 0x0f) << 32) |
                          (uint64_t(s[14]) << 24) | (uint64_t(s[15]) << 16) |
                          (uint64_t(s[16]) << 8) | s[17];
    }
    pos += len;
  }
  *frames_offset = pos;
  return si->sample_rate != 0;
}

// Skip a UTF-8-style coded number (frame/sample index).
bool skip_utf8(BitReader* br) {
  uint64_t b = br->bits(8);
  if (!br->ok()) return false;
  int extra = 0;
  if (b < 0x80) extra = 0;
  else if ((b & 0xE0) == 0xC0) extra = 1;
  else if ((b & 0xF0) == 0xE0) extra = 2;
  else if ((b & 0xF8) == 0xF0) extra = 3;
  else if ((b & 0xFC) == 0xF8) extra = 4;
  else if ((b & 0xFE) == 0xFC) extra = 5;
  else if (b == 0xFE) extra = 6;
  else return false;
  for (int i = 0; i < extra; ++i) br->bits(8);
  return br->ok();
}

bool decode_residual(BitReader* br, uint32_t block_size, uint32_t pred_order,
                     int64_t* out) {
  uint32_t method = uint32_t(br->bits(2));
  if (method > 1) return false;
  int param_bits = method == 0 ? 4 : 5;
  uint32_t escape = method == 0 ? 0xF : 0x1F;
  uint32_t part_order = uint32_t(br->bits(4));
  uint32_t n_parts = 1u << part_order;
  if ((block_size >> part_order) == 0) return false;
  uint32_t idx = pred_order;
  for (uint32_t part = 0; part < n_parts; ++part) {
    uint32_t count = block_size >> part_order;
    if (part == 0) {
      if (count < pred_order) return false;
      count -= pred_order;
    }
    uint32_t param = uint32_t(br->bits(param_bits));
    if (param == escape) {
      uint32_t raw = uint32_t(br->bits(5));
      for (uint32_t i = 0; i < count; ++i) out[idx++] = raw ? br->sbits(raw) : 0;
    } else {
      for (uint32_t i = 0; i < count; ++i) {
        uint32_t q = br->unary();
        uint64_t r = param ? br->bits(param) : 0;
        uint64_t v = (uint64_t(q) << param) | r;
        out[idx++] = (v & 1) ? -int64_t(v >> 1) - 1 : int64_t(v >> 1);  // zigzag
      }
    }
    if (!br->ok()) return false;
  }
  return true;
}

const int kFixedOrders[5][4] = {
    {},  // order 0
    {1},
    {2, -1},
    {3, -3, 1},
    {4, -6, 4, -1},
};

bool decode_subframe(BitReader* br, uint32_t block_size, uint32_t bps,
                     int64_t* out) {
  if (br->bits(1) != 0) return false;  // padding bit
  uint32_t type = uint32_t(br->bits(6));
  uint32_t wasted = 0;
  if (br->bits(1)) wasted = br->unary() + 1;
  if (!br->ok()) return false;
  uint32_t ebps = bps - wasted;

  if (type == 0) {  // CONSTANT
    int64_t v = br->sbits(int(ebps));
    for (uint32_t i = 0; i < block_size; ++i) out[i] = v;
  } else if (type == 1) {  // VERBATIM
    for (uint32_t i = 0; i < block_size; ++i) out[i] = br->sbits(int(ebps));
  } else if ((type & 0x38) == 0x08 && (type & 0x07) <= 4) {  // FIXED
    uint32_t order = type & 0x07;
    for (uint32_t i = 0; i < order; ++i) out[i] = br->sbits(int(ebps));
    if (!decode_residual(br, block_size, order, out)) return false;
    for (uint32_t i = order; i < block_size; ++i) {
      int64_t pred = 0;
      for (uint32_t j = 0; j < order; ++j)
        pred += int64_t(kFixedOrders[order][j]) * out[i - 1 - j];
      out[i] += pred;
    }
  } else if (type & 0x20) {  // LPC
    uint32_t order = (type & 0x1F) + 1;
    for (uint32_t i = 0; i < order; ++i) out[i] = br->sbits(int(ebps));
    uint32_t precision = uint32_t(br->bits(4)) + 1;
    if (precision == 16) return false;  // 0b1111 invalid
    int shift = int(br->sbits(5));
    if (shift < 0) return false;
    std::vector<int64_t> coef(order);
    for (uint32_t i = 0; i < order; ++i) coef[i] = br->sbits(int(precision));
    if (!decode_residual(br, block_size, order, out)) return false;
    for (uint32_t i = order; i < block_size; ++i) {
      int64_t pred = 0;
      for (uint32_t j = 0; j < order; ++j) pred += coef[j] * out[i - 1 - j];
      out[i] += pred >> shift;
    }
  } else {
    return false;
  }
  if (wasted)
    for (uint32_t i = 0; i < block_size; ++i) out[i] <<= wasted;
  return br->ok();
}

const uint32_t kBlockSizes[16] = {0,   192, 576,  1152, 2304, 4608, 0,    0,
                                  256, 512, 1024, 2048, 4096, 8192, 16384, 32768};
const uint32_t kSampleRates[12] = {0,     88200, 176400, 192000, 8000, 16000,
                                   22050, 24000, 32000,  44100,  48000, 96000};

// Decode one frame; append mono-averaged samples. Returns samples appended or -1.
int64_t decode_frame(BitReader* br, const StreamInfo& si,
                     std::vector<float>* mono,
                     std::vector<std::vector<int64_t>>* chan_buf) {
  uint64_t sync = br->bits(14);
  if (!br->ok()) return -1;
  if (sync != 0x3FFE) return -1;
  br->bits(1);                       // reserved
  br->bits(1);                       // blocking strategy
  uint32_t bs_code = uint32_t(br->bits(4));
  uint32_t sr_code = uint32_t(br->bits(4));
  uint32_t ch_code = uint32_t(br->bits(4));
  uint32_t ss_code = uint32_t(br->bits(3));
  br->bits(1);                       // reserved
  if (!skip_utf8(br)) return -1;

  uint32_t block_size;
  if (bs_code == 6) block_size = uint32_t(br->bits(8)) + 1;
  else if (bs_code == 7) block_size = uint32_t(br->bits(16)) + 1;
  else block_size = kBlockSizes[bs_code];
  if (block_size == 0) return -1;

  if (sr_code == 12) br->bits(8);
  else if (sr_code == 13 || sr_code == 14) br->bits(16);
  // else table / streaminfo

  uint32_t bps = si.bits_per_sample;
  static const uint32_t kBps[8] = {0, 8, 12, 0, 16, 20, 24, 32};
  if (ss_code != 0 && kBps[ss_code]) bps = kBps[ss_code];

  br->bits(8);  // CRC-8

  uint32_t n_chan;
  enum { INDEP, LEFT_SIDE, RIGHT_SIDE, MID_SIDE } mode = INDEP;
  if (ch_code < 8) {
    n_chan = ch_code + 1;
  } else if (ch_code == 8) { n_chan = 2; mode = LEFT_SIDE; }
  else if (ch_code == 9) { n_chan = 2; mode = RIGHT_SIDE; }
  else if (ch_code == 10) { n_chan = 2; mode = MID_SIDE; }
  else return -1;

  if (chan_buf->size() < n_chan) chan_buf->resize(n_chan);
  for (uint32_t c = 0; c < n_chan; ++c) {
    auto& buf = (*chan_buf)[c];
    if (buf.size() < block_size) buf.resize(block_size);
    uint32_t sub_bps = bps;
    // side channels carry one extra bit
    if ((mode == LEFT_SIDE && c == 1) || (mode == RIGHT_SIDE && c == 0) ||
        (mode == MID_SIDE && c == 1))
      sub_bps += 1;
    if (!decode_subframe(br, block_size, sub_bps, buf.data())) return -1;
  }
  br->align_byte();
  br->bits(16);  // CRC-16
  if (!br->ok()) return -1;

  // stereo decorrelation -> PCM, then channel-average to mono float
  const float scale = 1.0f / float(int64_t(1) << (bps - 1));
  size_t base = mono->size();
  mono->resize(base + block_size);
  if (n_chan == 1) {
    const auto& a = (*chan_buf)[0];
    for (uint32_t i = 0; i < block_size; ++i)
      (*mono)[base + i] = float(a[i]) * scale;
  } else if (n_chan == 2) {
    auto& a = (*chan_buf)[0];
    auto& b = (*chan_buf)[1];
    for (uint32_t i = 0; i < block_size; ++i) {
      int64_t l, r;
      switch (mode) {
        case LEFT_SIDE:  l = a[i]; r = a[i] - b[i]; break;
        case RIGHT_SIDE: l = a[i] + b[i]; r = b[i]; break;
        case MID_SIDE: {
          int64_t side = b[i];
          int64_t m2 = (a[i] << 1) | (side & 1);
          l = (m2 + side) >> 1; r = (m2 - side) >> 1; break;
        }
        default: l = a[i]; r = b[i];
      }
      (*mono)[base + i] = 0.5f * (float(l) + float(r)) * scale;
    }
  } else {
    for (uint32_t i = 0; i < block_size; ++i) {
      double acc = 0;
      for (uint32_t c = 0; c < n_chan; ++c) acc += double((*chan_buf)[c][i]);
      (*mono)[base + i] = float(acc / n_chan) * scale;
    }
  }
  return block_size;
}

int64_t decode_flac(const uint8_t* data, size_t size, std::vector<float>* mono,
                    int32_t* sample_rate) {
  StreamInfo si;
  size_t frames_at = 0;
  if (!parse_stream_info(data, size, &si, &frames_at)) return -2;
  *sample_rate = int32_t(si.sample_rate);
  if (si.total_samples) mono->reserve(size_t(si.total_samples));
  BitReader br(data, size);
  br.seek_bytes(frames_at);
  std::vector<std::vector<int64_t>> chan_buf;
  while (br.ok() && br.byte_pos() + 2 < size) {
    if (decode_frame(&br, si, mono, &chan_buf) < 0) break;
  }
  return int64_t(mono->size());
}

// -------------------------------------------------------------- wav decoding ----
int64_t decode_wav(const uint8_t* p, size_t n, std::vector<float>* mono,
                   int32_t* sample_rate) {
  if (n < 44 || memcmp(p, "RIFF", 4) != 0 || memcmp(p + 8, "WAVE", 4) != 0)
    return -2;
  size_t pos = 12;
  uint16_t fmt = 0, n_ch = 0, bits = 0;
  uint32_t sr = 0;
  const uint8_t* pcm = nullptr;
  size_t pcm_len = 0;
  auto rd16 = [&](size_t o) { return uint16_t(p[o] | (p[o + 1] << 8)); };
  auto rd32 = [&](size_t o) {
    return uint32_t(p[o] | (p[o + 1] << 8) | (p[o + 2] << 16) | (p[o + 3] << 24));
  };
  while (pos + 8 <= n) {
    uint32_t len = rd32(pos + 4);
    if (memcmp(p + pos, "fmt ", 4) == 0 && pos + 8 + 16 <= n) {
      fmt = rd16(pos + 8);
      n_ch = rd16(pos + 10);
      sr = rd32(pos + 12);
      bits = rd16(pos + 22);
    } else if (memcmp(p + pos, "data", 4) == 0) {
      pcm = p + pos + 8;
      pcm_len = std::min(size_t(len), n - pos - 8);
    }
    pos += 8 + len + (len & 1);
  }
  if (!pcm || !sr || !n_ch) return -2;
  *sample_rate = int32_t(sr);
  size_t n_samp;
  if (fmt == 1 && bits == 16) {
    n_samp = pcm_len / 2 / n_ch;
    mono->resize(n_samp);
    const int16_t* s = reinterpret_cast<const int16_t*>(pcm);
    for (size_t i = 0; i < n_samp; ++i) {
      float acc = 0;
      for (uint16_t c = 0; c < n_ch; ++c) acc += float(s[i * n_ch + c]);
      (*mono)[i] = acc / (32768.0f * n_ch);
    }
  } else if (fmt == 3 && bits == 32) {
    n_samp = pcm_len / 4 / n_ch;
    mono->resize(n_samp);
    const float* s = reinterpret_cast<const float*>(pcm);
    for (size_t i = 0; i < n_samp; ++i) {
      float acc = 0;
      for (uint16_t c = 0; c < n_ch; ++c) acc += s[i * n_ch + c];
      (*mono)[i] = acc / n_ch;
    }
  } else if (fmt == 1 && bits == 32) {
    n_samp = pcm_len / 4 / n_ch;
    mono->resize(n_samp);
    const int32_t* s = reinterpret_cast<const int32_t*>(pcm);
    for (size_t i = 0; i < n_samp; ++i) {
      double acc = 0;
      for (uint16_t c = 0; c < n_ch; ++c) acc += double(s[i * n_ch + c]);
      (*mono)[i] = float(acc / (2147483648.0 * n_ch));
    }
  } else if (fmt == 3 && bits == 64) {
    n_samp = pcm_len / 8 / n_ch;
    mono->resize(n_samp);
    const double* s = reinterpret_cast<const double*>(pcm);
    for (size_t i = 0; i < n_samp; ++i) {
      double acc = 0;
      for (uint16_t c = 0; c < n_ch; ++c) acc += s[i * n_ch + c];
      (*mono)[i] = float(acc / n_ch);
    }
  } else {
    return -3;
  }
  return int64_t(mono->size());
}

int64_t decode_file(const char* path, std::vector<float>* mono,
                    int32_t* sample_rate) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, 0, SEEK_END);
  long sz = ftell(f);
  fseek(f, 0, SEEK_SET);
  if (sz <= 0) { fclose(f); return -1; }
  std::vector<uint8_t> data(static_cast<size_t>(sz));
  size_t got = fread(data.data(), 1, size_t(sz), f);
  fclose(f);
  if (got != size_t(sz)) return -1;
  if (sz >= 4 && memcmp(data.data(), "fLaC", 4) == 0)
    return decode_flac(data.data(), data.size(), mono, sample_rate);
  return decode_wav(data.data(), data.size(), mono, sample_rate);
}

// Header-only length probe: STREAMINFO total_samples (FLAC) / data-chunk frame
// count (WAV). Returns -1 when the header does not carry the length (legal for
// FLAC streams with total_samples == 0) — caller falls back to a full decode.
int64_t header_len(const uint8_t* p, size_t n) {
  if (n >= 4 && memcmp(p, "fLaC", 4) == 0) {
    StreamInfo si;
    size_t off = 0;
    if (!parse_stream_info(p, n, &si, &off)) return -2;
    return si.total_samples ? int64_t(si.total_samples) : -1;
  }
  if (n < 44 || memcmp(p, "RIFF", 4) != 0 || memcmp(p + 8, "WAVE", 4) != 0)
    return -2;
  size_t pos = 12;
  uint16_t fmt = 0, n_ch = 0, bits = 0;
  size_t pcm_len = 0;
  auto rd16 = [&](size_t o) { return uint16_t(p[o] | (p[o + 1] << 8)); };
  auto rd32 = [&](size_t o) {
    return uint32_t(p[o] | (p[o + 1] << 8) | (p[o + 2] << 16) | (p[o + 3] << 24));
  };
  while (pos + 8 <= n) {
    uint32_t len = rd32(pos + 4);
    if (memcmp(p + pos, "fmt ", 4) == 0 && pos + 8 + 16 <= n) {
      fmt = rd16(pos + 8);
      n_ch = rd16(pos + 10);
      bits = rd16(pos + 22);
    } else if (memcmp(p + pos, "data", 4) == 0) {
      pcm_len = std::min(size_t(len), n - pos - 8);
    }
    pos += 8 + len + (len & 1);
  }
  if (!n_ch || !pcm_len) return -2;
  // Only the formats decode_wav actually supports; anything else (ADPCM, mu-law,
  // 8-bit PCM, ...) must report the same -3 the decoder would, never a bogus
  // length or a bits/8 == 0 division.
  const bool supported = (fmt == 1 && (bits == 16 || bits == 32)) ||
                         (fmt == 3 && (bits == 32 || bits == 64));
  if (!supported) return -3;
  return int64_t(pcm_len / (size_t(n_ch) * (bits / 8)));
}

}  // namespace

// --------------------------------------------------------------------- C ABI ----
extern "C" {

int64_t adfmsl_decode_len(const char* path) {
  // was: a FULL decode just to learn the length (doubling per-utterance host
  // decode cost on the hot path). Header-only now; full decode only as the
  // fallback for length-less FLAC streams.
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, 0, SEEK_END);
  long sz = ftell(f);
  fseek(f, 0, SEEK_SET);
  if (sz <= 0) { fclose(f); return -1; }
  std::vector<uint8_t> data(static_cast<size_t>(sz));
  size_t got = fread(data.data(), 1, size_t(sz), f);
  fclose(f);
  if (got != size_t(sz)) return -1;
  int64_t n = header_len(data.data(), data.size());
  if (n >= 0) return n;
  if (n == -1) {  // unknown-length FLAC: decode to count
    std::vector<float> mono;
    int32_t sr = 0;
    if (memcmp(data.data(), "fLaC", 4) == 0)
      return decode_flac(data.data(), data.size(), &mono, &sr);
  }
  return n;
}

int64_t adfmsl_decode(const char* path, float* out, int64_t capacity,
                      int32_t* sample_rate) {
  std::vector<float> mono;
  int64_t n = decode_file(path, &mono, sample_rate);
  if (n < 0) return n;
  int64_t m = n < capacity ? n : capacity;
  memcpy(out, mono.data(), size_t(m) * sizeof(float));
  return m;
}

// pad_mode: 0 = tile-repeat (maze2.py:236-242 semantics), 1 = zero-pad.
int32_t adfmsl_batch_decode_pad(const char** paths, int32_t n, float* out,
                                int64_t max_len, int32_t* sample_rates,
                                int32_t* lengths, int32_t pad_mode,
                                int32_t n_threads) {
  if (n <= 0 || max_len <= 0) return -1;
  std::atomic<int32_t> next(0);
  std::atomic<int32_t> failures(0);
  auto worker = [&]() {
    std::vector<float> mono;
    for (;;) {
      int32_t i = next.fetch_add(1);
      if (i >= n) return;
      mono.clear();
      int32_t sr = 0;
      int64_t got = decode_file(paths[i], &mono, &sr);
      float* dst = out + int64_t(i) * max_len;
      if (got <= 0) {  // missing/corrupt -> zeros (reference failure tolerance)
        memset(dst, 0, size_t(max_len) * sizeof(float));
        sample_rates[i] = 0;
        lengths[i] = 0;
        if (got < -1) failures.fetch_add(1);
        continue;
      }
      sample_rates[i] = sr;
      lengths[i] = int32_t(got < max_len ? got : max_len);
      if (got >= max_len) {
        memcpy(dst, mono.data(), size_t(max_len) * sizeof(float));
      } else if (pad_mode == 0) {
        for (int64_t off = 0; off < max_len; off += got) {
          int64_t chunk = std::min(got, max_len - off);
          memcpy(dst + off, mono.data(), size_t(chunk) * sizeof(float));
        }
      } else {
        memcpy(dst, mono.data(), size_t(got) * sizeof(float));
        memset(dst + got, 0, size_t(max_len - got) * sizeof(float));
      }
    }
  };
  int nt = n_threads > 0 ? n_threads : 1;
  if (nt > n) nt = n;
  std::vector<std::thread> threads;
  for (int t = 1; t < nt; ++t) threads.emplace_back(worker);
  worker();
  for (auto& th : threads) th.join();
  // >= 0: number of corrupt files zero-filled (missing files are the
  // reference's by-design tolerance and are not counted here)
  return failures.load();
}

}  // extern "C"
