// Native FLAC / WAV decoder and batched audio loader of rtdsd_tpu_torch.
//
// The port's own copy of rtdsd_tpu/native/flac_decoder.cpp, with the same
// algorithm throughout, so that the port's eval loader cuts the windows the
// JAX package's loader cuts: a from-scratch FLAC (and WAV) decoder, channel
// 0, linear resampling to the pipeline rate, repeat-tile, then a first-N or
// a seeded random-start window (two xorshifts of seed ^ (golden * (i + 1))),
// and a per-file status. A std::thread pool decodes a batch of files
// straight into a caller's (B, T) float32 buffer: one C call per batch, the
// GIL released on the Python side (ctypes).
//
// Format coverage: FLAC subframe types CONSTANT / VERBATIM / FIXED(0-4) /
// LPC(1-32), partitioned Rice residuals (4- and 5-bit params + escape),
// wasted bits, left/right/mid-side stereo decorrelation, 8/12/16/20/24/32
// bps. CRCs are parsed but not verified (decode robustness over validation).
// WAV: PCM 16/24/32 and float32.
//
// Built at first use by rtdsd_tpu_torch/native/flac.py
// (g++ -O2 -std=c++17 -shared -fPIC -pthread).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <atomic>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------- bit reader

struct BitReader {
  const uint8_t* data;
  size_t size;
  size_t byte_pos = 0;
  int bit_pos = 0;  // bits consumed of current byte (0..7)
  bool error = false;

  BitReader(const uint8_t* d, size_t n) : data(d), size(n) {}

  bool eof() const { return byte_pos >= size; }

  inline uint32_t read_bit() {
    if (byte_pos >= size) { error = true; return 0; }
    uint32_t b = (data[byte_pos] >> (7 - bit_pos)) & 1u;
    if (++bit_pos == 8) { bit_pos = 0; ++byte_pos; }
    return b;
  }

  inline uint64_t read_bits(int n) {  // n <= 57
    uint64_t v = 0;
    while (n > 0 && !error) {
      if (byte_pos >= size) { error = true; return 0; }
      int avail = 8 - bit_pos;
      int take = n < avail ? n : avail;
      uint32_t chunk =
          (data[byte_pos] >> (avail - take)) & ((1u << take) - 1u);
      v = (v << take) | chunk;
      bit_pos += take;
      if (bit_pos == 8) { bit_pos = 0; ++byte_pos; }
      n -= take;
    }
    return v;
  }

  inline int64_t read_signed(int n) {
    uint64_t v = read_bits(n);
    if (n == 0) return 0;
    uint64_t sign = 1ull << (n - 1);
    return (v & sign) ? (int64_t)(v | ~((sign << 1) - 1)) : (int64_t)v;
  }

  inline uint32_t read_unary() {
    uint32_t q = 0;
    while (!error && read_bit() == 0) {
      ++q;
      if (q > 1u << 24) { error = true; break; }  // corrupt stream guard
    }
    return q;
  }

  void align_to_byte() {
    if (bit_pos != 0) { bit_pos = 0; ++byte_pos; }
  }
};

// -------------------------------------------------------------- FLAC decode

struct FlacInfo {
  uint32_t sample_rate = 0;
  uint32_t channels = 0;
  uint32_t bps = 0;
  uint64_t total_samples = 0;
};

bool read_utf8_number(BitReader& br, uint64_t* out) {
  uint32_t b0 = (uint32_t)br.read_bits(8);
  if (br.error) return false;
  int extra;
  uint64_t v;
  if ((b0 & 0x80u) == 0) { v = b0; extra = 0; }
  else if ((b0 & 0xE0u) == 0xC0u) { v = b0 & 0x1Fu; extra = 1; }
  else if ((b0 & 0xF0u) == 0xE0u) { v = b0 & 0x0Fu; extra = 2; }
  else if ((b0 & 0xF8u) == 0xF0u) { v = b0 & 0x07u; extra = 3; }
  else if ((b0 & 0xFCu) == 0xF8u) { v = b0 & 0x03u; extra = 4; }
  else if ((b0 & 0xFEu) == 0xFCu) { v = b0 & 0x01u; extra = 5; }
  else if (b0 == 0xFEu) { v = 0; extra = 6; }
  else return false;
  for (int i = 0; i < extra; ++i) {
    uint32_t b = (uint32_t)br.read_bits(8);
    if (br.error || (b & 0xC0u) != 0x80u) return false;
    v = (v << 6) | (b & 0x3Fu);
  }
  *out = v;
  return true;
}

bool decode_residual(BitReader& br, int order, uint32_t block_size,
                     int64_t* out /* block_size entries, warmup filled */) {
  uint32_t method = (uint32_t)br.read_bits(2);
  if (method > 1 || br.error) return false;
  int plen = method == 0 ? 4 : 5;
  uint32_t escape = method == 0 ? 0xF : 0x1F;
  uint32_t part_order = (uint32_t)br.read_bits(4);
  uint32_t parts = 1u << part_order;
  if ((block_size >> part_order) == 0) return false;
  uint32_t idx = order;
  for (uint32_t p = 0; p < parts; ++p) {
    uint32_t count = block_size >> part_order;
    if (p == 0) {
      if (count < (uint32_t)order) return false;
      count -= order;
    }
    uint32_t param = (uint32_t)br.read_bits(plen);
    if (br.error) return false;
    if (param == escape) {
      uint32_t raw_bits = (uint32_t)br.read_bits(5);
      for (uint32_t i = 0; i < count; ++i)
        out[idx++] = br.read_signed((int)raw_bits);
    } else {
      for (uint32_t i = 0; i < count; ++i) {
        uint32_t q = br.read_unary();
        uint64_t r = br.read_bits((int)param);
        uint64_t zz = ((uint64_t)q << param) | r;
        out[idx++] = (int64_t)(zz >> 1) ^ -(int64_t)(zz & 1);
      }
    }
    if (br.error) return false;
  }
  return idx == block_size;
}

bool decode_subframe(BitReader& br, uint32_t block_size, int bps,
                     int64_t* out) {
  if (br.read_bit() != 0) return false;  // mandatory zero pad bit
  uint32_t type = (uint32_t)br.read_bits(6);
  uint32_t wasted = 0;
  if (br.read_bit() == 1) wasted = br.read_unary() + 1;
  if (br.error) return false;
  int ebps = bps - (int)wasted;
  if (ebps <= 0 || ebps > 33) return false;

  if (type == 0) {                       // CONSTANT
    int64_t v = br.read_signed(ebps);
    for (uint32_t i = 0; i < block_size; ++i) out[i] = v;
  } else if (type == 1) {                // VERBATIM
    for (uint32_t i = 0; i < block_size; ++i) out[i] = br.read_signed(ebps);
  } else if ((type & 0x38u) == 0x08u && (type & 0x07u) <= 4) {  // FIXED
    int order = (int)(type & 0x07u);
    // warmup samples write out[0..order): a corrupt frame with
    // block_size < order would overflow the block-sized buffer
    if ((uint32_t)order > block_size) return false;
    for (int i = 0; i < order; ++i) out[i] = br.read_signed(ebps);
    if (!decode_residual(br, order, block_size, out)) return false;
    switch (order) {
      case 0: break;
      case 1:
        for (uint32_t i = 1; i < block_size; ++i) out[i] += out[i - 1];
        break;
      case 2:
        for (uint32_t i = 2; i < block_size; ++i)
          out[i] += 2 * out[i - 1] - out[i - 2];
        break;
      case 3:
        for (uint32_t i = 3; i < block_size; ++i)
          out[i] += 3 * out[i - 1] - 3 * out[i - 2] + out[i - 3];
        break;
      case 4:
        for (uint32_t i = 4; i < block_size; ++i)
          out[i] += 4 * out[i - 1] - 6 * out[i - 2] + 4 * out[i - 3]
                    - out[i - 4];
        break;
    }
  } else if (type & 0x20u) {             // LPC
    int order = (int)(type & 0x1Fu) + 1;
    if ((uint32_t)order > block_size) return false;  // see FIXED note
    for (int i = 0; i < order; ++i) out[i] = br.read_signed(ebps);
    int precision = (int)br.read_bits(4) + 1;
    if (precision == 16) return false;   // 1111 invalid
    int shift = (int)br.read_signed(5);
    if (shift < 0) return false;
    int64_t coefs[32];
    for (int i = 0; i < order; ++i) coefs[i] = br.read_signed(precision);
    if (!decode_residual(br, order, block_size, out)) return false;
    for (uint32_t i = (uint32_t)order; i < block_size; ++i) {
      int64_t pred = 0;
      for (int j = 0; j < order; ++j) pred += coefs[j] * out[i - 1 - j];
      out[i] += pred >> shift;
    }
  } else {
    return false;  // reserved type
  }
  if (br.error) return false;
  if (wasted)
    for (uint32_t i = 0; i < block_size; ++i) out[i] <<= wasted;
  return true;
}

// Decode a whole FLAC stream to interleaved float32 (-1, 1).
// Returns samples-per-channel, or -1 on error.
int64_t decode_flac(const uint8_t* data, size_t size,
                    std::vector<float>* pcm, FlacInfo* info) {
  if (size < 8 || memcmp(data, "fLaC", 4) != 0) return -1;
  size_t pos = 4;
  bool have_streaminfo = false;
  // metadata blocks
  for (;;) {
    if (pos + 4 > size) return -1;
    uint8_t hdr = data[pos];
    uint32_t len = ((uint32_t)data[pos + 1] << 16) |
                   ((uint32_t)data[pos + 2] << 8) | data[pos + 3];
    uint32_t btype = hdr & 0x7Fu;
    pos += 4;
    if (btype == 0 && len >= 34) {  // STREAMINFO
      const uint8_t* p = data + pos;
      info->sample_rate = ((uint32_t)p[10] << 12) | ((uint32_t)p[11] << 4) |
                          (p[12] >> 4);
      info->channels = ((p[12] >> 1) & 0x7u) + 1;
      info->bps = (((p[12] & 1u) << 4) | (p[13] >> 4)) + 1;
      info->total_samples = ((uint64_t)(p[13] & 0x0Fu) << 32) |
                            ((uint64_t)p[14] << 24) | ((uint64_t)p[15] << 16) |
                            ((uint64_t)p[16] << 8) | p[17];
      have_streaminfo = true;
    }
    pos += len;
    if (pos > size) return -1;
    if (hdr & 0x80u) break;  // last block
  }
  if (!have_streaminfo || info->channels == 0) return -1;

  uint32_t ch = info->channels;
  pcm->clear();
  if (info->total_samples)
    pcm->reserve((size_t)info->total_samples * ch);

  BitReader br(data, size);
  br.byte_pos = pos;
  std::vector<std::vector<int64_t>> chans(ch);

  while (br.byte_pos + 2 < size) {
    // frame header
    uint64_t sync = br.read_bits(14);
    if (br.error) break;
    if (sync != 0x3FFEu) return -1;
    br.read_bit();  // reserved
    br.read_bit();  // blocking strategy
    uint32_t bs_code = (uint32_t)br.read_bits(4);
    uint32_t sr_code = (uint32_t)br.read_bits(4);
    uint32_t ch_asgn = (uint32_t)br.read_bits(4);
    uint32_t ss_code = (uint32_t)br.read_bits(3);
    br.read_bit();  // reserved
    uint64_t dummy;
    if (!read_utf8_number(br, &dummy)) return -1;

    uint32_t block_size;
    if (bs_code == 1) block_size = 192;
    else if (bs_code >= 2 && bs_code <= 5) block_size = 576u << (bs_code - 2);
    else if (bs_code == 6) block_size = (uint32_t)br.read_bits(8) + 1;
    else if (bs_code == 7) block_size = (uint32_t)br.read_bits(16) + 1;
    else if (bs_code >= 8) block_size = 256u << (bs_code - 8);
    else return -1;

    if (sr_code == 12) br.read_bits(8);        // kHz
    else if (sr_code == 13 || sr_code == 14) br.read_bits(16);

    int bps;
    switch (ss_code) {
      case 0: bps = (int)info->bps; break;
      case 1: bps = 8; break;
      case 2: bps = 12; break;
      case 4: bps = 16; break;
      case 5: bps = 20; break;
      case 6: bps = 24; break;
      case 7: bps = 32; break;
      default: return -1;
    }
    br.read_bits(8);  // CRC-8 (unverified)
    if (br.error) return -1;

    uint32_t nch = ch_asgn < 8 ? ch_asgn + 1 : 2;
    if (nch != ch) return -1;
    for (uint32_t c = 0; c < ch; ++c) {
      chans[c].resize(block_size);
      int sub_bps = bps;
      // side channel carries one extra bit
      if ((ch_asgn == 8 && c == 1) || (ch_asgn == 9 && c == 0) ||
          (ch_asgn == 10 && c == 1))
        sub_bps += 1;
      if (!decode_subframe(br, block_size, sub_bps, chans[c].data()))
        return -1;
    }
    br.align_to_byte();
    br.read_bits(16);  // CRC-16 (unverified)

    // stereo decorrelation
    if (ch_asgn == 8) {          // left/side
      for (uint32_t i = 0; i < block_size; ++i)
        chans[1][i] = chans[0][i] - chans[1][i];
    } else if (ch_asgn == 9) {   // right/side: left = side + right
      for (uint32_t i = 0; i < block_size; ++i)
        chans[0][i] = chans[0][i] + chans[1][i];
    } else if (ch_asgn == 10) {  // mid/side
      for (uint32_t i = 0; i < block_size; ++i) {
        int64_t side = chans[1][i];
        int64_t mid = (chans[0][i] << 1) | (side & 1);
        chans[0][i] = (mid + side) >> 1;
        chans[1][i] = (mid - side) >> 1;
      }
    }

    float scale = 1.0f / (float)(1ull << (bps - 1));
    size_t base = pcm->size();
    pcm->resize(base + (size_t)block_size * ch);
    float* dst = pcm->data() + base;
    for (uint32_t i = 0; i < block_size; ++i)
      for (uint32_t c = 0; c < ch; ++c)
        dst[i * ch + c] = (float)chans[c][i] * scale;

    if (info->total_samples &&
        pcm->size() >= info->total_samples * ch)
      break;
  }
  return (int64_t)(pcm->size() / ch);
}

// --------------------------------------------------------------- WAV decode

int64_t decode_wav(const uint8_t* data, size_t size, std::vector<float>* pcm,
                   FlacInfo* info) {
  if (size < 44 || memcmp(data, "RIFF", 4) != 0 ||
      memcmp(data + 8, "WAVE", 4) != 0)
    return -1;
  size_t pos = 12;
  uint16_t fmt = 0, channels = 0, bits = 0, sub_fmt = 0;
  uint32_t sr = 0;
  const uint8_t* raw = nullptr;
  size_t raw_len = 0;
  while (pos + 8 <= size) {
    uint32_t len;
    memcpy(&len, data + pos + 4, 4);
    const uint8_t* body = data + pos + 8;
    // never trust the declared chunk length past the file end (a
    // truncated/corrupt header must not cause over-reads)
    size_t avail = size - (pos + 8);
    uint32_t blen = len < avail ? len : (uint32_t)avail;
    if (memcmp(data + pos, "fmt ", 4) == 0 && blen >= 16) {
      memcpy(&fmt, body, 2);
      memcpy(&channels, body + 2, 2);
      memcpy(&sr, body + 4, 4);
      memcpy(&bits, body + 14, 2);
      // WAVE_FORMAT_EXTENSIBLE: the real code is the SubFormat GUID's
      // first two bytes (1 = PCM, 3 = IEEE float)
      if (blen >= 26) memcpy(&sub_fmt, body + 24, 2);
    } else if (memcmp(data + pos, "data", 4) == 0) {
      raw = body;
      raw_len = blen;
    }
    pos += 8 + len + (len & 1);
  }
  if (!raw || channels == 0) return -1;
  if (fmt == 0xFFFE) fmt = sub_fmt ? sub_fmt : 1;  // EXTENSIBLE: SubFormat
  info->sample_rate = sr;
  info->channels = channels;
  info->bps = bits;
  size_t n;
  if (fmt == 3 && bits == 32) {
    n = raw_len / 4;
    pcm->resize(n);
    memcpy(pcm->data(), raw, n * 4);
  } else if (fmt == 1 && bits == 16) {
    n = raw_len / 2;
    pcm->resize(n);
    const int16_t* s = (const int16_t*)raw;
    for (size_t i = 0; i < n; ++i) (*pcm)[i] = (float)s[i] / 32768.0f;
  } else if (fmt == 1 && bits == 24) {
    n = raw_len / 3;
    pcm->resize(n);
    for (size_t i = 0; i < n; ++i) {
      int32_t v = (int32_t)raw[3 * i] | ((int32_t)raw[3 * i + 1] << 8) |
                  ((int32_t)raw[3 * i + 2] << 16);
      if (v >= (1 << 23)) v -= (1 << 24);
      (*pcm)[i] = (float)v / 8388608.0f;
    }
  } else if (fmt == 1 && bits == 32) {
    n = raw_len / 4;
    pcm->resize(n);
    const int32_t* s = (const int32_t*)raw;
    for (size_t i = 0; i < n; ++i)
      (*pcm)[i] = (float)s[i] / 2147483648.0f;
  } else {
    return -1;
  }
  return (int64_t)(n / channels);
}

int64_t decode_any(const char* path, std::vector<float>* pcm,
                   FlacInfo* info) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, 0, SEEK_END);
  long fsize = ftell(f);
  fseek(f, 0, SEEK_SET);
  if (fsize <= 4) { fclose(f); return -1; }
  std::vector<uint8_t> buf((size_t)fsize);
  size_t got = fread(buf.data(), 1, (size_t)fsize, f);
  fclose(f);
  if (got != (size_t)fsize) return -1;
  if (memcmp(buf.data(), "fLaC", 4) == 0)
    return decode_flac(buf.data(), buf.size(), pcm, info);
  return decode_wav(buf.data(), buf.size(), pcm, info);
}

// xorshift for reproducible random-start crops
inline uint64_t xorshift64(uint64_t* s) {
  uint64_t x = *s;
  x ^= x << 13; x ^= x >> 7; x ^= x << 17;
  return *s = x;
}

}  // namespace

// ------------------------------------------------------------------- C API

extern "C" {

// Decode one file. *out is malloc'd interleaved float32 (free with
// rtdsd_free). Returns samples per channel, or -1.
int64_t rtdsd_decode(const char* path, float** out, int* channels,
                     int* sample_rate) {
  std::vector<float> pcm;
  FlacInfo info;
  int64_t n = decode_any(path, &pcm, &info);
  if (n < 0) return -1;
  *out = (float*)malloc(pcm.size() * sizeof(float));
  if (!*out) return -1;
  memcpy(*out, pcm.data(), pcm.size() * sizeof(float));
  *channels = (int)info.channels;
  *sample_rate = (int)info.sample_rate;
  return n;
}

void rtdsd_free(float* p) { free(p); }

// Batched loader: decode `count` files on `num_threads` threads, take
// channel 0, linear-resample to expected_sr when the file rate differs
// (expected_sr > 0), repeat-tile + crop to `duration` samples (random-start
// when seed != 0, deterministic per (seed, index)), write into
// out[count][duration] (caller-allocated, C-contiguous). Returns number of
// failed files.
// `status` (optional, count entries) records per-file outcome: 0 ok,
// 1 decode failed (row zero-filled) — lets the caller skip/replace bad
// rows instead of aborting the whole batch.
static int load_batch_impl(const char** paths, int count, int64_t duration,
                           uint64_t seed, float* out, int num_threads,
                           int expected_sr, int* status) {
  std::atomic<int> next(0), failed(0);
  int nt = num_threads > 0 ? num_threads : 1;
  if (nt > count) nt = count;

  auto worker = [&]() {
    std::vector<float> pcm;
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= count) return;
      FlacInfo info;
      pcm.clear();
      int64_t n = decode_any(paths[i], &pcm, &info);
      float* dst = out + (size_t)i * duration;
      if (n <= 0) {
        memset(dst, 0, (size_t)duration * sizeof(float));
        if (status) status[i] = 1;
        failed.fetch_add(1);
        continue;
      }
      if (status) status[i] = 0;
      uint32_t ch = info.channels ? info.channels : 1;
      // mono channel 0
      std::vector<float> mono((size_t)n);
      for (int64_t t = 0; t < n; ++t) mono[(size_t)t] = pcm[(size_t)t * ch];
      // linear resample if the container rate differs from the pipeline rate
      if (expected_sr > 0 && info.sample_rate > 0 &&
          (int)info.sample_rate != expected_sr) {
        double ratio = (double)info.sample_rate / (double)expected_sr;
        int64_t n2 = (int64_t)((double)n / ratio);
        if (n2 < 1) n2 = 1;
        std::vector<float> res((size_t)n2);
        for (int64_t t = 0; t < n2; ++t) {
          double srcp = (double)t * ratio;
          int64_t lo = (int64_t)srcp;
          double frac = srcp - (double)lo;
          int64_t hi = lo + 1 < n ? lo + 1 : n - 1;
          res[(size_t)t] = (float)((1.0 - frac) * mono[(size_t)lo] +
                                   frac * mono[(size_t)hi]);
        }
        mono.swap(res);
        n = n2;
      }
      // repeat-tile to >= duration, then window
      int64_t start = 0;
      if (seed != 0 && n > duration) {
        uint64_t s = seed ^ (0x9E3779B97F4A7C15ull * (uint64_t)(i + 1));
        xorshift64(&s);
        start = (int64_t)(xorshift64(&s) % (uint64_t)(n - duration + 1));
      }
      for (int64_t t = 0; t < duration; ++t) {
        dst[t] = mono[(size_t)((start + t) % n)];
      }
    }
  };

  std::vector<std::thread> threads;
  for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
  return failed.load();
}

int rtdsd_load_batch_status(const char** paths, int count, int64_t duration,
                            uint64_t seed, float* out, int num_threads,
                            int expected_sr, int* status) {
  return load_batch_impl(paths, count, duration, seed, out, num_threads,
                         expected_sr, status);
}

}  // extern "C"
