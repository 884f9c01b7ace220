// Native client of the port's serving daemon (wire protocol v1), the
// port's own copy of the JAX package's rtdsd_tpu/native/serve_client.cpp.
//
// The daemon (rtdsd_tpu_torch/engine/netserve.py) takes live audio over a
// socket. Edge producers (telephony bridges, capture agents, SBCs) are
// rarely Python processes, so this file gives them a dependency-free C ABI
// speaking the same length-prefixed little-endian frame protocol:
//
//   client -> server:  0x01 OPEN  0x02 PUSH  0x03 CLOSE  0x04 PING
//   server -> client:  0x80 HELLO 0x81 OPENED 0x82 SCORE 0x83 CLOSED
//                      0x84 PONG  0xFF ERROR
//
// Conversions mirror rtdsd_tpu_torch/engine/serving.py exactly: float wave
// -> int16 is clip(rint(x*32768), -32768, 32767) with round-half-to-even
// (np.rint), and mulaw8 is the continuous mu-law
// y = sign(x)*log1p(255|x|)/log1p(255), quantized AFTER companding to
// clip(rint(y*127), -127, 127) int8.
//
// Built at first use by rtdsd_tpu_torch/native/client.py (g++, into
// build/rtdsd_tpu_torch/, named by a hash of this source and the flags):
//   library: g++ -O2 -std=c++17 -shared -fPIC serve_client.cpp
//   feeder binary (reads a PCM16 WAV, streams it, prints scores):
//            g++ -O2 -std=c++17 -DRTDSD_FEED_MAIN serve_client.cpp
//
// Python binds the library via ctypes in rtdsd_tpu_torch/native/client.py;
// parity with the Python ServeClient is pinned in
// tests/test_torch_native_client.py.

#include <arpa/inet.h>
#include <netdb.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <sys/un.h>
#include <unistd.h>

#include <algorithm>
#include <cerrno>
#include <cfenv>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <string>
#include <vector>

namespace {

constexpr uint8_t F_OPEN = 0x01, F_PUSH = 0x02, F_CLOSE = 0x03,
                  F_PING = 0x04;
constexpr uint8_t F_HELLO = 0x80, F_OPENED = 0x81, F_SCORE = 0x82,
                  F_CLOSED = 0x83, F_PONG = 0x84, F_ERROR = 0xFF;
constexpr uint32_t CONN_HANDLE = 0xFFFFFFFFu;
constexpr size_t MAX_FRAME = 1u << 26;

// little-endian loads/stores (portable — no unaligned-pointer casts)
inline uint32_t ld_u32(const uint8_t* p) {
  return uint32_t(p[0]) | uint32_t(p[1]) << 8 | uint32_t(p[2]) << 16 |
         uint32_t(p[3]) << 24;
}
inline uint64_t ld_u64(const uint8_t* p) {
  return uint64_t(ld_u32(p)) | uint64_t(ld_u32(p + 4)) << 32;
}
inline float ld_f32(const uint8_t* p) {
  uint32_t u = ld_u32(p);
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline void st_u32(uint8_t* p, uint32_t v) {
  p[0] = uint8_t(v);
  p[1] = uint8_t(v >> 8);
  p[2] = uint8_t(v >> 16);
  p[3] = uint8_t(v >> 24);
}

struct Frame {
  uint8_t type = 0;
  std::vector<uint8_t> payload;
};

}  // namespace

extern "C" {

typedef struct rtdsd_event {
  int32_t type;  // 1 SCORE, 2 CLOSED, 3 ERROR (message in last_error)
  uint32_t handle;
  uint64_t start_sample;
  float score;
  uint8_t flags;  // bit0 escalated (cascade flagship), bit1 energy-gated
} rtdsd_event;

#define RTDSD_FLAG_ESCALATED 1
#define RTDSD_FLAG_GATED 2

struct rtdsd_client {
  int fd = -1;
  // HELLO fields
  uint32_t proto = 0, sample_rate = 0, duration = 0, hop = 0,
           max_streams = 0;
  uint8_t transport = 0;  // 0 float32, 1 int16, 2 mulaw8
  std::string last_error;
  std::deque<Frame> pending;  // SCORE/CLOSED read while awaiting a reply
  std::vector<uint8_t> scratch;
};

}  // extern "C"

namespace {

bool send_all(rtdsd_client* c, const uint8_t* p, size_t n) {
  while (n) {
    ssize_t w = ::send(c->fd, p, n, MSG_NOSIGNAL);
    if (w < 0) {
      if (errno == EINTR) continue;
      c->last_error = std::string("send: ") + std::strerror(errno);
      return false;
    }
    p += w;
    n -= size_t(w);
  }
  return true;
}

bool send_frame(rtdsd_client* c, uint8_t type, const uint8_t* payload,
                uint32_t len) {
  uint8_t hdr[5];
  hdr[0] = type;
  st_u32(hdr + 1, len);
  if (!send_all(c, hdr, 5)) return false;
  return len == 0 || send_all(c, payload, len);
}

// -1 connection error, 0 timeout (only when timeout_ms >= 0), 1 ok
int recv_exact(rtdsd_client* c, uint8_t* p, size_t n, int timeout_ms) {
  timeval tv{};
  tv.tv_sec = timeout_ms >= 0 ? timeout_ms / 1000 : 0;
  tv.tv_usec = timeout_ms >= 0 ? (timeout_ms % 1000) * 1000 : 0;
  // a zero timeval DISABLES SO_RCVTIMEO (blocks forever) — timeout_ms=0
  // means "poll", so bump it to the smallest real timeout
  if (timeout_ms == 0) tv.tv_usec = 1;
  ::setsockopt(c->fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
  size_t got = 0;
  while (got < n) {
    ssize_t r = ::recv(c->fd, p + got, n - got, 0);
    if (r == 0) {
      c->last_error = "daemon closed the connection";
      return -1;
    }
    if (r < 0) {
      if (errno == EINTR) continue;
      if ((errno == EAGAIN || errno == EWOULDBLOCK) && timeout_ms >= 0) {
        // timeout only counts before the first byte of this read; a
        // torn frame mid-read is a protocol error
        if (got == 0) return 0;
        c->last_error = "timed out mid-frame";
        return -1;
      }
      c->last_error = std::string("recv: ") + std::strerror(errno);
      return -1;
    }
    got += size_t(r);
  }
  return 1;
}

int read_frame(rtdsd_client* c, Frame* f, int timeout_ms) {
  uint8_t hdr[5];
  int rc = recv_exact(c, hdr, 5, timeout_ms);
  if (rc != 1) return rc;
  f->type = hdr[0];
  uint32_t len = ld_u32(hdr + 1);
  if (len > MAX_FRAME) {
    c->last_error = "oversized frame from daemon";
    return -1;
  }
  f->payload.resize(len);
  if (len) {
    rc = recv_exact(c, f->payload.data(), len, -1);
    if (rc != 1) return rc;
  }
  return 1;
}

void set_error_from_frame(rtdsd_client* c, const Frame& f) {
  c->last_error.assign(
      reinterpret_cast<const char*>(f.payload.data()) + 4,
      f.payload.size() > 4 ? f.payload.size() - 4 : 0);
  if (c->last_error.empty()) c->last_error = "daemon error";
}

// wait for a reply frame of `want`; queue interleaved SCORE/CLOSED
bool expect(rtdsd_client* c, uint8_t want, Frame* out) {
  for (;;) {
    Frame f;
    if (read_frame(c, &f, -1) != 1) return false;
    if (f.type == F_SCORE || f.type == F_CLOSED) {
      c->pending.push_back(std::move(f));
      continue;
    }
    if (f.type == F_ERROR) {
      set_error_from_frame(c, f);
      return false;
    }
    if (f.type != want) {
      char buf[64];
      std::snprintf(buf, sizeof buf, "expected 0x%02x, got 0x%02x", want,
                    f.type);
      c->last_error = buf;
      return false;
    }
    *out = std::move(f);
    return true;
  }
}

rtdsd_client* finish_connect(int fd, char* err, int errlen) {
  auto* c = new rtdsd_client;
  c->fd = fd;
  Frame hello;
  if (read_frame(c, &hello, -1) != 1 || hello.type != F_HELLO ||
      hello.payload.size() < 21) {
    if (err && errlen > 0)
      std::snprintf(err, size_t(errlen), "bad HELLO: %s",
                    c->last_error.c_str());
    delete c;
    ::close(fd);
    return nullptr;
  }
  const uint8_t* p = hello.payload.data();
  c->proto = ld_u32(p);
  if (c->proto != 1) {
    if (err && errlen > 0)
      std::snprintf(err, size_t(errlen),
                    "daemon speaks protocol v%u, this client v1", c->proto);
    delete c;
    ::close(fd);
    return nullptr;
  }
  c->sample_rate = ld_u32(p + 4);
  c->duration = ld_u32(p + 8);
  c->hop = ld_u32(p + 12);
  c->transport = p[16];
  c->max_streams = ld_u32(p + 17);
  return c;
}

// float wave -> transport bytes, matching engine/serving.py push()
void encode_wave(uint8_t transport, const float* wave, uint32_t n,
                 std::vector<uint8_t>* out) {
  std::fesetround(FE_TONEAREST);  // half-to-even, like np.rint
  if (transport == 1) {  // int16 PCM
    out->resize(size_t(n) * 2);
    auto* q = reinterpret_cast<int16_t*>(out->data());
    for (uint32_t i = 0; i < n; ++i) {
      float v = std::nearbyintf(wave[i] * 32768.0f);
      if (v > 32767.0f) v = 32767.0f;
      if (v < -32768.0f) v = -32768.0f;
      q[i] = int16_t(v);
    }
  } else if (transport == 2) {  // continuous mu-law int8
    const float inv_log1p_mu = 1.0f / std::log1p(255.0f);
    out->resize(n);
    auto* q = reinterpret_cast<int8_t*>(out->data());
    for (uint32_t i = 0; i < n; ++i) {
      float x = wave[i];
      if (x > 1.0f) x = 1.0f;
      if (x < -1.0f) x = -1.0f;
      float y = std::copysign(std::log1p(255.0f * std::fabs(x)) *
                                  inv_log1p_mu,
                              x);
      float v = std::nearbyintf(y * 127.0f);
      if (v > 127.0f) v = 127.0f;
      if (v < -127.0f) v = -127.0f;
      q[i] = int8_t(v);
    }
  } else {  // float32 passthrough
    out->resize(size_t(n) * 4);
    std::memcpy(out->data(), wave, size_t(n) * 4);
  }
}

}  // namespace

extern "C" {

rtdsd_client* rtdsd_connect_unix(const char* path, char* err, int errlen) {
  int fd = ::socket(AF_UNIX, SOCK_STREAM, 0);
  if (fd < 0) {
    if (err) std::snprintf(err, size_t(errlen), "socket: %s",
                           std::strerror(errno));
    return nullptr;
  }
  sockaddr_un addr{};
  addr.sun_family = AF_UNIX;
  std::snprintf(addr.sun_path, sizeof addr.sun_path, "%s", path);
  if (::connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof addr) < 0) {
    if (err) std::snprintf(err, size_t(errlen), "connect %s: %s", path,
                           std::strerror(errno));
    ::close(fd);
    return nullptr;
  }
  return finish_connect(fd, err, errlen);
}

rtdsd_client* rtdsd_connect_tcp(const char* host, int port, char* err,
                                int errlen) {
  addrinfo hints{}, *res = nullptr;
  hints.ai_family = AF_UNSPEC;
  hints.ai_socktype = SOCK_STREAM;
  char portbuf[16];
  std::snprintf(portbuf, sizeof portbuf, "%d", port);
  int rc = ::getaddrinfo(host, portbuf, &hints, &res);
  if (rc != 0) {
    if (err) std::snprintf(err, size_t(errlen), "resolve %s: %s", host,
                           gai_strerror(rc));
    return nullptr;
  }
  int fd = -1;
  for (addrinfo* ai = res; ai; ai = ai->ai_next) {
    fd = ::socket(ai->ai_family, ai->ai_socktype, ai->ai_protocol);
    if (fd < 0) continue;
    if (::connect(fd, ai->ai_addr, ai->ai_addrlen) == 0) break;
    ::close(fd);
    fd = -1;
  }
  ::freeaddrinfo(res);
  if (fd < 0) {
    if (err) std::snprintf(err, size_t(errlen), "connect %s:%d: %s", host,
                           port, std::strerror(errno));
    return nullptr;
  }
  int one = 1;
  ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);
  return finish_connect(fd, err, errlen);
}

void rtdsd_disconnect(rtdsd_client* c) {
  if (!c) return;
  if (c->fd >= 0) ::close(c->fd);
  delete c;
}

uint32_t rtdsd_proto(const rtdsd_client* c) { return c->proto; }
uint32_t rtdsd_sample_rate(const rtdsd_client* c) { return c->sample_rate; }
uint32_t rtdsd_window_samples(const rtdsd_client* c) { return c->duration; }
uint32_t rtdsd_hop_samples(const rtdsd_client* c) { return c->hop; }
int rtdsd_transport(const rtdsd_client* c) { return c->transport; }
uint32_t rtdsd_max_streams(const rtdsd_client* c) { return c->max_streams; }
const char* rtdsd_last_error(const rtdsd_client* c) {
  return c->last_error.c_str();
}

// >= 0 handle on success, -1 on error (see rtdsd_last_error)
int64_t rtdsd_open(rtdsd_client* c, const char* name) {
  const auto* p = reinterpret_cast<const uint8_t*>(name ? name : "");
  if (!send_frame(c, F_OPEN, p, uint32_t(std::strlen(name ? name : ""))))
    return -1;
  Frame f;
  if (!expect(c, F_OPENED, &f)) return -1;
  if (f.payload.size() < 4) {
    c->last_error = "short OPENED";
    return -1;
  }
  return int64_t(ld_u32(f.payload.data()));
}

// raw transport bytes (what a capture card DMAs) — zero conversion
int rtdsd_push_bytes(rtdsd_client* c, uint32_t handle, const void* data,
                     uint32_t nbytes) {
  std::vector<uint8_t>& buf = c->scratch;
  buf.resize(size_t(nbytes) + 4);
  st_u32(buf.data(), handle);
  std::memcpy(buf.data() + 4, data, nbytes);
  return send_frame(c, F_PUSH, buf.data(), uint32_t(buf.size())) ? 0 : -1;
}

// float wave in [-1, 1]; converted to the daemon's transport client-side
int rtdsd_push(rtdsd_client* c, uint32_t handle, const float* wave,
               uint32_t n) {
  std::vector<uint8_t> enc;
  encode_wave(c->transport, wave, n, &enc);
  return rtdsd_push_bytes(c, handle, enc.data(), uint32_t(enc.size()));
}

int rtdsd_close_stream(rtdsd_client* c, uint32_t handle, int flush) {
  uint8_t payload[5];
  st_u32(payload, handle);
  payload[4] = flush ? 1 : 0;
  return send_frame(c, F_CLOSE, payload, 5) ? 0 : -1;
}

int rtdsd_ping(rtdsd_client* c) {
  if (!send_frame(c, F_PING, nullptr, 0)) return -1;
  Frame f;
  return expect(c, F_PONG, &f) ? 0 : -1;
}

// 1 = event filled, 0 = timeout, -1 = connection error.
// ERROR frames become type-3 events (handle filled, message via
// rtdsd_last_error) so one bad stream doesn't tear down the consumer.
int rtdsd_next_event(rtdsd_client* c, rtdsd_event* ev, int timeout_ms) {
  Frame f;
  if (!c->pending.empty()) {
    f = std::move(c->pending.front());
    c->pending.pop_front();
  } else {
    int rc = read_frame(c, &f, timeout_ms);
    if (rc != 1) return rc;
  }
  std::memset(ev, 0, sizeof *ev);
  if (f.type == F_SCORE && f.payload.size() >= 17) {
    const uint8_t* p = f.payload.data();
    ev->type = 1;
    ev->handle = ld_u32(p);
    ev->start_sample = ld_u64(p + 4);
    ev->score = ld_f32(p + 12);
    ev->flags = p[16];
    return 1;
  }
  if (f.type == F_CLOSED && f.payload.size() >= 4) {
    ev->type = 2;
    ev->handle = ld_u32(f.payload.data());
    return 1;
  }
  if (f.type == F_ERROR) {
    set_error_from_frame(c, f);
    ev->type = 3;
    ev->handle = f.payload.size() >= 4 ? ld_u32(f.payload.data())
                                       : CONN_HANDLE;
    return 1;
  }
  c->last_error = "unexpected frame in event stream";
  return -1;
}

}  // extern "C"

#ifdef RTDSD_FEED_MAIN
// Standalone feeder: stream a PCM16 mono WAV into the daemon and print
// per-window scores. Usage:
//   rtdsd_feed unix:/path.sock file.wav [--realtime]
//   rtdsd_feed host:port file.wav [--realtime]
#include <chrono>
#include <thread>

namespace {

bool read_wav_pcm16(const char* path, std::vector<float>* wave,
                    uint32_t* sr) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return false;
  uint8_t hdr[12];
  if (std::fread(hdr, 1, 12, fp) != 12 || std::memcmp(hdr, "RIFF", 4) ||
      std::memcmp(hdr + 8, "WAVE", 4)) {
    std::fclose(fp);
    return false;
  }
  uint16_t channels = 0, bits = 0;
  for (;;) {
    uint8_t ch[8];
    if (std::fread(ch, 1, 8, fp) != 8) break;
    uint32_t len = ld_u32(ch + 4);
    if (!std::memcmp(ch, "fmt ", 4)) {
      std::vector<uint8_t> fmt(len);
      if (std::fread(fmt.data(), 1, len, fp) != len) break;
      channels = uint16_t(fmt[2] | fmt[3] << 8);
      *sr = ld_u32(fmt.data() + 4);
      bits = uint16_t(fmt[14] | fmt[15] << 8);
    } else if (!std::memcmp(ch, "data", 4)) {
      if (channels != 1 || bits != 16) {
        std::fprintf(stderr, "feeder handles PCM16 mono only\n");
        break;
      }
      std::vector<int16_t> pcm(len / 2);
      if (std::fread(pcm.data(), 1, len, fp) != len) break;
      wave->resize(pcm.size());
      for (size_t i = 0; i < pcm.size(); ++i)
        (*wave)[i] = float(pcm[i]) / 32768.0f;
      std::fclose(fp);
      return true;
    } else {
      std::fseek(fp, long(len + (len & 1)), SEEK_CUR);
    }
  }
  std::fclose(fp);
  return false;
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 3) {
    std::fprintf(stderr,
                 "usage: %s unix:/sock|host:port file.wav [--realtime]\n",
                 argv[0]);
    return 2;
  }
  bool realtime = argc > 3 && !std::strcmp(argv[3], "--realtime");
  char err[256];
  rtdsd_client* c;
  std::string addr = argv[1];
  if (addr.rfind("unix:", 0) == 0) {
    c = rtdsd_connect_unix(addr.c_str() + 5, err, sizeof err);
  } else {
    auto colon = addr.rfind(':');
    if (colon == std::string::npos) {
      std::fprintf(stderr, "bad address %s\n", addr.c_str());
      return 2;
    }
    c = rtdsd_connect_tcp(addr.substr(0, colon).c_str(),
                          std::atoi(addr.c_str() + colon + 1), err,
                          sizeof err);
  }
  if (!c) {
    std::fprintf(stderr, "%s\n", err);
    return 1;
  }
  std::vector<float> wave;
  uint32_t sr = 0;
  if (!read_wav_pcm16(argv[2], &wave, &sr)) {
    std::fprintf(stderr, "cannot read %s\n", argv[2]);
    return 1;
  }
  if (sr != rtdsd_sample_rate(c))
    std::fprintf(stderr, "warning: wav %u Hz, daemon expects %u Hz\n", sr,
                 rtdsd_sample_rate(c));
  int64_t h = rtdsd_open(c, argv[2]);
  if (h < 0) {
    std::fprintf(stderr, "open: %s\n", rtdsd_last_error(c));
    return 1;
  }
  const uint32_t hop = rtdsd_hop_samples(c);
  double sum = 0.0;
  size_t nscores = 0;
  for (size_t i = 0; i < wave.size(); i += hop) {
    uint32_t n = uint32_t(std::min<size_t>(hop, wave.size() - i));
    if (rtdsd_push(c, uint32_t(h), wave.data() + i, n) != 0) {
      std::fprintf(stderr, "push: %s\n", rtdsd_last_error(c));
      return 1;
    }
    // drain any scores already on the wire (non-blocking)
    rtdsd_event ev;
    int rc;
    while ((rc = rtdsd_next_event(c, &ev, 0)) == 1) {
      if (ev.type == 1) {
        std::printf("window @%llu score %.6f%s%s\n",
                    (unsigned long long)ev.start_sample, ev.score,
                    (ev.flags & RTDSD_FLAG_ESCALATED) ? " (escalated)" : "",
                    (ev.flags & RTDSD_FLAG_GATED) ? " (gated)" : "");
        sum += ev.score;
        ++nscores;
      }
    }
    if (rc < 0) {
      std::fprintf(stderr, "event: %s\n", rtdsd_last_error(c));
      return 1;
    }
    if (realtime)
      std::this_thread::sleep_for(
          std::chrono::microseconds(uint64_t(n) * 1000000u /
                                    rtdsd_sample_rate(c)));
  }
  rtdsd_close_stream(c, uint32_t(h), 1);
  for (;;) {
    rtdsd_event ev;
    int rc = rtdsd_next_event(c, &ev, 60000);
    if (rc <= 0) {
      std::fprintf(stderr, "drain: %s\n",
                   rc ? rtdsd_last_error(c) : "timeout");
      return 1;
    }
    if (ev.type == 1) {
      std::printf("window @%llu score %.6f%s%s\n",
                  (unsigned long long)ev.start_sample, ev.score,
                  (ev.flags & RTDSD_FLAG_ESCALATED) ? " (escalated)" : "",
                  (ev.flags & RTDSD_FLAG_GATED) ? " (gated)" : "");
      sum += ev.score;
      ++nscores;
    } else if (ev.type == 2 && ev.handle == uint32_t(h)) {
      break;
    } else if (ev.type == 3) {
      std::fprintf(stderr, "daemon error: %s\n", rtdsd_last_error(c));
      return 1;
    }
  }
  if (nscores)
    std::printf("%s %.6f\n", argv[2], sum / double(nscores));
  rtdsd_disconnect(c);
  return 0;
}
#endif  // RTDSD_FEED_MAIN
