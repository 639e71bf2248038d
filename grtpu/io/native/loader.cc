// Native host data-loader: UDP ingest/egress pumps, write-behind file
// sink, and fused format converters reading straight out of the ring.
//
// Analog of the reference's C++ I/O data plane:
//   * gr_udp_source / gr_udp_sink (gnuradio-core/src/lib/io/gr_udp_source.h:
//     39-99, gr_udp_sink.h:39-86) — raw-datagram sample streaming, default
//     1472-byte payload, zero-length datagram = EOF;
//   * gr_file_sink write path (io/gr_file_sink_base.cc) — here write-behind
//     on a native thread so the Python chunk loop never blocks on disk;
//   * the gri_* type-conversion loops (gr_ishort_to_complex,
//     gr_short_to_float, gr_uchar_to_float, gr_float_to_short …) — here
//     fused with the ring read so bytes convert on the way out of the
//     double-mapped region (one pass, g++ autovectorizes the loops).
//
// Built into libgrtpu_ringbuf.so together with ringbuf.cc (see
// grtpu/io/native/__init__.py); RingBuf layout must match ringbuf.cc.

#include <atomic>
#include <arpa/inet.h>
#include <cstdint>
#include <cstring>
#include <netdb.h>
#include <netinet/in.h>
#include <pthread.h>
#include <sys/socket.h>
#include <sys/types.h>
#include <unistd.h>
#include <cstdio>

namespace {

// Resolve a dotted quad or hostname to an IPv4 address (0 on failure).
// inet_addr alone returns INADDR_NONE for names like "localhost".
bool resolve_ipv4(const char* host, in_addr_t* out) {
  in_addr_t a = inet_addr(host);
  if (a != INADDR_NONE) { *out = a; return true; }
  struct addrinfo hints = {}, *res = nullptr;
  hints.ai_family = AF_INET;
  hints.ai_socktype = SOCK_DGRAM;
  if (getaddrinfo(host, nullptr, &hints, &res) != 0 || !res) return false;
  *out = ((sockaddr_in*)res->ai_addr)->sin_addr.s_addr;
  freeaddrinfo(res);
  return true;
}

}  // namespace

struct RingBuf;  // opaque; all access through ringbuf.cc's extern "C" API

extern "C" {
int grtpu_ring_eof(RingBuf* rb);
size_t grtpu_ring_readable(RingBuf* rb);
size_t grtpu_ring_writable(RingBuf* rb);
size_t grtpu_ring_write(RingBuf* rb, const uint8_t* src, size_t n);
void grtpu_ring_set_eof(RingBuf* rb);
const uint8_t* grtpu_ring_peek(RingBuf* rb);
void grtpu_ring_advance(RingBuf* rb, size_t n);

// ------------------------------------------------------------------- UDP in
// Background receiver: datagrams -> ring; zero-length datagram = EOF
// (gr_udp_source.h:50 convention).
struct UdpPump {
  RingBuf* rb;
  int sock;
  size_t payload;
  std::atomic<int> stop{0};
  // service-level accounting (stream_service_bench records these):
  // datagrams/bytes landed in the ring vs kernel-level socket drops
  // (SO_RXQ_OVFL cmsg counter when available).
  std::atomic<size_t> rx_dgrams{0};
  std::atomic<size_t> rx_bytes{0};
  std::atomic<size_t> drops{0};
  pthread_t thread;
};

static void* udp_pump_main(void* arg) {
  UdpPump* up = (UdpPump*)arg;
  uint8_t* tmp = new uint8_t[up->payload];
  char cbuf[64];
  while (!up->stop.load()) {
    struct iovec iov = {tmp, up->payload};
    struct msghdr mh = {};
    mh.msg_iov = &iov;
    mh.msg_iovlen = 1;
    mh.msg_control = cbuf;
    mh.msg_controllen = sizeof(cbuf);
    ssize_t got = recvmsg(up->sock, &mh, 0);
    if (got < 0) continue;  // timeout -> poll stop flag
#ifdef SO_RXQ_OVFL
    for (cmsghdr* c = CMSG_FIRSTHDR(&mh); c; c = CMSG_NXTHDR(&mh, c)) {
      if (c->cmsg_level == SOL_SOCKET && c->cmsg_type == SO_RXQ_OVFL) {
        uint32_t d;
        memcpy(&d, CMSG_DATA(c), sizeof(d));
        up->drops.store(d);  // kernel counter is cumulative
      }
    }
#endif
    if (got == 0) { grtpu_ring_set_eof(up->rb); break; }
    up->rx_dgrams.fetch_add(1);
    up->rx_bytes.fetch_add((size_t)got);
    size_t off = 0;
    while (off < (size_t)got && !up->stop.load()) {
      off += grtpu_ring_write(up->rb, tmp + off, got - off);
      if (off < (size_t)got) usleep(100);
    }
  }
  delete[] tmp;
  return nullptr;
}

size_t grtpu_udp_pump_rx_dgrams(UdpPump* up) { return up->rx_dgrams.load(); }
size_t grtpu_udp_pump_rx_bytes(UdpPump* up) { return up->rx_bytes.load(); }
size_t grtpu_udp_pump_drops(UdpPump* up) { return up->drops.load(); }

UdpPump* grtpu_udp_pump(RingBuf* rb, const char* host, int port,
                        size_t payload) {
  int sock = socket(AF_INET, SOCK_DGRAM, 0);
  if (sock < 0) return nullptr;
  int one = 1;
  setsockopt(sock, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  struct timeval tv = {0, 200000};  // 200ms poll so stop() is responsive
  setsockopt(sock, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
  int big = 4 << 20;
  setsockopt(sock, SOL_SOCKET, SO_RCVBUF, &big, sizeof(big));
#ifdef SO_RXQ_OVFL
  setsockopt(sock, SOL_SOCKET, SO_RXQ_OVFL, &one, sizeof(one));
#endif
  sockaddr_in addr = {};
  addr.sin_family = AF_INET;
  addr.sin_port = htons((uint16_t)port);
  addr.sin_addr.s_addr = INADDR_ANY;
  if (host && host[0] && !resolve_ipv4(host, &addr.sin_addr.s_addr)) {
    close(sock);
    return nullptr;
  }
  if (bind(sock, (sockaddr*)&addr, sizeof(addr)) != 0) {
    close(sock);
    return nullptr;
  }
  UdpPump* up = new UdpPump();
  up->rb = rb;
  up->sock = sock;
  up->payload = payload ? payload : 1472;
  if (pthread_create(&up->thread, nullptr, udp_pump_main, up) != 0) {
    close(sock);
    delete up;
    return nullptr;
  }
  return up;
}

void grtpu_udp_pump_stop(UdpPump* up) {
  if (!up) return;
  up->stop.store(1);
  pthread_join(up->thread, nullptr);
  close(up->sock);
  delete up;
}

// ------------------------------------------------------------------ UDP out
struct UdpSender {
  int sock;
  size_t payload;
};

UdpSender* grtpu_udp_sender(const char* host, int port, size_t payload) {
  int sock = socket(AF_INET, SOCK_DGRAM, 0);
  if (sock < 0) return nullptr;
  sockaddr_in addr = {};
  addr.sin_family = AF_INET;
  addr.sin_port = htons((uint16_t)port);
  if (!resolve_ipv4(host, &addr.sin_addr.s_addr) ||
      connect(sock, (sockaddr*)&addr, sizeof(addr)) != 0) {
    close(sock);
    return nullptr;
  }
  UdpSender* s = new UdpSender();
  s->sock = sock;
  s->payload = payload ? payload : 1472;
  return s;
}

// Blocking send, split into payload-size datagrams (gr_udp_sink semantics).
size_t grtpu_udp_send(UdpSender* s, const uint8_t* src, size_t n) {
  size_t off = 0;
  while (off < n) {
    size_t chunk = n - off < s->payload ? n - off : s->payload;
    ssize_t sent = send(s->sock, src + off, chunk, 0);
    if (sent <= 0) break;
    off += (size_t)sent;
  }
  return off;
}

void grtpu_udp_send_eof(UdpSender* s) { send(s->sock, "", 0, 0); }

void grtpu_udp_sender_close(UdpSender* s) {
  if (!s) return;
  close(s->sock);
  delete s;
}

// ---------------------------------------------------------- file write-behind
// Drains a ring into a file on a native thread (gr_file_sink that never
// blocks the chunk loop).  Producer writes into the ring; on close the
// thread flushes the remainder after EOF is set.
struct WritePump {
  RingBuf* rb;
  FILE* f;
  std::atomic<int> stop{0};
  pthread_t thread;
};

static void* write_pump_main(void* arg) {
  WritePump* wp = (WritePump*)arg;
  for (;;) {
    size_t avail = grtpu_ring_readable(wp->rb);
    if (avail == 0) {
      if (grtpu_ring_eof(wp->rb) || wp->stop.load()) break;
      usleep(200);
      continue;
    }
    const uint8_t* p = grtpu_ring_peek(wp->rb);
    size_t put = fwrite(p, 1, avail, wp->f);
    grtpu_ring_advance(wp->rb, put);
    if (put < avail) break;  // disk error
  }
  fflush(wp->f);
  return nullptr;
}

WritePump* grtpu_write_pump(RingBuf* rb, const char* path, int append) {
  FILE* f = fopen(path, append ? "ab" : "wb");
  if (!f) return nullptr;
  WritePump* wp = new WritePump();
  wp->rb = rb;
  wp->f = f;
  if (pthread_create(&wp->thread, nullptr, write_pump_main, wp) != 0) {
    fclose(f);
    delete wp;
    return nullptr;
  }
  return wp;
}

void grtpu_write_pump_stop(WritePump* wp) {
  if (!wp) return;
  grtpu_ring_set_eof(wp->rb);
  pthread_join(wp->thread, nullptr);
  fclose(wp->f);
  delete wp;
}

// --------------------------------------------------------------- converters
// Fused ring-read + type conversion: convert n_items straight out of the
// double-mapped region (linear thanks to the double map — no wraparound
// branch, one pass).  Return items converted (0 if not enough buffered).

size_t grtpu_ring_read_i16_to_f32(RingBuf* rb, float* dst, size_t n_items,
                                  float scale) {
  if (grtpu_ring_readable(rb) < n_items * 2) return 0;
  const int16_t* src = (const int16_t*)grtpu_ring_peek(rb);
  for (size_t i = 0; i < n_items; ++i) dst[i] = (float)src[i] * scale;
  grtpu_ring_advance(rb, n_items * 2);
  return n_items;
}

size_t grtpu_ring_read_u8_to_f32(RingBuf* rb, float* dst, size_t n_items,
                                 float scale, float offset) {
  if (grtpu_ring_readable(rb) < n_items) return 0;
  const uint8_t* src = grtpu_ring_peek(rb);
  for (size_t i = 0; i < n_items; ++i)
    dst[i] = ((float)src[i] + offset) * scale;
  grtpu_ring_advance(rb, n_items);
  return n_items;
}

// Interleaved i16 I/Q (the UHD "sc16" wire format / usrp capture format,
// gr_interleaved_short_to_complex) -> planar float32 re/im.
size_t grtpu_ring_read_sc16_to_f32_planar(RingBuf* rb, float* re, float* im,
                                          size_t n_cplx, float scale) {
  if (grtpu_ring_readable(rb) < n_cplx * 4) return 0;
  const int16_t* src = (const int16_t*)grtpu_ring_peek(rb);
  for (size_t i = 0; i < n_cplx; ++i) {
    re[i] = (float)src[2 * i] * scale;
    im[i] = (float)src[2 * i + 1] * scale;
  }
  grtpu_ring_advance(rb, n_cplx * 4);
  return n_cplx;
}

// Standalone buffers (sink-side): f32 -> i16 with round+clip
// (gr_float_to_short semantics).
void grtpu_f32_to_i16(const float* src, int16_t* dst, size_t n, float scale) {
  for (size_t i = 0; i < n; ++i) {
    float v = src[i] * scale;
    v = v > 32767.f ? 32767.f : (v < -32768.f ? -32768.f : v);
    dst[i] = (int16_t)(v >= 0 ? v + 0.5f : v - 0.5f);
  }
}

}  // extern "C"
