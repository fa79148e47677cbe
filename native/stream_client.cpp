// Native consumer of the tpu-ocean/1 frame stream (tpu_ocean/serve.py).
//
// A production deployment pairs the GPU solver host with render/physics
// clients that are NOT Python — this is that client, dependency-free C++:
// connect, parse the one-line JSON header (only the four fixed keys the
// protocol guarantees), then read raw little-endian f32 planes and report
// per-frame statistics. Exit code 0 iff the requested number of frames
// arrived intact and every plane was finite.
//
//   ./tpu_ocean_stream_client <host> <port> <frames> [lod] [dtype]
//
// [dtype] = "float16" requests the half-width wire (serve.py r5): planes
// arrive as little-endian f16 and are widened host-side — half the socket
// volume for ~3 decimal digits, plenty for display consumers.
//
// Wire format (serve.py): the client first sends ONE JSON request line —
// "{}" for the full grid, {"lod": d} for spatially decimated planes (the
// serving analogue of the reference's distance tessellation falloff,
// MistralWaterCommon.cginc:215-296); sending it immediately ends the
// server's legacy-client negotiation window. Then: header line
//   {"proto": "tpu-ocean/1", "resolution": N/d, "length": L, "lod": d,
//    "full_resolution": N, "fields": [...], "dtype": "float32"}
// then per frame: one JSON meta line ({"step": k, "t": s}) followed by the
// planes of each declared field in order (normal is M*M*3, others M*M,
// M = the header's served resolution).

#include <arpa/inet.h>
#include <netdb.h>
#include <sys/socket.h>
#include <unistd.h>

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

// Minimal extraction from the flat, known-shape header JSON — not a JSON
// parser; the protocol pins the key names and value forms.
bool find_number(const std::string& s, const std::string& key, double* out) {
  auto p = s.find("\"" + key + "\"");
  if (p == std::string::npos) return false;
  p = s.find(':', p);
  if (p == std::string::npos) return false;
  *out = std::strtod(s.c_str() + p + 1, nullptr);
  return true;
}

std::vector<std::string> find_string_list(const std::string& s,
                                          const std::string& key) {
  std::vector<std::string> out;
  auto p = s.find("\"" + key + "\"");
  if (p == std::string::npos) return out;
  auto lb = s.find('[', p), rb = s.find(']', p);
  if (lb == std::string::npos || rb == std::string::npos) return out;
  auto body = s.substr(lb + 1, rb - lb - 1);
  size_t i = 0;
  while ((i = body.find('"', i)) != std::string::npos) {
    auto j = body.find('"', i + 1);
    if (j == std::string::npos) break;
    out.push_back(body.substr(i + 1, j - i - 1));
    i = j + 1;
  }
  return out;
}

bool read_line(int fd, std::string* line) {
  line->clear();
  char c;
  while (true) {
    ssize_t r = ::read(fd, &c, 1);
    if (r <= 0) return false;
    if (c == '\n') return true;
    line->push_back(c);
    if (line->size() > 1 << 20) return false;  // runaway guard
  }
}

std::string find_string(const std::string& s, const std::string& key) {
  auto p = s.find("\"" + key + "\"");
  if (p == std::string::npos) return "";
  p = s.find(':', p);
  if (p == std::string::npos) return "";
  auto q1 = s.find('"', p + 1);
  if (q1 == std::string::npos) return "";
  auto q2 = s.find('"', q1 + 1);
  if (q2 == std::string::npos) return "";
  return s.substr(q1 + 1, q2 - q1 - 1);
}

// IEEE binary16 -> binary32 (the f16 wire of serve.py r5)
float half_to_float(uint16_t h) {
  const uint32_t sign = static_cast<uint32_t>(h & 0x8000u) << 16;
  uint32_t exp = (h >> 10) & 0x1Fu;
  uint32_t man = h & 0x3FFu;
  uint32_t f;
  if (exp == 0) {
    if (man == 0) {
      f = sign;                                    // +-0
    } else {                                       // subnormal
      exp = 127 - 15 + 1;
      while (!(man & 0x400u)) {
        man <<= 1;
        --exp;
      }
      man &= 0x3FFu;
      f = sign | (exp << 23) | (man << 13);
    }
  } else if (exp == 31) {
    f = sign | 0x7F800000u | (man << 13);          // inf / nan
  } else {
    f = sign | ((exp - 15 + 127) << 23) | (man << 13);
  }
  float out;
  std::memcpy(&out, &f, sizeof out);
  return out;
}

bool read_exact(int fd, void* buf, size_t count) {
  auto* p = static_cast<char*>(buf);
  while (count > 0) {
    ssize_t r = ::read(fd, p, count);
    if (r <= 0) return false;
    p += r;
    count -= static_cast<size_t>(r);
  }
  return true;
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 4 || argc > 6) {
    std::fprintf(stderr,
                 "usage: %s <host> <port> <frames> [lod] [dtype]\n", argv[0]);
    return 2;
  }
  const char* host = argv[1];
  const char* port = argv[2];
  const long want = std::strtol(argv[3], nullptr, 10);
  const long lod = argc >= 5 ? std::strtol(argv[4], nullptr, 10) : 0;
  const bool want_f16 = argc == 6 && std::strcmp(argv[5], "float16") == 0;

  addrinfo hints{}, *res = nullptr;
  hints.ai_family = AF_UNSPEC;
  hints.ai_socktype = SOCK_STREAM;
  if (getaddrinfo(host, port, &hints, &res) != 0 || res == nullptr) {
    std::fprintf(stderr, "resolve failed\n");
    return 2;
  }
  int fd = ::socket(res->ai_family, res->ai_socktype, res->ai_protocol);
  if (fd < 0 || ::connect(fd, res->ai_addr, res->ai_addrlen) != 0) {
    std::fprintf(stderr, "connect failed\n");
    freeaddrinfo(res);
    return 2;
  }
  freeaddrinfo(res);

  // LOD/dtype request (or "{}"): ends the negotiation window immediately
  char req[96];
  int req_len;
  if (lod > 1 && want_f16) {
    req_len = std::snprintf(req, sizeof req,
                            "{\"lod\": %ld, \"dtype\": \"float16\"}\n", lod);
  } else if (lod > 1) {
    req_len = std::snprintf(req, sizeof req, "{\"lod\": %ld}\n", lod);
  } else if (want_f16) {
    req_len = std::snprintf(req, sizeof req, "{\"dtype\": \"float16\"}\n");
  } else {
    req_len = std::snprintf(req, sizeof req, "{}\n");
  }
  for (int sent = 0; sent < req_len;) {
    ssize_t w = ::write(fd, req + sent, static_cast<size_t>(req_len - sent));
    if (w <= 0) {
      std::fprintf(stderr, "request write failed\n");
      ::close(fd);
      return 2;
    }
    sent += static_cast<int>(w);
  }

  std::string header;
  if (!read_line(fd, &header) ||
      header.find("\"tpu-ocean/1\"") == std::string::npos) {
    std::fprintf(stderr, "not a tpu-ocean/1 stream: %s\n", header.c_str());
    ::close(fd);
    return 2;
  }
  double n_d = 0;
  if (!find_number(header, "resolution", &n_d)) {
    std::fprintf(stderr, "header missing resolution\n");
    ::close(fd);
    return 2;
  }
  const size_t n = static_cast<size_t>(n_d);
  if (n == 0 || n > (1u << 16)) {
    std::fprintf(stderr, "implausible resolution %zu\n", n);
    ::close(fd);
    return 2;
  }
  const auto fields = find_string_list(header, "fields");
  const bool f16_wire = find_string(header, "dtype") == "float16";
  std::printf("# connected: %zux%zu, %zu field(s), %s wire\n", n, n,
              fields.size(), f16_wire ? "f16" : "f32");

  std::vector<float> plane;
  std::vector<uint16_t> half;
  long got = 0;
  while (got < want) {
    std::string meta;
    if (!read_line(fd, &meta)) break;  // server closed between frames
    double step = -1;
    find_number(meta, "step", &step);
    bool ok = true;
    for (const auto& name : fields) {
      const size_t count = n * n * (name == "normal" ? 3 : 1);
      plane.resize(count);
      if (f16_wire) {
        half.resize(count);
        if (!read_exact(fd, half.data(), count * sizeof(uint16_t))) {
          std::fprintf(stderr, "stream ended mid-frame\n");
          ::close(fd);
          return 1;
        }
        for (size_t i = 0; i < count; ++i) plane[i] = half_to_float(half[i]);
      } else if (!read_exact(fd, plane.data(), count * sizeof(float))) {
        std::fprintf(stderr, "stream ended mid-frame\n");
        ::close(fd);
        return 1;
      }
      double mn = plane[0], mx = plane[0];
      for (float v : plane) {
        if (!std::isfinite(v)) ok = false;
        mn = std::min<double>(mn, v);
        mx = std::max<double>(mx, v);
      }
      std::printf("frame %ld %s in [%.4f, %.4f]\n",
                  static_cast<long>(step), name.c_str(), mn, mx);
    }
    if (!ok) {
      std::fprintf(stderr, "non-finite plane\n");
      ::close(fd);
      return 1;
    }
    ++got;
  }
  ::close(fd);
  std::printf("# received %ld/%ld frames\n", got, want);
  return got == want ? 0 : 1;
}
