// artifact_server — native HTTP artifact-exchange server.
//
// C++ replacement for the reference's Mongoose-based runMserver
// (reference: server/src/runMserver.cpp, routes :237-285, multipart parse
// :160-170, metrics :20-48) with the same endpoint contract as the Python
// comm server (ppqsflhe/comm/server.py):
//
//   GET  /healthz
//   GET  /getCC                → <storage>/CC.json
//   GET  /sendPbKeyC<i>        → <storage>/client_<i>/client_<i>-public.key
//   GET  /download/<relpath>   → any file under <storage>
//   POST /upload<Kind>C<i>     → multipart {file, client_id, type}
//
// Dependency-free POSIX implementation: blocking accept loop + one thread
// per connection (the reference server handled 37 MB uploads in 36-96 ms
// single-threaded; this is not the bottleneck). Metrics CSV rows use the
// reference 12-column schema (SURVEY.md §2.4 item 5).
//
// Build: make -C ppqsflhe/runtime   →  bin/artifact_server
// Usage: artifact_server <storage_root> <port> [metrics_csv]

#include <arpa/inet.h>
#include <fcntl.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <signal.h>
#include <sys/socket.h>
#include <sys/stat.h>
#include <unistd.h>

#include <atomic>
#include <chrono>
#include <cstdio>
#include <cstring>
#include <ctime>
#include <fstream>
#include <mutex>
#include <sstream>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr size_t kMaxBody = 256ull * 1024 * 1024;  // reference raised to 200 MB

std::mutex g_metrics_mu;
std::string g_metrics_path;
std::string g_storage;

std::string now_iso() {
  std::time_t t = std::time(nullptr);
  char buf[32];
  std::strftime(buf, sizeof buf, "%Y-%m-%dT%H:%M:%S", std::localtime(&t));
  return buf;
}

void log_metric(const std::string& method, const std::string& endpoint,
                const std::string& client_id, const std::string& type,
                const std::string& file, size_t payload, size_t sent,
                size_t received, double latency_ms, int code) {
  if (g_metrics_path.empty()) return;
  std::lock_guard<std::mutex> lk(g_metrics_mu);
  bool fresh = access(g_metrics_path.c_str(), F_OK) != 0;
  std::ofstream f(g_metrics_path, std::ios::app);
  if (fresh)
    f << "timestamp,role,method,endpoint,client_id,type,file,payload_size,"
         "bytes_sent,bytes_received,latency_ms,http_code\n";
  f << now_iso() << ",server," << method << ',' << endpoint << ',' << client_id
    << ',' << type << ',' << file << ',' << payload << ',' << sent << ','
    << received << ',' << (long long)latency_ms << ',' << code << "\n";
}

bool read_file(const std::string& path, std::string* out) {
  std::ifstream f(path, std::ios::binary);
  if (!f) return false;
  std::ostringstream ss;
  ss << f.rdbuf();
  *out = ss.str();
  return true;
}

void send_all(int fd, const char* data, size_t len) {
  size_t off = 0;
  while (off < len) {
    ssize_t n = ::send(fd, data + off, len - off, MSG_NOSIGNAL);
    if (n <= 0) return;
    off += (size_t)n;
  }
}

void reply(int fd, int code, const std::string& status, const std::string& body,
           const char* ctype = "application/octet-stream") {
  std::ostringstream h;
  h << "HTTP/1.1 " << code << ' ' << status << "\r\nContent-Type: " << ctype
    << "\r\nContent-Length: " << body.size() << "\r\nConnection: close\r\n\r\n";
  std::string head = h.str();
  send_all(fd, head.data(), head.size());
  send_all(fd, body.data(), body.size());
}

// Reject path traversal; join under storage root.
bool safe_join(const std::string& rel, std::string* out) {
  if (rel.find("..") != std::string::npos) return false;
  *out = g_storage + "/" + rel;
  return true;
}

struct Multipart {
  std::string filename, filedata, client_id, type;
};

// Minimal multipart/form-data parse: fields `file`, `client_id`, `type`
// (matches comm/client.py's encoder and the reference msend contract).
bool parse_multipart(const std::string& body, const std::string& boundary,
                     Multipart* out) {
  std::string delim = "--" + boundary;
  size_t pos = 0;
  while (true) {
    size_t start = body.find(delim, pos);
    if (start == std::string::npos) break;
    start += delim.size();
    if (body.compare(start, 2, "--") == 0) break;  // final boundary
    size_t hdr_end = body.find("\r\n\r\n", start);
    if (hdr_end == std::string::npos) break;
    std::string headers = body.substr(start, hdr_end - start);
    size_t data_start = hdr_end + 4;
    size_t data_end = body.find(delim, data_start);
    if (data_end == std::string::npos) break;
    size_t dlen = data_end - data_start;
    if (dlen >= 2) dlen -= 2;  // trailing \r\n
    std::string data = body.substr(data_start, dlen);

    auto get_attr = [&](const char* key) -> std::string {
      std::string k = std::string(key) + "=\"";
      size_t p = headers.find(k);
      if (p == std::string::npos) return "";
      p += k.size();
      size_t e = headers.find('"', p);
      return headers.substr(p, e - p);
    };
    std::string name = get_attr("name");
    if (name == "file") {
      out->filename = get_attr("filename");
      out->filedata = std::move(data);
    } else if (name == "client_id") {
      out->client_id = data;
    } else if (name == "type") {
      out->type = data;
    }
    pos = data_end;
  }
  return !out->filedata.empty() || !out->filename.empty();
}

std::string basename_of(const std::string& p) {
  size_t s = p.find_last_of('/');
  return s == std::string::npos ? p : p.substr(s + 1);
}

void handle_get(int fd, const std::string& path) {
  auto t0 = std::chrono::steady_clock::now();
  std::string file;
  if (path == "/healthz") {
    reply(fd, 200, "OK", "ok", "text/plain");
    return;
  } else if (path == "/getCC") {
    file = g_storage + "/CC.json";
  } else if (path.rfind("/sendPbKeyC", 0) == 0) {
    std::string cid = path.substr(strlen("/sendPbKeyC"));
    file = g_storage + "/client_" + cid + "/client_" + cid + "-public.key";
  } else if (path.rfind("/download/", 0) == 0) {
    if (!safe_join(path.substr(strlen("/download/")), &file)) {
      reply(fd, 403, "Forbidden", "bad path");
      return;
    }
  } else {
    reply(fd, 404, "Not Found", "unknown route");
    return;
  }
  std::string body;
  if (!read_file(file, &body)) {
    reply(fd, 404, "Not Found", "no such artifact");
    log_metric("GET", path, "", "", basename_of(file), 0, 0, 0, 0, 404);
    return;
  }
  reply(fd, 200, "OK", body);
  double ms = std::chrono::duration<double, std::milli>(
                  std::chrono::steady_clock::now() - t0).count();
  log_metric("GET", path, "", "", basename_of(file), body.size(), body.size(),
             0, ms, 200);
}

void handle_post(int fd, const std::string& path, const std::string& ctype,
                 const std::string& body) {
  auto t0 = std::chrono::steady_clock::now();
  // route: /upload<Kind>C<digits>
  std::string kind, cid;
  if (path.rfind("/upload", 0) == 0) {
    size_t cpos = path.find_last_of('C');
    if (cpos != std::string::npos && cpos > 7) {
      kind = path.substr(7, cpos - 7);
      cid = path.substr(cpos + 1);
    }
  }
  if (kind.empty()) {
    reply(fd, 404, "Not Found", "unknown route");
    return;
  }
  Multipart mp;
  size_t bpos = ctype.find("boundary=");
  if (bpos != std::string::npos) {
    if (!parse_multipart(body, ctype.substr(bpos + 9), &mp)) {
      reply(fd, 400, "Bad Request", "no file part");
      return;
    }
  } else {
    mp.filename = "upload.bin";
    mp.filedata = body;
  }
  std::string sub = (kind == "Aggregated") ? "" : ("client_" + cid);
  std::string dir = g_storage + (sub.empty() ? "" : "/" + sub);
  ::mkdir(dir.c_str(), 0755);
  std::string dest = dir + "/" + basename_of(mp.filename);
  std::ofstream f(dest, std::ios::binary);
  f.write(mp.filedata.data(), (std::streamsize)mp.filedata.size());
  f.close();
  reply(fd, 200, "OK", "ok", "text/plain");
  double ms = std::chrono::duration<double, std::milli>(
                  std::chrono::steady_clock::now() - t0).count();
  log_metric("POST", path, mp.client_id.empty() ? cid : mp.client_id,
             mp.type.empty() ? kind : mp.type, basename_of(mp.filename),
             mp.filedata.size(), 0, body.size(), ms, 200);
}

void handle_conn(int fd) {
  std::string buf;
  buf.reserve(16384);
  char tmp[65536];
  size_t header_end = std::string::npos;
  while (header_end == std::string::npos) {
    ssize_t n = ::recv(fd, tmp, sizeof tmp, 0);
    if (n <= 0) { ::close(fd); return; }
    buf.append(tmp, (size_t)n);
    header_end = buf.find("\r\n\r\n");
    if (buf.size() > 1 << 20 && header_end == std::string::npos) {
      ::close(fd); return;
    }
  }
  std::string head = buf.substr(0, header_end);
  std::istringstream hs(head);
  std::string method, path, ver;
  hs >> method >> path >> ver;
  // headers
  size_t content_length = 0;
  std::string ctype;
  std::string line;
  std::getline(hs, line);
  while (std::getline(hs, line)) {
    if (!line.empty() && line.back() == '\r') line.pop_back();
    auto ci = line.find(':');
    if (ci == std::string::npos) continue;
    std::string key = line.substr(0, ci);
    for (auto& c : key) c = (char)tolower(c);
    std::string val = line.substr(ci + 1);
    while (!val.empty() && val.front() == ' ') val.erase(val.begin());
    if (key == "content-length") content_length = (size_t)atoll(val.c_str());
    else if (key == "content-type") ctype = val;
  }
  if (content_length > kMaxBody) { reply(fd, 413, "Too Large", ""); ::close(fd); return; }
  std::string body = buf.substr(header_end + 4);
  while (body.size() < content_length) {
    ssize_t n = ::recv(fd, tmp, sizeof tmp, 0);
    if (n <= 0) break;
    body.append(tmp, (size_t)n);
  }
  if (method == "GET") handle_get(fd, path);
  else if (method == "POST") handle_post(fd, path, ctype, body);
  else reply(fd, 405, "Method Not Allowed", "");
  ::close(fd);
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 3) {
    std::fprintf(stderr, "usage: %s <storage_root> <port> [metrics_csv]\n", argv[0]);
    return 2;
  }
  g_storage = argv[1];
  int port = atoi(argv[2]);
  if (argc > 3) g_metrics_path = argv[3];
  ::mkdir(g_storage.c_str(), 0755);
  signal(SIGPIPE, SIG_IGN);

  int srv = ::socket(AF_INET, SOCK_STREAM, 0);
  int one = 1;
  setsockopt(srv, SOL_SOCKET, SO_REUSEADDR, &one, sizeof one);
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
  addr.sin_port = htons((uint16_t)port);
  if (::bind(srv, (sockaddr*)&addr, sizeof addr) != 0) {
    perror("bind");
    return 1;
  }
  ::listen(srv, 64);
  // report the actual port (port 0 → ephemeral) on stdout for the launcher
  socklen_t alen = sizeof addr;
  getsockname(srv, (sockaddr*)&addr, &alen);
  std::printf("LISTENING %d\n", ntohs(addr.sin_port));
  std::fflush(stdout);

  while (true) {
    int fd = ::accept(srv, nullptr, nullptr);
    if (fd < 0) continue;
    std::thread(handle_conn, fd).detach();
  }
}
