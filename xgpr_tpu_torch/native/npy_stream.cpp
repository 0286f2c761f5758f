// Native streaming .npy chunk loader with background prefetch (the
// port's own copy of xgpr_tpu/native/npy_stream.cpp; built and loaded by
// loader.py beside it).
//
// Overlaps disk IO and decode of file i+1 with the caller's work on file
// i through a background prefetch thread.
//
// C ABI (consumed from Python via ctypes -- no pybind/nanobind needed):
//   xgpr_stream_open(paths, n_files, depth)        -> handle
//   xgpr_stream_next(handle, &buf, &rows, &cols,
//                    &dtype_code)                  -> 1 ok / 0 end / -1 err
//   xgpr_stream_release_buffer(handle)             -> recycle last buffer
//   xgpr_stream_close(handle)
//
// dtype codes: 0 = f32, 1 = f64, 2 = i32, 3 = i64.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Chunk {
    std::vector<char> data;
    int64_t rows = 0;
    int64_t cols = 0;  // flattened trailing dims
    int dtype_code = -1;
    bool ok = false;
};

int dtype_code_of(const std::string &descr) {
    if (descr == "<f4") return 0;
    if (descr == "<f8") return 1;
    if (descr == "<i4") return 2;
    if (descr == "<i8") return 3;
    return -1;
}

// Minimal .npy v1/v2 reader (C-order little-endian arrays only).
bool read_npy(const std::string &path, Chunk &out) {
    FILE *f = std::fopen(path.c_str(), "rb");
    if (!f) return false;
    unsigned char magic[8];
    if (std::fread(magic, 1, 8, f) != 8 ||
        std::memcmp(magic, "\x93NUMPY", 6) != 0) {
        std::fclose(f);
        return false;
    }
    int major = magic[6];
    uint32_t header_len = 0;
    if (major == 1) {
        unsigned char b[2];
        if (std::fread(b, 1, 2, f) != 2) { std::fclose(f); return false; }
        header_len = b[0] | (b[1] << 8);
    } else {
        unsigned char b[4];
        if (std::fread(b, 1, 4, f) != 4) { std::fclose(f); return false; }
        header_len = b[0] | (b[1] << 8) | (b[2] << 16) |
                     (uint32_t(b[3]) << 24);
    }
    std::string header(header_len, '\0');
    if (std::fread(&header[0], 1, header_len, f) != header_len) {
        std::fclose(f);
        return false;
    }

    auto find_value = [&](const char *key) -> std::string {
        size_t pos = header.find(key);
        if (pos == std::string::npos) return "";
        pos = header.find(':', pos);
        if (pos == std::string::npos) return "";
        return header.substr(pos + 1);
    };

    // dtype
    std::string descr_part = find_value("'descr'");
    size_t q1 = descr_part.find('\'');
    size_t q2 = descr_part.find('\'', q1 + 1);
    if (q1 == std::string::npos || q2 == std::string::npos) {
        std::fclose(f);
        return false;
    }
    std::string descr = descr_part.substr(q1 + 1, q2 - q1 - 1);
    out.dtype_code = dtype_code_of(descr);
    if (out.dtype_code < 0) { std::fclose(f); return false; }

    if (header.find("'fortran_order': True") != std::string::npos) {
        std::fclose(f);
        return false;
    }

    // shape tuple
    size_t sp = header.find("'shape'");
    sp = header.find('(', sp);
    size_t ep = header.find(')', sp);
    if (sp == std::string::npos || ep == std::string::npos) {
        std::fclose(f);
        return false;
    }
    std::string shape_str = header.substr(sp + 1, ep - sp - 1);
    std::vector<int64_t> shape;
    {
        int64_t cur = 0;
        bool in_num = false;
        for (char c : shape_str) {
            if (c >= '0' && c <= '9') {
                cur = cur * 10 + (c - '0');
                in_num = true;
            } else if (in_num) {
                shape.push_back(cur);
                cur = 0;
                in_num = false;
            }
        }
        if (in_num) shape.push_back(cur);
    }
    if (shape.empty()) { std::fclose(f); return false; }

    out.rows = shape[0];
    out.cols = 1;
    for (size_t i = 1; i < shape.size(); i++) out.cols *= shape[i];

    size_t itemsize = (out.dtype_code == 0 || out.dtype_code == 2) ? 4 : 8;
    size_t nbytes = size_t(out.rows) * size_t(out.cols) * itemsize;
    out.data.resize(nbytes);
    size_t got = std::fread(out.data.data(), 1, nbytes, f);
    std::fclose(f);
    if (got != nbytes) return false;
    out.ok = true;
    return true;
}

struct Stream {
    std::vector<std::string> paths;
    size_t next_to_load = 0;
    size_t depth = 2;
    std::deque<Chunk> ready;
    Chunk current;  // buffer handed to Python, kept alive until release
    std::mutex mu;
    std::condition_variable cv_ready, cv_space;
    std::thread worker;
    std::atomic<bool> stop{false};
    bool error = false;

    void run() {
        for (size_t i = 0; i < paths.size() && !stop.load(); i++) {
            Chunk c;
            bool ok = read_npy(paths[i], c);
            std::unique_lock<std::mutex> lk(mu);
            if (!ok) {
                error = true;
                cv_ready.notify_all();
                return;
            }
            cv_space.wait(lk, [&] {
                return ready.size() < depth || stop.load();
            });
            if (stop.load()) return;
            ready.push_back(std::move(c));
            cv_ready.notify_all();
        }
    }
};

}  // namespace

extern "C" {

void *xgpr_stream_open(const char **paths, int64_t n_files,
                       int64_t depth) {
    Stream *s = new Stream();
    for (int64_t i = 0; i < n_files; i++) s->paths.emplace_back(paths[i]);
    s->depth = depth > 0 ? size_t(depth) : 2;
    s->worker = std::thread([s] { s->run(); });
    return s;
}

// Returns 1 with a chunk, 0 at end of stream, -1 on error.  The returned
// buffer stays valid until the next call to next/close.
int xgpr_stream_next(void *handle, const void **buf, int64_t *rows,
                     int64_t *cols, int *dtype_code) {
    Stream *s = static_cast<Stream *>(handle);
    std::unique_lock<std::mutex> lk(s->mu);
    s->cv_ready.wait(lk, [&] {
        return !s->ready.empty() || s->error ||
               (s->next_to_load >= s->paths.size() && s->ready.empty());
    });
    if (s->error) return -1;
    if (s->ready.empty()) return 0;
    s->current = std::move(s->ready.front());
    s->ready.pop_front();
    s->next_to_load++;
    s->cv_space.notify_all();
    *buf = s->current.data.data();
    *rows = s->current.rows;
    *cols = s->current.cols;
    *dtype_code = s->current.dtype_code;
    return 1;
}

void xgpr_stream_close(void *handle) {
    Stream *s = static_cast<Stream *>(handle);
    s->stop.store(true);
    s->cv_space.notify_all();
    s->cv_ready.notify_all();
    if (s->worker.joinable()) s->worker.join();
    delete s;
}

}  // extern "C"
