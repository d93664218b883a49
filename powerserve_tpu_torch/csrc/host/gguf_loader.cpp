// The port's native host runtime: GGUF parsing, the multithreaded weight
// repack at load and the tokenizer's merge loop, in plain C ABI for
// ctypes (powerserve_tpu_torch/core/native.py, which builds it with g++
// at first use). A copy of the JAX package's csrc/gguf_loader.cpp with
// one change: the port reads no environment, so psv_open always maps
// the file (psv_open_ex takes the loading strategy).
//
// Repack target layout (powerserve_tpu_torch/core/quant.py):
//   q      int8   [K, N]  (or uint8 [K/2, N] group-packed nibbles)
//   scales float  [K/32, N]
//   bias   float  [K/32, N]   (Q4_K only)
// where the GGUF payload is row-major [N rows, K elements] with quant
// blocks along K.

#include <atomic>
#include <cmath>
#include <cstdint>
#include <functional>
#include <cstring>
#include <cstdio>
#include <cstdlib>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

// ---------------------------------------------------------------------------
// fp16 -> fp32 (bit manipulation, no F16C dependency)
// ---------------------------------------------------------------------------
inline float fp16_to_fp32(uint16_t h) {
    uint32_t sign = (uint32_t)(h & 0x8000) << 16;
    uint32_t exp = (h >> 10) & 0x1F;
    uint32_t man = h & 0x3FF;
    uint32_t bits;
    if (exp == 0) {
        if (man == 0) {
            bits = sign;
        } else {  // subnormal
            exp = 127 - 15 + 1;
            while ((man & 0x400) == 0) { man <<= 1; exp--; }
            man &= 0x3FF;
            bits = sign | (exp << 23) | (man << 13);
        }
    } else if (exp == 31) {
        bits = sign | 0x7F800000u | (man << 13);
    } else {
        bits = sign | ((exp - 15 + 127) << 23) | (man << 13);
    }
    float f;
    std::memcpy(&f, &bits, 4);
    return f;
}

// nibble packing index helper: for element k with pack group G,
// returns (row, high?) in the packed [K/2, N] layout
inline void pack_index(int64_t k, int64_t group, int64_t *row, bool *high) {
    int64_t g = k / group;
    int64_t o = k % group;
    int64_t half = group / 2;
    if (o < half) { *row = g * half + o; *high = false; }
    else          { *row = g * half + (o - half); *high = true; }
}

void parallel_for(int64_t n, const std::function<void(int64_t, int64_t)> &fn) {
    unsigned hw = std::thread::hardware_concurrency();
    int64_t n_threads = hw ? (hw > 16 ? 16 : hw) : 4;
    if (n < n_threads * 4) { fn(0, n); return; }
    std::vector<std::thread> ts;
    int64_t chunk = (n + n_threads - 1) / n_threads;
    for (int64_t t = 0; t < n_threads; t++) {
        int64_t lo = t * chunk, hi = lo + chunk > n ? n : lo + chunk;
        if (lo >= hi) break;
        ts.emplace_back([=, &fn] { fn(lo, hi); });
    }
    for (auto &t : ts) t.join();
}

}  // namespace

// ---------------------------------------------------------------------------
// GGUF container parsing (format per the public GGUF v3 spec)
// ---------------------------------------------------------------------------

struct PsvTensor {
    std::string name;
    uint32_t ggml_type;
    uint64_t offset;     // into data section
    uint64_t ne[4];
    uint32_t n_dims;
};

struct PsvFile {
    int fd = -1;
    const uint8_t *data = nullptr;
    size_t size = 0;
    bool owned = false;  // heap buffer (BIO/DIO/async) vs mmap
    uint64_t data_offset = 0;
    std::vector<PsvTensor> tensors;
    std::string meta_json;
};

namespace {

struct Cursor {
    const uint8_t *p;
    const uint8_t *end;
    bool ok = true;
    template <typename T> T read() {
        if (p + sizeof(T) > end) { ok = false; return T{}; }
        T v;
        std::memcpy(&v, p, sizeof(T));
        p += sizeof(T);
        return v;
    }
    std::string read_str() {
        uint64_t n = read<uint64_t>();
        if (!ok || p + n > end) { ok = false; return ""; }
        std::string s((const char *)p, n);
        p += n;
        return s;
    }
};

void json_escape(std::string &out, const std::string &s) {
    out += '"';
    for (char c : s) {
        switch (c) {
            case '"': out += "\\\""; break;
            case '\\': out += "\\\\"; break;
            case '\n': out += "\\n"; break;
            case '\r': out += "\\r"; break;
            case '\t': out += "\\t"; break;
            default:
                if ((unsigned char)c < 0x20) {
                    char buf[8];
                    snprintf(buf, sizeof buf, "\\u%04x", c);
                    out += buf;
                } else out += c;
        }
    }
    out += '"';
}

// serialize one metadata value as JSON (strings and scalars; long
// arrays are serialized fully — the Python side asks for them rarely)
void value_to_json(Cursor &c, uint32_t vtype, std::string &out, int depth = 0) {
    char buf[64];
    switch (vtype) {
        case 0: snprintf(buf, sizeof buf, "%u", c.read<uint8_t>()); out += buf; break;
        case 1: snprintf(buf, sizeof buf, "%d", c.read<int8_t>()); out += buf; break;
        case 2: snprintf(buf, sizeof buf, "%u", c.read<uint16_t>()); out += buf; break;
        case 3: snprintf(buf, sizeof buf, "%d", c.read<int16_t>()); out += buf; break;
        case 4: snprintf(buf, sizeof buf, "%u", c.read<uint32_t>()); out += buf; break;
        case 5: snprintf(buf, sizeof buf, "%d", c.read<int32_t>()); out += buf; break;
        case 6: snprintf(buf, sizeof buf, "%.9g", c.read<float>()); out += buf; break;
        case 7: out += (c.read<uint8_t>() ? "true" : "false"); break;
        case 8: json_escape(out, c.read_str()); break;
        case 9: {
            uint32_t et = c.read<uint32_t>();
            uint64_t n = c.read<uint64_t>();
            out += '[';
            for (uint64_t i = 0; i < n && c.ok; i++) {
                if (i) out += ',';
                value_to_json(c, et, out, depth + 1);
            }
            out += ']';
            break;
        }
        case 10: snprintf(buf, sizeof buf, "%llu", (unsigned long long)c.read<uint64_t>()); out += buf; break;
        case 11: snprintf(buf, sizeof buf, "%lld", (long long)c.read<int64_t>()); out += buf; break;
        case 12: snprintf(buf, sizeof buf, "%.17g", c.read<double>()); out += buf; break;
        default: c.ok = false;
    }
}

}  // namespace

// ---------------------------------------------------------------------------
// file loading strategies (reference src/storage/file_loader.cpp:16-35
// factory: MMap / BIO buffered read / DIO O_DIRECT / UV async; here the
// async role is a thread-pool of range preads — overlapped IO without a
// loop dependency)
// ---------------------------------------------------------------------------

namespace {

enum PsvLoadMethod { PSV_MMAP = 0, PSV_BIO = 1, PSV_DIO = 2, PSV_ASYNC = 3 };

// buffered whole-file read into a heap buffer
uint8_t *load_bio(int fd, size_t size) {
    uint8_t *buf = (uint8_t *)malloc(size ? size : 1);
    if (!buf) return nullptr;
    size_t off = 0;
    while (off < size) {
        size_t chunk = size - off;
        if (chunk > (16u << 20)) chunk = 16u << 20;
        ssize_t r = pread(fd, buf + off, chunk, (off_t)off);
        if (r <= 0) { free(buf); return nullptr; }
        off += (size_t)r;
    }
    return buf;
}

// O_DIRECT read: page-aligned buffer, 4K-multiple reads (tail read falls
// back to buffered IO on the same fd range)
uint8_t *load_dio(const char *path, size_t size) {
    int fd = open(path, O_RDONLY | O_DIRECT);
    if (fd < 0) return nullptr;
    const size_t align = 4096;
    size_t rounded = (size + align - 1) / align * align;
    uint8_t *buf = nullptr;
    if (posix_memalign((void **)&buf, align, rounded ? rounded : align)) {
        close(fd);
        return nullptr;
    }
    size_t aligned_end = size / align * align;
    size_t off = 0;
    bool ok = true;
    while (off < aligned_end && ok) {
        size_t chunk = aligned_end - off;
        if (chunk > (16u << 20)) chunk = 16u << 20;
        ssize_t r = pread(fd, buf + off, chunk, (off_t)off);
        if (r <= 0 || ((size_t)r % align) != 0) { ok = false; break; }
        off += (size_t)r;
    }
    close(fd);
    if (ok && aligned_end < size) {  // unaligned tail via buffered fd
        int bfd = open(path, O_RDONLY);
        ok = bfd >= 0;
        size_t toff = aligned_end;
        while (ok && toff < size) {
            ssize_t r = pread(bfd, buf + toff, size - toff, (off_t)toff);
            if (r <= 0) { ok = false; break; }
            toff += (size_t)r;
        }
        if (bfd >= 0) close(bfd);
    }
    if (!ok) { free(buf); return nullptr; }
    return buf;
}

// overlapped range reads across a thread pool (the libuv-async role)
uint8_t *load_async(int fd, size_t size) {
    uint8_t *buf = (uint8_t *)malloc(size ? size : 1);
    if (!buf) return nullptr;
    std::atomic<bool> ok{true};
    parallel_for((int64_t)((size + (4u << 20) - 1) / (4u << 20)),
                 [&](int64_t lo, int64_t hi) {
        for (int64_t c = lo; c < hi && ok.load(); c++) {
            size_t off = (size_t)c * (4u << 20);
            size_t want = size - off;
            if (want > (4u << 20)) want = 4u << 20;
            size_t done = 0;
            while (done < want) {
                ssize_t r = pread(fd, buf + off + done, want - done,
                                  (off_t)(off + done));
                if (r <= 0) { ok.store(false); break; }
                done += (size_t)r;
            }
        }
    });
    if (!ok.load()) { free(buf); return nullptr; }
    return buf;
}

}  // namespace

extern "C" {

void psv_close(void *h);  // fwd decl (used by psv_open error paths)

void *psv_open_ex(const char *path, int method) {
    int fd = open(path, O_RDONLY);
    if (fd < 0) return nullptr;
    struct stat st;
    if (fstat(fd, &st) != 0) { close(fd); return nullptr; }

    auto *f = new PsvFile;
    f->size = st.st_size;
    if (method == PSV_BIO || method == PSV_DIO || method == PSV_ASYNC) {
        uint8_t *buf = nullptr;
        if (method == PSV_BIO) buf = load_bio(fd, f->size);
        else if (method == PSV_ASYNC) buf = load_async(fd, f->size);
        else {
            buf = load_dio(path, f->size);
            if (!buf) buf = load_bio(fd, f->size);  // O_DIRECT unsupported fs
        }
        close(fd);
        if (!buf) { delete f; return nullptr; }
        f->data = buf;
        f->owned = true;
    } else {
        void *map = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
        if (map == MAP_FAILED) { close(fd); delete f; return nullptr; }
        madvise(map, st.st_size, MADV_SEQUENTIAL);
        f->fd = fd;
        f->data = (const uint8_t *)map;
    }

    Cursor c{f->data, f->data + f->size};
    uint32_t magic = c.read<uint32_t>();
    uint32_t version = c.read<uint32_t>();
    if (magic != 0x46554747u || (version != 2 && version != 3)) {
        psv_close(f);
        return nullptr;
    }
    uint64_t n_tensors = c.read<uint64_t>();
    uint64_t n_kv = c.read<uint64_t>();

    uint64_t alignment = 32;
    std::string &json = f->meta_json;
    json += '{';
    for (uint64_t i = 0; i < n_kv && c.ok; i++) {
        std::string key = c.read_str();
        uint32_t vtype = c.read<uint32_t>();
        if (i) json += ',';
        json_escape(json, key);
        json += ':';
        size_t val_start = json.size();
        value_to_json(c, vtype, json);
        if (key == "general.alignment") {
            alignment = strtoull(json.c_str() + val_start, nullptr, 10);
            if (!alignment) alignment = 32;
        }
    }
    json += '}';

    for (uint64_t i = 0; i < n_tensors && c.ok; i++) {
        PsvTensor t;
        t.name = c.read_str();
        t.n_dims = c.read<uint32_t>();
        if (t.n_dims > 4) { c.ok = false; break; }
        for (uint32_t d = 0; d < 4; d++) t.ne[d] = 1;
        for (uint32_t d = 0; d < t.n_dims; d++) t.ne[d] = c.read<uint64_t>();
        t.ggml_type = c.read<uint32_t>();
        t.offset = c.read<uint64_t>();
        f->tensors.push_back(std::move(t));
    }
    if (!c.ok) { psv_close(f); return nullptr; }
    uint64_t head = c.p - f->data;
    f->data_offset = (head + alignment - 1) / alignment * alignment;
    return f;
}

// the mmap strategy (the reference's build_file_loader default)
void *psv_open(const char *path) { return psv_open_ex(path, PSV_MMAP); }

void psv_close(void *h) {
    auto *f = (PsvFile *)h;
    if (!f) return;
    if (f->data) {
        if (f->owned) free((void *)f->data);
        else munmap((void *)f->data, f->size);
    }
    if (f->fd >= 0) close(f->fd);
    delete f;
}

const char *psv_meta_json(void *h) { return ((PsvFile *)h)->meta_json.c_str(); }

int64_t psv_tensor_count(void *h) { return (int64_t)((PsvFile *)h)->tensors.size(); }

// info out params; returns 0 on success
int psv_tensor_info(void *h, int64_t i, const char **name, uint32_t *ggml_type,
                    uint32_t *n_dims, uint64_t *ne, uint64_t *offset) {
    auto *f = (PsvFile *)h;
    if (i < 0 || (size_t)i >= f->tensors.size()) return -1;
    auto &t = f->tensors[i];
    *name = t.name.c_str();
    *ggml_type = t.ggml_type;
    *n_dims = t.n_dims;
    for (int d = 0; d < 4; d++) ne[d] = t.ne[d];
    *offset = t.offset;
    return 0;
}

const uint8_t *psv_tensor_data(void *h, int64_t i) {
    auto *f = (PsvFile *)h;
    if (i < 0 || (size_t)i >= f->tensors.size()) return nullptr;
    return f->data + f->data_offset + f->tensors[i].offset;
}

// ---------------------------------------------------------------------------
// repack kernels: GGUF payload [N rows x K elems] -> TPU layout
// (parallel over output rows N)
// ---------------------------------------------------------------------------

// Q4_0: 18-byte blocks of 32 (fp16 d + 16 nibble bytes; byte j packs
// elems j and j+16). Output: packed nibbles (two's complement of q-8)
// + f32 scales.
void psv_repack_q4_0(const uint8_t *payload, int64_t n_out, int64_t k_in,
                     int64_t pack_group, uint8_t *q_packed, float *scales) {
    const int64_t kb = k_in / 32;
    parallel_for(n_out, [&](int64_t lo, int64_t hi) {
        for (int64_t n = lo; n < hi; n++) {
            const uint8_t *row = payload + n * kb * 18;
            for (int64_t b = 0; b < kb; b++) {
                const uint8_t *blk = row + b * 18;
                uint16_t d16;
                std::memcpy(&d16, blk, 2);
                scales[b * n_out + n] = fp16_to_fp32(d16);
                for (int j = 0; j < 16; j++) {
                    uint8_t byte = blk[2 + j];
                    // GGUF nibbles are raw 0..15 with zero point 8; the
                    // packed layout stores them biased as-is (kernel
                    // dequant: w = nib * s - 8 * s)
                    int64_t ks[2] = {b * 32 + j, b * 32 + 16 + j};
                    uint8_t vs[2] = {(uint8_t)(byte & 0xF),
                                     (uint8_t)(byte >> 4)};
                    for (int t = 0; t < 2; t++) {
                        int64_t prow; bool high;
                        pack_index(ks[t], pack_group, &prow, &high);
                        uint8_t &dst = q_packed[prow * n_out + n];
                        if (high) dst = (uint8_t)((dst & 0x0F) | (vs[t] << 4));
                        else      dst = (uint8_t)((dst & 0xF0) | vs[t]);
                    }
                }
            }
        }
    });
}

// Q8_0: 34-byte blocks of 32 (fp16 d + 32 int8). Output int8 [K, N].
void psv_repack_q8_0(const uint8_t *payload, int64_t n_out, int64_t k_in,
                     int8_t *q, float *scales) {
    const int64_t kb = k_in / 32;
    parallel_for(n_out, [&](int64_t lo, int64_t hi) {
        for (int64_t n = lo; n < hi; n++) {
            const uint8_t *row = payload + n * kb * 34;
            for (int64_t b = 0; b < kb; b++) {
                const uint8_t *blk = row + b * 34;
                uint16_t d16;
                std::memcpy(&d16, blk, 2);
                scales[b * n_out + n] = fp16_to_fp32(d16);
                for (int j = 0; j < 32; j++) {
                    q[(b * 32 + j) * n_out + n] = (int8_t)blk[2 + j];
                }
            }
        }
    });
}

// Q4_K: 144-byte superblocks of 256 (fp16 d, fp16 dmin, 12B 6-bit
// scales/mins, 128B nibbles; chunk c's byte j packs elems 64c+j and
// 64c+32+j). Output: packed unsigned nibbles + per-32 f32 scales+bias.
void psv_repack_q4_k(const uint8_t *payload, int64_t n_out, int64_t k_in,
                     int64_t pack_group, uint8_t *q_packed, float *scales,
                     float *bias) {
    const int64_t nsb = k_in / 256;
    parallel_for(n_out, [&](int64_t lo, int64_t hi) {
        for (int64_t n = lo; n < hi; n++) {
            const uint8_t *row = payload + n * nsb * 144;
            for (int64_t sb = 0; sb < nsb; sb++) {
                const uint8_t *blk = row + sb * 144;
                uint16_t d16, dmin16;
                std::memcpy(&d16, blk, 2);
                std::memcpy(&dmin16, blk + 2, 2);
                float d = fp16_to_fp32(d16);
                float dmin = fp16_to_fp32(dmin16);
                const uint8_t *sc = blk + 4;
                // decode 8 six-bit (scale, min) pairs
                for (int j = 0; j < 8; j++) {
                    uint8_t s6, m6;
                    if (j < 4) {
                        s6 = sc[j] & 63;
                        m6 = sc[j + 4] & 63;
                    } else {
                        s6 = (uint8_t)((sc[j + 4] & 0xF) | ((sc[j - 4] >> 6) << 4));
                        m6 = (uint8_t)((sc[j + 4] >> 4) | ((sc[j] >> 6) << 4));
                    }
                    int64_t kb32 = sb * 8 + j;
                    scales[kb32 * n_out + n] = d * s6;
                    bias[kb32 * n_out + n] = dmin * m6;
                }
                const uint8_t *qs = blk + 16;
                for (int c = 0; c < 4; c++) {
                    for (int j = 0; j < 32; j++) {
                        uint8_t byte = qs[c * 32 + j];
                        int64_t ks[2] = {sb * 256 + c * 64 + j,
                                         sb * 256 + c * 64 + 32 + j};
                        uint8_t vs[2] = {(uint8_t)(byte & 0xF),
                                         (uint8_t)(byte >> 4)};
                        for (int t = 0; t < 2; t++) {
                            int64_t prow; bool high;
                            pack_index(ks[t], pack_group, &prow, &high);
                            uint8_t &dst = q_packed[prow * n_out + n];
                            if (high) dst = (uint8_t)((dst & 0x0F) | (vs[t] << 4));
                            else      dst = (uint8_t)((dst & 0xF0) | vs[t]);
                        }
                    }
                }
            }
        }
    });
}

// Q6_K: 210-byte superblocks of 256 (ql[128] low nibbles, qh[64] 2-bit
// highs, sc[16] int8 per-16 scales, fp16 d). Real llama.cpp Q4_K_M
// files carry Q6_K for output/ffn_down — the single largest tensor —
// so the load-time dequant + per-32 int8 requant (the TPU-side Q8
// layout, matching the Python fallback in core/quant.py
// repack_gguf_tensor's requant branch) is worth doing multithreaded.
void psv_repack_q6_k(const uint8_t *payload, int64_t n_out, int64_t k_in,
                     int8_t *q, float *scales) {
    const int64_t nsb = k_in / 256;
    parallel_for(n_out, [&](int64_t lo, int64_t hi) {
        std::vector<float> w(k_in);
        for (int64_t n = lo; n < hi; n++) {
            const uint8_t *row = payload + n * nsb * 210;
            for (int64_t sb = 0; sb < nsb; sb++) {
                const uint8_t *blk = row + sb * 210;
                const uint8_t *ql = blk;
                const uint8_t *qh = blk + 128;
                const int8_t *sc = (const int8_t *)(blk + 192);
                uint16_t d16;
                std::memcpy(&d16, blk + 208, 2);
                float d = fp16_to_fp32(d16);
                float *wb = w.data() + sb * 256;
                for (int half = 0; half < 2; half++) {
                    const uint8_t *qlh = ql + 64 * half;
                    const uint8_t *qhh = qh + 32 * half;
                    const int8_t *sch = sc + 8 * half;
                    float *wh = wb + 128 * half;
                    for (int l = 0; l < 32; l++) {
                        int s01 = l / 16;
                        int q1 = ((qlh[l] & 0xF) | (((qhh[l] >> 0) & 3) << 4)) - 32;
                        int q2 = ((qlh[32 + l] & 0xF) | (((qhh[l] >> 2) & 3) << 4)) - 32;
                        int q3 = ((qlh[l] >> 4) | (((qhh[l] >> 4) & 3) << 4)) - 32;
                        int q4 = ((qlh[32 + l] >> 4) | (((qhh[l] >> 6) & 3) << 4)) - 32;
                        wh[l] = d * sch[0 + s01] * q1;
                        wh[32 + l] = d * sch[2 + s01] * q2;
                        wh[64 + l] = d * sch[4 + s01] * q3;
                        wh[96 + l] = d * sch[6 + s01] * q4;
                    }
                }
            }
            // per-32 symmetric int8 requant into the transposed layout
            const int64_t kb = k_in / 32;
            for (int64_t b = 0; b < kb; b++) {
                float amax = 0.f;
                for (int j = 0; j < 32; j++) {
                    float a = std::fabs(w[b * 32 + j]);
                    if (a > amax) amax = a;
                }
                float s = amax / 127.0f;
                float inv = s > 0.f ? 1.0f / s : 0.0f;
                scales[b * n_out + n] = s;
                for (int j = 0; j < 32; j++) {
                    float v = std::nearbyint(w[b * 32 + j] * inv);
                    if (v > 127.f) v = 127.f;
                    if (v < -127.f) v = -127.f;
                    q[(b * 32 + j) * n_out + n] = (int8_t)v;
                }
            }
        }
    });
}

// fp16 payload -> f32 (for norms / biases)
void psv_fp16_to_f32(const uint8_t *payload, int64_t n, float *out) {
    parallel_for(n, [&](int64_t lo, int64_t hi) {
        for (int64_t i = lo; i < hi; i++) {
            uint16_t h;
            std::memcpy(&h, payload + 2 * i, 2);
            out[i] = fp16_to_fp32(h);
        }
    });
}

}  // extern "C"

// ---------------------------------------------------------------------------
// tokenizer fast path: agglomerative pair merging (the reference vendors
// llama.cpp's C++ tokenizer; tokenizer/vocab.py keeps a pure-Python
// fallback with IDENTICAL semantics — best pair first, leftmost on ties,
// stale heap entries skipped by candidate-string comparison)
// ---------------------------------------------------------------------------

#include <unordered_map>
#include <queue>
#include <limits>

struct PsvVocab {
    std::unordered_map<std::string, int32_t> token_to_id;
    std::vector<float> scores;            // empty = no scores
    std::unordered_map<std::string, int32_t> merge_ranks;  // "a\x01b"
    int32_t byte_tokens[256];
    int32_t unk_id = -1;
};

extern "C" void *psv_vocab_create(const uint8_t *blob, const int64_t *offsets,
                       int64_t n, const float *scores_or_null,
                       const int32_t *byte_token_ids, int32_t unk_id) {
    auto *v = new PsvVocab();
    v->token_to_id.reserve((size_t)n * 2);
    for (int64_t i = 0; i < n; i++) {
        std::string t((const char *)blob + offsets[i],
                      (size_t)(offsets[i + 1] - offsets[i]));
        v->token_to_id.emplace(std::move(t), (int32_t)i);
    }
    if (scores_or_null) v->scores.assign(scores_or_null, scores_or_null + n);
    for (int i = 0; i < 256; i++)
        v->byte_tokens[i] = byte_token_ids ? byte_token_ids[i] : -1;
    v->unk_id = unk_id;
    return v;
}

extern "C" void psv_vocab_set_merges(void *h, const uint8_t *blob,
                          const int64_t *offsets, int64_t n) {
    auto *v = (PsvVocab *)h;
    v->merge_ranks.reserve((size_t)n * 2);
    for (int64_t r = 0; r < n; r++) {
        std::string m((const char *)blob + offsets[r],
                      (size_t)(offsets[r + 1] - offsets[r]));
        size_t sp = m.find(' ');
        if (sp == std::string::npos) continue;
        std::string key = m.substr(0, sp);
        key.push_back('\x01');
        key.append(m, sp + 1, std::string::npos);
        v->merge_ranks.emplace(std::move(key), (int32_t)r);
    }
}

extern "C" void psv_vocab_free(void *h) { delete (PsvVocab *)h; }

namespace {

// split UTF-8 into code-point strings
static void utf8_split(const char *s, int64_t len,
                       std::vector<std::string> &out) {
    int64_t i = 0;
    while (i < len) {
        unsigned char c = (unsigned char)s[i];
        int n = c < 0x80 ? 1 : (c >> 5) == 0x6 ? 2 : (c >> 4) == 0xE ? 3
                : (c >> 3) == 0x1E ? 4 : 1;
        if (i + n > len) n = 1;
        out.emplace_back(s + i, (size_t)n);
        i += n;
    }
}

struct HeapEnt {
    double pr;      // smaller merges first
    int64_t i;      // left symbol index (leftmost wins ties)
    std::string cand;
};
struct HeapCmp {  // min-heap on (pr, i)
    bool operator()(const HeapEnt &a, const HeapEnt &b) const {
        if (a.pr != b.pr) return a.pr > b.pr;
        return a.i > b.i;
    }
};

// shared agglomerative loop; pair_pr returns NaN for "no merge"
template <class PairPr>
static void merge_symbols(std::vector<std::string> &sym, PairPr pair_pr) {
    const int64_t n = (int64_t)sym.size();
    if (n < 2) return;
    std::vector<int64_t> prev(n), nxt(n);
    for (int64_t i = 0; i < n; i++) { prev[i] = i - 1; nxt[i] = i + 1; }
    nxt[n - 1] = -1;
    std::priority_queue<HeapEnt, std::vector<HeapEnt>, HeapCmp> heap;
    auto push = [&](int64_t i) {
        if (i < 0) return;
        int64_t j = nxt[i];
        if (j < 0 || sym[i].empty() || sym[j].empty()) return;
        std::string cand = sym[i] + sym[j];
        double pr = pair_pr(cand);
        if (pr == pr) heap.push({pr, i, std::move(cand)});
    };
    for (int64_t i = 0; i < n - 1; i++) push(i);
    while (!heap.empty()) {
        HeapEnt e = heap.top();
        heap.pop();
        int64_t i = e.i;
        if (sym[i].empty()) continue;
        int64_t j = nxt[i];
        if (j < 0 || sym[j].empty() || sym[i] + sym[j] != e.cand)
            continue;  // stale
        sym[i] = std::move(e.cand);
        sym[j].clear();
        nxt[i] = nxt[j];
        if (nxt[j] >= 0) prev[nxt[j]] = i;
        if (prev[i] >= 0) push(prev[i]);
        push(i);
    }
}

}  // namespace

// SPM: max token score first (no scores: shortest merged string first);
// byte fallback for unmatched symbols. Returns id count (caller sizes
// out_ids >= #codepoints * 4 to cover byte fallback).
extern "C" int64_t psv_spm_encode(void *h, const char *text, int64_t len,
                       int32_t *out_ids) {
    auto *v = (PsvVocab *)h;
    std::vector<std::string> sym;
    utf8_split(text, len, sym);
    merge_symbols(sym, [&](const std::string &cand) -> double {
        auto it = v->token_to_id.find(cand);
        if (it == v->token_to_id.end())
            return std::numeric_limits<double>::quiet_NaN();
        double sc = v->scores.empty() ? -(double)cand.size()
                                      : (double)v->scores[it->second];
        return -sc;
    });
    int64_t n_out = 0;
    for (auto &s : sym) {
        if (s.empty()) continue;
        auto it = v->token_to_id.find(s);
        if (it != v->token_to_id.end()) {
            out_ids[n_out++] = it->second;
        } else {
            for (unsigned char b : s) {
                if (v->byte_tokens[b] >= 0) out_ids[n_out++] = v->byte_tokens[b];
                else if (v->unk_id >= 0) out_ids[n_out++] = v->unk_id;
            }
        }
    }
    return n_out;
}

// GPT-2 BPE on a byte-mapped word: lowest merge rank first
extern "C" int64_t psv_bpe_encode(void *h, const char *word, int64_t len,
                       int32_t *out_ids) {
    auto *v = (PsvVocab *)h;
    std::vector<std::string> sym;
    utf8_split(word, len, sym);
    // rank lookup needs the (left, right) split, not just the merged
    // string; track via a map keyed by the candidate built at push time
    std::vector<int64_t> dummy;
    (void)dummy;
    // re-run the generic loop but with a pair function that knows both
    // halves: wrap by probing every split of cand against merge_ranks
    // is wrong — instead use a dedicated loop mirroring merge_symbols
    const int64_t n = (int64_t)sym.size();
    if (n >= 2) {
        std::vector<int64_t> prev(n), nxt(n);
        for (int64_t i = 0; i < n; i++) { prev[i] = i - 1; nxt[i] = i + 1; }
        nxt[n - 1] = -1;
        std::priority_queue<HeapEnt, std::vector<HeapEnt>, HeapCmp> heap;
        auto push = [&](int64_t i) {
            if (i < 0) return;
            int64_t j = nxt[i];
            if (j < 0 || sym[i].empty() || sym[j].empty()) return;
            std::string key = sym[i];
            key.push_back('\x01');
            key += sym[j];
            auto it = v->merge_ranks.find(key);
            if (it == v->merge_ranks.end()) return;
            heap.push({(double)it->second, i, sym[i] + sym[j]});
        };
        for (int64_t i = 0; i < n - 1; i++) push(i);
        while (!heap.empty()) {
            HeapEnt e = heap.top();
            heap.pop();
            int64_t i = e.i;
            if (sym[i].empty()) continue;
            int64_t j = nxt[i];
            if (j < 0 || sym[j].empty() || sym[i] + sym[j] != e.cand)
                continue;
            sym[i] = std::move(e.cand);
            sym[j].clear();
            nxt[i] = nxt[j];
            if (nxt[j] >= 0) prev[nxt[j]] = i;
            if (prev[i] >= 0) push(prev[i]);
            push(i);
        }
    }
    int64_t n_out = 0;
    for (auto &s : sym) {
        if (s.empty()) continue;
        auto it = v->token_to_id.find(s);
        if (it != v->token_to_id.end()) out_ids[n_out++] = it->second;
        else if (v->unk_id >= 0) out_ids[n_out++] = v->unk_id;
    }
    return n_out;
}
