// JPEG decoding for the port's image input (powerserve_tpu_torch/core/
// image.py), bit-equal to libjpeg-turbo's default decode as Pillow runs
// it (Image.open(...).convert("RGB")):
//   - Huffman-coded 8-bit baseline and extended-sequential frames (SOF0,
//     SOF1) and progressive frames (SOF2: spectral selection and
//     successive approximation, DC and AC refinement), restart intervals;
//     a sequential frame without its DHT (Motion JPEG) takes the standard
//     tables, as libjpeg-turbo does (a progressive frame without them is
//     an error there and here);
//   - 1 component (gray, replicated to RGB) or 3 (YCbCr, or RGB when an
//     Adobe APP14 marker says transform 0, or the component ids are 'R',
//     'G', 'B' without JFIF or Adobe markers: libjpeg's guess);
//   - sampling factors of 1 or 2 per axis (4:4:4, 4:2:2, 4:4:0, 4:2:0);
//   - the islow integer IDCT of jidctint.c with libjpeg's range-limit
//     table, fancy upsampling (the h2v1, h1v2 and h2v2 triangle filters of
//     jdsample.c, box replication where libjpeg takes it: h2 with a
//     downsampled width of at most 2), and jdcolor.c's fixed-point
//     YCbCr -> RGB tables.
// Not taken (the caller's ValueError names what is): arithmetic coding,
// lossless and hierarchical frames, precisions other than 8 bits, 2 or 4
// components (CMYK, YCCK), other sampling factors. Progressive block
// smoothing is not run: libjpeg runs it only on coefficients left
// unrefined, which a whole progressive file does not leave.
//
// The input is untrusted (HTTP requests): every read is bounds-checked,
// a truncated or corrupt stream is an error (status 1), never a crash or
// a loop without end; the pixel count is checked from the SOF before any
// buffer is sized. Plain C ABI for ctypes:
//   int psv_jpeg_decode(data, n, max_pixels, &w, &h, &rgb, err, errlen)
//     0: rgb = malloc'd uint8 [h, w, 3] (free with psv_jpeg_free);
//     1: corrupt or truncated; 2: a JPEG of a kind not taken (err says).

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <new>
#include <string>
#include <vector>

namespace {

struct JpegError {
    int status;
    std::string msg;
};

[[noreturn]] void corrupt(const std::string &m) { throw JpegError{1, m}; }
[[noreturn]] void refuse(const std::string &m) { throw JpegError{2, m}; }

// zigzag -> natural order, with libjpeg's 16 trailing 63s so a run past
// the block's end lands on coefficient 63 as it does there
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

const int kMaxScans = 1000;
const int kMaxBlocksInMcu = 10;  // libjpeg's D_MAX_BLOCKS_IN_MCU
const int kLook = 9;             // Huffman lookahead bits

// ITU T.81 Annex K.3's tables (counts by length 1..16, then symbols): DC
// and AC, luminance (slot 0) and chrominance (slot 1). libjpeg-turbo loads
// them into a sequential frame's undefined slots 0 and 1 when it starts to
// decode (jinit_huff_decoder), for Motion-JPEG frames that omit their DHT.
const uint8_t kStdDcCounts[2][16] = {
    {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0},
    {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0}};
const uint8_t kStdAcCounts[2][16] = {
    {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d},
    {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77}};
const uint8_t kStdDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kStdAcVals[2][162] = {
    {0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
     0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
     0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
     0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
     0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
     0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
     0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
     0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
     0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
     0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
     0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
     0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
     0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
     0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa},
    {0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
     0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
     0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
     0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
     0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
     0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
     0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
     0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
     0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
     0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
     0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
     0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
     0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
     0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa}};

// ---------------------------------------------------------------------------
// entropy-coded segment bits
// ---------------------------------------------------------------------------

struct BitReader {
    const uint8_t *d;
    size_t n, pos;
    uint64_t buf = 0;  // MSB first
    int cnt = 0;       // bits in buf
    int fake = 0;      // zero bits appended past a marker or the end
    bool stop = false;

    BitReader(const uint8_t *d_, size_t n_, size_t pos_)
        : d(d_), n(n_), pos(pos_) {}

    void fill() {
        while (cnt <= 56) {
            if (stop) {
                cnt += 8;
                fake += 8;
                continue;
            }
            if (pos >= n) {
                stop = true;
                continue;
            }
            uint8_t b = d[pos];
            if (b == 0xFF) {
                size_t q = pos + 1;
                while (q < n && d[q] == 0xFF) q++;
                if (q >= n || d[q] != 0x00) {  // a marker: stop before it
                    stop = true;
                    continue;
                }
                pos = q + 1;  // a stuffed 0xFF
            } else {
                pos++;
            }
            buf |= (uint64_t)b << (56 - cnt);
            cnt += 8;
        }
    }
    uint32_t peek(int k) {
        if (cnt < k) fill();
        return (uint32_t)(buf >> (64 - k));
    }
    void consume(int k) {
        if (k > cnt - fake) corrupt("JPEG data ends inside a scan");
        buf <<= k;
        cnt -= k;
    }
    int get(int k) {
        if (k == 0) return 0;
        uint32_t v = peek(k);
        consume(k);
        return (int)v;
    }
    // discard the buffered bits (a restart or the end of a scan)
    void reset() {
        buf = 0;
        cnt = fake = 0;
        stop = false;
    }
};

inline int extend(int r, int s) {
    return r < (1 << (s - 1)) ? r + (int)(((unsigned)-1 << s) + 1) : r;
}

struct Huff {
    bool defined = false;
    uint8_t counts[17] = {0};
    uint8_t vals[256] = {0};
    int32_t maxcode[18] = {0};
    int32_t valoff[18] = {0};
    uint16_t look[1 << kLook] = {0};  // (length << 8) | symbol; 0: longer

    void load(const uint8_t *cnt, const uint8_t *sym, bool dc) {
        int total = 0;
        counts[0] = 0;
        for (int l = 1; l <= 16; l++) total += counts[l] = cnt[l - 1];
        std::memset(vals, 0, sizeof(vals));
        std::memcpy(vals, sym, (size_t)total);
        build(dc);
    }

    void build(bool dc) {
        int code = 0, p = 0;
        for (int l = 1; l <= 16; l++) {
            valoff[l] = p - code;
            p += counts[l];
            code += counts[l];
            // libjpeg's check: no code of all one bits
            if (code >= (1 << l)) corrupt("bad JPEG Huffman table");
            maxcode[l] = counts[l] ? code - 1 : -1;
            code <<= 1;
        }
        maxcode[17] = 0x7FFFFFFF;
        if (dc)
            for (int i = 0; i < p; i++)
                if (vals[i] > 15) corrupt("bad JPEG DC Huffman table");
        std::memset(look, 0, sizeof(look));
        code = 0;
        p = 0;
        for (int l = 1; l <= kLook; l++) {
            for (int i = 0; i < counts[l]; i++, p++, code++) {
                int shift = kLook - l;
                for (int j = 0; j < (1 << shift); j++)
                    look[(code << shift) | j] =
                        (uint16_t)((l << 8) | vals[p]);
            }
            code <<= 1;
        }
        defined = true;
    }

    int decode(BitReader &br) const {
        uint16_t e = look[br.peek(kLook)];
        if (e >> 8) {
            br.consume(e >> 8);
            return e & 0xFF;
        }
        for (int l = kLook + 1; l <= 16; l++) {
            int32_t c = (int32_t)br.peek(l);
            if (c <= maxcode[l]) {
                br.consume(l);
                int idx = c + valoff[l];
                if (idx < 0 || idx > 255) corrupt("bad JPEG Huffman code");
                return vals[idx];
            }
        }
        corrupt("bad JPEG Huffman code");
    }
};

// ---------------------------------------------------------------------------
// the frame
// ---------------------------------------------------------------------------

struct Comp {
    int id = 0, h = 1, v = 1, tq = 0;
    int bw = 0, bh = 0;            // blocks stored (whole MCUs)
    int bw_real = 0, bh_real = 0;  // blocks that hold the image
    int ds_w = 0, ds_h = 0;        // the component's samples
    std::vector<int16_t> coef;     // [bh, bw, 64], natural order
    bool latched = false;
    uint16_t q[64] = {0};  // natural order
    int dc_pred = 0;
    int16_t *block(int by, int bx) {
        return coef.data() + ((size_t)by * bw + bx) * 64;
    }
};

struct Decoder {
    const uint8_t *d;
    size_t n;
    int64_t max_pixels;
    size_t pos = 0;

    bool have_frame = false, progressive = false;
    int width = 0, height = 0, hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
    std::vector<Comp> comps;
    uint16_t qt[4][64];
    bool qt_defined[4] = {false, false, false, false};
    Huff dc[4], ac[4];
    int restart_interval = 0;
    bool saw_jfif = false, saw_adobe = false;
    int adobe_transform = 0;
    int n_scans = 0;

    Decoder(const uint8_t *d_, size_t n_, int64_t max_px)
        : d(d_), n(n_), max_pixels(max_px) {}

    int byte() {
        if (pos >= n) corrupt("truncated JPEG");
        return d[pos++];
    }
    int u16() {
        int hi = byte();
        return (hi << 8) | byte();
    }

    // the next marker's code, skipping what lies before it (libjpeg's
    // next_marker: garbage bytes, then fill 0xFFs)
    int next_marker() {
        for (;;) {
            while (pos < n && d[pos] != 0xFF) pos++;
            if (pos >= n) corrupt("truncated JPEG (no EOI)");
            while (pos < n && d[pos] == 0xFF) pos++;
            if (pos >= n) corrupt("truncated JPEG (no EOI)");
            int m = d[pos++];
            if (m != 0) return m;
        }
    }

    // a marker segment's body: [start, end)
    size_t segment(size_t *end) {
        int len = u16();
        if (len < 2 || pos + (size_t)(len - 2) > n)
            corrupt("truncated JPEG marker segment");
        *end = pos + (size_t)(len - 2);
        return pos;
    }

    void read_dqt() {
        size_t end, p = segment(&end);
        while (p < end) {
            int pq = d[p] >> 4, tq = d[p] & 15;
            p++;
            if (tq > 3 || pq > 1) corrupt("bad JPEG DQT");
            size_t need = pq ? 128 : 64;
            if (p + need > end) corrupt("truncated JPEG DQT");
            for (int i = 0; i < 64; i++) {
                int val = pq ? (d[p + 2 * i] << 8) | d[p + 2 * i + 1]
                             : d[p + i];
                qt[tq][kNatural[i]] = (uint16_t)val;
            }
            qt_defined[tq] = true;
            p += need;
        }
        pos = end;
    }

    void read_dht() {
        size_t end, p = segment(&end);
        while (p < end) {
            if (p + 17 > end) corrupt("truncated JPEG DHT");
            int tc = d[p] >> 4, th = d[p] & 15;
            if (tc > 1 || th > 3) corrupt("bad JPEG DHT");
            int total = 0;
            for (int i = 1; i <= 16; i++) total += d[p + i];
            if (total > 256 || p + 17 + (size_t)total > end)
                corrupt("bad JPEG DHT");
            (tc ? ac[th] : dc[th]).load(d + p + 1, d + p + 17, tc == 0);
            p += 17 + (size_t)total;
        }
        pos = end;
    }

    void read_dri() {
        size_t end;
        segment(&end);
        if (end - pos != 2) corrupt("bad JPEG DRI");
        restart_interval = u16();
    }

    void read_app(int m) {
        size_t end, p = segment(&end);
        size_t len = end - p;
        if (m == 0xE0 && len >= 14 && std::memcmp(d + p, "JFIF\0", 5) == 0)
            saw_jfif = true;
        if (m == 0xEE && len >= 12 && std::memcmp(d + p, "Adobe", 5) == 0) {
            saw_adobe = true;
            adobe_transform = d[p + 11];
        }
        pos = end;
    }

    void read_sof(int m) {
        if (have_frame) corrupt("JPEG with two frames");
        size_t end;
        segment(&end);
        if (end - pos < 6) corrupt("bad JPEG SOF");
        int precision = byte();
        height = u16();
        width = u16();
        int nf = byte();
        if (precision != 8) refuse(std::to_string(precision) + "-bit JPEG");
        if (nf == 4) refuse("4-component (CMYK/YCCK) JPEG");
        if (nf != 1 && nf != 3)
            refuse(std::to_string(nf) + "-component JPEG");
        if (end - pos != (size_t)(3 * nf)) corrupt("bad JPEG SOF length");
        if (width <= 0 || height <= 0)
            corrupt("JPEG of " + std::to_string(width) + " x " +
                    std::to_string(height) + " pixels");
        if ((int64_t)width * height > max_pixels)
            corrupt("JPEG of " + std::to_string(width) + " x " +
                    std::to_string(height) + " pixels: more than " +
                    std::to_string(max_pixels));
        progressive = m == 0xC2;
        comps.resize(nf);
        for (int i = 0; i < nf; i++) {
            Comp &c = comps[i];
            c.id = byte();
            int hv = byte();
            c.h = hv >> 4;
            c.v = hv & 15;
            c.tq = byte();
            if (c.tq > 3) corrupt("bad JPEG quantization table id");
            if (c.h < 1 || c.h > 2 || c.v < 1 || c.v > 2)
                refuse("JPEG sampling factors " + std::to_string(c.h) + "x" +
                       std::to_string(c.v));
            for (int j = 0; j < i; j++)
                if (comps[j].id == c.id)
                    corrupt("JPEG with a repeated component id");
            hmax = std::max(hmax, c.h);
            vmax = std::max(vmax, c.v);
        }
        mcux = (width + 8 * hmax - 1) / (8 * hmax);
        mcuy = (height + 8 * vmax - 1) / (8 * vmax);
        for (Comp &c : comps) {
            c.ds_w = (int)(((int64_t)width * c.h + hmax - 1) / hmax);
            c.ds_h = (int)(((int64_t)height * c.v + vmax - 1) / vmax);
            c.bw_real = (c.ds_w + 7) / 8;
            c.bh_real = (c.ds_h + 7) / 8;
            c.bw = mcux * c.h;
            c.bh = mcuy * c.v;
            c.coef.assign((size_t)c.bw * c.bh * 64, 0);
        }
        have_frame = true;
    }

    // -- scans ---------------------------------------------------------------

    void restart(BitReader &br, int &next_rst) {
        br.reset();
        pos = br.pos;
        int m = next_marker();
        if (m != 0xD0 + next_rst) corrupt("JPEG restart marker missing");
        next_rst = (next_rst + 1) & 7;
        br.pos = pos;
    }

    void read_sos() {
        if (!have_frame) corrupt("JPEG scan before its frame");
        if (++n_scans > kMaxScans) corrupt("JPEG with too many scans");
        if (n_scans == 1 && !progressive)
            for (int t = 0; t < 2; t++) {
                if (!dc[t].defined)
                    dc[t].load(kStdDcCounts[t], kStdDcVals, true);
                if (!ac[t].defined)
                    ac[t].load(kStdAcCounts[t], kStdAcVals[t], false);
            }
        size_t end;
        segment(&end);
        int ns = byte();
        if (ns < 1 || ns > (int)comps.size() ||
            end - pos != (size_t)(2 * ns + 3))
            corrupt("bad JPEG SOS");
        std::vector<int> sc(ns), td(ns), ta(ns);
        for (int i = 0; i < ns; i++) {
            int cid = byte(), t = byte();
            int ci = -1;
            for (size_t j = 0; j < comps.size(); j++)
                if (comps[j].id == cid) ci = (int)j;
            if (ci < 0) corrupt("JPEG scan of an unknown component");
            for (int j = 0; j < i; j++)
                if (sc[j] == ci) corrupt("JPEG scan repeats a component");
            sc[i] = ci;
            td[i] = t >> 4;
            ta[i] = t & 15;
            if (td[i] > 3 || ta[i] > 3) corrupt("bad JPEG SOS table id");
        }
        int ss = byte(), se = byte(), a = byte();
        int ah = a >> 4, al = a & 15;
        if (progressive) {
            bool bad = ss == 0 ? se != 0 : (se < ss || se > 63 || ns != 1);
            if ((ah != 0 && al != ah - 1) || al > 13) bad = true;
            if (bad) corrupt("bad JPEG progression");
        } else {
            ss = 0;
            se = 63;
            ah = al = 0;
        }
        int blocks = 0;
        for (int i = 0; i < ns; i++) {
            Comp &c = comps[sc[i]];
            blocks += ns > 1 ? c.h * c.v : 1;
            if (!c.latched) {  // libjpeg latches a table at its first scan
                if (!qt_defined[c.tq])
                    corrupt("JPEG component without a quantization table");
                std::memcpy(c.q, qt[c.tq], sizeof(c.q));
                c.latched = true;
            }
            // a sequential scan decodes with both of its tables
            bool need_dc = ss == 0 && ah == 0,
                 need_ac = ss > 0 || !progressive;
            if ((need_dc && !dc[td[i]].defined) ||
                (need_ac && !ac[ta[i]].defined))
                corrupt("JPEG scan without its Huffman table");
            c.dc_pred = 0;
        }
        if (blocks > kMaxBlocksInMcu) corrupt("JPEG MCU of too many blocks");

        BitReader br(d, n, pos);
        int eobrun = 0, next_rst = 0;
        int64_t n_mcu = 0;
        auto block = [&](int i, int16_t *blk) {
            Comp &c = comps[sc[i]];
            if (!progressive)
                decode_sequential(br, c, blk, dc[td[i]], ac[ta[i]]);
            else if (ss == 0 && ah == 0)
                dc_first(br, c, blk, dc[td[i]], al);
            else if (ss == 0)
                dc_refine(br, blk, al);
            else if (ah == 0)
                ac_first(br, blk, ac[ta[i]], ss, se, al, eobrun);
            else
                ac_refine(br, blk, ac[ta[i]], ss, se, al, eobrun);
        };
        auto mcu_start = [&]() {
            if (restart_interval && n_mcu > 0 &&
                n_mcu % restart_interval == 0) {
                restart(br, next_rst);
                for (int i = 0; i < ns; i++) comps[sc[i]].dc_pred = 0;
                eobrun = 0;
            }
            n_mcu++;
        };
        if (ns > 1) {
            for (int my = 0; my < mcuy; my++)
                for (int mx = 0; mx < mcux; mx++) {
                    mcu_start();
                    for (int i = 0; i < ns; i++) {
                        Comp &c = comps[sc[i]];
                        for (int by = 0; by < c.v; by++)
                            for (int bx = 0; bx < c.h; bx++)
                                block(i, c.block(my * c.v + by,
                                                 mx * c.h + bx));
                    }
                }
        } else {
            Comp &c = comps[sc[0]];
            for (int by = 0; by < c.bh_real; by++)
                for (int bx = 0; bx < c.bw_real; bx++) {
                    mcu_start();
                    block(0, c.block(by, bx));
                }
        }
        br.reset();
        pos = br.pos;
    }

    static void decode_sequential(BitReader &br, Comp &c, int16_t *blk,
                                  const Huff &dct, const Huff &act) {
        int s = dct.decode(br);
        if (s) s = extend(br.get(s), s);
        c.dc_pred += s;
        blk[0] = (int16_t)c.dc_pred;
        for (int k = 1; k < 64; k++) {
            int rs = act.decode(br);
            int r = rs >> 4;
            s = rs & 15;
            if (s) {
                k += r;
                blk[kNatural[k]] = (int16_t)extend(br.get(s), s);
            } else {
                if (r != 15) break;
                k += 15;
            }
        }
    }

    static void dc_first(BitReader &br, Comp &c, int16_t *blk,
                         const Huff &dct, int al) {
        int s = dct.decode(br);
        if (s) s = extend(br.get(s), s);
        c.dc_pred += s;
        blk[0] = (int16_t)((unsigned)c.dc_pred << al);
    }

    static void dc_refine(BitReader &br, int16_t *blk, int al) {
        if (br.get(1)) blk[0] = (int16_t)(blk[0] | (1 << al));
    }

    static void ac_first(BitReader &br, int16_t *blk, const Huff &act,
                         int ss, int se, int al, int &eobrun) {
        if (eobrun > 0) {
            eobrun--;
            return;
        }
        for (int k = ss; k <= se; k++) {
            int rs = act.decode(br);
            int r = rs >> 4, s = rs & 15;
            if (s) {
                k += r;
                int v = extend(br.get(s), s);
                blk[kNatural[k]] = (int16_t)((unsigned)v << al);
            } else if (r == 15) {
                k += 15;
            } else {
                eobrun = 1 << r;
                if (r) eobrun += br.get(r);
                eobrun--;
                break;
            }
        }
    }

    static void refine_one(BitReader &br, int16_t *coef, int p1, int m1) {
        if (br.get(1) && (*coef & p1) == 0)
            *coef = (int16_t)(*coef + (*coef >= 0 ? p1 : m1));
    }

    static void ac_refine(BitReader &br, int16_t *blk, const Huff &act,
                          int ss, int se, int al, int &eobrun) {
        int p1 = 1 << al, m1 = (int)((unsigned)-1 << al);
        int k = ss;
        if (eobrun == 0) {
            for (; k <= se; k++) {
                int rs = act.decode(br);
                int r = rs >> 4, s = rs & 15;
                if (s) {  // s must be 1 (libjpeg warns and goes on)
                    s = br.get(1) ? p1 : m1;
                } else if (r != 15) {
                    eobrun = 1 << r;
                    if (r) eobrun += br.get(r);
                    break;
                }
                do {
                    int16_t *coef = blk + kNatural[k];
                    if (*coef != 0) {
                        refine_one(br, coef, p1, m1);
                    } else {
                        if (--r < 0) break;
                    }
                    k++;
                } while (k <= se);
                if (s) blk[kNatural[k]] = (int16_t)s;
            }
        }
        if (eobrun > 0) {
            for (; k <= se; k++) {
                int16_t *coef = blk + kNatural[k];
                if (*coef != 0) refine_one(br, coef, p1, m1);
            }
            eobrun--;
        }
    }

    void parse() {
        if (n < 2 || d[0] != 0xFF || d[1] != 0xD8) corrupt("not a JPEG file");
        pos = 2;
        for (;;) {
            int m = next_marker();
            if (m == 0xD9) break;  // EOI
            switch (m) {
            case 0xC0: case 0xC1: case 0xC2:
                read_sof(m);
                break;
            case 0xC3: refuse("lossless JPEG");
            case 0xC5: case 0xC6: case 0xC7: case 0xCD: case 0xCE:
            case 0xCF:
                refuse("hierarchical JPEG");
            case 0xC9: case 0xCA: case 0xCB:
                refuse("arithmetic-coded JPEG");
            case 0xC4: read_dht(); break;
            case 0xDB: read_dqt(); break;
            case 0xDD: read_dri(); break;
            case 0xDA: read_sos(); break;
            case 0xD8: corrupt("JPEG with a second SOI");
            case 0x01: case 0xD0: case 0xD1: case 0xD2: case 0xD3:
            case 0xD4: case 0xD5: case 0xD6: case 0xD7:
                break;  // parameterless: ignored, as libjpeg does
            default:
                if (m >= 0xE0 && m <= 0xEF) {
                    read_app(m);
                } else if (m == 0xFE || m == 0xDC || m == 0xCC ||
                           m == 0xDE || m == 0xDF) {
                    size_t end;
                    segment(&end);
                    pos = end;
                } else {
                    char buf[64];
                    std::snprintf(buf, sizeof(buf),
                                  "unknown JPEG marker 0x%02X", m);
                    corrupt(buf);
                }
            }
        }
        if (!have_frame || n_scans == 0) corrupt("JPEG without image data");
    }

    // -- pixels --------------------------------------------------------------

    std::vector<uint8_t> plane(Comp &c);
    void upsample(Comp &c, const std::vector<uint8_t> &src, int stride,
                  uint8_t *dst);
    void output(uint8_t *rgb);
};

// jidctint.c's jpeg_idct_islow
const int CONST_BITS = 13, PASS1_BITS = 2;
const int64_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196,
              FIX_0_541196100 = 4433, FIX_0_765366865 = 6270,
              FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
              FIX_1_501321110 = 12299, FIX_1_847759065 = 15137,
              FIX_1_961570560 = 16069, FIX_2_053119869 = 16819,
              FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) {
    return (x + ((int64_t)1 << (n - 1))) >> n;
}

// libjpeg's sample_range_limit (+ CENTERJSAMPLE for the IDCT's index):
// the IDCT's output & 1023 through it
struct RangeLimit {
    uint8_t idct[1024];
    RangeLimit() {
        for (int v = 0; v < 1024; v++) {
            int x = v < 512 ? v : v - 1024;  // the signed value mod 1024
            int o;
            if (v < 128) o = v + 128;
            else if (v < 512) o = 255;
            else if (v < 896) o = 0;
            else o = x + 128;
            idct[v] = (uint8_t)o;
        }
    }
};
const RangeLimit kRange;

void idct_islow(const int16_t *in, const uint16_t *q, uint8_t *out,
                int stride) {
    int64_t ws[64];
    for (int c = 0; c < 8; c++) {
        const int16_t *ip = in + c;
        const uint16_t *qp = q + c;
        if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] &&
            !ip[56]) {
            int64_t dcval = (int64_t)ip[0] * qp[0] * (1 << PASS1_BITS);
            for (int r = 0; r < 8; r++) ws[r * 8 + c] = dcval;
            continue;
        }
        int64_t z2 = (int64_t)ip[16] * qp[16], z3 = (int64_t)ip[48] * qp[48];
        int64_t z1 = (z2 + z3) * FIX_0_541196100;
        int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
        int64_t tmp3 = z1 + z2 * FIX_0_765366865;
        z2 = (int64_t)ip[0] * qp[0];
        z3 = (int64_t)ip[32] * qp[32];
        int64_t tmp0 = (z2 + z3) * (1 << CONST_BITS);
        int64_t tmp1 = (z2 - z3) * (1 << CONST_BITS);
        int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
        int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        tmp0 = (int64_t)ip[56] * qp[56];
        tmp1 = (int64_t)ip[40] * qp[40];
        tmp2 = (int64_t)ip[24] * qp[24];
        tmp3 = (int64_t)ip[8] * qp[8];
        z1 = tmp0 + tmp3;
        z2 = tmp1 + tmp2;
        z3 = tmp0 + tmp2;
        int64_t z4 = tmp1 + tmp3;
        int64_t z5 = (z3 + z4) * FIX_1_175875602;
        tmp0 *= FIX_0_298631336;
        tmp1 *= FIX_2_053119869;
        tmp2 *= FIX_3_072711026;
        tmp3 *= FIX_1_501321110;
        z1 *= -FIX_0_899976223;
        z2 *= -FIX_2_562915447;
        z3 *= -FIX_1_961570560;
        z4 *= -FIX_0_390180644;
        z3 += z5;
        z4 += z5;
        tmp0 += z1 + z3;
        tmp1 += z2 + z4;
        tmp2 += z2 + z3;
        tmp3 += z1 + z4;
        const int sh = CONST_BITS - PASS1_BITS;
        ws[0 * 8 + c] = (int32_t)descale(tmp10 + tmp3, sh);
        ws[7 * 8 + c] = (int32_t)descale(tmp10 - tmp3, sh);
        ws[1 * 8 + c] = (int32_t)descale(tmp11 + tmp2, sh);
        ws[6 * 8 + c] = (int32_t)descale(tmp11 - tmp2, sh);
        ws[2 * 8 + c] = (int32_t)descale(tmp12 + tmp1, sh);
        ws[5 * 8 + c] = (int32_t)descale(tmp12 - tmp1, sh);
        ws[3 * 8 + c] = (int32_t)descale(tmp13 + tmp0, sh);
        ws[4 * 8 + c] = (int32_t)descale(tmp13 - tmp0, sh);
    }
    const int sh = CONST_BITS + PASS1_BITS + 3;
    for (int r = 0; r < 8; r++) {
        const int64_t *w = ws + r * 8;
        uint8_t *o = out + (size_t)r * stride;
        if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
            uint8_t v = kRange.idct[descale(w[0], PASS1_BITS + 3) & 1023];
            for (int c = 0; c < 8; c++) o[c] = v;
            continue;
        }
        int64_t z2 = w[2], z3 = w[6];
        int64_t z1 = (z2 + z3) * FIX_0_541196100;
        int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
        int64_t tmp3 = z1 + z2 * FIX_0_765366865;
        int64_t tmp0 = (w[0] + w[4]) * (1 << CONST_BITS);
        int64_t tmp1 = (w[0] - w[4]) * (1 << CONST_BITS);
        int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
        int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        tmp0 = w[7];
        tmp1 = w[5];
        tmp2 = w[3];
        tmp3 = w[1];
        z1 = tmp0 + tmp3;
        z2 = tmp1 + tmp2;
        z3 = tmp0 + tmp2;
        int64_t z4 = tmp1 + tmp3;
        int64_t z5 = (z3 + z4) * FIX_1_175875602;
        tmp0 *= FIX_0_298631336;
        tmp1 *= FIX_2_053119869;
        tmp2 *= FIX_3_072711026;
        tmp3 *= FIX_1_501321110;
        z1 *= -FIX_0_899976223;
        z2 *= -FIX_2_562915447;
        z3 *= -FIX_1_961570560;
        z4 *= -FIX_0_390180644;
        z3 += z5;
        z4 += z5;
        tmp0 += z1 + z3;
        tmp1 += z2 + z4;
        tmp2 += z2 + z3;
        tmp3 += z1 + z4;
        o[0] = kRange.idct[descale(tmp10 + tmp3, sh) & 1023];
        o[7] = kRange.idct[descale(tmp10 - tmp3, sh) & 1023];
        o[1] = kRange.idct[descale(tmp11 + tmp2, sh) & 1023];
        o[6] = kRange.idct[descale(tmp11 - tmp2, sh) & 1023];
        o[2] = kRange.idct[descale(tmp12 + tmp1, sh) & 1023];
        o[5] = kRange.idct[descale(tmp12 - tmp1, sh) & 1023];
        o[3] = kRange.idct[descale(tmp13 + tmp0, sh) & 1023];
        o[4] = kRange.idct[descale(tmp13 - tmp0, sh) & 1023];
    }
}

// the component's samples [bh_real * 8, bw_real * 8]
std::vector<uint8_t> Decoder::plane(Comp &c) {
    int stride = c.bw_real * 8;
    std::vector<uint8_t> out((size_t)stride * c.bh_real * 8);
    for (int by = 0; by < c.bh_real; by++)
        for (int bx = 0; bx < c.bw_real; bx++)
            idct_islow(c.block(by, bx), c.q,
                       out.data() + (size_t)by * 8 * stride + bx * 8, stride);
    return out;
}

// the component upsampled to [height, width] as jdsample.c does it
void Decoder::upsample(Comp &c, const std::vector<uint8_t> &src, int stride,
                       uint8_t *dst) {
    const int rh = hmax / c.h, rv = vmax / c.v;
    const int W = width, H = height, dw = c.ds_w, dh = c.ds_h;
    std::vector<int> row(2 * (size_t)dw + 2);
    std::vector<uint8_t> line(2 * (size_t)dw);
    for (int y = 0; y < H; y++) {
        uint8_t *o = dst + (size_t)y * W;
        const uint8_t *in0 = src.data() + (size_t)(y / rv) * stride;
        if (rv == 2) {
            int i = y / 2;
            int nb = (y & 1) ? std::min(i + 1, dh - 1) : std::max(i - 1, 0);
            const uint8_t *in1 = src.data() + (size_t)nb * stride;
            if (rh == 1) {  // h1v2: 3/4 this row + 1/4 the nearer other
                int bias = (y & 1) ? 2 : 1;
                for (int x = 0; x < W; x++)
                    o[x] = (uint8_t)((in0[x] * 3 + in1[x] + bias) >> 2);
                continue;
            }
            if (dw > 2) {  // h2v2: the column sums, then across
                int *cs = row.data();
                for (int x = 0; x < dw; x++) cs[x] = in0[x] * 3 + in1[x];
                line[0] = (uint8_t)((cs[0] * 4 + 8) >> 4);
                line[1] = (uint8_t)((cs[0] * 3 + cs[1] + 7) >> 4);
                for (int x = 1; x < dw - 1; x++) {
                    line[2 * x] = (uint8_t)((cs[x] * 3 + cs[x - 1] + 8) >> 4);
                    line[2 * x + 1] =
                        (uint8_t)((cs[x] * 3 + cs[x + 1] + 7) >> 4);
                }
                line[2 * dw - 2] =
                    (uint8_t)((cs[dw - 1] * 3 + cs[dw - 2] + 8) >> 4);
                line[2 * dw - 1] = (uint8_t)((cs[dw - 1] * 4 + 7) >> 4);
                std::memcpy(o, line.data(), (size_t)W);
                continue;
            }
            for (int x = 0; x < W; x++) o[x] = in0[x / 2];  // box
            continue;
        }
        if (rh == 1) {
            std::memcpy(o, in0, (size_t)W);
        } else if (dw > 2) {  // h2v1
            line[0] = in0[0];
            line[1] = (uint8_t)((in0[0] * 3 + in0[1] + 2) >> 2);
            for (int x = 1; x < dw - 1; x++) {
                line[2 * x] = (uint8_t)((in0[x] * 3 + in0[x - 1] + 1) >> 2);
                line[2 * x + 1] = (uint8_t)((in0[x] * 3 + in0[x + 1] + 2) >> 2);
            }
            line[2 * dw - 2] =
                (uint8_t)((in0[dw - 1] * 3 + in0[dw - 2] + 1) >> 2);
            line[2 * dw - 1] = in0[dw - 1];
            std::memcpy(o, line.data(), (size_t)W);
        } else {
            for (int x = 0; x < W; x++) o[x] = in0[x / 2];
        }
    }
}

// jdcolor.c's build_ycc_rgb_table
struct YccTables {
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    YccTables() {
        const int SCALEBITS = 16;
        const int64_t ONE_HALF = (int64_t)1 << (SCALEBITS - 1);
        auto fix = [](double x) {
            return (int64_t)(x * (1L << 16) + 0.5);
        };
        for (int i = 0, x = -128; i < 256; i++, x++) {
            cr_r[i] = (int)((fix(1.40200) * x + ONE_HALF) >> SCALEBITS);
            cb_b[i] = (int)((fix(1.77200) * x + ONE_HALF) >> SCALEBITS);
            cr_g[i] = -fix(0.71414) * x;
            cb_g[i] = -fix(0.34414) * x + ONE_HALF;
        }
    }
};
const YccTables kYcc;

inline uint8_t clamp255(int v) {
    return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
}

void Decoder::output(uint8_t *rgb) {
    const size_t npx = (size_t)width * height;
    std::vector<std::vector<uint8_t>> full(comps.size());
    for (size_t i = 0; i < comps.size(); i++) {
        Comp &c = comps[i];
        std::vector<uint8_t> p = plane(c);
        full[i].resize(npx);
        upsample(c, p, c.bw_real * 8, full[i].data());
    }
    if (comps.size() == 1) {
        const uint8_t *g = full[0].data();
        for (size_t k = 0; k < npx; k++)
            rgb[3 * k] = rgb[3 * k + 1] = rgb[3 * k + 2] = g[k];
        return;
    }
    bool is_rgb;
    if (saw_jfif) {
        is_rgb = false;
    } else if (saw_adobe) {
        is_rgb = adobe_transform == 0;
    } else {
        is_rgb = comps[0].id == 'R' && comps[1].id == 'G' &&
                 comps[2].id == 'B';
    }
    const uint8_t *a = full[0].data(), *b = full[1].data(),
                  *c = full[2].data();
    if (is_rgb) {
        for (size_t k = 0; k < npx; k++) {
            rgb[3 * k] = a[k];
            rgb[3 * k + 1] = b[k];
            rgb[3 * k + 2] = c[k];
        }
        return;
    }
    for (size_t k = 0; k < npx; k++) {
        int y = a[k], cb = b[k], cr = c[k];
        rgb[3 * k] = clamp255(y + kYcc.cr_r[cr]);
        rgb[3 * k + 1] =
            clamp255(y + (int)((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16));
        rgb[3 * k + 2] = clamp255(y + kYcc.cb_b[cb]);
    }
}

void set_err(char *err, int errlen, const std::string &m) {
    if (err && errlen > 0) {
        std::strncpy(err, m.c_str(), (size_t)errlen - 1);
        err[errlen - 1] = 0;
    }
}

}  // namespace

extern "C" int psv_jpeg_decode(const uint8_t *data, int64_t n,
                               int64_t max_pixels, int32_t *w, int32_t *h,
                               uint8_t **rgb, char *err, int errlen) {
    *rgb = nullptr;
    *w = *h = 0;
    try {
        Decoder dec(data, (size_t)n, max_pixels);
        dec.parse();
        size_t bytes = (size_t)dec.width * dec.height * 3;
        uint8_t *out = (uint8_t *)std::malloc(bytes);
        if (!out) throw std::bad_alloc();
        dec.output(out);
        *w = dec.width;
        *h = dec.height;
        *rgb = out;
        return 0;
    } catch (const JpegError &e) {
        set_err(err, errlen, e.msg);
        return e.status;
    } catch (const std::bad_alloc &) {
        set_err(err, errlen, "JPEG too large to decode in memory");
        return 1;
    }
}

extern "C" void psv_jpeg_free(uint8_t *p) { std::free(p); }
