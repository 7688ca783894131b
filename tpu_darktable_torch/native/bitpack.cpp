// JPEG entropy bit-packer: the serial tail of the encoder that does not
// belong on the TPU.  The reference delegates this to nvJPEG
// (csrc/jpeg_encoder.cu); here the device produces (code, length) emission
// streams and this packer concatenates them MSB-first with JPEG 0xFF byte
// stuffing.  Built as a plain shared library, bound via ctypes.
//
// Build: g++ -O3 -shared -fPIC -o libtdtpu.so bitpack.cpp

#include <cstdint>
#include <cstddef>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// Pack n (code, length<=32) emissions MSB-first into out with 0xFF->0xFF00
// stuffing; pads the final partial byte with 1 bits.  Returns the number of
// bytes written, or -1 if capacity would be exceeded.
long long jpeg_pack_bits(
    const uint32_t* codes,
    const uint8_t* lengths,
    long long n,
    uint8_t* out,
    long long capacity)
{
    uint64_t acc = 0;   // bit accumulator, MSB-aligned in the low `nbits` bits
    int nbits = 0;
    long long written = 0;

    for (long long i = 0; i < n; ++i) {
        int len = lengths[i];
        acc = (acc << len) | (uint64_t)(codes[i] & ((len == 32) ? 0xFFFFFFFFu : ((1u << len) - 1u)));
        nbits += len;
        while (nbits >= 8) {
            uint8_t byte = (uint8_t)(acc >> (nbits - 8));
            nbits -= 8;
            if (written + 2 > capacity) return -1;
            out[written++] = byte;
            if (byte == 0xFF) out[written++] = 0x00;
        }
    }
    if (nbits > 0) {
        uint8_t byte = (uint8_t)((acc << (8 - nbits)) | ((1u << (8 - nbits)) - 1u));
        if (written + 2 > capacity) return -1;
        out[written++] = byte;
        if (byte == 0xFF) out[written++] = 0x00;
    }
    return written;
}

// Decode packed 12-bit RAW on the host (fast path for file loaders that want
// to avoid a device round-trip).  layout 0 = standard, 1 = IDS.
void decode12_u16_host(
    const uint8_t* packed,
    uint16_t* out,
    long long n_pairs,
    int ids_format)
{
    if (ids_format) {
        for (long long i = 0; i < n_pairs; ++i) {
            const uint8_t* p = packed + i * 3;
            out[i * 2] = (uint16_t)((p[0] << 4) | (p[2] & 0xF));
            out[i * 2 + 1] = (uint16_t)((p[1] << 4) | (p[2] >> 4));
        }
    } else {
        for (long long i = 0; i < n_pairs; ++i) {
            const uint8_t* p = packed + i * 3;
            out[i * 2] = (uint16_t)(((p[1] & 0xF) << 8) | p[0]);
            out[i * 2 + 1] = (uint16_t)((p[2] << 4) | (p[1] >> 4));
        }
    }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Baseline JPEG entropy encoder: walks MCUs, Huffman-codes DC diffs and AC
// run-lengths, packs bits with 0xFF stuffing.  The DCT/quantization happens
// on the TPU; this is the serial tail (the role nvJPEG's entropy stage plays
// in the reference).
// ---------------------------------------------------------------------------

namespace {

struct BitWriter {
    uint8_t* out;
    long long cap;
    long long written = 0;
    uint64_t acc = 0;
    int nbits = 0;
    bool overflow = false;

    inline void put(uint32_t code, int len) {
        acc = (acc << len) | (uint64_t)(code & ((len >= 32) ? 0xFFFFFFFFu : ((1u << len) - 1u)));
        nbits += len;
        while (nbits >= 8) {
            uint8_t byte = (uint8_t)(acc >> (nbits - 8));
            nbits -= 8;
            if (written + 2 > cap) { overflow = true; return; }
            out[written++] = byte;
            if (byte == 0xFF) out[written++] = 0x00;
        }
    }

    inline void finish() {
        if (nbits > 0) {
            uint8_t byte = (uint8_t)((acc << (8 - nbits)) | ((1u << (8 - nbits)) - 1u));
            if (written + 2 > cap) { overflow = true; return; }
            out[written++] = byte;
            if (byte == 0xFF) out[written++] = 0x00;
        }
    }
};

inline int bit_size(int v) {
    int a = v < 0 ? -v : v;
    int n = 0;
    while (a) { ++n; a >>= 1; }
    return n;
}

inline void encode_block(
    BitWriter& bw,
    const int16_t* blk,       // 64 zigzag coefficients
    int& prev_dc,
    const uint32_t* dc_codes, const uint8_t* dc_lens,
    const uint32_t* ac_codes, const uint8_t* ac_lens)
{
    int diff = (int)blk[0] - prev_dc;
    prev_dc = (int)blk[0];
    int size = bit_size(diff);
    bw.put(dc_codes[size], dc_lens[size]);
    if (size) {
        int bits = diff >= 0 ? diff : diff - 1;
        bw.put((uint32_t)bits & ((1u << size) - 1u), size);
    }

    int run = 0;
    for (int i = 1; i < 64; ++i) {
        int v = blk[i];
        if (v == 0) { ++run; continue; }
        while (run >= 16) {
            bw.put(ac_codes[0xF0], ac_lens[0xF0]);  // ZRL
            run -= 16;
        }
        int s = bit_size(v);
        int sym = (run << 4) | s;
        bw.put(ac_codes[sym], ac_lens[sym]);
        int bits = v >= 0 ? v : v - 1;
        bw.put((uint32_t)bits & ((1u << s) - 1u), s);
        run = 0;
    }
    if (run > 0) bw.put(ac_codes[0x00], ac_lens[0x00]);  // EOB
}

}  // namespace

extern "C" {

// Encode the interleaved baseline scan.  subsampling: 0=444, 1=422, 2=GRAY.
// y/cb/cr: (n_*, 64) int16 zigzag blocks (cb/cr null for GRAY).
// Tables: 256-entry (code, len) arrays for DC/AC luma + chroma.
// Returns bytes written or -1 on overflow.
long long jpeg_encode_baseline(
    const int16_t* yb, long long ny,
    const int16_t* cbb, const int16_t* crb, long long nc,
    int subsampling,
    const uint32_t* dc0c, const uint8_t* dc0l,
    const uint32_t* ac0c, const uint8_t* ac0l,
    const uint32_t* dc1c, const uint8_t* dc1l,
    const uint32_t* ac1c, const uint8_t* ac1l,
    uint8_t* out, long long cap)
{
    BitWriter bw{out, cap};
    int pdc_y = 0, pdc_cb = 0, pdc_cr = 0;

    if (cbb == nullptr) {  // GRAY
        for (long long m = 0; m < ny; ++m)
            encode_block(bw, yb + m * 64, pdc_y, dc0c, dc0l, ac0c, ac0l);
    } else if (subsampling == 1) {  // 422: [Y0 Y1 Cb Cr] per MCU
        for (long long m = 0; m < nc; ++m) {
            encode_block(bw, yb + (2 * m) * 64, pdc_y, dc0c, dc0l, ac0c, ac0l);
            encode_block(bw, yb + (2 * m + 1) * 64, pdc_y, dc0c, dc0l, ac0c, ac0l);
            encode_block(bw, cbb + m * 64, pdc_cb, dc1c, dc1l, ac1c, ac1l);
            encode_block(bw, crb + m * 64, pdc_cr, dc1c, dc1l, ac1c, ac1l);
        }
    } else {  // 444
        for (long long m = 0; m < ny; ++m) {
            encode_block(bw, yb + m * 64, pdc_y, dc0c, dc0l, ac0c, ac0l);
            encode_block(bw, cbb + m * 64, pdc_cb, dc1c, dc1l, ac1c, ac1l);
            encode_block(bw, crb + m * 64, pdc_cr, dc1c, dc1l, ac1c, ac1l);
        }
    }
    bw.finish();
    return bw.overflow ? -1 : bw.written;
}

// Restart-interval parallel baseline scan (the on-GPU per-MCU-row entropy
// parallelism of the reference's nvJPEG, csrc/jpeg_encoder.cu:117-148,
// mapped to host threads).  The scan is split into intervals of
// `restart_interval` MCUs; each interval byte-aligns independently and DC
// predictors reset at its start, so intervals encode in parallel and are
// joined with RSTn markers (T.81 section B.2.1.2: marker index cycles 0-7).
// Output is byte-identical regardless of thread count.  Returns bytes
// written or -1 on overflow.
long long jpeg_encode_baseline_rst(
    const int16_t* yb, long long ny,
    const int16_t* cbb, const int16_t* crb, long long nc,
    int subsampling,
    const uint32_t* dc0c, const uint8_t* dc0l,
    const uint32_t* ac0c, const uint8_t* ac0l,
    const uint32_t* dc1c, const uint8_t* dc1l,
    const uint32_t* ac1c, const uint8_t* ac1l,
    long long restart_interval,
    int n_threads,
    uint8_t* out, long long cap)
{
    const bool gray = (cbb == nullptr);
    const long long n_mcu = gray ? ny : (subsampling == 1 ? nc : ny);
    if (restart_interval <= 0) restart_interval = n_mcu;
    const long long n_iv = (n_mcu + restart_interval - 1) / restart_interval;

    int hw = (int)std::thread::hardware_concurrency();
    if (n_threads <= 0) n_threads = hw > 0 ? hw : 1;
    if ((long long)n_threads > n_iv) n_threads = (int)n_iv;
    if (n_threads < 1) n_threads = 1;

    std::vector<std::vector<uint8_t>> slabs(n_threads);
    std::vector<std::vector<long long>> sizes(n_threads);

    auto encode_mcu = [&](BitWriter& bw, long long m,
                          int& py, int& pcb, int& pcr) {
        if (gray) {
            encode_block(bw, yb + m * 64, py, dc0c, dc0l, ac0c, ac0l);
        } else if (subsampling == 1) {
            encode_block(bw, yb + (2 * m) * 64, py, dc0c, dc0l, ac0c, ac0l);
            encode_block(bw, yb + (2 * m + 1) * 64, py, dc0c, dc0l, ac0c, ac0l);
            encode_block(bw, cbb + m * 64, pcb, dc1c, dc1l, ac1c, ac1l);
            encode_block(bw, crb + m * 64, pcr, dc1c, dc1l, ac1c, ac1l);
        } else {
            encode_block(bw, yb + m * 64, py, dc0c, dc0l, ac0c, ac0l);
            encode_block(bw, cbb + m * 64, pcb, dc1c, dc1l, ac1c, ac1l);
            encode_block(bw, crb + m * 64, pcr, dc1c, dc1l, ac1c, ac1l);
        }
    };

    auto worker = [&](int t) {
        const long long iv_lo = n_iv * t / n_threads;
        const long long iv_hi = n_iv * (t + 1) / n_threads;
        // Worst case ~4 bytes/coefficient after stuffing; grow as needed.
        std::vector<uint8_t>& slab = slabs[t];
        slab.resize(4096);
        long long used = 0;
        for (long long iv = iv_lo; iv < iv_hi; ++iv) {
            const long long m_lo = iv * restart_interval;
            const long long m_hi =
                (m_lo + restart_interval < n_mcu) ? m_lo + restart_interval : n_mcu;
            const long long blocks =
                (m_hi - m_lo) * (gray ? 1 : (subsampling == 1 ? 4 : 3));
            const long long need = used + blocks * 64 * 4 + 4096;
            if ((long long)slab.size() < need) slab.resize(need);
            BitWriter bw{slab.data() + used, (long long)slab.size() - used};
            int py = 0, pcb = 0, pcr = 0;
            for (long long m = m_lo; m < m_hi; ++m)
                encode_mcu(bw, m, py, pcb, pcr);
            bw.finish();
            if (bw.overflow) { sizes[t].clear(); return; }
            sizes[t].push_back(bw.written);
            used += bw.written;
        }
    };

    if (n_threads == 1) {
        worker(0);
    } else {
        std::vector<std::thread> pool;
        pool.reserve(n_threads);
        for (int t = 0; t < n_threads; ++t) pool.emplace_back(worker, t);
        for (auto& th : pool) th.join();
    }

    long long written = 0;
    long long iv_global = 0;
    for (int t = 0; t < n_threads; ++t) {
        const long long iv_lo = n_iv * t / n_threads;
        const long long iv_hi = n_iv * (t + 1) / n_threads;
        if ((long long)sizes[t].size() != iv_hi - iv_lo) return -1;  // overflow
        long long off = 0;
        for (long long sz : sizes[t]) {
            if (written + sz + 2 > cap) return -1;
            std::memcpy(out + written, slabs[t].data() + off, (size_t)sz);
            written += sz;
            off += sz;
            if (iv_global + 1 < n_iv) {  // RSTn between intervals, not after last
                out[written++] = 0xFF;
                out[written++] = (uint8_t)(0xD0 + (iv_global % 8));
            }
            ++iv_global;
        }
    }
    return written;
}

}  // extern "C"
