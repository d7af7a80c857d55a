// MPT node codec: flat-list RLP encode + SHA3-256, one call.
//
// Reference behavior being replaced: the per-node `rlp.encode` +
// `hashlib.sha3_256` pair on every trie store/commit
// (state/trie/pruning_trie.py in the reference; plenum_tpu/state/trie.py
// and state/rlp.py here). Trie nodes are lists of byte strings; nodes
// with EMBEDDED (nested-list) children stay on the pure-Python twin —
// the Python caller checks flatness before dispatching here.
//
// SHA3-256 is FIPS 202 (padding 0x06), matching hashlib.sha3_256 —
// implemented in-tree so the .so needs no OpenSSL linkage.
//
// C ABI (ctypes):
//   mptc_encode_hash(n_items, lens[], concat, out_rlp, out_cap, out_hash32)
//       -> rlp length, or -1 if out_cap is too small
//   mptc_sha3_256(data, len, out32)           (differential-test surface)
//   mptc_rlp_encode(...)  encode without hashing (same args minus hash)

#include <cstdint>
#include <cstring>

// the absorb loop XORs input bytes straight into the uint64 lane array —
// correct only when lane byte order is little-endian (as Keccak specifies
// for its state serialization)
#if !defined(__BYTE_ORDER__) || __BYTE_ORDER__ != __ORDER_LITTLE_ENDIAN__
#error "mptcodec.cpp assumes a little-endian host"
#endif

namespace {

// ---------------------------------------------------------------- keccak
const uint64_t RC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808aULL,
    0x8000000080008000ULL, 0x000000000000808bULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008aULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000aULL,
    0x000000008000808bULL, 0x800000000000008bULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800aULL, 0x800000008000000aULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL};

inline uint64_t rotl(uint64_t x, int n) {
    return (x << n) | (x >> (64 - n));
}

void keccak_f(uint64_t st[25]) {
    for (int round = 0; round < 24; ++round) {
        // theta
        uint64_t bc[5];
        for (int i = 0; i < 5; ++i)
            bc[i] = st[i] ^ st[i + 5] ^ st[i + 10] ^ st[i + 15] ^ st[i + 20];
        for (int i = 0; i < 5; ++i) {
            uint64_t t = bc[(i + 4) % 5] ^ rotl(bc[(i + 1) % 5], 1);
            for (int j = 0; j < 25; j += 5) st[j + i] ^= t;
        }
        // rho + pi
        uint64_t t = st[1];
        static const int piln[24] = {10, 7,  11, 17, 18, 3,  5,  16,
                                     8,  21, 24, 4,  15, 23, 19, 13,
                                     12, 2,  20, 14, 22, 9,  6,  1};
        static const int rotc[24] = {1,  3,  6,  10, 15, 21, 28, 36,
                                     45, 55, 2,  14, 27, 41, 56, 8,
                                     25, 43, 62, 18, 39, 61, 20, 44};
        for (int i = 0; i < 24; ++i) {
            int j = piln[i];
            uint64_t tmp = st[j];
            st[j] = rotl(t, rotc[i]);
            t = tmp;
        }
        // chi
        for (int j = 0; j < 25; j += 5) {
            uint64_t b[5];
            for (int i = 0; i < 5; ++i) b[i] = st[j + i];
            for (int i = 0; i < 5; ++i)
                st[j + i] = b[i] ^ ((~b[(i + 1) % 5]) & b[(i + 2) % 5]);
        }
        st[0] ^= RC[round];
    }
}

void sha3_256(const uint8_t* data, size_t len, uint8_t out[32]) {
    const size_t rate = 136;  // 1088-bit rate for SHA3-256
    uint64_t st[25];
    std::memset(st, 0, sizeof(st));
    uint8_t* bytes = reinterpret_cast<uint8_t*>(st);
    // absorb
    while (len >= rate) {
        for (size_t i = 0; i < rate; ++i) bytes[i] ^= data[i];
        keccak_f(st);
        data += rate;
        len -= rate;
    }
    for (size_t i = 0; i < len; ++i) bytes[i] ^= data[i];
    bytes[len] ^= 0x06;        // FIPS 202 SHA3 domain padding
    bytes[rate - 1] ^= 0x80;
    keccak_f(st);
    std::memcpy(out, bytes, 32);
}

// ------------------------------------------------------------------- rlp
// length prefix into out; returns bytes written
size_t len_prefix(size_t length, uint8_t offset, uint8_t* out) {
    if (length < 56) {
        out[0] = offset + static_cast<uint8_t>(length);
        return 1;
    }
    uint8_t tmp[8];
    size_t n = 0;
    size_t v = length;
    while (v) {
        tmp[n++] = static_cast<uint8_t>(v & 0xff);
        v >>= 8;
    }
    out[0] = offset + 55 + static_cast<uint8_t>(n);
    for (size_t i = 0; i < n; ++i) out[1 + i] = tmp[n - 1 - i];
    return 1 + n;
}

// flat list of byte strings -> RLP; returns length or -1 if cap too small
long rlp_flat(int32_t n_items, const uint32_t* lens, const uint8_t* concat,
              uint8_t* out, size_t cap) {
    // worst case per item: 9-byte prefix + payload; header: 9
    if (cap < 18) return -1;   // room for header staging even when empty
    uint8_t hdr_buf[16];
    // encode items into out after a max header gap, then move
    size_t payload = 0;
    {
        size_t off = 0;
        size_t pos = 9;  // leave room for the largest possible list header
        for (int32_t i = 0; i < n_items; ++i) {
            const uint8_t* item = concat + off;
            size_t il = lens[i];
            size_t need = pos + 9 + il;
            if (need > cap) return -1;
            if (il == 1 && item[0] < 0x80) {
                out[pos++] = item[0];
            } else {
                pos += len_prefix(il, 0x80, out + pos);
                std::memcpy(out + pos, item, il);
                pos += il;
            }
            off += il;
        }
        payload = pos - 9;
    }
    size_t hl = len_prefix(payload, 0xc0, hdr_buf);
    std::memmove(out + hl, out + 9, payload);
    std::memcpy(out, hdr_buf, hl);
    return static_cast<long>(hl + payload);
}

}  // namespace

extern "C" {

void mptc_sha3_256(const uint8_t* data, uint64_t len, uint8_t* out32) {
    sha3_256(data, static_cast<size_t>(len), out32);
}

long mptc_rlp_encode(int32_t n_items, const uint32_t* lens,
                     const uint8_t* concat, uint8_t* out, uint64_t cap) {
    return rlp_flat(n_items, lens, concat, out, static_cast<size_t>(cap));
}

long mptc_encode_hash(int32_t n_items, const uint32_t* lens,
                      const uint8_t* concat, uint8_t* out, uint64_t cap,
                      uint8_t* out_hash32) {
    long n = rlp_flat(n_items, lens, concat, out, static_cast<size_t>(cap));
    if (n < 0) return n;
    sha3_256(out, static_cast<size_t>(n), out_hash32);
    return n;
}

// Batch encode+hash with BACKREFS: the trie's whole dirty set for a 3PC
// batch in ONE call (per-node ctypes dispatch measured ~2x slower than
// Python; the batch amortizes it). Nodes arrive in post-order (children
// before parents). Item tags:
//   -1  literal byte string (RLP string-encode; next chunk of concat)
//   -2  raw RLP splice (pre-encoded inline child; next chunk of concat)
//   j>=0 backref to node j: splice node j's RLP raw when it is <32 bytes
//        (an inline child, per the MPT ref rule), else string-encode its
//        32-byte SHA3 from out_hashes
// `lens` has one entry PER CHUNK (tag<0 items in order), not per item —
// the Python caller builds it with a single map(len, chunks).
// Node RLPs are written contiguously into out; out_lens[i] and
// out_hashes[32*i..] are filled for EVERY node. Returns total bytes,
// -1 on cap overflow, -2 on a forward backref.
long mptc_encode_hash_batch(int32_t n_nodes, const int32_t* item_counts,
                            const int32_t* tags, const uint32_t* lens,
                            const uint8_t* concat, uint8_t* out,
                            uint64_t cap64, uint32_t* out_lens,
                            uint8_t* out_hashes) {
    const size_t cap = static_cast<size_t>(cap64);
    uint64_t* offs = new uint64_t[n_nodes > 0 ? n_nodes : 1];
    size_t cursor = 0;     // next write position in out
    size_t item_idx = 0;
    size_t chunk_idx = 0;
    size_t data_off = 0;
    for (int32_t ni = 0; ni < n_nodes; ++ni) {
        const size_t node_off = cursor;
        size_t pos = node_off + 9;    // gap for the largest list header
        if (pos + 9 > cap) { delete[] offs; return -1; }
        for (int32_t k = 0; k < item_counts[ni]; ++k, ++item_idx) {
            const int32_t tag = tags[item_idx];
            if (tag == -1) {
                const size_t il = lens[chunk_idx++];
                if (pos + 9 + il > cap) { delete[] offs; return -1; }
                const uint8_t* item = concat + data_off;
                if (il == 1 && item[0] < 0x80) {
                    out[pos++] = item[0];
                } else {
                    pos += len_prefix(il, 0x80, out + pos);
                    std::memcpy(out + pos, item, il);
                    pos += il;
                }
                data_off += il;
            } else if (tag == -2) {
                const size_t il = lens[chunk_idx++];
                if (pos + il > cap) { delete[] offs; return -1; }
                std::memcpy(out + pos, concat + data_off, il);
                pos += il;
                data_off += il;
            } else {
                if (tag >= ni) { delete[] offs; return -2; }
                const uint32_t cl = out_lens[tag];
                if (cl < 32) {    // inline child: splice its RLP raw
                    if (pos + cl > cap) { delete[] offs; return -1; }
                    std::memcpy(out + pos, out + offs[tag], cl);
                    pos += cl;
                } else {          // hashed child: 0xa0 + 32-byte digest
                    if (pos + 33 > cap) { delete[] offs; return -1; }
                    out[pos++] = 0x80 + 32;
                    std::memcpy(out + pos,
                                out_hashes + 32 * static_cast<size_t>(tag),
                                32);
                    pos += 32;
                }
            }
        }
        const size_t payload = pos - (node_off + 9);
        uint8_t hdr[16];
        const size_t hl = len_prefix(payload, 0xc0, hdr);
        std::memmove(out + node_off + hl, out + node_off + 9, payload);
        std::memcpy(out + node_off, hdr, hl);
        const size_t total = hl + payload;
        out_lens[ni] = static_cast<uint32_t>(total);
        offs[ni] = node_off;
        sha3_256(out + node_off, total,
                 out_hashes + 32 * static_cast<size_t>(ni));
        cursor = node_off + total;
    }
    delete[] offs;
    return static_cast<long>(cursor);
}

}  // extern "C"
