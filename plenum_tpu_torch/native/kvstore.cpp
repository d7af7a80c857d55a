// Native log-structured KV engine — the framework's LevelDB/RocksDB slot.
//
// Reference behavior being replaced: storage/kv_store_leveldb.py:14 /
// kv_store_rocksdb.py:15 (durable KV backends behind the KeyValueStorage
// ABC). Design is bitcask-shaped rather than an LSM: one append-only data
// file, an in-memory index of key -> (offset, length) built by replaying
// the log at open, CRC-checked records, torn-tail tolerance, and offline
// compaction that rewrites only live records. That matches this
// framework's access pattern (ledger logs and caches: point lookups,
// ordered scans of modest key sets, append-heavy writes) without the
// read-amplification machinery an LSM needs.
//
// Record format (little-endian):
//   u32 crc32(payload) | u8 op | u32 klen | u32 vlen | key | value
// op: 0 = PUT, 1 = DEL. A record with a bad CRC or truncated payload ends
// the replay (torn tail: everything before it stays durable).
//
// Exposed as a C ABI for ctypes (no pybind11 in this image).

#include <cstdint>
#include <unistd.h>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <map>
#include <string>
#include <vector>

namespace {

uint32_t crc_table[256];
bool crc_init_done = false;

void crc_init() {
    if (crc_init_done) return;
    for (uint32_t i = 0; i < 256; i++) {
        uint32_t c = i;
        for (int k = 0; k < 8; k++)
            c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
        crc_table[i] = c;
    }
    crc_init_done = true;
}

uint32_t crc32(const uint8_t* data, size_t n, uint32_t seed = 0) {
    crc_init();
    uint32_t c = seed ^ 0xFFFFFFFFu;
    for (size_t i = 0; i < n; i++)
        c = crc_table[(c ^ data[i]) & 0xFF] ^ (c >> 8);
    return c ^ 0xFFFFFFFFu;
}

struct Entry {
    uint64_t offset;   // of the value bytes inside the data file
    uint32_t vlen;
};

struct Store {
    std::string path;
    FILE* fh = nullptr;     // append handle
    FILE* rf = nullptr;     // persistent read handle (reopened on compact)
    // std::map: ordered iteration comes free, which the Python ABC's
    // (start, end) iterator contract needs
    std::map<std::string, Entry> index;
    uint64_t live_bytes = 0;    // payload bytes reachable from the index
    uint64_t total_bytes = 0;   // file size (garbage ratio = 1 - live/total)
    bool batching = false;      // kvn_begin_batch: defer fflush to batch end
    bool dirty = false;         // unflushed appends pending
};

constexpr size_t HDR = 4 + 1 + 4 + 4;

bool read_exact(FILE* f, uint8_t* buf, size_t n) {
    return fread(buf, 1, n, f) == n;
}

uint32_t rd32(const uint8_t* p) {
    return (uint32_t)p[0] | ((uint32_t)p[1] << 8) |
           ((uint32_t)p[2] << 16) | ((uint32_t)p[3] << 24);
}

void wr32(uint8_t* p, uint32_t v) {
    p[0] = v & 0xFF; p[1] = (v >> 8) & 0xFF;
    p[2] = (v >> 16) & 0xFF; p[3] = (v >> 24) & 0xFF;
}

// Replays the log; returns false only on I/O errors opening the file.
bool replay(Store* s) {
    FILE* f = fopen(s->path.c_str(), "rb");
    if (!f) return true;                 // fresh store
    std::vector<uint8_t> payload;
    uint8_t hdr[HDR];
    uint64_t off = 0;
    while (true) {
        if (!read_exact(f, hdr, HDR)) break;            // clean EOF / torn
        uint32_t crc = rd32(hdr);
        uint8_t op = hdr[4];
        uint32_t klen = rd32(hdr + 5), vlen = rd32(hdr + 9);
        if (op > 1 || klen > (1u << 28) || vlen > (1u << 30)) break;
        payload.resize((size_t)klen + vlen);
        if (!read_exact(f, payload.data(), payload.size())) break;  // torn
        uint32_t want = crc32(hdr + 4, HDR - 4);
        want = crc32(payload.data(), payload.size(), want);
        if (want != crc) break;                          // corrupt: stop
        std::string key((const char*)payload.data(), klen);
        if (op == 0) {
            auto it = s->index.find(key);
            if (it != s->index.end())
                s->live_bytes -= it->second.vlen;
            s->index[key] = Entry{off + HDR + klen, vlen};
            s->live_bytes += vlen;
        } else {
            auto it = s->index.find(key);
            if (it != s->index.end()) {
                s->live_bytes -= it->second.vlen;
                s->index.erase(it);
            }
        }
        off += HDR + klen + vlen;
    }
    fclose(f);
    s->total_bytes = off;
    // truncate any torn tail so future appends start at a clean boundary
    FILE* t = fopen(s->path.c_str(), "rb+");
    if (t) {
        fseek(t, 0, SEEK_END);
        if ((uint64_t)ftell(t) > off) {
            fflush(t);
            if (ftruncate(fileno(t), (off_t)off) != 0) { /* keep going */ }
        }
        fclose(t);
    }
    return true;
}

int append_record(Store* s, uint8_t op, const uint8_t* key, uint32_t klen,
                  const uint8_t* val, uint32_t vlen) {
    uint8_t hdr[HDR];
    hdr[4] = op;
    wr32(hdr + 5, klen);
    wr32(hdr + 9, vlen);
    uint32_t crc = crc32(hdr + 4, HDR - 4);
    crc = crc32(key, klen, crc);
    if (vlen) crc = crc32(val, vlen, crc);
    wr32(hdr, crc);
    if (fwrite(hdr, 1, HDR, s->fh) != HDR) return -1;
    if (fwrite(key, 1, klen, s->fh) != klen) return -1;
    if (vlen && fwrite(val, 1, vlen, s->fh) != vlen) return -1;
    if (s->batching) {
        s->dirty = true;        // ONE fflush at kvn_end_batch
    } else if (fflush(s->fh) != 0) {
        return -1;
    }
    s->total_bytes += HDR + klen + vlen;
    return 0;
}

}  // namespace

extern "C" {

void* kvn_open(const char* path) {
    Store* s = new Store();
    s->path = path;
    if (!replay(s)) { delete s; return nullptr; }
    s->fh = fopen(path, "ab");
    if (!s->fh) { delete s; return nullptr; }
    s->rf = fopen(path, "rb");   // may be null for a fresh file; lazily opened
    return s;
}

int kvn_put(void* h, const uint8_t* key, uint32_t klen,
            const uint8_t* val, uint32_t vlen) {
    Store* s = (Store*)h;
    uint64_t voff = s->total_bytes + HDR + klen;
    if (append_record(s, 0, key, klen, val, vlen) != 0) return -1;
    std::string k((const char*)key, klen);
    auto it = s->index.find(k);
    if (it != s->index.end()) s->live_bytes -= it->second.vlen;
    s->index[k] = Entry{voff, vlen};
    s->live_bytes += vlen;
    return 0;
}

long kvn_get(void* h, const uint8_t* key, uint32_t klen,
             uint8_t* buf, uint32_t buflen) {
    Store* s = (Store*)h;
    auto it = s->index.find(std::string((const char*)key, klen));
    if (it == s->index.end()) return -1;
    if (it->second.vlen > buflen) return (long)it->second.vlen;  // need more
    if (!s->rf) s->rf = fopen(s->path.c_str(), "rb");
    if (!s->rf) return -2;
    // reads go through the persistent handle; appends fflush, so the
    // separate read FD always sees committed records. Inside a batch the
    // flush is deferred — a read of a just-batched key forces it, keeping
    // read-your-writes exact (commit batches are write-mostly, so this
    // rarely fires).
    if (s->dirty && fflush(s->fh) == 0) s->dirty = false;
    // (a failed lazy flush keeps dirty set so kvn_end_batch retries and
    // surfaces the error; the fread below then short-reads and returns -2)
    fseek(s->rf, (long)it->second.offset, SEEK_SET);
    size_t got = fread(buf, 1, it->second.vlen, s->rf);
    return got == it->second.vlen ? (long)it->second.vlen : -2;
}

long kvn_get_len(void* h, const uint8_t* key, uint32_t klen) {
    Store* s = (Store*)h;
    auto it = s->index.find(std::string((const char*)key, klen));
    return it == s->index.end() ? -1 : (long)it->second.vlen;
}

int kvn_del(void* h, const uint8_t* key, uint32_t klen) {
    Store* s = (Store*)h;
    std::string k((const char*)key, klen);
    auto it = s->index.find(k);
    if (it == s->index.end()) return 0;
    if (append_record(s, 1, key, klen, nullptr, 0) != 0) return -1;
    s->live_bytes -= it->second.vlen;
    s->index.erase(it);
    return 0;
}

long kvn_count(void* h) {
    return (long)((Store*)h)->index.size();
}

// Group-commit mode: appends between begin/end skip the per-record fflush;
// end issues ONE flush for the whole batch. Records keep their individual
// CRC framing, so a crash mid-batch replays a valid prefix (torn-tail
// tolerance unchanged) — the grouping is a durability-latency win, not an
// atomicity guarantee (the pure-python log's _BATCH record provides that).
int kvn_begin_batch(void* h) {
    ((Store*)h)->batching = true;
    return 0;
}

int kvn_end_batch(void* h) {
    Store* s = (Store*)h;
    s->batching = false;
    if (s->dirty) {
        s->dirty = false;
        if (fflush(s->fh) != 0) return -1;
    }
    return 0;
}

// Sorted keys in [start, end) serialized as repeated (u32 klen | key).
// start/end may be empty (slen/elen 0) for open bounds. Caller frees with
// kvn_free. *out_n gets the total byte length.
uint8_t* kvn_iter_keys(void* h, const uint8_t* start, uint32_t slen,
                       const uint8_t* end, uint32_t elen, uint64_t* out_n) {
    Store* s = (Store*)h;
    std::string lo((const char*)start, slen), hi((const char*)end, elen);
    size_t total = 0;
    auto it = slen ? s->index.lower_bound(lo) : s->index.begin();
    for (auto j = it; j != s->index.end(); ++j) {
        if (elen && j->first > hi) break;   // inclusive end: KvMemory semantics
        total += 4 + j->first.size();
    }
    uint8_t* out = (uint8_t*)malloc(total ? total : 1);
    if (!out) { *out_n = 0; return nullptr; }
    uint8_t* p = out;
    for (auto j = it; j != s->index.end(); ++j) {
        if (elen && j->first > hi) break;   // inclusive end: KvMemory semantics
        wr32(p, (uint32_t)j->first.size());
        p += 4;
        memcpy(p, j->first.data(), j->first.size());
        p += j->first.size();
    }
    *out_n = total;
    return out;
}

void kvn_free(uint8_t* p) { free(p); }

// Rewrite only live records; returns 0 on success. Safe crash-wise: writes
// to path.compact then renames over the original.
int kvn_compact(void* h) {
    Store* s = (Store*)h;
    std::string tmp = s->path + ".compact";
    FILE* out = fopen(tmp.c_str(), "wb");
    if (!out) return -1;
    FILE* in = fopen(s->path.c_str(), "rb");
    if (!in) { fclose(out); return -1; }
    Store fresh;
    fresh.path = tmp;
    fresh.fh = out;
    std::vector<uint8_t> val;
    for (auto& kv : s->index) {
        val.resize(kv.second.vlen);
        fseek(in, (long)kv.second.offset, SEEK_SET);
        if (!read_exact(in, val.data(), val.size())) {
            fclose(in); fclose(out); remove(tmp.c_str()); return -2;
        }
        if (append_record(&fresh, 0, (const uint8_t*)kv.first.data(),
                          (uint32_t)kv.first.size(), val.data(),
                          (uint32_t)val.size()) != 0) {
            fclose(in); fclose(out); remove(tmp.c_str()); return -3;
        }
    }
    fclose(in);
    fclose(out);
    fclose(s->fh);
    s->fh = nullptr;
    if (s->rf) { fclose(s->rf); s->rf = nullptr; }
    if (rename(tmp.c_str(), s->path.c_str()) != 0) {
        // failed rename: the original file is intact — restore the append
        // handle so the store stays usable (a null fh would segfault puts)
        s->fh = fopen(s->path.c_str(), "ab");
        return s->fh ? -4 : -5;
    }
    // reopen + rebuild offsets (cheap: sizes known, but replay is simplest)
    s->index.clear();
    s->live_bytes = s->total_bytes = 0;
    replay(s);
    s->fh = fopen(s->path.c_str(), "ab");
    s->rf = fopen(s->path.c_str(), "rb");
    return s->fh ? 0 : -5;
}

double kvn_garbage_ratio(void* h) {
    Store* s = (Store*)h;
    if (s->total_bytes == 0) return 0.0;
    return 1.0 - (double)s->live_bytes / (double)s->total_bytes;
}

void kvn_close(void* h) {
    Store* s = (Store*)h;
    if (s->fh) fclose(s->fh);
    if (s->rf) fclose(s->rf);
    delete s;
}

}  // extern "C"
