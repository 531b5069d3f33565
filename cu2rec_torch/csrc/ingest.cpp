// Fast ratings-CSV ingest and export for cu2rec_torch (host C++).
//
// Native replacement for the reference's host-side line-by-line ifstream
// parser (reference matrix_factorization/util.cu:17-45): Netflix-scale files
// (~100M rows) are mmapped and parsed with hand-rolled integer/float
// scanning, multi-threaded over byte ranges, then written straight into
// caller-provided numpy buffers via ctypes — no Python-object churn.
//
// Contract (matches readCSV): rows are `userId<delim>itemId<delim>rating`,
// 1-based ids; the caller handles header skipping via `skip_lines`,
// 0-basing, max-id counting and mean computation (cheap vector ops in
// numpy).  Malformed lines are skipped, like ifstream >> would stop; we are
// more lenient and keep going.
//
// Build: cu2rec_torch/csrc/build.py (g++ -O3 -std=c++17 -fPIC -shared
// -lpthread) into build/cu2rec_torch/<hash>/libingest.so, loaded by
// cu2rec_torch/data/native.py.  A plain C ABI; no device code.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <fcntl.h>
#include <locale.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#include <string>
#include <thread>
#include <vector>

namespace {

// The %f writer and strtof reader promise byte-compatibility with the
// Python csv path, which always formats with '.' decimals.  snprintf and
// strtof are LC_NUMERIC-sensitive, so every worker thread pins itself to
// the C numeric locale for its lifetime (snprintf_l is BSD-only; on Linux
// the per-thread uselocale is the portable equivalent).
locale_t c_numeric_locale() {
    static locale_t loc = newlocale(LC_NUMERIC_MASK, "C", (locale_t)0);
    return loc;
}

struct ScopedCLocale {
    locale_t old;
    ScopedCLocale() : old(uselocale(c_numeric_locale())) {}
    ~ScopedCLocale() { uselocale(old); }
};

struct Chunk {
    const char* begin;
    const char* end;
    std::vector<int64_t> users;
    std::vector<int64_t> items;
    std::vector<float> ratings;
};

inline const char* parse_int(const char* p, const char* end, int64_t* out, bool* ok) {
    int64_t v = 0;
    bool neg = false;
    if (p < end && (*p == '-' || *p == '+')) { neg = (*p == '-'); ++p; }
    const char* start = p;
    while (p < end && *p >= '0' && *p <= '9') { v = v * 10 + (*p - '0'); ++p; }
    *ok = (p != start);
    *out = neg ? -v : v;
    return p;
}

inline const char* parse_float(const char* p, const char* end, double* out, bool* ok) {
    double v = 0.0;
    bool neg = false;
    if (p < end && (*p == '-' || *p == '+')) { neg = (*p == '-'); ++p; }
    const char* start = p;
    while (p < end && *p >= '0' && *p <= '9') { v = v * 10.0 + (*p - '0'); ++p; }
    if (p < end && *p == '.') {
        ++p;
        double scale = 0.1;
        while (p < end && *p >= '0' && *p <= '9') { v += (*p - '0') * scale; scale *= 0.1; ++p; }
    }
    if (p < end && (*p == 'e' || *p == 'E')) {
        ++p;
        int64_t e; bool eok;
        p = parse_int(p, end, &e, &eok);
        if (eok) {
            double f = e < 0 ? 0.1 : 10.0;
            for (int64_t k = e < 0 ? -e : e; k > 0; --k) v *= f;
        }
    }
    *ok = (p != start);
    *out = neg ? -v : v;
    return p;
}

inline const char* skip_ws(const char* p, const char* end) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
    return p;
}

// Skip whitespace, then the delimiter (or treat whitespace itself as the
// separator, like ifstream >> does for space-delimited files).
inline const char* skip_sep(const char* p, const char* end, char delim,
                            bool* ok) {
    const char* q = skip_ws(p, end);
    if (q < end && *q == delim) { *ok = true; return skip_ws(q + 1, end); }
    *ok = (q != p);  // pure-whitespace separator
    return q;
}

void parse_chunk(Chunk* c, char delim) {
    const char* p = c->begin;
    const char* end = c->end;
    size_t approx = (size_t)((end - p) / 12) + 16;
    c->users.reserve(approx);
    c->items.reserve(approx);
    c->ratings.reserve(approx);
    while (p < end) {
        const char* line_end = (const char*)memchr(p, '\n', end - p);
        if (!line_end) line_end = end;
        int64_t u, i;
        double r;
        bool ok1, ok2, ok3, s1, s2;
        const char* q = parse_int(skip_ws(p, line_end), line_end, &u, &ok1);
        if (ok1) {
            q = skip_sep(q, line_end, delim, &s1);
            q = parse_int(q, line_end, &i, &ok2);
            if (s1 && ok2) {
                q = skip_sep(q, line_end, delim, &s2);
                q = parse_float(q, line_end, &r, &ok3);
                if (s2 && ok3) {
                    c->users.push_back(u);
                    c->items.push_back(i);
                    c->ratings.push_back((float)r);
                }
            }
        }
        p = line_end + 1;
    }
}

}  // namespace

extern "C" {

// Pass 1: count parseable rows and parse into thread-local buffers held in a
// session object; pass 2 copies into caller buffers.  Exposed as a simple
// two-call API so ctypes callers can allocate exact-size numpy arrays.
struct IngestResult {
    std::vector<Chunk> chunks;
    int64_t total;
};

void* cu2rec_ingest_open(const char* path, char delim, int skip_lines) {
    int fd = open(path, O_RDONLY);
    if (fd < 0) return nullptr;
    struct stat st;
    if (fstat(fd, &st) != 0 || st.st_size == 0) { close(fd); return nullptr; }
    size_t size = (size_t)st.st_size;
    const char* base = (const char*)mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0);
    close(fd);
    if (base == MAP_FAILED) return nullptr;

    const char* p = base;
    const char* end = base + size;
    for (int s = 0; s < skip_lines && p < end; ++s) {
        const char* nl = (const char*)memchr(p, '\n', end - p);
        p = nl ? nl + 1 : end;
    }

    unsigned hw = std::thread::hardware_concurrency();
    size_t n_threads = hw ? hw : 4;
    size_t span = (size_t)(end - p);
    if (span < (64u << 10)) n_threads = 1;

    IngestResult* res = new IngestResult();
    res->chunks.resize(n_threads);
    // Split on newline boundaries.
    const char* cur = p;
    for (size_t t = 0; t < n_threads; ++t) {
        const char* cend;
        if (t + 1 == n_threads) {
            cend = end;
        } else {
            cend = p + span * (t + 1) / n_threads;
            const char* nl = (const char*)memchr(cend, '\n', end - cend);
            cend = nl ? nl + 1 : end;
        }
        if (cend < cur) cend = cur;
        res->chunks[t].begin = cur;
        res->chunks[t].end = cend;
        cur = cend;
    }
    std::vector<std::thread> workers;
    for (size_t t = 1; t < n_threads; ++t)
        workers.emplace_back(parse_chunk, &res->chunks[t], delim);
    parse_chunk(&res->chunks[0], delim);
    for (auto& w : workers) w.join();

    res->total = 0;
    for (auto& c : res->chunks) res->total += (int64_t)c.users.size();
    munmap((void*)base, size);
    return res;
}

int64_t cu2rec_ingest_count(void* handle) {
    return handle ? ((IngestResult*)handle)->total : -1;
}

void cu2rec_ingest_copy(void* handle, int64_t* users, int64_t* items, float* ratings) {
    IngestResult* res = (IngestResult*)handle;
    int64_t off = 0;
    for (auto& c : res->chunks) {
        size_t n = c.users.size();
        if (n) {
            memcpy(users + off, c.users.data(), n * sizeof(int64_t));
            memcpy(items + off, c.items.data(), n * sizeof(int64_t));
            memcpy(ratings + off, c.ratings.data(), n * sizeof(float));
        }
        off += (int64_t)n;
    }
}

void cu2rec_ingest_close(void* handle) {
    delete (IngestResult*)handle;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Parallel CSR build: counting-sort ratings by user (stable), then sort each
// user's slice by item id.  Replaces np.lexsort + cumsum, which dominates
// host-side prep at Netflix scale (~100M rows).  The host-side equivalent
// of the reference's createSparseMatrix precondition pipeline
// (util.cu:152-179 + preprocessing/sort_ratings.py).
// ---------------------------------------------------------------------------

#include <algorithm>
#include <atomic>

extern "C" {

// users/items: int32 0-based; ratings float32; n rows.
// Outputs (caller-allocated): indptr int32[n_users+1],
// out_items int32[n], out_ratings float32[n].
// Returns 0 on success, -1 on invalid input (user id out of range).
int cu2rec_csr_build(const int32_t* users, const int32_t* items,
                     const float* ratings, int64_t n, int32_t n_users,
                     int32_t* indptr, int32_t* out_items,
                     float* out_ratings) {
    std::vector<int64_t> counts(n_users + 1, 0);
    for (int64_t i = 0; i < n; ++i) {
        int32_t u = users[i];
        if (u < 0 || u >= n_users) return -1;
        ++counts[u + 1];
    }
    for (int32_t u = 0; u < n_users; ++u) counts[u + 1] += counts[u];
    for (int32_t u = 0; u <= n_users; ++u) indptr[u] = (int32_t)counts[u];

    std::vector<int64_t> cursor(counts.begin(), counts.end() - 1);
    for (int64_t i = 0; i < n; ++i) {
        int64_t dst = cursor[users[i]]++;
        out_items[dst] = items[i];
        out_ratings[dst] = ratings[i];
    }

    // Per-user (item, rating) sort, parallel over user ranges.
    unsigned hw = std::thread::hardware_concurrency();
    size_t n_threads = hw ? hw : 4;
    std::atomic<int32_t> next_user(0);
    const int32_t chunk = 1024;
    auto worker = [&]() {
        std::vector<std::pair<int32_t, float>> buf;
        for (;;) {
            int32_t u0 = next_user.fetch_add(chunk);
            if (u0 >= n_users) break;
            int32_t u1 = std::min(u0 + chunk, n_users);
            for (int32_t u = u0; u < u1; ++u) {
                int64_t lo = counts[u], hi = counts[u + 1];
                int64_t len = hi - lo;
                if (len < 2) continue;
                buf.resize(len);
                for (int64_t k = 0; k < len; ++k)
                    buf[k] = {out_items[lo + k], out_ratings[lo + k]};
                std::sort(buf.begin(), buf.end(),
                          [](const auto& a, const auto& b) {
                              return a.first < b.first;
                          });
                for (int64_t k = 0; k < len; ++k) {
                    out_items[lo + k] = buf[k].first;
                    out_ratings[lo + k] = buf[k].second;
                }
            }
        }
    };
    std::vector<std::thread> workers;
    for (size_t t = 1; t < n_threads; ++t) workers.emplace_back(worker);
    worker();
    for (auto& w : workers) w.join();
    return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Fast ratings-CSV writer: the inverse of the ingest path, used by the
// planted-synthetic data generator to materialize ML-20M/Netflix-scale
// files for the full CLI journey (write_to_file contract of the
// reference's preprocessing/map_items.py:80-89: `userId,itemId,rating`
// rows, 1-based ids, optional header).  Rows are formatted in parallel
// into per-thread buffers, then written sequentially in order.
// ---------------------------------------------------------------------------

extern "C" {

// users/items 0-based int32 (written 1-based); ratings float32.
// Returns 0 on success, -1 on I/O failure.
// ---------------------------------------------------------------------------
// Component-matrix CSV writer/reader: the export/restore path of the
// trained model (reference writeCSV util.cu:86-97 / read_array
// util.cu:52-81).  At Netflix scale a component is ~144M values
// (480K users x 300 factors); the pure-Python per-value loop in
// data/ratings.py takes minutes there, so both directions get native
// fast paths.  Format contract is byte-compatible with the Python
// writer: one row per line, comma-separated, each value printf("%f")
// (6 decimals), no trailing separator.
// ---------------------------------------------------------------------------

// data: row-major float32.  Returns 0 on success, -1 on I/O failure.
//
// Serialization runs in waves of n_threads fixed-size row blocks so the
// transient buffer footprint is bounded (~1M values of text per thread,
// not the whole file — a 144M-value Netflix component would otherwise
// hold ~1.5 GB of serialized text in RAM at once); buffers are reused
// across waves and written to disk in row order between waves.
int cu2rec_write_matrix(const char* path, const float* data, int64_t rows,
                        int64_t cols) {
    if (rows < 0 || cols <= 0) return -1;
    FILE* f = fopen(path, "wb");
    if (!f) return -1;
    unsigned hw = std::thread::hardware_concurrency();
    size_t n_threads = hw ? hw : 4;
    if ((size_t)rows < n_threads) n_threads = rows ? (size_t)rows : 1;
    const int64_t block_rows =
        std::max<int64_t>(1, (int64_t)(1u << 20) / cols);
    std::vector<std::string> bufs(n_threads);
    int rc = 0;
    for (int64_t wave = 0; wave < rows && rc == 0;
         wave += block_rows * (int64_t)n_threads) {
        auto worker = [&](size_t t) {
            ScopedCLocale locale_guard;
            std::string& out = bufs[t];
            out.clear();
            int64_t lo = wave + (int64_t)t * block_rows;
            int64_t hi = std::min(lo + block_rows, rows);
            if (lo >= hi) return;
            out.reserve((size_t)(hi - lo) * (size_t)cols * 10);
            char val[48];
            for (int64_t r = lo; r < hi; ++r) {
                const float* row = data + r * cols;
                for (int64_t c = 0; c < cols; ++c) {
                    int len = snprintf(val, sizeof val, c ? ",%f" : "%f",
                                       (double)row[c]);
                    out.append(val, (size_t)len);
                }
                out.push_back('\n');
            }
        };
        std::vector<std::thread> workers;
        for (size_t t = 1; t < n_threads; ++t) workers.emplace_back(worker, t);
        worker(0);
        for (auto& w : workers) w.join();
        for (auto& b : bufs)
            if (b.size() && fwrite(b.data(), 1, b.size(), f) != b.size())
                rc = -1;
    }
    if (fclose(f) != 0) rc = -1;
    return rc;
}

// Writer variant for the id-mapper (preprocessing/map_items.py:80-89
// contract): ids are written AS GIVEN (the caller passes 1-based mapped
// ids), and the rating column is an index into a table of preformatted
// value strings — real datasets have a tiny rating vocabulary (10 values
// for MovieLens halves, 5 for Netflix), so the file reproduces Python's
// str(float(r)) byte-for-byte without any per-row float formatting.
// table: n_vals entries of `stride` bytes each, NUL-padded (numpy 'S'
// array); vidx: per-row int64 index into the table.
namespace {

// Minimal unsigned itoa (mapped ids are always positive): ~5x faster than
// snprintf, which dominated the write stage at 100M rows.
inline char* format_u64(char* p, uint64_t v) {
    char tmp[20];
    int k = 0;
    do { tmp[k++] = (char)('0' + v % 10); v /= 10; } while (v);
    while (k) *p++ = tmp[--k];
    return p;
}

}  // namespace

int cu2rec_write_ratings_mapped(const char* path, const int64_t* users,
                                const int64_t* items, const int64_t* vidx,
                                const char* table, int64_t stride,
                                int64_t n_vals, int64_t n,
                                const char* header) {
    if (stride <= 0 || n_vals <= 0) return -1;
    for (int64_t i = 0; i < n; ++i)
        if (vidx[i] < 0 || vidx[i] >= n_vals) return -1;
    FILE* f = fopen(path, "wb");
    if (!f) return -1;
    if (header && header[0]) {
        fputs(header, f);
        fputc('\n', f);
    }
    std::vector<size_t> vlen((size_t)n_vals);
    for (int64_t v = 0; v < n_vals; ++v)
        vlen[(size_t)v] = strnlen(table + v * stride, (size_t)stride);
    unsigned hw = std::thread::hardware_concurrency();
    size_t n_threads = hw ? hw : 4;
    const int64_t block_rows = 4 << 20;
    std::vector<std::string> bufs(n_threads);
    int rc = 0;
    for (int64_t wave = 0; wave < n && rc == 0;
         wave += block_rows * (int64_t)n_threads) {
        auto worker = [&](size_t t) {
            std::string& out = bufs[t];
            out.clear();
            int64_t lo = wave + (int64_t)t * block_rows;
            int64_t hi = std::min(lo + block_rows, n);
            if (lo >= hi) return;
            out.reserve((size_t)(hi - lo) * 20);
            char line[64];
            for (int64_t i = lo; i < hi; ++i) {
                char* p = format_u64(line, (uint64_t)users[i]);
                *p++ = ',';
                p = format_u64(p, (uint64_t)items[i]);
                *p++ = ',';
                out.append(line, (size_t)(p - line));
                out.append(table + vidx[i] * stride,
                           vlen[(size_t)vidx[i]]);
                out.push_back('\n');
            }
        };
        std::vector<std::thread> workers;
        for (size_t t = 1; t < n_threads; ++t) workers.emplace_back(worker, t);
        worker(0);
        for (auto& w : workers) w.join();
        for (auto& b : bufs)
            if (b.size() && fwrite(b.data(), 1, b.size(), f) != b.size())
                rc = -1;
    }
    if (fclose(f) != 0) rc = -1;
    return rc;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// First-appearance id factorization + fused sort-by-user: the two host
// stages of the id-mapping journey (reference preprocessing/map_items.py
// assignment rule :40-54 and sort :64-77) that NumPy can only express as
// O(n log n) sorts of the full 100M-row column.  Here: a single-pass
// open-addressing hash (O(n)) and a stable counting-sort scatter.
// ---------------------------------------------------------------------------

namespace {

inline uint64_t splitmix64(uint64_t x) {
    x += 0x9e3779b97f4a7c15ull;
    x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ull;
    x = (x ^ (x >> 27)) * 0x94d049bb133111ebull;
    return x ^ (x >> 31);
}

// Open-addressing int64→int64 map, linear probing, 16-byte entries so a
// probe costs one cache line.  Empty slot sentinel: key == INT64_MIN
// (callers reject that id value up front).
struct I64Map {
    struct Entry { int64_t k, v; };
    std::vector<Entry> slots;
    size_t mask = 0;
    size_t filled = 0;
    static constexpr int64_t kEmpty = INT64_MIN;

    explicit I64Map(size_t expect) {
        size_t cap = 1024;
        while (cap * 5 < expect * 8) cap <<= 1;  // keep load < 62.5%
        slots.assign(cap, {kEmpty, 0});
        mask = cap - 1;
    }
    void grow() {
        std::vector<Entry> old;
        old.swap(slots);
        slots.assign(old.size() * 2, {kEmpty, 0});
        mask = slots.size() - 1;
        for (const Entry& e : old)
            if (e.k != kEmpty) {
                size_t h = splitmix64((uint64_t)e.k) & mask;
                while (slots[h].k != kEmpty) h = (h + 1) & mask;
                slots[h] = e;
            }
    }
    // Returns slot index of key (existing or freshly claimed with val=-1
    // when insert); claimed slots must be assigned by the caller.
    inline int64_t* find(int64_t key) {
        size_t h = splitmix64((uint64_t)key) & mask;
        for (;;) {
            if (slots[h].k == key) return &slots[h].v;
            if (slots[h].k == kEmpty) return nullptr;
            h = (h + 1) & mask;
        }
    }
    inline int64_t* insert(int64_t key, int64_t val, bool* fresh) {
        if ((filled + 1) * 8 >= slots.size() * 5) grow();
        size_t h = splitmix64((uint64_t)key) & mask;
        for (;;) {
            if (slots[h].k == key) { *fresh = false; return &slots[h].v; }
            if (slots[h].k == kEmpty) {
                slots[h] = {key, val};
                ++filled;
                *fresh = true;
                return &slots[h].v;
            }
            h = (h + 1) & mask;
        }
    }
};

}  // namespace

extern "C" {

// First-appearance factorization (the reference's dict rule, map_items.py
// :40-54): codes[i] = mapped value of ids[i].  The pre-existing mapping is
// passed as (ex_keys, ex_vals, nk); new ids are assigned next_val,
// next_val+1, ... in first-appearance order and their RAW keys are
// appended to new_keys (capacity uniq_cap).  With add_missing=0 unknown
// ids get code 0 and are not added.  Returns the count of new ids, or -1
// on error (id == INT64_MIN, or more than uniq_cap new ids).
int64_t cu2rec_factorize(const int64_t* ids, int64_t n,
                         const int64_t* ex_keys, const int64_t* ex_vals,
                         int64_t nk, int64_t next_val, int add_missing,
                         int64_t* codes, int64_t* new_keys,
                         int64_t uniq_cap) {
    I64Map map((size_t)nk + (size_t)std::min<int64_t>(n, 1 << 20));
    for (int64_t j = 0; j < nk; ++j) {
        if (ex_keys[j] == I64Map::kEmpty) return -1;
        bool fresh;
        map.insert(ex_keys[j], ex_vals[j], &fresh);
    }
    int64_t n_new = 0;
    if (add_missing) {
        for (int64_t i = 0; i < n; ++i) {
            int64_t id = ids[i];
            if (id == I64Map::kEmpty) return -1;
            bool fresh;
            int64_t* v = map.insert(id, next_val + n_new, &fresh);
            if (fresh) {
                if (n_new >= uniq_cap) return -1;
                new_keys[n_new++] = id;
            }
            codes[i] = *v;
        }
    } else {
        for (int64_t i = 0; i < n; ++i) {
            int64_t id = ids[i];
            if (id == I64Map::kEmpty) return -1;
            int64_t* v = map.find(id);
            codes[i] = v ? *v : 0;
        }
    }
    return n_new;
}

// Fused stable sort-by-user: scatter (users, items, ratings) rows into
// user-sorted order in ONE parallel pass (stable — within-user file order
// preserved, matching the reference's per-user list append,
// map_items.py:65-77).  users are 1-based mapped ids in [1, n_users].
// Returns 0 on success, -1 if any user id is out of range.
int cu2rec_sort_ratings_by_user(const int64_t* users, const int64_t* items,
                                const float* ratings, int64_t n,
                                int64_t n_users, int64_t* out_u,
                                int64_t* out_i, float* out_r) {
    unsigned hw = std::thread::hardware_concurrency();
    size_t n_threads = hw ? hw : 4;
    if (n < (int64_t)(1 << 16)) n_threads = 1;
    // Per-thread per-user counts → exclusive prefix = each thread's
    // starting cursor per user, preserving (thread block, file order)
    // stability.
    std::vector<std::vector<int64_t>> counts(
        n_threads, std::vector<int64_t>((size_t)n_users, 0));
    std::vector<int64_t> bounds(n_threads + 1);
    for (size_t t = 0; t <= n_threads; ++t)
        bounds[t] = (int64_t)((__int128)n * t / n_threads);
    std::atomic<int> bad(0);
    auto count_worker = [&](size_t t) {
        std::vector<int64_t>& c = counts[t];
        for (int64_t i = bounds[t]; i < bounds[t + 1]; ++i) {
            int64_t u = users[i] - 1;
            if (u < 0 || u >= n_users) { bad.store(1); return; }
            ++c[(size_t)u];
        }
    };
    std::vector<std::thread> workers;
    for (size_t t = 1; t < n_threads; ++t)
        workers.emplace_back(count_worker, t);
    count_worker(0);
    for (auto& w : workers) w.join();
    workers.clear();
    if (bad.load()) return -1;
    // cursor[t][u] = global start of thread t's run of user u.
    int64_t run = 0;
    for (int64_t u = 0; u < n_users; ++u)
        for (size_t t = 0; t < n_threads; ++t) {
            int64_t c = counts[t][(size_t)u];
            counts[t][(size_t)u] = run;
            run += c;
        }
    auto scatter_worker = [&](size_t t) {
        std::vector<int64_t>& cursor = counts[t];
        for (int64_t i = bounds[t]; i < bounds[t + 1]; ++i) {
            int64_t dst = cursor[(size_t)(users[i] - 1)]++;
            out_u[dst] = users[i];
            out_i[dst] = items[i];
            out_r[dst] = ratings[i];
        }
    };
    for (size_t t = 1; t < n_threads; ++t)
        workers.emplace_back(scatter_worker, t);
    scatter_worker(0);
    for (auto& w : workers) w.join();
    return 0;
}

}  // extern "C"

namespace {

struct MatrixResult {
    std::vector<std::vector<float>> chunks;   // parsed values, in file order
    std::vector<int64_t> chunk_rows;
    int64_t rows = 0;
    int64_t cols = -1;
    bool failed = false;
};

// Parse one newline-aligned byte range of a matrix CSV.  Values are
// decoded with strtof (correctly rounded, matching Python float()) on a
// NUL-terminated copy of the chunk; blank lines are skipped like the
// Python reader's `if not line: continue`.  Sets *cols to the column
// count (must be uniform within the chunk).  On malformed/ragged input
// sets *failed, zeroes *nrows and clears *out so a partially-parsed bad
// chunk can never inflate the copy size past rows*cols (a chunk whose
// FIRST line is malformed ends with nrows==0, so failure must be
// signalled distinctly from "chunk held only blank lines").
void parse_matrix_chunk(const char* begin, const char* end,
                        std::vector<float>* out, int64_t* nrows,
                        int64_t* cols, bool* failed) {
    ScopedCLocale locale_guard;
    *nrows = 0;
    *cols = -1;
    *failed = false;
    auto fail = [&]() {
        out->clear();
        *nrows = 0;
        *cols = -1;
        *failed = true;
    };
    std::string copy(begin, (size_t)(end - begin));
    copy.push_back('\0');
    char* p = copy.data();
    char* cend = p + copy.size() - 1;
    out->reserve((size_t)(end - begin) / 9 + 8);
    while (p < cend) {
        char* nl = (char*)memchr(p, '\n', cend - p);
        char* line_end = nl ? nl : cend;
        *line_end = '\0';
        // Skip blank / whitespace-only lines.
        char* q = p;
        while (*q == ' ' || *q == '\t' || *q == '\r') ++q;
        if (q != line_end) {
            int64_t n_vals = 0;
            for (;;) {
                char* after;
                float v = strtof(q, &after);
                if (after == q) return fail();  // malformed
                // strtof accepts hex floats ("0x1p3") that Python float()
                // rejects; keep the documented fallback contract by
                // treating any consumed 'x' as malformed.
                for (char* h = q; h < after; ++h)
                    if (*h == 'x' || *h == 'X') return fail();
                out->push_back(v);
                ++n_vals;
                q = after;
                while (*q == ' ' || *q == '\t' || *q == '\r') ++q;
                if (q == line_end) break;
                if (*q != ',') return fail();
                ++q;
            }
            if (*cols == -1) *cols = n_vals;
            else if (*cols != n_vals) return fail();  // ragged
            ++*nrows;
        }
        p = line_end + 1;
    }
}

}  // namespace

extern "C" {

// Two-call session API mirroring cu2rec_ingest_*: open parses the whole
// file in parallel and validates rectangularity; rows/cols report the
// shape; copy fills a caller-allocated row-major float32 buffer.
// Returns nullptr on I/O error or malformed/ragged input (the Python
// caller falls back to the pure-Python reader and its error behavior).
void* cu2rec_matrix_open(const char* path) {
    int fd = open(path, O_RDONLY);
    if (fd < 0) return nullptr;
    struct stat st;
    if (fstat(fd, &st) != 0 || st.st_size == 0) { close(fd); return nullptr; }
    size_t size = (size_t)st.st_size;
    const char* base =
        (const char*)mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0);
    close(fd);
    if (base == MAP_FAILED) return nullptr;

    const char* p = base;
    const char* end = base + size;
    unsigned hw = std::thread::hardware_concurrency();
    size_t n_threads = hw ? hw : 4;
    if (size < (64u << 10)) n_threads = 1;

    MatrixResult* res = new MatrixResult();
    res->chunks.resize(n_threads);
    res->chunk_rows.resize(n_threads);
    std::vector<const char*> bounds(n_threads + 1);
    const char* cur = p;
    for (size_t t = 0; t < n_threads; ++t) {
        bounds[t] = cur;
        const char* cend;
        if (t + 1 == n_threads) {
            cend = end;
        } else {
            cend = p + size * (t + 1) / n_threads;
            if (cend < cur) cend = cur;
            const char* nl = cend < end
                ? (const char*)memchr(cend, '\n', end - cend) : nullptr;
            cend = nl ? nl + 1 : end;
        }
        cur = cend;
    }
    bounds[n_threads] = end;

    std::vector<int64_t> chunk_cols(n_threads);
    // char, not vector<bool>: each worker writes its own element.
    std::vector<char> chunk_failed(n_threads, 0);
    auto worker = [&](size_t t) {
        bool failed = false;
        parse_matrix_chunk(bounds[t], bounds[t + 1], &res->chunks[t],
                           &res->chunk_rows[t], &chunk_cols[t], &failed);
        chunk_failed[t] = failed ? 1 : 0;
    };
    std::vector<std::thread> workers;
    for (size_t t = 1; t < n_threads; ++t) workers.emplace_back(worker, t);
    worker(0);
    for (auto& w : workers) w.join();
    munmap((void*)base, size);

    for (size_t t = 0; t < n_threads; ++t) {
        // A malformed chunk must fail the whole read even when its row
        // count is 0 (first line bad) — checked before the empty skip.
        if (chunk_failed[t]) {
            delete res;
            return nullptr;
        }
        if (res->chunk_rows[t] == 0) continue;
        if (chunk_cols[t] < 0 ||
            (res->cols >= 0 && chunk_cols[t] != res->cols)) {
            delete res;
            return nullptr;
        }
        if (res->cols < 0) res->cols = chunk_cols[t];
        res->rows += res->chunk_rows[t];
    }
    if (res->rows == 0) { delete res; return nullptr; }
    return res;
}

int64_t cu2rec_matrix_rows(void* handle) {
    return handle ? ((MatrixResult*)handle)->rows : -1;
}

int64_t cu2rec_matrix_cols(void* handle) {
    return handle ? ((MatrixResult*)handle)->cols : -1;
}

void cu2rec_matrix_copy(void* handle, float* out) {
    MatrixResult* res = (MatrixResult*)handle;
    int64_t off = 0;
    for (auto& c : res->chunks) {
        if (!c.empty()) memcpy(out + off, c.data(), c.size() * sizeof(float));
        off += (int64_t)c.size();
    }
}

void cu2rec_matrix_close(void* handle) {
    delete (MatrixResult*)handle;
}

int cu2rec_write_ratings(const char* path, const int32_t* users,
                         const int32_t* items, const float* ratings,
                         int64_t n, const char* header) {
    FILE* f = fopen(path, "wb");
    if (!f) return -1;
    if (header && header[0]) {
        fputs(header, f);
        fputc('\n', f);
    }
    unsigned hw = std::thread::hardware_concurrency();
    size_t n_threads = hw ? hw : 4;
    // Wave-blocked like cu2rec_write_matrix: bounds transient text memory
    // to ~n_threads * 80 MB regardless of row count (100M Netflix rows
    // would otherwise serialize ~2 GB before the first fwrite).
    const int64_t block_rows = 4 << 20;
    std::vector<std::string> bufs(n_threads);
    int rc = 0;
    for (int64_t wave = 0; wave < n && rc == 0;
         wave += block_rows * (int64_t)n_threads) {
        auto worker = [&](size_t t) {
            ScopedCLocale locale_guard;
            std::string& out = bufs[t];
            out.clear();
            int64_t lo = wave + (int64_t)t * block_rows;
            int64_t hi = std::min(lo + block_rows, n);
            if (lo >= hi) return;
            out.reserve((size_t)(hi - lo) * 20);
            char line[64];
            for (int64_t i = lo; i < hi; ++i) {
                int len = snprintf(line, sizeof line, "%d,%d,%.3f\n",
                                   users[i] + 1, items[i] + 1,
                                   (double)ratings[i]);
                out.append(line, (size_t)len);
            }
        };
        std::vector<std::thread> workers;
        for (size_t t = 1; t < n_threads; ++t) workers.emplace_back(worker, t);
        worker(0);
        for (auto& w : workers) w.join();
        for (auto& b : bufs)
            if (b.size() && fwrite(b.data(), 1, b.size(), f) != b.size())
                rc = -1;
    }
    if (fclose(f) != 0) rc = -1;
    return rc;
}

}  // extern "C"
