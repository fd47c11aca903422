// Native inverted metadata index.
//
// The reference's metadata filter is a full scan over every stored node
// with per-node Python dict comparison (reference
// src/vector_db/services/storage_service.py:106-128) — O(N) Python work
// per filtered query. This C++ index maintains posting lists keyed by
// exact (key, value) pairs, making a filter query O(sum of posting-list
// lengths) with C-speed set intersection, while returning exactly the same
// id sets. Exposed through a plain C ABI and loaded from Python via ctypes
// (no pybind11 dependency).
//
// Concurrency: a single mutex guards all mutation/query — the host ingest
// path is the one place the engine needs a lock (device-side state is
// updated functionally; see SURVEY.md §5 on the reference's unguarded
// mutation).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
#include <set>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Index {
    // (key, value) -> sorted set of ids
    std::unordered_map<std::string, std::set<int64_t>> postings;
    // id -> its (key, value) tokens, for removal
    std::unordered_map<int64_t, std::vector<std::string>> tokens_of;
    std::mutex mu;
};

// token = key + '\x1f' + value (both caller-serialized strings)
std::string make_token(const char* key, const char* value) {
    std::string t(key);
    t.push_back('\x1f');
    t += value;
    return t;
}

}  // namespace

extern "C" {

void* mdx_new() { return new Index(); }

void mdx_free(void* h) { delete static_cast<Index*>(h); }

// Replace id's metadata with `n` (key, value) pairs.
void mdx_set(void* h, int64_t id, const char** keys, const char** values,
             int64_t n) {
    auto* idx = static_cast<Index*>(h);
    std::lock_guard<std::mutex> lock(idx->mu);
    auto it = idx->tokens_of.find(id);
    if (it != idx->tokens_of.end()) {
        for (const auto& tok : it->second) {
            auto p = idx->postings.find(tok);
            if (p != idx->postings.end()) {
                p->second.erase(id);
                if (p->second.empty()) idx->postings.erase(p);
            }
        }
        idx->tokens_of.erase(it);
    }
    std::vector<std::string> toks;
    toks.reserve(static_cast<size_t>(n));
    for (int64_t i = 0; i < n; ++i) {
        std::string tok = make_token(keys[i], values[i]);
        idx->postings[tok].insert(id);
        toks.push_back(std::move(tok));
    }
    idx->tokens_of[id] = std::move(toks);
}

void mdx_remove(void* h, int64_t id) {
    auto* idx = static_cast<Index*>(h);
    std::lock_guard<std::mutex> lock(idx->mu);
    auto it = idx->tokens_of.find(id);
    if (it == idx->tokens_of.end()) return;
    for (const auto& tok : it->second) {
        auto p = idx->postings.find(tok);
        if (p != idx->postings.end()) {
            p->second.erase(id);
            if (p->second.empty()) idx->postings.erase(p);
        }
    }
    idx->tokens_of.erase(it);
}

int64_t mdx_size(void* h) {
    auto* idx = static_cast<Index*>(h);
    std::lock_guard<std::mutex> lock(idx->mu);
    return static_cast<int64_t>(idx->tokens_of.size());
}

// Ids matching ALL of the n (key, value) pairs. Writes up to `cap` ids
// into `out`; returns the total match count (callers re-query with a
// bigger buffer if count > cap). n == 0 matches every indexed id.
int64_t mdx_query(void* h, const char** keys, const char** values, int64_t n,
                  int64_t* out, int64_t cap) {
    auto* idx = static_cast<Index*>(h);
    std::lock_guard<std::mutex> lock(idx->mu);

    std::vector<int64_t> result;
    if (n == 0) {
        result.reserve(idx->tokens_of.size());
        for (const auto& kv : idx->tokens_of) result.push_back(kv.first);
        std::sort(result.begin(), result.end());
    } else {
        // start from the smallest posting list, intersect the rest
        std::vector<const std::set<int64_t>*> lists;
        lists.reserve(static_cast<size_t>(n));
        for (int64_t i = 0; i < n; ++i) {
            auto p = idx->postings.find(make_token(keys[i], values[i]));
            if (p == idx->postings.end()) return 0;
            lists.push_back(&p->second);
        }
        std::sort(lists.begin(), lists.end(),
                  [](const auto* a, const auto* b) {
                      return a->size() < b->size();
                  });
        for (int64_t id : *lists[0]) {
            bool all = true;
            for (size_t j = 1; j < lists.size(); ++j) {
                if (!lists[j]->count(id)) { all = false; break; }
            }
            if (all) result.push_back(id);
        }
    }
    int64_t total = static_cast<int64_t>(result.size());
    int64_t write = std::min(total, cap);
    for (int64_t i = 0; i < write; ++i) out[i] = result[i];
    return total;
}

}  // extern "C"
