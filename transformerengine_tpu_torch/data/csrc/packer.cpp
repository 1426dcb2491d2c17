// Native data-loader / sequence-packer runtime of the PyTorch port: a
// copy of transformerengine_tpu/data/csrc/packer.cpp (the port imports
// nothing of the JAX package), with the same C ABI and results.
//
// Exposes a C ABI consumed via ctypes:
//   - te_pack_sequences: first-fit-decreasing bin packing of documents
//     into fixed-length rows, emitting tokens + segment ids + positions
//     (the packed-batch format that
//     SequenceDescriptor.from_segment_ids_and_pos consumes).
//   - te_loader_*: memory-mapped token-bin reader with an epoch
//     shuffler and a multi-threaded prefetch ring buffer. With more than
//     one thread the order in which batches reach the ring depends on
//     which worker finishes first; one thread gives a fixed order.
//
// Token-bin format ("TEBIN001"):
//   char magic[8]; int64 n_docs; int64 offsets[n_docs + 1];
//   int32 tokens[offsets[n_docs]];
//
// data/loader.py builds it with g++ -O2 -std=c++17 -shared -fPIC into the
// package's _build/ directory at first use.

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <numeric>
#include <random>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

extern "C" {

// ---------------------------------------------------------------------------
// Packing
// ---------------------------------------------------------------------------

// First-fit-decreasing packing of documents into rows of max_len.
// Documents longer than max_len are split into max_len-sized chunks
// first (each chunk becomes its own segment). Outputs are dense
// (n_rows x max_len); returns the number of rows written, or -1 if
// out_capacity_rows is too small. Segment ids are 1-based per row in
// packing order; pad slots get segment id 0 and token pad_id; positions
// restart at 0 on each segment (the contract of
// SequenceDescriptor.from_segment_ids_and_pos).
int64_t te_pack_sequences(
    const int32_t* tokens, const int64_t* doc_offsets, int64_t n_docs,
    int64_t max_len, int32_t pad_id,
    int32_t* out_tokens, int32_t* out_segment_ids, int32_t* out_positions,
    int64_t out_capacity_rows) {
  struct Chunk { int64_t start, len; };
  std::vector<Chunk> chunks;
  chunks.reserve(static_cast<size_t>(n_docs));
  for (int64_t d = 0; d < n_docs; ++d) {
    int64_t s = doc_offsets[d], e = doc_offsets[d + 1];
    for (int64_t c = s; c < e; c += max_len)
      chunks.push_back({c, std::min(max_len, e - c)});
  }
  // Decreasing length, stable so equal-length chunks keep doc order.
  std::stable_sort(chunks.begin(), chunks.end(),
                   [](const Chunk& a, const Chunk& b) { return a.len > b.len; });

  struct Row { int64_t used = 0; int32_t n_segs = 0; };
  std::vector<Row> rows;
  std::vector<std::vector<Chunk>> row_chunks;
  for (const Chunk& ch : chunks) {
    // First fit: the first row with enough space.
    int64_t target = -1;
    for (size_t r = 0; r < rows.size(); ++r)
      if (rows[r].used + ch.len <= max_len) { target = static_cast<int64_t>(r); break; }
    if (target < 0) {
      rows.push_back({});
      row_chunks.emplace_back();
      target = static_cast<int64_t>(rows.size()) - 1;
    }
    rows[static_cast<size_t>(target)].used += ch.len;
    rows[static_cast<size_t>(target)].n_segs += 1;
    row_chunks[static_cast<size_t>(target)].push_back(ch);
  }
  int64_t n_rows = static_cast<int64_t>(rows.size());
  if (n_rows > out_capacity_rows) return -1;

  for (int64_t r = 0; r < n_rows; ++r) {
    int32_t* tok = out_tokens + r * max_len;
    int32_t* seg = out_segment_ids + r * max_len;
    int32_t* pos = out_positions + r * max_len;
    int64_t cur = 0;
    int32_t seg_id = 1;
    for (const Chunk& ch : row_chunks[static_cast<size_t>(r)]) {
      std::memcpy(tok + cur, tokens + ch.start,
                  static_cast<size_t>(ch.len) * sizeof(int32_t));
      for (int64_t i = 0; i < ch.len; ++i) {
        seg[cur + i] = seg_id;
        pos[cur + i] = static_cast<int32_t>(i);
      }
      cur += ch.len;
      ++seg_id;
    }
    for (; cur < max_len; ++cur) {
      tok[cur] = pad_id;
      seg[cur] = 0;
      pos[cur] = 0;
    }
  }
  return n_rows;
}

// ---------------------------------------------------------------------------
// Memory-mapped token-bin loader with prefetch
// ---------------------------------------------------------------------------

namespace {

struct Batch {
  std::vector<int32_t> tokens, segment_ids, positions;
};

struct Loader {
  // mapped file
  int fd = -1;
  const uint8_t* map = nullptr;
  size_t map_size = 0;
  const int64_t* offsets = nullptr;  // n_docs + 1
  const int32_t* tokens = nullptr;
  int64_t n_docs = 0;

  int64_t batch_rows = 0, seq_len = 0;
  int32_t pad_id = 0;
  uint64_t seed = 0;

  // document cursor (epoch-shuffled)
  std::vector<int64_t> order;
  size_t cursor = 0;
  uint64_t epoch = 0;

  // prefetch ring
  std::deque<Batch> ring;
  size_t ring_cap = 4;
  std::mutex mu;
  std::condition_variable cv_full, cv_empty;
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};

  void reshuffle() {
    order.resize(static_cast<size_t>(n_docs));
    std::iota(order.begin(), order.end(), 0);
    std::mt19937_64 rng(seed + epoch);
    std::shuffle(order.begin(), order.end(), rng);
    cursor = 0;
  }

  // Rows FFD would use for these chunk lengths (the same algorithm as
  // te_pack_sequences, lengths only) — the selection's feasibility test.
  static int64_t ffd_rows(std::vector<int64_t> lens, int64_t cap) {
    std::stable_sort(lens.begin(), lens.end(), std::greater<int64_t>());
    std::vector<int64_t> used;
    for (int64_t l : lens) {
      bool placed = false;
      for (int64_t& u : used)
        if (u + l <= cap) { u += l; placed = true; break; }
      if (!placed) used.push_back(l);
    }
    return static_cast<int64_t>(used.size());
  }

  // Pull docs while the packed result still fits batch_rows rows.
  // Selection (shared cursor) runs under mu; packing outside the lock.
  Batch make_batch() {
    std::vector<int64_t> picked;
    bool truncate_single = false;
    {
      std::unique_lock<std::mutex> lk(mu);
      if (cursor >= order.size()) { ++epoch; reshuffle(); }
      std::vector<int64_t> chunk_lens;
      while (cursor < order.size()) {
        int64_t d = order[cursor];
        int64_t len = offsets[d + 1] - offsets[d];
        std::vector<int64_t> trial = chunk_lens;
        for (int64_t c = 0; c < len; c += seq_len)
          trial.push_back(std::min(seq_len, len - c));
        if (ffd_rows(trial, seq_len) > batch_rows) {
          if (picked.empty()) {  // single doc longer than the whole batch
            picked.push_back(d);
            ++cursor;
            truncate_single = true;
          }
          break;
        }
        picked.push_back(d);
        chunk_lens.swap(trial);
        ++cursor;
      }
    }
    // Contiguous view of the picked docs (truncated to the batch token
    // budget in the oversized-single-doc case).
    std::vector<int32_t> flat;
    std::vector<int64_t> offs{0};
    for (int64_t d : picked) {
      int64_t s = offsets[d], e = offsets[d + 1];
      if (truncate_single) e = std::min(e, s + batch_rows * seq_len);
      flat.insert(flat.end(), tokens + s, tokens + e);
      offs.push_back(static_cast<int64_t>(flat.size()));
    }
    Batch b;
    b.tokens.assign(static_cast<size_t>(batch_rows * seq_len), pad_id);
    b.segment_ids.assign(static_cast<size_t>(batch_rows * seq_len), 0);
    b.positions.assign(static_cast<size_t>(batch_rows * seq_len), 0);
    te_pack_sequences(flat.data(), offs.data(),
                      static_cast<int64_t>(picked.size()), seq_len, pad_id,
                      b.tokens.data(), b.segment_ids.data(),
                      b.positions.data(), batch_rows);
    return b;
  }

  void worker() {
    while (!stop.load()) {
      Batch b = make_batch();
      std::unique_lock<std::mutex> lk(mu);
      cv_full.wait(lk, [&] { return ring.size() < ring_cap || stop.load(); });
      if (stop.load()) return;
      ring.push_back(std::move(b));
      cv_empty.notify_one();
    }
  }
};

}  // namespace

void* te_loader_create(const char* path, int64_t batch_rows, int64_t seq_len,
                       int32_t pad_id, uint64_t seed, int32_t n_threads,
                       int32_t ring_capacity) {
  auto* L = new Loader();
  L->fd = open(path, O_RDONLY);
  if (L->fd < 0) { delete L; return nullptr; }
  struct stat st;
  if (fstat(L->fd, &st) != 0) { close(L->fd); delete L; return nullptr; }
  L->map_size = static_cast<size_t>(st.st_size);
  L->map = static_cast<const uint8_t*>(
      mmap(nullptr, L->map_size, PROT_READ, MAP_PRIVATE, L->fd, 0));
  if (L->map == MAP_FAILED || L->map_size < 16 ||
      std::memcmp(L->map, "TEBIN001", 8) != 0) {
    if (L->map != MAP_FAILED) munmap(const_cast<uint8_t*>(L->map), L->map_size);
    close(L->fd); delete L; return nullptr;
  }
  std::memcpy(&L->n_docs, L->map + 8, sizeof(int64_t));
  L->offsets = reinterpret_cast<const int64_t*>(L->map + 16);
  L->tokens = reinterpret_cast<const int32_t*>(
      L->map + 16 + (L->n_docs + 1) * sizeof(int64_t));
  L->batch_rows = batch_rows;
  L->seq_len = seq_len;
  L->pad_id = pad_id;
  L->seed = seed;
  L->ring_cap = static_cast<size_t>(ring_capacity > 0 ? ring_capacity : 4);
  L->reshuffle();
  int nt = n_threads > 0 ? n_threads : 1;
  for (int i = 0; i < nt; ++i) L->workers.emplace_back(&Loader::worker, L);
  return L;
}

// Copies the next prefetched batch into caller buffers, each
// (batch_rows * seq_len) int32. Blocks until one is ready.
void te_loader_next(void* loader, int32_t* out_tokens,
                    int32_t* out_segment_ids, int32_t* out_positions) {
  auto* L = static_cast<Loader*>(loader);
  Batch b;
  {
    std::unique_lock<std::mutex> lk(L->mu);
    L->cv_empty.wait(lk, [&] { return !L->ring.empty(); });
    b = std::move(L->ring.front());
    L->ring.pop_front();
    L->cv_full.notify_one();
  }
  std::memcpy(out_tokens, b.tokens.data(), b.tokens.size() * sizeof(int32_t));
  std::memcpy(out_segment_ids, b.segment_ids.data(),
              b.segment_ids.size() * sizeof(int32_t));
  std::memcpy(out_positions, b.positions.data(),
              b.positions.size() * sizeof(int32_t));
}

int64_t te_loader_num_docs(void* loader) {
  return static_cast<Loader*>(loader)->n_docs;
}

void te_loader_destroy(void* loader) {
  auto* L = static_cast<Loader*>(loader);
  L->stop.store(true);
  L->cv_full.notify_all();
  L->cv_empty.notify_all();
  for (auto& t : L->workers) t.join();
  if (L->map) munmap(const_cast<uint8_t*>(L->map), L->map_size);
  if (L->fd >= 0) close(L->fd);
  delete L;
}

}  // extern "C"
