// Streaming headerless-CSV reader with background prefetch.
//
// Counterpart to csv_loader.cpp (whole-file parse) for corpora that
// should not be materialized in host memory at once: a single background
// thread reads the file sequentially in byte blocks, parses complete
// lines into float rows (same cell semantics as csv_loader.cpp — every
// cell coerced to float, non-numeric/empty/NaN -> 0.0f, short rows
// zero-padded, long rows truncated), and hands off fixed-size row chunks
// through a bounded ring of buffers. The consumer overlaps parsing with
// whatever it does next (device upload, statistics, inference).
//
// C ABI (ctypes-friendly):
//   stream_open(path, chunk_rows) -> handle (>0) or 0 on failure
//   stream_cols(handle)           -> column count (from the first line)
//   stream_next(handle, out, &rows) -> 0 chunk ready (rows <= chunk_rows),
//                                      1 end-of-file (rows == 0),
//                                      2 error
//   stream_close(handle)
//
// One reader thread per stream; `stream_next` blocks until the next
// chunk is parsed. The ring holds RING_SLOTS chunks, so peak memory is
// O(RING_SLOTS * chunk_rows * cols) regardless of file size.

#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

constexpr size_t kReadBlock = 1 << 20;  // 1 MiB file-read granularity
constexpr int kRingSlots = 4;

// Same acceptance rule as csv_loader.cpp::parse_cell (kept in sync; the
// parity test exercises both paths on the same file).
float parse_cell(const char* begin, const char* end) {
  while (begin < end && (*begin == ' ' || *begin == '\t')) ++begin;
  while (end > begin && (end[-1] == ' ' || end[-1] == '\t' ||
                         end[-1] == '\r')) --end;
  if (begin >= end) return 0.0f;
  char* parse_end = nullptr;
  float v = std::strtof(begin, &parse_end);
  if (parse_end != end) return 0.0f;
  if (v != v) return 0.0f;  // NaN -> 0, matching pandas fillna(0)
  return v;
}

struct Chunk {
  std::vector<float> data;  // chunk_rows * cols floats
  int64_t rows = 0;
  bool eof = false;
};

struct Stream {
  std::ifstream file;
  int64_t chunk_rows = 0;
  int64_t cols = 0;
  bool error = false;

  // ring of parsed chunks
  std::vector<Chunk> ring;
  size_t head = 0, tail = 0, filled = 0;
  bool producer_done = false;
  std::mutex mu;
  std::condition_variable cv_producer, cv_consumer;
  std::thread worker;

  ~Stream() {
    {
      std::lock_guard<std::mutex> lock(mu);
      producer_done = true;  // signal abort to the producer
      filled = 0;            // free all slots so the producer never blocks
    }
    cv_producer.notify_all();
    if (worker.joinable()) worker.join();
  }
};

// Parse one line into out[0..cols); returns past-the-newline pointer.
void parse_line(const char* p, const char* line_end, int64_t cols,
                float* out) {
  int64_t c = 0;
  const char* cell_begin = p;
  for (const char* q = p; q <= line_end && c < cols; ++q) {
    if (q == line_end || *q == ',') {
      out[c++] = parse_cell(cell_begin, q);
      cell_begin = q + 1;
    }
  }
  for (; c < cols; ++c) out[c] = 0.0f;
}

void producer_loop(Stream* s) {
  std::string carry;  // partial line from the previous block
  std::vector<char> block(kReadBlock);
  Chunk* cur = nullptr;
  int64_t cur_row = 0;

  auto acquire_slot = [&]() -> Chunk* {
    std::unique_lock<std::mutex> lock(s->mu);
    s->cv_producer.wait(lock, [&] {
      return s->filled < s->ring.size() || s->producer_done;
    });
    if (s->producer_done) return nullptr;  // consumer closed early
    return &s->ring[s->head];
  };
  auto publish_slot = [&](int64_t rows, bool eof) {
    {
      std::lock_guard<std::mutex> lock(s->mu);
      s->ring[s->head].rows = rows;
      s->ring[s->head].eof = eof;
      s->head = (s->head + 1) % s->ring.size();
      ++s->filled;
      if (eof) s->producer_done = true;
    }
    s->cv_consumer.notify_one();
  };

  auto emit_line = [&](const char* begin, const char* end) -> bool {
    if (cur == nullptr) {
      cur = acquire_slot();
      if (cur == nullptr) return false;
      cur_row = 0;
    }
    parse_line(begin, end, s->cols, cur->data.data() + cur_row * s->cols);
    if (++cur_row == s->chunk_rows) {
      publish_slot(cur_row, false);
      cur = nullptr;
    }
    return true;
  };

  bool aborted = false;
  while (!aborted && s->file) {
    s->file.read(block.data(), static_cast<std::streamsize>(block.size()));
    std::streamsize got = s->file.gcount();
    if (got <= 0) break;
    const char* p = block.data();
    const char* end = block.data() + got;
    while (p < end) {
      const char* nl =
          static_cast<const char*>(memchr(p, '\n', static_cast<size_t>(end - p)));
      if (nl == nullptr) {
        carry.append(p, end);
        break;
      }
      if (!carry.empty()) {
        carry.append(p, nl);
        if (!emit_line(carry.data(), carry.data() + carry.size())) {
          aborted = true;
          break;
        }
        carry.clear();
      } else if (nl > p) {  // skip empty lines
        if (!emit_line(p, nl)) {
          aborted = true;
          break;
        }
      }
      p = nl + 1;
    }
  }
  if (aborted) return;
  if (s->file.bad()) {
    // Mid-file I/O failure is an ERROR, not EOF — reporting it as a
    // clean end would silently truncate the corpus downstream.
    {
      std::lock_guard<std::mutex> lock(s->mu);
      s->error = true;
    }
    s->cv_consumer.notify_all();
    return;
  }
  if (!carry.empty()) {  // final line without trailing newline
    if (!emit_line(carry.data(), carry.data() + carry.size())) return;
  }
  // flush the partial chunk, then the EOF marker
  if (cur != nullptr && cur_row > 0) publish_slot(cur_row, false);
  Chunk* last = acquire_slot();
  if (last != nullptr) publish_slot(0, true);
}

std::mutex g_mu;
std::unordered_map<int64_t, std::unique_ptr<Stream>> g_streams;
int64_t g_next_handle = 1;

Stream* find(int64_t handle) {
  std::lock_guard<std::mutex> lock(g_mu);
  auto it = g_streams.find(handle);
  return it == g_streams.end() ? nullptr : it->second.get();
}

}  // namespace

extern "C" {

int64_t stream_open(const char* path, int64_t chunk_rows) {
  if (chunk_rows <= 0) return 0;
  auto s = std::make_unique<Stream>();
  s->file.open(path, std::ios::binary);
  if (!s->file) return 0;

  // Column count from the first NON-EMPTY line (the producer loop skips
  // blank lines, so this is the line that defines the schema); stream
  // rewound afterwards. All-blank/empty files fail open.
  std::string first;
  while (std::getline(s->file, first)) {
    if (!first.empty() && first != "\r") break;
    first.clear();
  }
  if (first.empty() || first == "\r") return 0;
  s->cols = 1;
  for (char c : first) {
    if (c == ',') ++s->cols;
  }
  s->file.clear();
  s->file.seekg(0);

  s->chunk_rows = chunk_rows;
  s->ring.resize(kRingSlots);
  for (auto& chunk : s->ring) {
    chunk.data.resize(static_cast<size_t>(chunk_rows * s->cols));
  }
  s->worker = std::thread(producer_loop, s.get());

  std::lock_guard<std::mutex> lock(g_mu);
  int64_t handle = g_next_handle++;
  g_streams[handle] = std::move(s);
  return handle;
}

int64_t stream_cols(int64_t handle) {
  Stream* s = find(handle);
  return s == nullptr ? 0 : s->cols;
}

int stream_next(int64_t handle, float* out, int64_t* rows) {
  Stream* s = find(handle);
  if (s == nullptr) return 2;
  std::unique_lock<std::mutex> lock(s->mu);
  s->cv_consumer.wait(lock, [&] { return s->filled > 0 || s->error; });
  if (s->error) return 2;
  Chunk& chunk = s->ring[s->tail];
  if (chunk.eof) {
    *rows = 0;
    return 1;
  }
  std::memcpy(out, chunk.data.data(),
              static_cast<size_t>(chunk.rows * s->cols) * sizeof(float));
  *rows = chunk.rows;
  s->tail = (s->tail + 1) % s->ring.size();
  --s->filled;
  lock.unlock();
  s->cv_producer.notify_one();
  return 0;
}

void stream_close(int64_t handle) {
  std::unique_ptr<Stream> s;
  {
    std::lock_guard<std::mutex> lock(g_mu);
    auto it = g_streams.find(handle);
    if (it == g_streams.end()) return;
    s = std::move(it->second);
    g_streams.erase(it);
  }
  // ~Stream joins the worker.
}

}  // extern "C"
