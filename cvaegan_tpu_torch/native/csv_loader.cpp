// Fast headerless-CSV parser for the tabular ingestion path.
//
// Semantics mirror the framework's pandas-based loader (and the
// reference's `src/datasets/__init__.py:11-17`): every cell is coerced
// to float; non-numeric or empty cells become 0.0f. Parsing is
// multithreaded by row ranges — each worker handles a contiguous span of
// lines located by a cheap newline pre-scan.
//
// C ABI (ctypes-friendly):
//   csv_dims(path, &rows, &cols)            -> 0 on success
//   csv_parse(path, out, capacity, &rows, &cols) -> 0 on success
// `cols` is taken from the first line; short rows are zero-padded and
// long rows truncated (pandas would error; we degrade gracefully and the
// python wrapper falls back to pandas when strictness matters).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <string>
#include <thread>
#include <vector>

namespace {

// Read an entire file into a string buffer (+1 sentinel newline).
bool read_file(const char* path, std::string* out) {
  std::ifstream f(path, std::ios::binary | std::ios::ate);
  if (!f) return false;
  std::streamsize size = f.tellg();
  f.seekg(0);
  out->resize(static_cast<size_t>(size));
  if (size > 0 && !f.read(&(*out)[0], size)) return false;
  if (out->empty() || out->back() != '\n') out->push_back('\n');
  return true;
}

// Parse one cell [begin, end) in place; non-numeric or NaN -> 0.0f.
// Safe without a copy: ',' and '\n' terminate float parsing, and the
// file buffer carries a '\n' sentinel, so strtof never leaves the cell
// with a valid parse longer than the cell itself unless the whole cell
// was consumed (which is exactly the acceptance condition).
float parse_cell(const char* begin, const char* end) {
  while (begin < end && (*begin == ' ' || *begin == '\t')) ++begin;
  while (end > begin && (end[-1] == ' ' || end[-1] == '\t' ||
                         end[-1] == '\r')) --end;
  if (begin >= end) return 0.0f;
  char* parse_end = nullptr;
  float v = std::strtof(begin, &parse_end);
  if (parse_end != end) return 0.0f;
  if (v != v) return 0.0f;  // literal "nan" -> 0, matching pandas fillna(0)
  return v;
}

// Count columns in the first line.
int64_t count_cols(const std::string& data) {
  int64_t cols = 1;
  for (char c : data) {
    if (c == '\n') break;
    if (c == ',') ++cols;
  }
  return data.empty() ? 0 : cols;
}

// Offsets of every line start.
std::vector<size_t> line_starts(const std::string& data) {
  std::vector<size_t> starts;
  starts.push_back(0);
  for (size_t i = 0; i + 1 < data.size(); ++i) {
    if (data[i] == '\n') starts.push_back(i + 1);
  }
  // Drop a trailing empty line.
  while (starts.size() > 1 && starts.back() >= data.size()) starts.pop_back();
  return starts;
}

void parse_rows(const std::string& data, const std::vector<size_t>& starts,
                int64_t row_begin, int64_t row_end, int64_t cols,
                float* out) {
  for (int64_t r = row_begin; r < row_end; ++r) {
    const char* p = data.data() + starts[static_cast<size_t>(r)];
    const char* line_end = strchr(p, '\n');
    if (!line_end) line_end = data.data() + data.size();
    float* row_out = out + r * cols;
    int64_t c = 0;
    const char* cell_begin = p;
    for (const char* q = p; q <= line_end && c < cols; ++q) {
      if (q == line_end || *q == ',') {
        row_out[c++] = parse_cell(cell_begin, q);
        cell_begin = q + 1;
      }
    }
    for (; c < cols; ++c) row_out[c] = 0.0f;  // zero-pad short rows
  }
}

}  // namespace

extern "C" {

int csv_dims(const char* path, int64_t* rows, int64_t* cols) {
  std::string data;
  if (!read_file(path, &data)) return 1;
  auto starts = line_starts(data);
  *rows = static_cast<int64_t>(starts.size());
  *cols = count_cols(data);
  return 0;
}

int csv_parse(const char* path, float* out, int64_t capacity, int64_t* rows,
              int64_t* cols) {
  std::string data;
  if (!read_file(path, &data)) return 1;
  auto starts = line_starts(data);
  int64_t n_rows = static_cast<int64_t>(starts.size());
  int64_t n_cols = count_cols(data);
  if (n_rows * n_cols > capacity) return 2;

  unsigned workers = std::thread::hardware_concurrency();
  if (workers == 0) workers = 1;
  if (n_rows < 4096) workers = 1;
  std::vector<std::thread> threads;
  int64_t chunk = (n_rows + workers - 1) / workers;
  for (unsigned w = 0; w < workers; ++w) {
    int64_t begin = static_cast<int64_t>(w) * chunk;
    int64_t end = begin + chunk < n_rows ? begin + chunk : n_rows;
    if (begin >= end) break;
    threads.emplace_back(parse_rows, std::cref(data), std::cref(starts),
                         begin, end, n_cols, out);
  }
  for (auto& t : threads) t.join();
  *rows = n_rows;
  *cols = n_cols;
  return 0;
}

}  // extern "C"
