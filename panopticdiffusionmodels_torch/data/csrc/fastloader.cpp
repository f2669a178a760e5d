// fastloader: native threaded batch assembler for pre-encoded feature datasets.
//
// The port's own copy of the JAX package's `native/fastloader.cpp`, built by
// `ops/kernels/build.py::build_host_library` into build/torch_native/ and
// loaded by `data/native_loader.py` through ctypes.  Host code: no CUDA.
//
// The training hot path reads per-sample .npy triples (VAE latent moments,
// CLIP context, panoptic seg map -- the file contract of the extraction
// scripts, reference datasets.py:564-613).  The Python loader pays
// interpreter overhead per sample; this C++ runtime does the whole batch
// pipeline natively:
//
//   * a worker thread pool reads + parses .npy files (minimal parser for
//     <f4/<f8/<i4/<i8 C-order arrays),
//   * panoptic maps are k x k min-pooled (256 -> 64, reference datasets.py:591)
//     during assembly,
//   * finished batches sit in a bounded ring buffer; the consumer copies them
//     out through a zero-dependency C ABI.
//
// Beside the JAX copy's fl_open / fl_next / fl_close it exports fl_stop, which
// only wakes and stops (safe while another thread blocks in fl_next), so a
// caller can end the stream from another thread and free it with fl_close
// once that fl_next has returned; and a worker that gives up on a bad file
// sets its dead flag under the queue's mutex, so a consumer about to wait
// cannot miss the wake-up.
//
// Build: g++ -O3 -std=c++17 -fPIC -pthread -shared
#include <algorithm>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <queue>
#include <random>
#include <string>
#include <thread>
#include <vector>

namespace {

struct NpyArray {
  std::vector<int64_t> shape;
  std::string dtype;  // "<f4", "<i4", "<i8"
  std::vector<char> data;
};

// Minimal .npy (v1/v2) reader for little-endian C-order arrays.
bool read_npy(const std::string& path, NpyArray* out) {
  FILE* f = std::fopen(path.c_str(), "rb");
  if (!f) return false;
  unsigned char magic[8];
  if (std::fread(magic, 1, 8, f) != 8 || std::memcmp(magic, "\x93NUMPY", 6) != 0) {
    std::fclose(f);
    return false;
  }
  uint32_t header_len = 0;
  if (magic[6] == 1) {
    uint16_t h16;
    if (std::fread(&h16, 2, 1, f) != 1) { std::fclose(f); return false; }
    header_len = h16;
  } else {
    if (std::fread(&header_len, 4, 1, f) != 1) { std::fclose(f); return false; }
  }
  std::string header(header_len, '\0');
  if (std::fread(&header[0], 1, header_len, f) != header_len) {
    std::fclose(f);
    return false;
  }
  // parse dtype
  auto dpos = header.find("'descr':");
  if (dpos == std::string::npos) { std::fclose(f); return false; }
  auto q1 = header.find('\'', dpos + 8);
  auto q2 = header.find('\'', q1 + 1);
  out->dtype = header.substr(q1 + 1, q2 - q1 - 1);
  // fortran_order must be False
  if (header.find("'fortran_order': True") != std::string::npos) {
    std::fclose(f);
    return false;
  }
  // parse shape tuple
  auto spos = header.find("'shape':");
  auto p1 = header.find('(', spos);
  auto p2 = header.find(')', p1);
  std::string shape_str = header.substr(p1 + 1, p2 - p1 - 1);
  out->shape.clear();
  int64_t val = 0;
  bool in_num = false;
  for (char c : shape_str) {
    if (c >= '0' && c <= '9') {
      val = val * 10 + (c - '0');
      in_num = true;
    } else if (in_num) {
      out->shape.push_back(val);
      val = 0;
      in_num = false;
    }
  }
  if (in_num) out->shape.push_back(val);
  size_t itemsize = 0;
  if (out->dtype == "<f4" || out->dtype == "<i4") itemsize = 4;
  else if (out->dtype == "<f8" || out->dtype == "<i8") itemsize = 8;
  else { std::fclose(f); return false; }
  size_t n = itemsize;
  for (int64_t s : out->shape) n *= static_cast<size_t>(s);
  out->data.resize(n);
  bool ok = std::fread(out->data.data(), 1, n, f) == n;
  std::fclose(f);
  return ok;
}

// Copy an arbitrary supported dtype into an int32 buffer.
void to_i32(const NpyArray& a, int32_t* dst, size_t n) {
  if (a.dtype == "<i4") {
    std::memcpy(dst, a.data.data(), n * 4);
  } else if (a.dtype == "<i8") {
    const int64_t* src = reinterpret_cast<const int64_t*>(a.data.data());
    for (size_t i = 0; i < n; ++i) dst[i] = static_cast<int32_t>(src[i]);
  } else if (a.dtype == "<f4") {
    const float* src = reinterpret_cast<const float*>(a.data.data());
    for (size_t i = 0; i < n; ++i) dst[i] = static_cast<int32_t>(src[i]);
  } else {
    const double* src = reinterpret_cast<const double*>(a.data.data());
    for (size_t i = 0; i < n; ++i) dst[i] = static_cast<int32_t>(src[i]);
  }
}

void to_f32(const NpyArray& a, float* dst, size_t n) {
  if (a.dtype == "<f4") {
    std::memcpy(dst, a.data.data(), n * 4);
  } else if (a.dtype == "<f8") {
    const double* src = reinterpret_cast<const double*>(a.data.data());
    for (size_t i = 0; i < n; ++i) dst[i] = static_cast<float>(src[i]);
  } else if (a.dtype == "<i4") {
    const int32_t* src = reinterpret_cast<const int32_t*>(a.data.data());
    for (size_t i = 0; i < n; ++i) dst[i] = static_cast<float>(src[i]);
  } else {
    const int64_t* src = reinterpret_cast<const int64_t*>(a.data.data());
    for (size_t i = 0; i < n; ++i) dst[i] = static_cast<float>(src[i]);
  }
}

struct Batch {
  std::vector<float> moments;    // (B, h, w, c) channel-last
  std::vector<float> context;    // (B, T, D)
  std::vector<int32_t> seg;      // (B, m, m, 1)
};

struct Loader {
  std::string dir;
  std::vector<int64_t> indices;
  int batch_size = 0;
  int num_captions = 5;
  // moments stored CHW (c, h, w); emitted HWC
  int mc = 0, mh = 0, mw = 0;
  int ct = 0, cd = 0;       // context (T, D)
  int seg_in = 0, seg_out = 0;  // seg stored (seg_in, seg_in); pooled to seg_out
  bool shuffle = true;
  uint64_t seed = 0;

  std::vector<std::thread> workers;
  std::queue<Batch*> ready;
  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  size_t max_queue = 4;
  std::atomic<bool> stop{false};
  // Set on any unrecoverable load error: fl_next then returns 0 instead of
  // blocking forever while workers spin on a persistently missing file.
  std::atomic<bool> dead{false};
  uint64_t epoch = 0;          // guarded by order_mu
  std::vector<int64_t> order;  // guarded by order_mu
  size_t cursor = 0;           // guarded by order_mu
  std::mutex order_mu;

  bool next_indices(std::vector<int64_t>* out) {
    // order/cursor/epoch are read AND written under one lock: the previous
    // lock-free fetch_add let a worker copy from `order` while another
    // thread reassigned it inside the reshuffle (use-after-realloc UB).
    std::lock_guard<std::mutex> lk(order_mu);
    for (;;) {
      if (stop.load()) return false;
      if (cursor + static_cast<size_t>(batch_size) <= order.size()) {
        out->assign(order.begin() + cursor,
                    order.begin() + cursor + batch_size);
        cursor += batch_size;
        return true;
      }
      if (order.size() < static_cast<size_t>(batch_size)) return false;
      std::mt19937_64 rng(seed + (++epoch));
      order = indices;
      if (shuffle) std::shuffle(order.begin(), order.end(), rng);
      cursor = 0;
    }
  }

  static int64_t numel(const NpyArray& a) {
    int64_t n = 1;
    for (int64_t d : a.shape) n *= d;
    return n;
  }

  bool load_sample(int64_t idx, int bi, Batch* b, std::mt19937_64* rng) {
    char buf[64];
    NpyArray a;
    // moments: {i}.npy stored (c, h, w) -> transpose to (h, w, c)
    std::snprintf(buf, sizeof buf, "/%lld.npy", static_cast<long long>(idx));
    std::vector<float> chw(static_cast<size_t>(mc) * mh * mw);
    if (!read_npy(dir + buf, &a) ||
        numel(a) != static_cast<int64_t>(chw.size())) {
      std::fprintf(stderr, "fastloader: bad or missing %s%s\n", dir.c_str(), buf);
      return false;
    }
    to_f32(a, chw.data(), chw.size());
    float* mdst = b->moments.data() + static_cast<size_t>(bi) * mh * mw * mc;
    for (int h = 0; h < mh; ++h)
      for (int w = 0; w < mw; ++w)
        for (int c = 0; c < mc; ++c)
          mdst[(static_cast<size_t>(h) * mw + w) * mc + c] =
              chw[(static_cast<size_t>(c) * mh + h) * mw + w];
    // context: {i}_{k}.npy, random caption
    int k = static_cast<int>((*rng)() % num_captions);
    std::snprintf(buf, sizeof buf, "/%lld_%d.npy", static_cast<long long>(idx), k);
    if (!read_npy(dir + buf, &a) ||
        numel(a) != static_cast<int64_t>(ct) * cd) {
      std::fprintf(stderr, "fastloader: bad or missing %s%s\n", dir.c_str(), buf);
      return false;
    }
    to_f32(a, b->context.data() + static_cast<size_t>(bi) * ct * cd,
           static_cast<size_t>(ct) * cd);
    // seg: {i}_seg.npy with min-pool
    if (seg_out > 0) {
      std::snprintf(buf, sizeof buf, "/%lld_seg.npy", static_cast<long long>(idx));
      std::vector<int32_t> full(static_cast<size_t>(seg_in) * seg_in);
      if (!read_npy(dir + buf, &a) ||
          numel(a) != static_cast<int64_t>(full.size())) {
        std::fprintf(stderr, "fastloader: bad or missing %s%s\n", dir.c_str(), buf);
        return false;
      }
      to_i32(a, full.data(), full.size());
      int pool = seg_in / seg_out;
      int32_t* sdst = b->seg.data() + static_cast<size_t>(bi) * seg_out * seg_out;
      for (int i = 0; i < seg_out; ++i) {
        for (int j = 0; j < seg_out; ++j) {
          int32_t m = INT32_MAX;
          for (int pi = 0; pi < pool; ++pi)
            for (int pj = 0; pj < pool; ++pj) {
              int32_t v = full[static_cast<size_t>(i * pool + pi) * seg_in + j * pool + pj];
              m = std::min(m, v);
            }
          sdst[static_cast<size_t>(i) * seg_out + j] = m;
        }
      }
    }
    return true;
  }

  void worker(int wid) {
    std::mt19937_64 rng(seed * 1315423911u + wid);
    std::vector<int64_t> batch_idx;
    while (!stop.load() && !dead.load()) {
      if (!next_indices(&batch_idx)) break;
      Batch* b = new Batch();
      b->moments.resize(static_cast<size_t>(batch_size) * mh * mw * mc);
      b->context.resize(static_cast<size_t>(batch_size) * ct * cd);
      if (seg_out > 0) b->seg.resize(static_cast<size_t>(batch_size) * seg_out * seg_out);
      bool ok = true;
      for (int i = 0; i < batch_size && ok; ++i) {
        // Bounded retry: a transient host error (EMFILE under the thread
        // pool, NFS hiccup) must not abort a long training run; only a read
        // that stays broken across retries is a real dataset problem worth
        // surfacing (fl_next then raises instead of blocking forever).
        ok = load_sample(batch_idx[i], i, b, &rng);
        for (int attempt = 0; !ok && attempt < 3 && !stop.load(); ++attempt) {
          std::this_thread::sleep_for(std::chrono::milliseconds(50 << attempt));
          ok = load_sample(batch_idx[i], i, b, &rng);
        }
      }
      if (!ok) {
        delete b;
        {
          std::lock_guard<std::mutex> lk(mu);
          dead.store(true);
        }
        cv_ready.notify_all();
        break;
      }
      std::unique_lock<std::mutex> lk(mu);
      cv_space.wait(lk, [&] { return ready.size() < max_queue || stop.load(); });
      if (stop.load()) {
        delete b;
        break;
      }
      ready.push(b);
      cv_ready.notify_one();
    }
  }
};

}  // namespace

extern "C" {

void* fl_open(const char* dir, const int64_t* indices, int64_t n_indices,
              int batch_size, int num_captions, int mc, int mh, int mw, int ct,
              int cd, int seg_in, int seg_out, int shuffle, uint64_t seed,
              int num_threads) {
  if (n_indices < batch_size || batch_size <= 0) return nullptr;
  auto* l = new Loader();
  l->dir = dir;
  l->indices.assign(indices, indices + n_indices);
  l->batch_size = batch_size;
  l->num_captions = num_captions;
  l->mc = mc; l->mh = mh; l->mw = mw;
  l->ct = ct; l->cd = cd;
  l->seg_in = seg_in; l->seg_out = seg_out;
  l->shuffle = shuffle != 0;
  l->seed = seed;
  l->order = l->indices;
  if (l->shuffle) {
    std::mt19937_64 rng(seed);
    std::shuffle(l->order.begin(), l->order.end(), rng);
  }
  for (int i = 0; i < num_threads; ++i)
    l->workers.emplace_back(&Loader::worker, l, i);
  return l;
}

// Blocks until a batch is ready; copies into caller buffers. Returns 1 on ok.
int fl_next(void* handle, float* moments, float* context, int32_t* seg) {
  auto* l = static_cast<Loader*>(handle);
  Batch* b = nullptr;
  {
    std::unique_lock<std::mutex> lk(l->mu);
    l->cv_ready.wait(lk, [&] {
      return !l->ready.empty() || l->stop.load() || l->dead.load();
    });
    if (l->ready.empty()) return 0;
    b = l->ready.front();
    l->ready.pop();
    l->cv_space.notify_one();
  }
  std::memcpy(moments, b->moments.data(), b->moments.size() * 4);
  std::memcpy(context, b->context.data(), b->context.size() * 4);
  if (seg && !b->seg.empty()) std::memcpy(seg, b->seg.data(), b->seg.size() * 4);
  delete b;
  return 1;
}

// Wakes every waiter and stops the workers; frees nothing.  Safe to call
// while another thread is inside fl_next, which then returns 0.
void fl_stop(void* handle) {
  auto* l = static_cast<Loader*>(handle);
  {
    std::lock_guard<std::mutex> lk(l->mu);
    l->stop.store(true);
  }
  l->cv_ready.notify_all();
  l->cv_space.notify_all();
}

// Stops, joins the workers and frees the loader; no fl_next may be running.
void fl_close(void* handle) {
  auto* l = static_cast<Loader*>(handle);
  fl_stop(handle);
  for (auto& t : l->workers) t.join();
  {
    std::lock_guard<std::mutex> lk(l->mu);
    while (!l->ready.empty()) {
      delete l->ready.front();
      l->ready.pop();
    }
  }
  delete l;
}

}  // extern "C"
