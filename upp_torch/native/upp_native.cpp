// UPP native host-runtime components (a copy of upp_tpu/native/upp_native.cpp
// for the PyTorch port, which imports nothing of the JAX package).
//
// The reference ships its hot host-side primitives as native extensions
// (extensions/chamfer_dist, extensions/emd, pip CUDA ops); the device math
// lives in the port's CUDA kernels, and this library provides the
// *host-runtime* native pieces:
//
//   * upp_fps       — exact pointnet2-style farthest point sampling
//                     (datasets/ModelNetDataset.py:29-49 cache building,
//                     ~100x the numpy loop)
//   * upp_fps_batch — multi-threaded batched FPS
//   * upp_read_npy_batch — parallel .npy point-cloud reader feeding the
//                     BatchLoader (replaces torch DataLoader worker procs)
//
// Build: g++ -O3 -march=native -shared -fPIC -pthread upp_native.cpp -o libupp_native.so

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <functional>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------- FPS core
void fps_one(const float* pts, int n, int m, int start, int32_t* out_idx,
             float* dist_buf) {
  for (int i = 0; i < n; ++i) dist_buf[i] = 1e10f;
  int cur = start;
  for (int s = 0; s < m; ++s) {
    out_idx[s] = cur;
    const float cx = pts[3 * cur], cy = pts[3 * cur + 1], cz = pts[3 * cur + 2];
    float best = -1.0f;
    int best_i = 0;
    for (int i = 0; i < n; ++i) {
      const float dx = pts[3 * i] - cx;
      const float dy = pts[3 * i + 1] - cy;
      const float dz = pts[3 * i + 2] - cz;
      const float d = dx * dx + dy * dy + dz * dz;
      if (d < dist_buf[i]) dist_buf[i] = d;
      if (dist_buf[i] > best) { best = dist_buf[i]; best_i = i; }
    }
    cur = best_i;
  }
}

// ------------------------------------------------------------- npy parsing
// Minimal NPY v1/v2 reader for C-contiguous float32/float64 arrays.
bool read_npy_f32(const char* path, float* out, int64_t max_elems,
                  int64_t* n_elems) {
  std::ifstream f(path, std::ios::binary);
  if (!f) return false;
  char magic[6];
  f.read(magic, 6);
  if (memcmp(magic, "\x93NUMPY", 6) != 0) return false;
  uint8_t ver[2];
  f.read(reinterpret_cast<char*>(ver), 2);
  uint32_t hlen = 0;
  if (ver[0] == 1) {
    uint16_t h16;
    f.read(reinterpret_cast<char*>(&h16), 2);
    hlen = h16;
  } else {
    f.read(reinterpret_cast<char*>(&hlen), 4);
  }
  std::string header(hlen, '\0');
  f.read(&header[0], hlen);
  const bool f8 = header.find("<f8") != std::string::npos;
  if (!f8 && header.find("<f4") == std::string::npos) return false;
  if (header.find("'fortran_order': True") != std::string::npos) return false;

  // element count from the shape tuple
  auto sp = header.find("'shape':");
  if (sp == std::string::npos) return false;
  auto lp = header.find('(', sp), rp = header.find(')', sp);
  int64_t count = 1;
  {
    std::string dims = header.substr(lp + 1, rp - lp - 1);
    int64_t v = 0;
    bool any = false, in_num = false;
    for (char c : dims) {
      if (c >= '0' && c <= '9') { v = v * 10 + (c - '0'); in_num = true; }
      else if (in_num) { count *= v; v = 0; in_num = false; any = true; }
    }
    if (in_num) { count *= v; any = true; }
    if (!any) return false;
  }
  if (count > max_elems) count = max_elems;
  *n_elems = count;
  if (f8) {
    std::vector<double> tmp(count);
    f.read(reinterpret_cast<char*>(tmp.data()), count * 8);
    for (int64_t i = 0; i < count; ++i) out[i] = static_cast<float>(tmp[i]);
  } else {
    f.read(reinterpret_cast<char*>(out), count * 4);
  }
  return static_cast<bool>(f);
}

void parallel_for(int n_items, int n_threads, const std::function<void(int)>& fn) {
  std::atomic<int> next{0};
  auto worker = [&]() {
    for (int i = next.fetch_add(1); i < n_items; i = next.fetch_add(1)) fn(i);
  };
  std::vector<std::thread> pool;
  const int t = n_threads > 0 ? n_threads : 1;
  pool.reserve(t);
  for (int i = 0; i < t; ++i) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// Single-cloud FPS: pts [n,3] row-major → out_idx [m].
void upp_fps(const float* pts, int n, int m, int start, int32_t* out_idx) {
  std::vector<float> dist(n);
  fps_one(pts, n, m, start, out_idx, dist.data());
}

// Batched multi-threaded FPS: pts [b,n,3] → out_idx [b,m].
void upp_fps_batch(const float* pts, int b, int n, int m, int32_t* out_idx,
                   int n_threads) {
  parallel_for(b, n_threads, [&](int i) {
    std::vector<float> dist(n);
    fps_one(pts + static_cast<int64_t>(i) * n * 3, n, m, 0,
            out_idx + static_cast<int64_t>(i) * m, dist.data());
  });
}

// Parallel npy batch read: `paths` is b concatenated NUL-terminated strings.
// Each file is read into out[i * stride : i * stride + stride] (f32), short
// files zero-padded. Returns number of successfully read files.
int upp_read_npy_batch(const char* paths, int b, int64_t stride, float* out,
                       int n_threads) {
  std::vector<const char*> ptrs(b);
  const char* p = paths;
  for (int i = 0; i < b; ++i) {
    ptrs[i] = p;
    p += strlen(p) + 1;
  }
  std::atomic<int> ok{0};
  parallel_for(b, n_threads, [&](int i) {
    float* dst = out + static_cast<int64_t>(i) * stride;
    int64_t got = 0;
    if (read_npy_f32(ptrs[i], dst, stride, &got)) {
      if (got < stride) memset(dst + got, 0, (stride - got) * sizeof(float));
      ok.fetch_add(1);
    } else {
      memset(dst, 0, stride * sizeof(float));
    }
  });
  return ok.load();
}

}  // extern "C"
