// Native trajectory batch loader: mmap'd .npy atom14 memmaps -> prefetched
// host batches.
//
// The port's copy of the JAX package's batch loader (native/loader.cpp), in
// place of the reference's torch DataLoader workers
// (src/mdgen/dataset.py + torch.utils.data.DataLoader in src/train.py:32-43):
// the hot host path — window selection, f16->f32 conversion, crop/pad,
// batch assembly — runs in C++ worker threads over memory-mapped files, with
// a bounded ring of ready batches so the accelerator never waits on Python.
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 dependency).
//
// .npy format handled: v1.0/2.0 headers, C-order, dtypes <f2 and <f4, shape
// (T, L, 14, 3).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <mutex>
#include <queue>
#include <random>
#include <string>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct F16 {
  uint16_t bits;
};

static inline float f16_to_f32(uint16_t h) {
  uint32_t sign = (uint32_t)(h & 0x8000) << 16;
  uint32_t exp = (h >> 10) & 0x1f;
  uint32_t mant = h & 0x3ff;
  uint32_t f;
  if (exp == 0) {
    if (mant == 0) {
      f = sign;
    } else {  // subnormal
      exp = 127 - 15 + 1;
      while (!(mant & 0x400)) {
        mant <<= 1;
        exp--;
      }
      mant &= 0x3ff;
      f = sign | (exp << 23) | (mant << 13);
    }
  } else if (exp == 31) {
    f = sign | 0x7f800000 | (mant << 13);
  } else {
    f = sign | ((exp - 15 + 127) << 23) | (mant << 13);
  }
  float out;
  std::memcpy(&out, &f, 4);
  return out;
}

struct Traj {
  const uint8_t* data = nullptr;  // payload start
  size_t mapped_size = 0;
  const uint8_t* map_base = nullptr;
  int64_t T = 0, L = 0;
  bool is_f16 = true;
  std::vector<int32_t> aatype;  // length L
};

struct Batch {
  std::vector<float> atom14;   // B*T*crop*14*3
  std::vector<int32_t> seqres; // B*crop
  std::vector<float> mask;     // B*crop
};

struct Loader {
  std::vector<Traj> trajs;
  int64_t batch_size = 0, num_frames = 0, crop = 0, frame_interval = 1;
  std::mt19937_64 rng;
  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  std::queue<Batch*> ready;
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};
  size_t max_queue = 4;

  ~Loader() {
    stop.store(true);
    cv_space.notify_all();
    for (auto& t : workers)
      if (t.joinable()) t.join();
    while (!ready.empty()) {
      delete ready.front();
      ready.pop();
    }
    for (auto& tr : trajs)
      if (tr.map_base) munmap((void*)tr.map_base, tr.mapped_size);
  }

  void fill(Batch* b, std::mt19937_64& lrng) {
    const int64_t B = batch_size, T = num_frames, C = crop;
    b->atom14.resize(B * T * C * 14 * 3);
    b->seqres.resize(B * C);
    b->mask.resize(B * C);
    for (int64_t i = 0; i < B; i++) {
      const Traj& tr = trajs[lrng() % trajs.size()];
      const int64_t eff_T = (tr.T + frame_interval - 1) / frame_interval;
      const int64_t span = eff_T > T ? eff_T - T : 1;
      const int64_t start = (int64_t)(lrng() % (uint64_t)span);
      // crop window over residues
      int64_t cstart = 0;
      const int64_t Luse = tr.L < C ? tr.L : C;
      if (tr.L > C) cstart = (int64_t)(lrng() % (uint64_t)(tr.L - C + 1));

      float* out = b->atom14.data() + i * T * C * 14 * 3;
      for (int64_t f = 0; f < T; f++) {
        int64_t src_f = (start + f) < eff_T ? (start + f) : eff_T - 1;  // repeat last
        src_f *= frame_interval;
        const uint8_t* frame = tr.data + (size_t)src_f * tr.L * 14 * 3 * (tr.is_f16 ? 2 : 4);
        for (int64_t l = 0; l < Luse; l++) {
          const uint8_t* res = frame + (size_t)(cstart + l) * 14 * 3 * (tr.is_f16 ? 2 : 4);
          float* dst = out + ((f * C + l) * 14 * 3);
          if (tr.is_f16) {
            const uint16_t* src = (const uint16_t*)res;
            for (int a = 0; a < 42; a++) dst[a] = f16_to_f32(src[a]);
          } else {
            std::memcpy(dst, res, 42 * sizeof(float));
          }
        }
        for (int64_t l = Luse; l < C; l++)
          std::memset(out + ((f * C + l) * 14 * 3), 0, 42 * sizeof(float));
      }
      for (int64_t l = 0; l < C; l++) {
        bool pad = l >= Luse;
        b->seqres[i * C + l] = pad ? 0 : tr.aatype[cstart + l];
        b->mask[i * C + l] = pad ? 0.f : 1.f;
      }
    }
  }

  void worker(uint64_t seed) {
    std::mt19937_64 lrng(seed);
    while (!stop.load()) {
      Batch* b = new Batch();
      fill(b, lrng);
      std::unique_lock<std::mutex> lk(mu);
      cv_space.wait(lk, [&] { return ready.size() < max_queue || stop.load(); });
      if (stop.load()) {
        delete b;
        return;
      }
      ready.push(b);
      cv_ready.notify_one();
    }
  }
};

bool parse_npy(const char* path, Traj* out) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return false;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return false;
  }
  const uint8_t* base = (const uint8_t*)mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  close(fd);
  if (base == MAP_FAILED) return false;
  if (std::memcmp(base, "\x93NUMPY", 6) != 0) {
    munmap((void*)base, st.st_size);
    return false;
  }
  uint8_t major = base[6];
  size_t header_len, header_off;
  if (major == 1) {
    header_len = base[8] | (base[9] << 8);
    header_off = 10;
  } else {
    header_len = base[8] | (base[9] << 8) | ((size_t)base[10] << 16) | ((size_t)base[11] << 24);
    header_off = 12;
  }
  std::string header((const char*)base + header_off, header_len);
  out->is_f16 = header.find("<f2") != std::string::npos;
  if (!out->is_f16 && header.find("<f4") == std::string::npos) {
    munmap((void*)base, st.st_size);
    return false;
  }
  size_t sp = header.find("'shape':");
  size_t lp = header.find('(', sp);
  long dims[4] = {0, 0, 0, 0};
  if (sscanf(header.c_str() + lp, "(%ld, %ld, %ld, %ld)", &dims[0], &dims[1], &dims[2], &dims[3]) != 4 ||
      dims[2] != 14 || dims[3] != 3) {
    munmap((void*)base, st.st_size);
    return false;
  }
  // reject truncated/inconsistent files: the mmap must cover the declared
  // shape, or workers would read out of bounds (SIGBUS/garbage)
  size_t itemsize = out->is_f16 ? 2 : 4;
  size_t need = header_off + header_len +
                (size_t)dims[0] * (size_t)dims[1] * 14 * 3 * itemsize;
  if ((size_t)st.st_size < need) {
    munmap((void*)base, st.st_size);
    return false;
  }
  out->map_base = base;
  out->mapped_size = st.st_size;
  out->data = base + header_off + header_len;
  out->T = dims[0];
  out->L = dims[1];
  return true;
}

}  // namespace

extern "C" {

void* ld_create(int64_t batch_size, int64_t num_frames, int64_t crop, int64_t frame_interval,
                uint64_t seed, int64_t n_threads, int64_t max_queue) {
  auto* ld = new Loader();
  ld->batch_size = batch_size;
  ld->num_frames = num_frames;
  ld->crop = crop;
  ld->frame_interval = frame_interval > 0 ? frame_interval : 1;
  ld->rng.seed(seed);
  ld->max_queue = max_queue > 0 ? (size_t)max_queue : 4;
  (void)n_threads;
  return ld;
}

// aatype: int32 array of length L for this trajectory
int ld_add_traj(void* handle, const char* path, const int32_t* aatype, int64_t L_seq) {
  auto* ld = (Loader*)handle;
  Traj tr;
  if (!parse_npy(path, &tr)) return -1;
  if (L_seq != tr.L) {
    munmap((void*)tr.map_base, tr.mapped_size);
    return -2;
  }
  tr.aatype.assign(aatype, aatype + L_seq);
  ld->trajs.push_back(std::move(tr));
  return 0;
}

int ld_start(void* handle, int64_t n_threads) {
  auto* ld = (Loader*)handle;
  if (ld->trajs.empty()) return -1;
  for (int64_t i = 0; i < (n_threads > 0 ? n_threads : 1); i++) {
    // draw the seed on the main thread: ld->rng is not thread-safe, and
    // calling it from inside the new threads would race (and could hand
    // several workers identical seeds -> duplicate batches)
    uint64_t s = ld->rng() + (uint64_t)i;
    ld->workers.emplace_back([ld, s] { ld->worker(s); });
  }
  return 0;
}

// copies the next ready batch into caller buffers; blocks until available
int ld_next(void* handle, float* atom14, int32_t* seqres, float* mask) {
  auto* ld = (Loader*)handle;
  Batch* b = nullptr;
  {
    std::unique_lock<std::mutex> lk(ld->mu);
    ld->cv_ready.wait(lk, [&] { return !ld->ready.empty() || ld->stop.load(); });
    if (ld->stop.load() && ld->ready.empty()) return -1;
    b = ld->ready.front();
    ld->ready.pop();
    ld->cv_space.notify_one();
  }
  std::memcpy(atom14, b->atom14.data(), b->atom14.size() * sizeof(float));
  std::memcpy(seqres, b->seqres.data(), b->seqres.size() * sizeof(int32_t));
  std::memcpy(mask, b->mask.data(), b->mask.size() * sizeof(float));
  delete b;
  return 0;
}

void ld_destroy(void* handle) { delete (Loader*)handle; }

}  // extern "C"
