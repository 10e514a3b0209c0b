// Host-DRAM embedding store with its row optimizers: the port's copy of
// elasticdl_tpu/native/host_embedding.cc, the same algorithm and C API.
//
// Tables too large for the card's memory live in host DRAM behind this
// store (the role parameter-server pod memory played in ElasticDL): a
// step looks up the rows its batch touches, the card computes with
// them, and the row gradients come back here, where one of four sparse
// rules (SGD, momentum, Adam, Adagrad) moves exactly those rows and
// their slot rows. A row that does not exist yet is initialised on its
// first lookup, deterministically from (seed, id) by splitmix64, so the
// numpy store of native/host_embedding.py and the JAX package's store
// give the same row bit for bit.
//
// Host C++, not a CUDA kernel: ops/_build.py compiles it with the host
// compiler (c++ -O3 -shared -fPIC) at first use, and
// native/host_embedding.py binds the extern "C" functions with ctypes.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <shared_mutex>
#include <unordered_map>
#include <vector>

namespace {

// splitmix64: tiny, portable PRNG implemented identically in the numpy
// store (native/host_embedding.py _splitmix64_row) so both stores
// lazily initialize the same (seed, id) to the same row.
inline uint64_t splitmix64(uint64_t* state) {
  uint64_t z = (*state += 0x9E3779B97F4A7C15ULL);
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
  return z ^ (z >> 31);
}

struct Store {
  int64_t dim;
  uint64_t seed;
  float init_low;
  float init_high;
  // row id -> contiguous [dim] row; slot tables are separate Stores.
  std::unordered_map<int64_t, std::vector<float>> rows;
  mutable std::shared_mutex mu;

  Store(int64_t d, uint64_t s, float lo, float hi)
      : dim(d), seed(s), init_low(lo), init_high(hi) {}

  // Deterministic per-(seed, id) lazy init so restarts, replicas, and
  // the numpy store all agree without coordination.
  void init_row(int64_t id, std::vector<float>* row) const {
    row->resize(dim);
    uint64_t state = seed ^ static_cast<uint64_t>(id) * 0x9E3779B97F4A7C15ULL;
    const float span = init_high - init_low;
    for (int64_t i = 0; i < dim; ++i) {
      // top 53 bits -> uniform double in [0, 1)
      double frac = static_cast<double>(splitmix64(&state) >> 11)
                    * (1.0 / 9007199254740992.0);
      (*row)[i] = init_low + static_cast<float>(frac) * span;
    }
  }

  // Caller must hold `mu` exclusively: batch ops lock once per call
  // (per store, as ElasticDL's Go embedding table held one RWMutex)
  // and row references never escape the lock.
  std::vector<float>& get_or_init_locked(int64_t id) {
    auto [it, inserted] = rows.try_emplace(id);
    if (inserted) init_row(id, &it->second);
    return it->second;
  }
};

}  // namespace

extern "C" {

void* host_embedding_new(int64_t dim, uint64_t seed, float init_low,
                         float init_high) {
  return new Store(dim, seed, init_low, init_high);
}

void host_embedding_free(void* handle) {
  delete static_cast<Store*>(handle);
}

int64_t host_embedding_dim(void* handle) {
  return static_cast<Store*>(handle)->dim;
}

void host_embedding_clear(void* handle) {
  Store* store = static_cast<Store*>(handle);
  std::unique_lock<std::shared_mutex> lock(store->mu);
  store->rows.clear();
}

int64_t host_embedding_size(void* handle) {
  Store* store = static_cast<Store*>(handle);
  std::shared_lock<std::shared_mutex> lock(store->mu);
  return static_cast<int64_t>(store->rows.size());
}

// out: [n, dim] row-major. Lazily initializes missing rows.
void host_embedding_lookup(void* handle, const int64_t* ids, int64_t n,
                           float* out) {
  Store* store = static_cast<Store*>(handle);
  std::unique_lock<std::shared_mutex> lock(store->mu);
  for (int64_t i = 0; i < n; ++i) {
    const std::vector<float>& row = store->get_or_init_locked(ids[i]);
    std::memcpy(out + i * store->dim, row.data(),
                store->dim * sizeof(float));
  }
}

// Writes rows verbatim (checkpoint restore path).
void host_embedding_set(void* handle, const int64_t* ids, int64_t n,
                        const float* values) {
  Store* store = static_cast<Store*>(handle);
  std::unique_lock<std::shared_mutex> lock(store->mu);
  for (int64_t i = 0; i < n; ++i) {
    auto& row = store->rows[ids[i]];
    row.assign(values + i * store->dim, values + (i + 1) * store->dim);
  }
}

// Export up to `capacity` rows into caller buffers; returns the number
// written (the table may have grown since host_embedding_size()).
int64_t host_embedding_export(void* handle, int64_t* ids_out,
                              float* values_out, int64_t capacity) {
  Store* store = static_cast<Store*>(handle);
  std::shared_lock<std::shared_mutex> lock(store->mu);
  int64_t i = 0;
  for (const auto& kv : store->rows) {
    if (i >= capacity) break;
    ids_out[i] = kv.first;
    std::memcpy(values_out + i * store->dim, kv.second.data(),
                store->dim * sizeof(float));
    ++i;
  }
  return i;
}

// ---- sparse optimizer kernels: param store + slot stores passed as
// handles, ids deduplicated by the caller.

void host_embedding_sgd(void* param_h, const int64_t* ids,
                        const float* grads, int64_t n, float lr) {
  Store* param = static_cast<Store*>(param_h);
  std::unique_lock<std::shared_mutex> lock(param->mu);
  const int64_t dim = param->dim;
  for (int64_t i = 0; i < n; ++i) {
    std::vector<float>& p = param->get_or_init_locked(ids[i]);
    const float* g = grads + i * dim;
    for (int64_t k = 0; k < dim; ++k) p[k] -= lr * g[k];
  }
}

void host_embedding_momentum(void* param_h, void* vel_h,
                             const int64_t* ids, const float* grads,
                             int64_t n, float lr, float mu,
                             int nesterov) {
  Store* param = static_cast<Store*>(param_h);
  Store* vel = static_cast<Store*>(vel_h);
  // scoped_lock's deadlock-avoidance covers concurrent checkpoints
  // locking individual stores
  std::scoped_lock lock(param->mu, vel->mu);
  const int64_t dim = param->dim;
  for (int64_t i = 0; i < n; ++i) {
    std::vector<float>& p = param->get_or_init_locked(ids[i]);
    std::vector<float>& v = vel->get_or_init_locked(ids[i]);
    const float* g = grads + i * dim;
    for (int64_t k = 0; k < dim; ++k) {
      v[k] = mu * v[k] + g[k];
      p[k] -= lr * (nesterov ? mu * v[k] + g[k] : v[k]);
    }
  }
}

void host_embedding_adam(void* param_h, void* m_h, void* v_h,
                         const int64_t* ids, const float* grads,
                         int64_t n, float lr, float beta1, float beta2,
                         float eps, int64_t step) {
  Store* param = static_cast<Store*>(param_h);
  Store* m_store = static_cast<Store*>(m_h);
  Store* v_store = static_cast<Store*>(v_h);
  std::scoped_lock lock(param->mu, m_store->mu, v_store->mu);
  const int64_t dim = param->dim;
  const double t = static_cast<double>(step);
  const float alpha = static_cast<float>(
      lr * std::sqrt(1.0 - std::pow(beta2, t)) /
      (1.0 - std::pow(beta1, t)));
  for (int64_t i = 0; i < n; ++i) {
    std::vector<float>& p = param->get_or_init_locked(ids[i]);
    std::vector<float>& m = m_store->get_or_init_locked(ids[i]);
    std::vector<float>& v = v_store->get_or_init_locked(ids[i]);
    const float* g = grads + i * dim;
    for (int64_t k = 0; k < dim; ++k) {
      m[k] = beta1 * m[k] + (1.0f - beta1) * g[k];
      v[k] = beta2 * v[k] + (1.0f - beta2) * g[k] * g[k];
      p[k] -= alpha * m[k] / (std::sqrt(v[k]) + eps);
    }
  }
}

void host_embedding_adagrad(void* param_h, void* accum_h,
                            const int64_t* ids, const float* grads,
                            int64_t n, float lr, float eps) {
  Store* param = static_cast<Store*>(param_h);
  Store* accum = static_cast<Store*>(accum_h);
  std::scoped_lock lock(param->mu, accum->mu);
  const int64_t dim = param->dim;
  for (int64_t i = 0; i < n; ++i) {
    std::vector<float>& p = param->get_or_init_locked(ids[i]);
    std::vector<float>& a = accum->get_or_init_locked(ids[i]);
    const float* g = grads + i * dim;
    for (int64_t k = 0; k < dim; ++k) {
      a[k] += g[k] * g[k];
      p[k] -= lr * g[k] / (std::sqrt(a[k]) + eps);
    }
  }
}

}  // extern "C"
