// Embedding row gather for Hopper (sm_90a).
//
// Replaces the TPU kernel elasticdl_tpu/ops/embedding_ops.py::_gather_kernel
// (launched by embedding_gather through pl.pallas_call). Same function:
// out[i, :] = table[clip(ids[i], 0, vocab - 1), :] for int32 ids, so a
// padding id (-1) reads row 0 and an id past the table reads its last
// row; an out-of-range id never reads memory outside the table.
//
// What bounds it on the H100: it does no arithmetic; it moves
// n * dim * itemsize bytes in, as many out, and 4 n bytes of ids, so it
// is bound by memory bytes (3.35 TB/s). The rows it reads are scattered
// over a table far larger than the 50 MB L2 (a DLRM table is 154 MB), so
// every row is a separate DRAM burst; what matters is having many rows in
// flight at once, which the TPU kernel got from 8 row DMAs in flight.
//
// Design: one warp per id, grid-stride over ids. The warp reads its id,
// computes the row offset in 64 bits (a 1.2M x 32 table already needs
// 38.4M elements; larger tables pass 2^31) and copies the row with
// 16-byte vector loads and stores when the row is a multiple of 16 bytes
// and both pointers are 16-byte aligned, one element per lane otherwise.
// The copy moves raw bits (the element type is only its width), so the
// output equals table[ids] bit for bit in any float dtype of 2 or 4
// bytes. Thousands of warps, each with its own row in flight, take the
// place of the TPU kernel's DMA ring.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int NT = 256;  // 8 warps a block
constexpr int WARPS = NT / 32;

template <typename E>
__global__ void __launch_bounds__(NT)
    gather_kernel(const E* __restrict__ table, const int* __restrict__ ids,
                  E* __restrict__ out, long long n, long long vocab, int dim,
                  int vec16) {
  const int lane = threadIdx.x & 31;
  const long long nwarps = (long long)gridDim.x * WARPS;
  for (long long i = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
       i < n; i += nwarps) {
    long long r = __ldg(ids + i);
    r = r < 0 ? 0 : (r >= vocab ? vocab - 1 : r);
    const E* src = table + r * dim;
    E* dst = out + i * dim;
    if (vec16) {
      const int nv = (int)(dim * sizeof(E) / 16);
      const int4* s4 = reinterpret_cast<const int4*>(src);
      int4* d4 = reinterpret_cast<int4*>(dst);
      for (int j = lane; j < nv; j += 32) d4[j] = __ldg(s4 + j);
    } else {
      for (int j = lane; j < dim; j += 32) dst[j] = __ldg(src + j);
    }
  }
}

template <typename E>
int launch(const void* table, const void* ids, void* out, long long n,
           long long vocab, int dim, int vec16, cudaStream_t stream) {
  long long blocks = (n + WARPS - 1) / WARPS;
  if (blocks > 132 * 64) blocks = 132 * 64;  // grid-stride beyond this
  gather_kernel<E><<<(unsigned)blocks, NT, 0, stream>>>(
      static_cast<const E*>(table), static_cast<const int*>(ids),
      static_cast<E*>(out), n, vocab, dim, vec16);
  return (int)cudaGetLastError();
}

}  // namespace

// table [vocab, dim] contiguous, elements of `itemsize` bytes (2 or 4);
// ids [n] int32; out [n, dim] like table. vec16: 1 when dim * itemsize is
// a multiple of 16 and table and out are 16-byte aligned. Returns the
// cudaError_t of the launch (0 = launched).
extern "C" int edl_embedding_gather(const void* table, const void* ids,
                                    void* out, long long n, long long vocab,
                                    int dim, int itemsize, int vec16,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || dim <= 0) return 0;
  if (vocab <= 0) return (int)cudaErrorInvalidValue;
  if (itemsize == 4)
    return launch<uint32_t>(table, ids, out, n, vocab, dim, vec16, s);
  if (itemsize == 2)
    return launch<uint16_t>(table, ids, out, n, vocab, dim, vec16, s);
  return (int)cudaErrorInvalidValue;
}
