// Embedding row gather for Hopper (sm_90a), over up to MAX_TABLES tables
// in one launch.
//
// Replaces the TPU kernel elasticdl_tpu/ops/embedding_ops.py::_gather_kernel
// (launched by embedding_gather through pl.pallas_call). Same function,
// per table: out[i, :] = table[clip(ids[i], 0, vocab - 1), :] for int32
// ids, so a padding id (-1) reads row 0 and an id past the table reads
// its last row; an out-of-range id never reads memory outside the table.
// A DLRM forward gathers from its 26 tables at once; the TPU kernel took
// them one pallas_call each.
//
// What bounds it on the H100: it does no arithmetic; it moves
// n * dim * itemsize bytes in, as many out, and 4 n bytes of ids, so it
// is bound by memory bytes (3.35 TB/s). A DLRM step's 26 x 4096 rows of
// 128 bytes are 27.7 MB, 8.3 us at that rate. The rows are scattered over
// tables far larger than the 50 MB L2 (each DLRM table is 154 MB), so
// every row is its own DRAM burst, and the row's address waits for its
// id: two dependent memory latencies. One table's 1 MB gather is shorter
// than a launch plus those two latencies, so what is left to gain lies
// across the tables of a step and in rows in flight.
//
// Design: one launch for all the tables a call gives, their pointers,
// id counts and vocab sizes passed by value in the kernel's parameters
// (read through __grid_constant__, without a local copy). Grid row y is
// table y, so a block finds its table's descriptor in one read of the
// parameters (a search over chunk prefix sums, a dependent read of the
// SM's cold constant cache a step, made one table's row update, which
// shares this design, 1.36x slower).
// The block's warps walk the table's 32-id chunks, grid-stride. A warp
// loads its chunk's 32 ids in one coalesced load, clamps them and hands
// them out by shuffle, so an id's round trip is paid once per 32 rows. A
// row is split over 16-byte units when every row is a multiple of 16
// bytes and every table and output pointer is 16-byte aligned (8 lanes a
// row at dim 32 fp32, so a warp covers 4 rows a pass), over elements
// otherwise; the chunk's (row, unit) pairs are dealt to the lanes in
// order, so neighbouring lanes read neighbouring units of a row and the
// stores are one contiguous run. Each lane issues BATCH = 8 loads before
// its first store, none of them predicated, so a warp keeps 32 rows in
// flight (a predicated load's value is moved into its register behind
// the next load, which then waits for it: 2 rows in flight a lane, and
// one table's call 1.6x slower). Table rows are read once a step, with
// the streaming hint (ld.global.cs; ld.global.nc with and without
// L1::no_allocate measured the same); the output is stored plainly,
// since the next kernels read it. Offsets are 64-bit. The copy moves raw
// bits (the element type is only its width), so the output equals
// table[ids] bit for bit in any float dtype of 2 or 4 bytes.
//
// Hopper's bulk copy (cp.async.bulk: each of a block's 64 rows into
// shared memory against one mbarrier, then one bulk store of them all)
// was built and measured against this design: about as fast over a
// step, slower for one table (PERF.md), and it takes only rows of 16-byte
// multiples at 16-byte aligned addresses; the register design stayed.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int MAX_TABLES = 32;  // ops/embedding_ops.py's GROUP_TABLES
constexpr int BATCH = 8;        // loads a lane issues before its stores
constexpr int SMS = 132;

struct GatherTable {
  const void* table;
  const int* ids;
  void* out;
  long long n;
  long long vocab;
};

struct GatherArgs {
  GatherTable t[MAX_TABLES];  // table y is grid row y
  int units;                  // units of U in a row
};

// U: the unit a lane copies, int4 (16 bytes) or the element's width
template <typename U>
__global__ void __launch_bounds__(256)
    gather_kernel(const __grid_constant__ GatherArgs args) {
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const GatherTable& d = args.t[blockIdx.y];
  const int units = args.units;
  // a lane's next unit is 32 units on: q rows and r units further
  const int q = 32 / units, r = 32 % units;
  for (long long first = ((long long)blockIdx.x * warps + (threadIdx.x >> 5))
                         * 32;
       first < d.n; first += (long long)gridDim.x * warps * 32) {
    const int count = (int)min(32LL, d.n - first);
    int id = 0;
    if (lane < count) {
      const long long raw = __ldg(d.ids + first + lane);
      id = (int)(raw < 0 ? 0 : (raw >= d.vocab ? d.vocab - 1 : raw));
    }
    const U* __restrict__ table = static_cast<const U*>(d.table);
    U* __restrict__ out = static_cast<U*>(d.out) + first * units;
    const int n_units = count * units;
    int row = lane / units, u = lane % units;
    for (int base = 0; base < n_units; base += 32 * BATCH) {
      U buf[BATCH];
#pragma unroll
      for (int k = 0; k < BATCH; ++k) {
        // every lane loads, past the chunk's rows too (row 0 then: a lane
        // past `count` holds id 0), so no load is predicated: the
        // compiler then gives each its own register, where a predicated
        // load's value is moved into place behind the next load, which
        // waits on it (2 rows in flight a lane, not BATCH)
        const int src = __shfl_sync(0xffffffffu, id, row & 31);
        buf[k] = __ldcs(table + (long long)src * units + u);
        row += q;
        u += r;
        if (u >= units) {
          u -= units;
          ++row;
        }
      }
#pragma unroll
      for (int k = 0; k < BATCH; ++k) {
        const int f = base + 32 * k + lane;
        if (f < n_units) out[f] = buf[k];
      }
    }
  }
}

// warps a block: the most, up to 8, that still give every SM 8 blocks,
// so a small gather spreads over the SMs and a large one is not a
// handful of blocks more on some SMs than on others
int warps_per_block(long long chunks) {
  int w = 8;
  while (w > 1 && chunks < (long long)w * SMS * 8) w >>= 1;
  return w;
}

// grid: blocks enough for the largest table's chunks in each row
// (grid-stride beyond SMS * 32 blocks in all), a row per table
template <typename U>
int launch(const GatherArgs& args, int n_tables, long long chunks,
           long long most_chunks, cudaStream_t stream) {
  const int warps = warps_per_block(chunks);
  long long x = (most_chunks + warps - 1) / warps;
  if (x * n_tables > SMS * 32) x = (SMS * 32 + n_tables - 1) / n_tables;
  gather_kernel<U><<<dim3((unsigned)x, (unsigned)n_tables), warps * 32, 0,
                     stream>>>(args);
  return (int)cudaGetLastError();
}

}  // namespace

// n_tables tables (1..MAX_TABLES), each described by 5 values in `desc`:
// table [vocab, dim] contiguous, ids [n] int32, out [n, dim] like the
// table (pointers as integers), n > 0, vocab > 0. Elements of `itemsize`
// bytes (2 or 4). vec16: 1 when dim * itemsize is a multiple of 16 and
// every table and out pointer is 16-byte aligned. One launch. Returns the
// cudaError_t of the launch (0 = launched).
extern "C" int edl_embedding_gather(int n_tables, const long long* desc,
                                    int dim, int itemsize, int vec16,
                                    void* stream) {
  if (n_tables < 1 || n_tables > MAX_TABLES || dim <= 0)
    return (int)cudaErrorInvalidValue;
  if (itemsize != 2 && itemsize != 4) return (int)cudaErrorInvalidValue;
  GatherArgs args;
  long long chunks = 0, most = 0;
  for (int i = 0; i < n_tables; ++i) {
    const long long* v = desc + 5 * i;
    if (v[3] <= 0 || v[4] <= 0) return (int)cudaErrorInvalidValue;
    args.t[i] = {reinterpret_cast<const void*>(v[0]),
                 reinterpret_cast<const int*>(v[1]),
                 reinterpret_cast<void*>(v[2]), v[3], v[4]};
    chunks += (v[3] + 31) / 32;
    if ((v[3] + 31) / 32 > most) most = (v[3] + 31) / 32;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec16) {
    args.units = dim * itemsize / 16;
    return launch<int4>(args, n_tables, chunks, most, s);
  }
  args.units = dim;
  if (itemsize == 4)
    return launch<unsigned int>(args, n_tables, chunks, most, s);
  return launch<unsigned short>(args, n_tables, chunks, most, s);
}
