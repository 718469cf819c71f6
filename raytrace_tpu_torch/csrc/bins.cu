// Masked multi-column scatter for Hopper (sm_90a): per-ray float64 values
// summed into bins, the rays outside a mask skipped.
//
// Replaces no TPU kernel. The JAX package bins with XLA's scatter-add
// (raytrace_tpu/ops/reductions.py), and the port did so with torch's
// index_add_: one pass a column, every ray added (a masked one as 0.0 into
// a scrap bin), each add a float64 atomic in device memory. The emissivity
// table's 100 radial bins took five such passes of 2.5M rays a job, 12.5M
// atomics onto ~100 addresses, most onto the scrap bin: ~15 ms against the
// ~0.03 ms its ~100 MB of reads take at 3.35 TB/s.
//
// What bounds it on this card: the reads (an int64 id, a mask byte and k
// float64 values a ray), where the adds do not serialise on a few
// addresses. What the design does about that: a ray outside the mask reads
// no id and no value and adds nothing; and the adds follow the bins.
//  - Block-local route (launch warps > 0), for a few bins: each warp keeps
//    its own copy of the (k + 1) x n_bins bins in shared memory, so no two
//    warps add to one address. In a warp, __match_any_sync groups the lanes
//    that hit one bin; the group's lowest lane adds the others' values to
//    its own, in lane order, by shuffles, and alone writes the sums into
//    the warp's copy (no atomics). At the end the block sums its warps'
//    copies into one row of partials in device memory, and a second small
//    kernel sums those rows in block order. Which rays a block takes
//    depends only on the grid, so on one card the sums come out the same
//    bits from run to run.
//  - Global route (warps = 0), for many bins (the image's 10^6 pixels):
//    one float64 atomic a row a ray in the mask, onto bins that neighbouring
//    rays rarely share; the sums' order varies from run to run.
// Row 0 of the output is the count of the rays in the mask, row 1 + c the
// sum of column c over them; bins are the rows' columns.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxColumns = 16;  // reductions.py MAX_COLUMNS
constexpr size_t kSharedBytes = 48 * 1024;  // a block's, without the opt-in
constexpr int kGlobalThreads = 256;
constexpr int kReduceX = 32, kReduceY = 32;
constexpr unsigned kFull = 0xffffffffu;

struct Columns {
  const double* v[kMaxColumns];
};

__global__ void bin_scatter_global_kernel(const int64_t* __restrict__ ids,
                                          const uint8_t* __restrict__ mask, Columns cols, int k,
                                          int64_t n, int64_t n_bins, double* __restrict__ out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    if (!mask[i]) continue;
    const int64_t id = ids[i];
    if (id < 0 || id >= n_bins) continue;
    atomicAdd(out + id, 1.0);
    for (int c = 0; c < k; ++c) atomicAdd(out + (c + 1) * n_bins + id, cols.v[c][i]);
  }
}

// Each warp takes 32 consecutive rays at a time, a block's warps
// neighbouring runs of them, the grid striding over the batch; whole warps
// stay in the loop, so every shuffle has all 32 lanes.
__global__ void bin_scatter_block_kernel(const int64_t* __restrict__ ids,
                                         const uint8_t* __restrict__ mask, Columns cols, int k,
                                         int64_t n, int n_bins, double* __restrict__ partials) {
  extern __shared__ double bins[];
  const int width = (k + 1) * n_bins;
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int j = threadIdx.x; j < warps * width; j += blockDim.x) bins[j] = 0.0;
  __syncthreads();
  double* const mine = bins + warp * width;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i - lane < n;
       i += stride) {
    int id = -1;  // -1: the lane adds nothing
    if (i < n && mask[i]) {
      const int64_t raw = ids[i];
      if (raw >= 0 && raw < n_bins) id = static_cast<int>(raw);
    }
    const unsigned peers = __match_any_sync(kFull, id);
    const bool lead = id >= 0 && lane == __ffs(peers) - 1;
    const unsigned others = lead ? peers & (peers - 1) : 0u;  // the group but its lead
    const int rounds = __reduce_max_sync(kFull, id >= 0 ? __popc(peers) - 1 : 0);
    if (lead) mine[id] += static_cast<double>(__popc(peers));
    for (int c = 0; c < k; ++c) {
      const double v = id >= 0 ? cols.v[c][i] : 0.0;
      double sum = v;
      unsigned rest = others;
      for (int r = 0; r < rounds; ++r) {
        const int src = rest ? __ffs(rest) - 1 : lane;
        const double w = __shfl_sync(kFull, v, src);
        if (rest) {
          sum += w;
          rest &= rest - 1;
        }
      }
      if (lead) mine[(c + 1) * n_bins + id] += sum;
    }
    __syncwarp();  // this pass's writes before the next pass's lead reads
  }
  __syncthreads();
  double* const row = partials + static_cast<int64_t>(blockIdx.x) * width;
  for (int j = threadIdx.x; j < width; j += blockDim.x) {
    double s = bins[j];
    for (int w = 1; w < warps; ++w) s += bins[w * width + j];
    row[j] = s;
  }
}

// out[j] = the sum over blocks of partials[b][j], in a fixed order: a
// thread column sums every kReduceY-th block, then one thread the columns.
__global__ void bin_scatter_reduce_kernel(const double* __restrict__ partials, int64_t blocks,
                                          int width, double* __restrict__ out) {
  __shared__ double acc[kReduceY][kReduceX + 1];
  const int j = blockIdx.x * kReduceX + threadIdx.x;
  double s = 0.0;
  if (j < width)
    for (int64_t b = threadIdx.y; b < blocks; b += kReduceY) s += partials[b * width + j];
  acc[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && j < width) {
    double t = acc[0][threadIdx.x];
    for (int y = 1; y < kReduceY; ++y) t += acc[y][threadIdx.x];
    out[j] = t;
  }
}

size_t block_bytes(int warps, int64_t width) {
  return static_cast<size_t>(warps) * static_cast<size_t>(width) * sizeof(double);
}

}  // namespace

extern "C" {

// Scatter on `stream` the n rays whose mask byte is set: out, a
// (k + 1) x n_bins float64 array, gets the count of the rays in each bin in
// row 0 and the sum of columns[c] (k <= 16 device pointers to n float64)
// in row 1 + c. Ids outside [0, n_bins) add nothing. warps > 0: the
// block-local route, `blocks` blocks of that many warps, partials a
// blocks x (k + 1) x n_bins float64 scratch, out written whole; warps = 0:
// the global route, out zeroed by the caller. Returns cudaGetLastError()
// after the launches (0 on success); does not synchronise.
int rt_bin_scatter_launch(const void* ids, const void* mask, const void* const* columns, int k,
                          int64_t n, int64_t n_bins, int warps, int64_t blocks, void* partials,
                          void* out, void* stream) {
  if (n <= 0 || n_bins <= 0 || k < 0 || k > kMaxColumns || warps < 0 || warps > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  Columns cols{};
  for (int c = 0; c < k; ++c) cols.v[c] = static_cast<const double*>(columns[c]);
  const auto* id = static_cast<const int64_t*>(ids);
  const auto* m = static_cast<const uint8_t*>(mask);
  auto* o = static_cast<double*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (warps == 0) {
    const int64_t want = (n + kGlobalThreads - 1) / kGlobalThreads;
    const unsigned grid = static_cast<unsigned>(want < (1 << 30) ? want : (1 << 30));
    bin_scatter_global_kernel<<<grid, kGlobalThreads, 0, s>>>(id, m, cols, k, n, n_bins, o);
    return static_cast<int>(cudaGetLastError());
  }
  const int64_t width = (k + 1) * n_bins;
  if (blocks <= 0 || blocks > (1 << 30) || partials == nullptr ||
      block_bytes(warps, width) > kSharedBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  auto* p = static_cast<double*>(partials);
  bin_scatter_block_kernel<<<static_cast<unsigned>(blocks), warps * 32, block_bytes(warps, width),
                             s>>>(id, m, cols, k, n, static_cast<int>(n_bins), p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>((width + kReduceX - 1) / kReduceX);
  bin_scatter_reduce_kernel<<<grid, dim3(kReduceX, kReduceY), 0, s>>>(
      p, blocks, static_cast<int>(width), o);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
