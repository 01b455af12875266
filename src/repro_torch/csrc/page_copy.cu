// Batched page gather / in-place scatter over the page pool.
//
// Replaces the Pallas TPU kernels in repro/kernels/page_copy/kernel.py:
// _copy_kernel (gather_pages: out[i] = pool[idx[i]]) and _scatter_kernel
// (scatter_pages: pool[idx[i]] = buf[i], pool aliased in place).
//
// What bounds it on an H100: bytes.  Each page is read once and written
// once (2 x n x row_bytes), with no arithmetic, so the floor is
// 2 x n x row_bytes / 3.35 TB/s.  Design: one launch per batch; blockIdx.x
// is the batch entry, blockIdx.y a 16 KiB slice of its page, and every
// thread moves UNROLL 16-byte vectors with all loads issued before the
// stores, so a warp keeps 2 KiB in flight.  Neighbouring threads touch
// neighbouring 16-byte words (coalesced).  Offsets are 64-bit (the full
// pool is 2 GiB).  Pages are moved as raw bytes, so one kernel serves f32,
// bf16 and int32; the wrapper requires 16-byte rows and 16-byte aligned
// buffers.  A row index outside [0, num_pages) is skipped, never written.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;
constexpr long long VECS_PER_BLOCK = (long long)THREADS * UNROLL;

template <bool SCATTER>
__global__ void __launch_bounds__(THREADS)
page_copy_kernel(const uint4* __restrict__ src, const long long* __restrict__ idx,
                 uint4* __restrict__ dst, long long row_vecs, long long num_pages) {
  const long long i = blockIdx.x;
  const long long r = idx[i];
  if (r < 0 || r >= num_pages) return;
  const uint4* s = src + (SCATTER ? i : r) * row_vecs;
  uint4* d = dst + (SCATTER ? r : i) * row_vecs;
  const long long base = (long long)blockIdx.y * VECS_PER_BLOCK + threadIdx.x;
  uint4 v[UNROLL];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const long long j = base + (long long)u * THREADS;
    if (j < row_vecs) v[u] = __ldg(s + j);
  }
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const long long j = base + (long long)u * THREADS;
    if (j < row_vecs) d[j] = v[u];
  }
}

template <bool SCATTER>
int launch(const void* src, const void* idx, void* dst, long long n,
           long long row_bytes, long long num_pages, void* stream) {
  if (n <= 0) return 0;
  if (row_bytes % 16 != 0 || n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const long long row_vecs = row_bytes / 16;
  const long long slices = (row_vecs + VECS_PER_BLOCK - 1) / VECS_PER_BLOCK;
  if (slices > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)n, (unsigned)slices);
  page_copy_kernel<SCATTER><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint4*)src, (const long long*)idx, (uint4*)dst, row_vecs, num_pages);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int page_gather(const void* pool, const void* idx, void* out,
                           long long n, long long row_bytes, long long num_pages,
                           void* stream) {
  return launch<false>(pool, idx, out, n, row_bytes, num_pages, stream);
}

extern "C" int page_scatter(const void* buf, const void* idx, void* pool,
                            long long n, long long row_bytes, long long num_pages,
                            void* stream) {
  return launch<true>(buf, idx, pool, n, row_bytes, num_pages, stream);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
