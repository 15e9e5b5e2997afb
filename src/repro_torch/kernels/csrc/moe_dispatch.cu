// MoE dispatch for Hopper (sm_90a): the token -> expert crossbar.
//
// Replaces the Pallas TPU kernel moe_dispatch of the JAX package
// (src/repro/kernels/moe_dispatch.py:27, body _dispatch_kernel).  It fills
// the (E*C, D) expert input buffer of the sorted MoE layer:
//
//   out[s, :] = x[slot_token[s], :]     for slot_token[s] in [0, n_rows)
//   out[s, :] = 0                       otherwise
//
// x is x_padded (n_rows = T + 1): the token rows and a zeros row at index
// T that empty slots read, as in the TPU version (branch-free padding
// through its scalar-prefetch index map), so the output equals
// x_padded[slot_token] bit for bit.  An index outside [0, n_rows) that
// lies on the card writes a zero row without reading x; the wrapper
// range-checks indices that arrive from the host.
//
// Bound: bytes.  The kernel moves E*C*D*esize bytes out, reads at most as
// many in (each token row is read once per slot that names it; the distinct
// rows are T*D*esize) and 4*E*C bytes of indices, with no arithmetic to
// speak of.  The design therefore keeps to a plain row copy: one warp per
// output slot, the slot's index loaded by the warp itself (one broadcast
// load, no prefetch pass), the row copied as bytes in the widest vectors
// (up to 16 bytes a lane) that the row pitch and both base addresses allow,
// four independent loads in flight per lane.  Rows are copied as bytes, so
// bfloat16 and float32 share the one kernel.
//
// The entry point launches on the given stream, allocates nothing, does not
// synchronize, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

// One warp copies (or zero-fills, src == nullptr) one row in V-sized pieces.
template <typename V>
__device__ __forceinline__ void md_copy_row(char* dst, const char* src,
                                            int row_bytes, int lane) {
  const int n = row_bytes / (int)sizeof(V);
  V* d = reinterpret_cast<V*>(dst);
  if (src == nullptr) {
    const V zero = V();
    for (int i = lane; i < n; i += 32) d[i] = zero;
    return;
  }
  const V* s = reinterpret_cast<const V*>(src);
  int i = lane;
  for (; i + 96 < n; i += 128) {      // four independent loads in flight
    const V v0 = s[i], v1 = s[i + 32], v2 = s[i + 64], v3 = s[i + 96];
    d[i] = v0; d[i + 32] = v1; d[i + 64] = v2; d[i + 96] = v3;
  }
  for (; i < n; i += 32) d[i] = s[i];
}

#define MD_WARPS 8   // output slots per block

template <typename V>
__global__ void __launch_bounds__(MD_WARPS * 32)
md_dispatch_kernel(const char* __restrict__ x, const int* __restrict__ slot,
                   char* __restrict__ out, int S, int n_rows, int row_bytes) {
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * MD_WARPS + (threadIdx.x >> 5);
  if (s >= S) return;                       // ragged last block
  const int src_row = slot[s];              // same address: one broadcast
  const char* src = (src_row < 0 || src_row >= n_rows)
                        ? nullptr : x + (int64_t)src_row * row_bytes;
  md_copy_row<V>(out + (int64_t)s * row_bytes, src, row_bytes, lane);
}

// Widest power-of-two piece (<= 16 bytes) that divides the row pitch and
// both base addresses.
static int md_vec(const void* a, const void* b, int row_bytes) {
  const uintptr_t bits = (uintptr_t)a | (uintptr_t)b | (uintptr_t)row_bytes;
  int vec = 16;
  while (vec > 1 && (bits & (uintptr_t)(vec - 1))) vec >>= 1;
  return vec;
}

extern "C" {

int md_dispatch(const void* x, const void* slot, void* out, int S,
                int n_rows, int row_bytes, void* stream) {
  if (S > 0 && row_bytes > 0) {
    const int blocks = (S + MD_WARPS - 1) / MD_WARPS;
    const dim3 grid(blocks), block(MD_WARPS * 32);
    cudaStream_t st = (cudaStream_t)stream;
    const char* xs = (const char*)x;
    const int* sl = (const int*)slot;
    char* o = (char*)out;
    switch (md_vec(x, out, row_bytes)) {
      case 16:
        md_dispatch_kernel<uint4><<<grid, block, 0, st>>>(
            xs, sl, o, S, n_rows, row_bytes);
        break;
      case 8:
        md_dispatch_kernel<uint2><<<grid, block, 0, st>>>(
            xs, sl, o, S, n_rows, row_bytes);
        break;
      case 4:
        md_dispatch_kernel<uint32_t><<<grid, block, 0, st>>>(
            xs, sl, o, S, n_rows, row_bytes);
        break;
      case 2:
        md_dispatch_kernel<uint16_t><<<grid, block, 0, st>>>(
            xs, sl, o, S, n_rows, row_bytes);
        break;
      default:
        md_dispatch_kernel<uint8_t><<<grid, block, 0, st>>>(
            xs, sl, o, S, n_rows, row_bytes);
        break;
    }
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
