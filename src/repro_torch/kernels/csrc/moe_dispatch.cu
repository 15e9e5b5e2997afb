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
// speak of.  The design therefore keeps to a plain row copy in the widest
// vectors (up to 16 bytes) that the row pitch and both base addresses
// allow, up to four independent loads in flight per lane, and spends its
// care on keeping enough of them in flight across the card.  A warp copies
// one slot's row, or one of `splits` equal pieces of it: blockIdx.x picks
// 8 slots, blockIdx.y the piece.  The entry point picks the pieces (from
// the slots and the card's SM count): at olmoe's
// decode size (512 slots of 4 KB, 64 blocks of whole rows) a row in 2, so
// that every SM holds a block and each lane's 4 loads go out in one round;
// at its prefill size (81,920 slots) a row in 4, 2 loads a lane, so that
// more warps are in flight.  Each warp loads its slot's index itself (one
// broadcast load, no prefetch pass).  Rows are copied as bytes, so
// bfloat16 and float32 share the one kernel.
//
// The entry point launches on the given stream, allocates nothing, does not
// synchronize, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

// One warp copies (or zero-fills, src == nullptr) the V-sized pieces
// lo .. hi-1 of one row, reading x through the read-only path.
template <typename V>
__device__ __forceinline__ void md_copy_row(char* dst, const char* src,
                                            int lo, int hi, int lane) {
  V* d = reinterpret_cast<V*>(dst);
  if (src == nullptr) {
    const V zero = V();
    for (int i = lo + lane; i < hi; i += 32) d[i] = zero;
    return;
  }
  const V* s = reinterpret_cast<const V*>(src);
  int i = lo + lane;
  for (; i + 96 < hi; i += 128) {     // four independent loads in flight
    const V v0 = __ldg(s + i), v1 = __ldg(s + i + 32), v2 = __ldg(s + i + 64),
            v3 = __ldg(s + i + 96);
    d[i] = v0; d[i + 32] = v1; d[i + 64] = v2; d[i + 96] = v3;
  }
  for (; i < hi; i += 32) d[i] = __ldg(s + i);
}

#define MD_WARPS 8   // output slots per block
#define MD_MAX_DEVICES 64

template <typename V>
__global__ void __launch_bounds__(MD_WARPS * 32)
md_dispatch_kernel(const char* __restrict__ x, const int* __restrict__ slot,
                   char* __restrict__ out, int S, int n_rows, int row_bytes,
                   int piece) {
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * MD_WARPS + (threadIdx.x >> 5);
  if (s >= S) return;                       // ragged last block
  const int n = row_bytes / (int)sizeof(V);
  const int lo = blockIdx.y * piece, hi = min(n, lo + piece);
  const int src_row = slot[s];              // same address: one broadcast
  const char* src = (src_row < 0 || src_row >= n_rows)
                        ? nullptr : x + (int64_t)src_row * row_bytes;
  md_copy_row<V>(out + (int64_t)s * row_bytes, src, lo, hi, lane);
}

// Widest power-of-two piece (<= 16 bytes) that divides the row pitch and
// both base addresses.
static int md_vec(const void* a, const void* b, int row_bytes) {
  const uintptr_t bits = (uintptr_t)a | (uintptr_t)b | (uintptr_t)row_bytes;
  int vec = 16;
  while (vec > 1 && (bits & (uintptr_t)(vec - 1))) vec >>= 1;
  return vec;
}

// Pieces each row is cut into, one warp each: 4 loads a lane in one round
// while the slots alone (8 a block) give fewer blocks than the card has
// SMs, 2 loads a lane once they give more (see the note above).
static int md_splits(int slots, int pieces, int* splits) {
  static int sms[MD_MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= MD_MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!sms[dev]) {
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return (int)err;
  }
  const int per_lane = (slots + MD_WARPS - 1) / MD_WARPS < sms[dev] ? 4 : 2;
  const int per_warp = 32 * per_lane;
  *splits = pieces > per_warp ? (pieces + per_warp - 1) / per_warp : 1;
  return 0;
}

extern "C" {

int md_dispatch(const void* x, const void* slot, void* out, int S,
                int n_rows, int row_bytes, void* stream) {
  if (S > 0 && row_bytes > 0) {
    const int vec = md_vec(x, out, row_bytes);
    const int n = row_bytes / vec;
    int splits = 1;
    const int err = md_splits(S, n, &splits);
    if (err != 0) return err;
    const int piece = (n + splits - 1) / splits;
    const dim3 grid((S + MD_WARPS - 1) / MD_WARPS, (n + piece - 1) / piece);
    const dim3 block(MD_WARPS * 32);
    cudaStream_t st = (cudaStream_t)stream;
    const char* xs = (const char*)x;
    const int* sl = (const int*)slot;
    char* o = (char*)out;
    switch (vec) {
      case 16:
        md_dispatch_kernel<uint4><<<grid, block, 0, st>>>(
            xs, sl, o, S, n_rows, row_bytes, piece);
        break;
      case 8:
        md_dispatch_kernel<uint2><<<grid, block, 0, st>>>(
            xs, sl, o, S, n_rows, row_bytes, piece);
        break;
      case 4:
        md_dispatch_kernel<uint32_t><<<grid, block, 0, st>>>(
            xs, sl, o, S, n_rows, row_bytes, piece);
        break;
      case 2:
        md_dispatch_kernel<uint16_t><<<grid, block, 0, st>>>(
            xs, sl, o, S, n_rows, row_bytes, piece);
        break;
      default:
        md_dispatch_kernel<uint8_t><<<grid, block, 0, st>>>(
            xs, sl, o, S, n_rows, row_bytes, piece);
        break;
    }
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
