// Banked gather / scatter for Hopper (sm_90a): the paper's bank-resolution
// circuit in front of a bank-major table (n_banks, bank_volume, D).
//
// Replaces the three Pallas TPU kernels of the JAX package's
// kernels/banked_gather.py:
//   bk_gather        <- banked_gather        (_gather_kernel)
//   bk_scatter_rows  <- banked_scatter       (_scatter_kernel)
//   bk_scatter_elems <- banked_scatter_elems (_scatter_elem_kernel)
//
// What the TPU version does in the scalar-prefetch index_map -- evaluate
// BA(idx) and BO(idx) (Eq. 1-2 under the Sec-3.4 shift/mask/Crandall/NAF
// rewrites) and only then touch the memory -- happens here per row, inside
// the kernel, in int32: the op graphs arrive as DATA (a BkProgram passed by
// value, so it sits in the constant bank and every thread of a warp reads
// the same instruction), not as source.  One compiled library serves every
// banking scheme, and swapping the layout between two decode ticks costs no
// compile.
//
// Bound: bytes.  A gather moves 2*T*D*esize bytes plus 4*T of indices and
// does a few dozen integer ops per row; at the serving shapes (T <= 32 rows
// of 32 bytes) the launch itself is the whole cost.  The design therefore
// keeps to: one warp per row, the row's address resolved once by lane 0 and
// broadcast by shuffle, the row copied in the widest vectors (up to 16
// bytes a lane) that the row pitch and both base addresses allow.
//
// Duplicates in a scatter resolve LAST WRITE WINS IN INDEX ORDER, as the
// sequential TPU grid gives for free.  A CUDA grid has no order, so a write
// t is dropped when any later t' > t carries the same logical address (and,
// for bk_scatter_elems, the same column).  BA/BO is injective on logical
// addresses, so equal physical slots mean equal logical addresses, the
// surviving writes never alias, and the result is deterministic without a
// scratch table or a host-side pass.  The check reads O(T^2) indices in
// all; the wrapper caps T (BK_SCATTER_MAX_T on the Python side).
//
// Integer semantics of the interpreter (mirrored by
// core/transforms.run_kernel_program): registers are int32; add, sub, mul
// and shl wrap modulo 2^32 and are exact whenever the true value fits int32
// (NAF products go transiently negative through sub); shr is arithmetic;
// div and mod FLOOR like Python's // and %, for either sign; and is two's
// complement.  Logical addresses outside [0, logical_size) are not
// resolved: the gather returns a zero row for them and the scatters drop
// the write.
//
// Every entry point launches on the given stream, allocates nothing, does
// not synchronize, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#define BK_MAX_INSTRS 192
#define BK_MAX_REGS 32
#define BK_MAX_DIMS 8

enum BkOp {
  BK_CONST = 0, BK_SHL, BK_SHR, BK_AND, BK_MUL, BK_DIV, BK_MOD,
  BK_ADD, BK_SUB, BK_GE, BK_SELECT
};

struct BkInstr {
  uint8_t op, dst, a, b;
  int32_t imm;
};

struct BkProgram {
  int32_t n_dims;                 // logical dimensions (registers 0..n-1)
  int32_t n_instrs;
  int32_t n_ba;                   // BA graphs (1 flat, one per dim multidim)
  int32_t bo_reg;
  int32_t logical_size;           // prod(dims)
  int32_t bank_volume;
  int32_t dims[BK_MAX_DIMS];
  int32_t ba_regs[BK_MAX_DIMS];
  int32_t ba_fold[BK_MAX_DIMS];   // multidim bank fold: ba = ba * Ns[k] + ba_k
  BkInstr instrs[BK_MAX_INSTRS];
};

// Row index into the bank-major table (bank * bank_volume + offset) of one
// logical address, or -1 when the address is out of range.
__device__ __forceinline__ int64_t bk_resolve(const BkProgram& p, int addr) {
  if (addr < 0 || addr >= p.logical_size) return -1;
  int r[BK_MAX_REGS];
  int rem = addr;
  for (int i = p.n_dims - 1; i >= 0; --i) {   // row-major split
    const int d = p.dims[i];
    r[i] = rem % d;
    rem /= d;
  }
  for (int i = 0; i < p.n_instrs; ++i) {
    const BkInstr in = p.instrs[i];
    const int a = r[in.a];
    const int c = in.imm;
    int v;
    switch (in.op) {
      case BK_CONST: v = c; break;
      case BK_SHL: v = (int)((unsigned)a << c); break;
      case BK_SHR: v = a >> c; break;               // arithmetic on int
      case BK_AND: v = a & c; break;
      case BK_MUL: v = (int)((unsigned)a * (unsigned)c); break;
      case BK_DIV: {
        int q = a / c;
        const int m = a - q * c;
        if (m != 0 && ((m < 0) != (c < 0))) --q;    // truncation -> floor
        v = q;
        break;
      }
      case BK_MOD: {
        int m = a % c;
        if (m != 0 && ((m < 0) != (c < 0))) m += c;
        v = m;
        break;
      }
      case BK_ADD: v = (int)((unsigned)a + (unsigned)r[in.b]); break;
      case BK_SUB: v = (int)((unsigned)a - (unsigned)r[in.b]); break;
      case BK_GE: v = a >= r[in.b]; break;
      default: v = a ? r[in.b] : r[c]; break;       // BK_SELECT
    }
    r[in.dst] = v;
  }
  int ba = 0;
  for (int k = 0; k < p.n_ba; ++k) ba = ba * p.ba_fold[k] + r[p.ba_regs[k]];
  return (int64_t)ba * p.bank_volume + r[p.bo_reg];
}

// One warp copies (or zero-fills, src == nullptr) one row in V-sized pieces.
template <typename V>
__device__ __forceinline__ void bk_copy_row(char* dst, const char* src,
                                            int row_bytes, int lane) {
  const int n = row_bytes / (int)sizeof(V);
  V* d = reinterpret_cast<V*>(dst);
  if (src == nullptr) {
    const V zero = V();
    for (int i = lane; i < n; i += 32) d[i] = zero;
  } else {
    const V* s = reinterpret_cast<const V*>(src);
    int i = lane;
    for (; i + 96 < n; i += 128) {      // four independent loads in flight
      const V v0 = s[i], v1 = s[i + 32], v2 = s[i + 64], v3 = s[i + 96];
      d[i] = v0; d[i + 32] = v1; d[i + 64] = v2; d[i + 96] = v3;
    }
    for (; i < n; i += 32) d[i] = s[i];
  }
}

__device__ __forceinline__ void bk_copy_row_vec(char* dst, const char* src,
                                                int row_bytes, int vec,
                                                int lane) {
  switch (vec) {
    case 16: bk_copy_row<uint4>(dst, src, row_bytes, lane); break;
    case 8: bk_copy_row<uint2>(dst, src, row_bytes, lane); break;
    case 4: bk_copy_row<uint32_t>(dst, src, row_bytes, lane); break;
    case 2: bk_copy_row<uint16_t>(dst, src, row_bytes, lane); break;
    default: bk_copy_row<uint8_t>(dst, src, row_bytes, lane); break;
  }
}

#define BK_WARPS 8   // rows per block

// out[t, :] = table[BA(idx[t]), BO(idx[t]), :]
__global__ void __launch_bounds__(BK_WARPS * 32)
bk_gather_kernel(const char* __restrict__ table, const int* __restrict__ idx,
                 char* __restrict__ out, int T, int row_bytes, int vec,
                 const BkProgram prog) {
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * BK_WARPS + (threadIdx.x >> 5);
  if (t >= T) return;                       // ragged last block
  int64_t row = 0;
  if (lane == 0) row = bk_resolve(prog, idx[t]);
  row = __shfl_sync(0xffffffffu, row, 0);
  const char* src = row < 0 ? nullptr : table + row * row_bytes;
  bk_copy_row_vec(out + (int64_t)t * row_bytes, src, row_bytes, vec, lane);
}

// table[BA(idx[t]), BO(idx[t]), :] = values[t, :], last write wins.
__global__ void __launch_bounds__(BK_WARPS * 32)
bk_scatter_rows_kernel(char* __restrict__ table, const int* __restrict__ idx,
                       const char* __restrict__ values, int T, int row_bytes,
                       int vec, const BkProgram prog) {
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * BK_WARPS + (threadIdx.x >> 5);
  if (t >= T) return;
  const int mine = idx[t];
  bool later = false;                       // a later write to the same row?
  for (int u = t + 1 + lane; u < T && !later; u += 32) later = idx[u] == mine;
  if (__any_sync(0xffffffffu, later)) return;
  int64_t row = 0;
  if (lane == 0) row = bk_resolve(prog, mine);
  row = __shfl_sync(0xffffffffu, row, 0);
  if (row < 0) return;
  bk_copy_row_vec(table + row * row_bytes, values + (int64_t)t * row_bytes,
                  row_bytes, vec, lane);
}

// table[BA(idx[t]), BO(idx[t]), cols[t]] = values[t], last write wins.
template <typename E>
__global__ void __launch_bounds__(128)
bk_scatter_elems_kernel(E* __restrict__ table, const int* __restrict__ idx,
                        const int* __restrict__ cols,
                        const E* __restrict__ values, int T, int D,
                        const BkProgram prog) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T) return;
  const int mine = idx[t], col = cols[t];
  if (col < 0 || col >= D) return;
  for (int u = t + 1; u < T; ++u)
    if (idx[u] == mine && cols[u] == col) return;
  const int64_t row = bk_resolve(prog, mine);
  if (row < 0) return;
  table[row * D + col] = values[t];
}

// Widest power-of-two piece (<= 16 bytes) that divides the row pitch and
// both base addresses; never narrower than the element, which divides all
// three.
static int bk_vec(const void* a, const void* b, int row_bytes) {
  const uintptr_t bits = (uintptr_t)a | (uintptr_t)b | (uintptr_t)row_bytes;
  int vec = 16;
  while (vec > 1 && (bits & (uintptr_t)(vec - 1))) vec >>= 1;
  return vec;
}

extern "C" {

int bk_program_bytes() { return (int)sizeof(BkProgram); }

int bk_gather(const void* table, const void* idx, void* out, int T,
              int row_bytes, const BkProgram* prog, void* stream) {
  if (T > 0 && row_bytes > 0) {
    const int blocks = (T + BK_WARPS - 1) / BK_WARPS;
    bk_gather_kernel<<<blocks, BK_WARPS * 32, 0, (cudaStream_t)stream>>>(
        (const char*)table, (const int*)idx, (char*)out, T, row_bytes,
        bk_vec(table, out, row_bytes), *prog);
  }
  return (int)cudaGetLastError();
}

int bk_scatter_rows(void* table, const void* idx, const void* values, int T,
                    int row_bytes, const BkProgram* prog, void* stream) {
  if (T > 0 && row_bytes > 0) {
    const int blocks = (T + BK_WARPS - 1) / BK_WARPS;
    bk_scatter_rows_kernel<<<blocks, BK_WARPS * 32, 0,
                             (cudaStream_t)stream>>>(
        (char*)table, (const int*)idx, (const char*)values, T, row_bytes,
        bk_vec(table, values, row_bytes), *prog);
  }
  return (int)cudaGetLastError();
}

int bk_scatter_elems(void* table, const void* idx, const void* cols,
                     const void* values, int T, int D, int esize,
                     const BkProgram* prog, void* stream) {
  if (T > 0 && D > 0) {
    const int threads = 128;
    const int blocks = (T + threads - 1) / threads;
    cudaStream_t s = (cudaStream_t)stream;
    const int* i = (const int*)idx;
    const int* c = (const int*)cols;
    switch (esize) {
      case 1:
        bk_scatter_elems_kernel<uint8_t><<<blocks, threads, 0, s>>>(
            (uint8_t*)table, i, c, (const uint8_t*)values, T, D, *prog);
        break;
      case 2:
        bk_scatter_elems_kernel<uint16_t><<<blocks, threads, 0, s>>>(
            (uint16_t*)table, i, c, (const uint16_t*)values, T, D, *prog);
        break;
      case 4:
        bk_scatter_elems_kernel<uint32_t><<<blocks, threads, 0, s>>>(
            (uint32_t*)table, i, c, (const uint32_t*)values, T, D, *prog);
        break;
      case 8:
        bk_scatter_elems_kernel<uint64_t><<<blocks, threads, 0, s>>>(
            (uint64_t*)table, i, c, (const uint64_t*)values, T, D, *prog);
        break;
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
