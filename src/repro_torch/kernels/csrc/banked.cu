// Banked gather / scatter for Hopper (sm_90a): the paper's bank-resolution
// circuit in front of a bank-major table (n_banks, bank_volume, D).
//
// Replaces the three Pallas TPU kernels of the JAX package's
// kernels/banked_gather.py:
//   bk_gather_kernel         <- banked_gather        (_gather_kernel)
//   bk_scatter_rows_kernel   <- banked_scatter       (_scatter_kernel)
//   bk_scatter_elems_kernel  <- banked_scatter_elems (_scatter_elem_kernel)
//
// What the TPU version does in the scalar-prefetch index_map -- evaluate
// BA(idx) and BO(idx) (Eq. 1-2 under the Sec-3.4 shift/mask/Crandall/NAF
// rewrites) and only then touch the memory -- happens here per row, inside
// the kernel, in int32: the op graphs arrive as DATA (the packed program of
// core/transforms.pack_kernel_program), not as source.  One compiled
// library serves every banking scheme, and swapping the layout between two
// decode ticks costs no compile.
//
// Bound: bytes, and at the serving shapes (T <= 1024 rows of 32 bytes, or
// 8 to 8,000 single elements) the launch and the dependent chain idx load
// -> resolve -> row load -> store.
// On the H100 (clock64) an interpreter with a register file indexed at run
// time (local memory), a switch on the opcode (a compare-and-branch tree a
// step) and a division per coordinate takes ~2,250 cycles a row -- most of
// the gather -- while the size of the parameter block costs nothing (an
// empty kernel launches as fast with 1.66 KB of parameters as with 4
// bytes).  What the design does:
//
// * Every op but ge, select, div and mod is one LINEAR form, t = r[a] * ma
//   + r[b] * mb (+ k), r[dst] = (t >> s) & mask: a step is a straight chain
//   of integer operations, with no branch on the opcode.
// * The interpreter's registers are registers: a file of R = 4, 16 or 32
//   (the bucket's, see transforms.KERNEL_BUCKETS), read through a tree of
//   lop3 blends log2(R) deep and written by R blends -- no local memory, no
//   stack frame, and no predicate registers, of which there are too few to
//   set up one step's selects during the previous step.
// * The host shortens the chain before the kernel sees it
//   (transforms.pack_kernel_program): a shift or a mask followed by a shift,
//   a mask or a left shift, and any step without shift or mask followed by
//   anything, become one LINEAR step where the first value has no other
//   reader.  A program over one dimension and one bank graph whose LINEAR
//   steps all reduce to a sum of at most four terms of the address,
//   ((a * m + k) >> s) & mask each (transforms.kernel_terms), is passed by
//   value as that sum (BkTerms): the terms run side by side, so the
//   server's layout costs one term's chain instead of six dependent steps
//   of ~45-60 cycles.  Any other program is read from device memory
//   (BkDev), loaded beside the index so both arrive together.
// * The split of a flat address into coordinates multiplies by a packed
//   round-up reciprocal (transforms.split_constants) and does nothing for
//   one dimension.
// * Every thread resolves its own row: L lanes a row (L the power of two
//   that covers the row's 16-byte pieces, at most 32), each lane resolving
//   the same address, so no lane waits on another and nothing is shuffled.
//   At the decode tick's 32 rows of 32 bytes that is two warps.
//
// Duplicates in a scatter resolve LAST WRITE WINS IN INDEX ORDER, as the
// sequential TPU grid gives for free.  A CUDA grid has no order, so of the
// writes to one logical address only the one with the largest t copies.
// BA/BO is injective on logical addresses, so the surviving writes never
// alias and the result is deterministic.  Scanning the later writes for a
// duplicate is O(T^2) dependent loads (~9,700 cycles of one warp at the
// swap's T = 1024), so bk_scatter_rows_kernel picks the winner in O(1)
// expected work a write, with block barriers only:
//
// * The addresses are partitioned among about T / 128 blocks (at most one
//   wave) by a hash (bk_owner), so all writes to one address meet in one
//   block.  Each block reads every index and lists the writes it owns (one
//   shared atomic a warp).
// * A thread a listed write claims its address in a shared-memory hash
//   (atomicCAS on the key, linear probing, at most half full), raises the
//   slot's winner with atomicMax(t) and resolves its row; for rows of one
//   or two 16-byte pieces it also loads the row into registers.  After
//   __syncthreads only the winners store.
// * A block that owns more than BK_OWN writes (only possible when T >
//   BK_OWN, and then only under heavy skew) takes a winner table in device
//   memory instead -- one int a logical address, zero between calls,
//   allocated once by the wrapper per artifact and device: atomicMax(t + 1),
//   __syncthreads (the addresses are the block's alone), copy where the
//   table holds the write's own key, __syncthreads, zero what it used.
//   Nothing carries over from one call to the next, so a launch captured in
//   a CUDA graph replays correctly.
//
// bk_scatter_elems_kernel settles duplicate (address, column) pairs by
// ownership, in O(1) expected work a write and no scan over later writes
// (a scan is O(T) dependent loads a thread: 0.53 ms at a flush of 8,000
// writes on an H100 at 700 W, 105x index_put_):
//
// * Up to 32 writes (the decode tick's 8 records): one warp, a lane a
//   write; __match_any_sync on the pair's 64-bit key groups the lanes of
//   one pair, and the highest lane of each group stores.  The resolve runs
//   beside the match.  No loop, no shared memory.
// * Up to BK_ELEM_PER_BLOCK = 128 (the flush after a server admits short
//   prompts): one block, a thread a write, the same match in each warp;
//   each warp's last write of a pair claims it in a shared-memory hash of
//   256 slots and raises the slot's winner with atomicMax(t), and after
//   __syncthreads only the winners store.
// * More (a server's first flush after admitting long prompts, up to
//   SCATTER_MAX_T): the pairs are partitioned among about T / 128 blocks
//   (at most one wave) by a hash of the pair (bk_pair_owner), so all writes
//   to one pair meet in one block.  Each block (512 threads) reads every
//   (index, column), sixteen a thread in flight, and lists the writes it
//   owns (a scan across the warp and one shared atomic a warp, a prefetch
//   of the value); a thread a listed write claims
//   its pair in a shared-memory hash (atomicCAS, linear probing) and raises
//   the slot's winner with atomicMax(t), while it resolves the address and
//   loads the value into a register.  After __syncthreads only the winners
//   store.  A write is one element, so the hash holds pairs, not rows.
// * A block that owns more than BK_ELEM_OWN writes (skewed or adversarial
//   keys) walks all T again in windows of BK_ELEM_OWN writes, in order:
//   each window fits the hash, and its winners store after the previous
//   window's.  No grid barrier and no state carried between calls, so a
//   launch captured in a CUDA graph replays correctly.
//
// Integer semantics of the interpreter (mirrored by
// core/transforms.run_kernel_program and run_packed_program): registers are
// int32; add, sub, mul and shl wrap modulo 2^32 and are exact whenever the
// true value fits int32 (NAF products go transiently negative through sub);
// shr is arithmetic; div and mod FLOOR like Python's // and %, for either
// sign; and is two's complement.  Logical addresses outside [0,
// logical_size) are not resolved: the gather returns a zero row for them
// and the scatters drop the write.
//
// Every entry point launches on the given stream, allocates nothing, does
// not synchronize, and returns cudaGetLastError() (cudaErrorInvalidValue for
// arguments it does not take).

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#define BK_MAX_DIMS 8
#define BK_THREADS 256        // a block of the gather and the row scatter
#define BK_PER_BLOCK 128      // writes a block of the row scatter takes ...
#define BK_MAX_BLOCKS 132     // ... in at most one wave of blocks
#define BK_OWN 1024           // writes a block keeps in shared memory
#define BK_HASH_BITS 11       // its hash of addresses: at most half full
#define BK_HASH (1 << BK_HASH_BITS)
#define BK_MAX_TERMS 4        // terms of a BkTerms program
// The element scatter past one warp of writes: blocks of BkElemThreads,
// about BK_ELEM_PER_BLOCK writes each, listing at most BK_ELEM_OWN at once
// in a hash of (address, column) pairs at most half full.
#define BK_ELEM_PER_BLOCK 128
#define BK_ELEM_OWN 1024
#define BK_ELEM_HASH_BITS 11
#define BK_ELEM_HASH (1 << BK_ELEM_HASH_BITS)
#define BK_ELEM_SHARED (BK_ELEM_HASH * 12 + BK_ELEM_OWN * 12)   // bytes
// ... and up to BK_ELEM_PER_BLOCK writes, one block of a thread a write,
// with a hash of pairs at most half full
#define BK_ELEM_ONE_HASH_BITS 8
#define BK_ELEM_ONE_HASH (1 << BK_ELEM_ONE_HASH_BITS)
#define BK_ELEM_ONE_SHARED (BK_ELEM_ONE_HASH * 12)   // bytes
#define BK_EMPTY 0xffffffffffffffffull   // no pair's key

// Kinds of instructions (core/transforms.py KIND_*).
enum BkKind { BK_LINEAR = 0, BK_GE, BK_SELECT, BK_DIV, BK_MOD };

// The packed program (transforms.pack_kernel_program) in device memory, N
// instruction slots of four words: code, ma, mb, km, where code = kind |
// dst << 3 | a << 8 | b << 13 | s << 18 | mask << 23; then the dimensions'
// split, the bank folds and the sum of terms (transforms.kernel_terms).
#define BK_HEADER 8
template <int N>
struct BkLayout {                                        // 4 words a slot
  static constexpr int split = BK_HEADER + 4 * N;        // d, m, s a dim
  static constexpr int fold = split + 3 * BK_MAX_DIMS;   // reg, banks a graph
  static constexpr int terms = fold + 2 * BK_MAX_DIMS;   // n, base, 5 a term
  static constexpr int words = terms + 2 + 5 * BK_MAX_TERMS;
};

__host__ __device__ constexpr int bk_log2(int x) {
  return x <= 1 ? 0 : 1 + bk_log2(x / 2);
}

// m ? x1 : x0 for a mask m of 0 or -1, in one lop3 (x1 & m | x0 & ~m): the
// register file is read and written through these, so it needs no
// predicate registers -- seven of them would make each step wait for the
// previous one's -- and every mask depends on the program alone.
__device__ __forceinline__ int bk_blend(int x1, int x0, int m) {
  int d;
  asm("lop3.b32 %0, %1, %2, %3, 0xE4;" : "=r"(d) : "r"(x1), "r"(x0), "r"(m));
  return d;
}

// r[k] for a run-time k: a tree of blends on k's bits, log2(R) deep, laid
// out as a heap (node n chooses between nodes 2n and 2n + 1; the leaves R ..
// 2R - 1 are r).  One loop with constant bounds, so every index is a
// constant once it is unrolled and t stays in registers.
template <int R>
__device__ __forceinline__ int bk_pick(const int (&r)[R], int k) {
  int t[2 * R];
#pragma unroll
  for (int i = 0; i < R; ++i) t[R + i] = r[i];
#pragma unroll
  for (int n = R - 1; n >= 1; --n) {
    const int bit = bk_log2(R) - 1 - bk_log2(n);   // n's depth from the root
    t[n] = bk_blend(t[2 * n + 1], t[2 * n], -((k >> bit) & 1));
  }
  return t[1];
}

template <int R>
__device__ __forceinline__ void bk_put(int (&r)[R], int k, int v) {
#pragma unroll
  for (int i = 0; i < R; ++i) r[i] = bk_blend(v, r[i], -(int)(k == i));
}

// One LINEAR instruction: t = r[a] * ma + r[b] * mb (+ km unless masked),
// r[dst] = (t >> s) & (masked ? km : -1).  Its fields are in registers
// before the data arrives, so the data-dependent chain is the selects that
// read a and b, a multiply-add, a shift, an and and the selects that write
// r -- no branch.
template <int R>
__device__ __forceinline__ int bk_linear(const int (&r)[R], const int4 in,
                                         int& a, int& b) {
  const int code = in.x;
  const bool masked = (code >> 23) & 1;
  a = bk_pick(r, (code >> 8) & 31);
  b = bk_pick(r, (code >> 13) & 31);
  const unsigned bk = (unsigned)b * (unsigned)in.z +
                      (masked ? 0u : (unsigned)in.w);
  const int t = (int)((unsigned)a * (unsigned)in.y + bk);
  return (t >> ((code >> 18) & 31)) & (masked ? in.w : -1);
}

// DIV and MOD, floored like Python's // and %; out of line, so the steps
// of programs without them carry none of this code.
__device__ __noinline__ int bk_divmod(int kind, int a, int c) {
  if (kind == BK_DIV) {
    int q = a / c;
    const int m = a - q * c;
    if (m != 0 && ((m < 0) != (c < 0))) --q;        // truncation -> floor
    return q;
  }
  int m = a % c;
  if (m != 0 && ((m < 0) != (c < 0))) m += c;
  return m;
}

// Any instruction.
template <int R>
__device__ __forceinline__ void bk_step(int (&r)[R], const int4 in) {
  const int kind = in.x & 7;
  int a, b;
  int v = bk_linear(r, in, a, b);
  v = kind == BK_GE ? (int)(a >= b) : v;
  v = kind == BK_SELECT ? (a ? b : bk_pick(r, in.w)) : v;
  if (kind >= BK_DIV) v = bk_divmod(kind, a, in.w);
  bk_put(r, (in.x >> 3) & 31, v);
}

// A packed program in device memory, read by every thread: what a resolve
// needs first is loaded into registers by load(), whose global loads the
// caller issues right after its index load, so both arrive together.  A
// program of at most 8 slots lives in registers whole; a longer one reads
// each slot when it runs it.
template <int R, int N>
struct BkProgram {
  static constexpr int K = N <= 8 ? N : 1;   // slots kept in registers
  const int* g;
  int4 head0, head1;   // n_instrs n_regs n_dims n_ba | bo size volume cap
  int2 fold0;
  int4 ins[K];

  __device__ __forceinline__ void load(const int* __restrict__ prog) {
    g = prog;
    head0 = __ldg(reinterpret_cast<const int4*>(prog));
    head1 = __ldg(reinterpret_cast<const int4*>(prog) + 1);
    fold0 = __ldg(reinterpret_cast<const int2*>(prog + BkLayout<N>::fold));
    if (N <= 8) {
#pragma unroll
      for (int i = 0; i < K; ++i)
        ins[i] = __ldg(reinterpret_cast<const int4*>(prog + BK_HEADER) + i);
    }
  }

  __device__ __forceinline__ int size_() const { return head1.y; }

  // Row of the bank-major table (bank * bank_volume + offset) of one
  // logical address, or -1 when the address is out of range.
  __device__ __forceinline__ int64_t resolve(int addr) const {
    if (addr < 0 || addr >= head1.y) return -1;
    int r[R];
#pragma unroll
    for (int i = 0; i < R; ++i) r[i] = 0;
    unsigned rem = (unsigned)addr;
    for (int i = head0.z - 1; i > 0; --i) {  // innermost first; x0 is left
      const int* sp = g + BkLayout<N>::split + 3 * i;
      const unsigned q = (unsigned)(((unsigned long long)rem *
                                     (unsigned)__ldg(sp + 1)) >> __ldg(sp + 2));
      bk_put(r, i, (int)(rem - q * (unsigned)__ldg(sp)));
      rem = q;
    }
    bk_put(r, 0, (int)rem);
    const int n = head0.x;
    if (N <= 8) {
#pragma unroll
      for (int i = 0; i < K; ++i) {
        if (i >= n) break;
        bk_step(r, ins[i]);
      }
    } else {
      const int4* ip = reinterpret_cast<const int4*>(g + BK_HEADER);
      for (int i = 0; i < n; ++i) bk_step(r, __ldg(ip + i));
    }
    int ba = bk_pick(r, fold0.x);
    for (int k = 1; k < head0.w; ++k) {
      const int* fp = g + BkLayout<N>::fold + 2 * k;
      ba = ba * __ldg(fp + 1) + bk_pick(r, __ldg(fp));
    }
    return (int64_t)ba * head1.z + bk_pick(r, head1.x);
  }
};

// A program over one address that the host turned into a sum of K terms
// (transforms.kernel_terms): row = base + sum c_i * (((a * m_i + k_i) >>
// s_i) & mask_i).  Every term reads the address alone, so the K run side
// by side and the chain is one term deep (a multiply-add, a shift, an and,
// a multiply-add into the sum), whatever the program's length.  The
// server's layout is three terms: ((a >> 4) & 7) * 128, (a >> 3) & -16
// and a & 15.
template <int K>
struct BkTerms {
  int size, base;
  int m[K], k[K], s[K], mask[K], c[K];

  __device__ __forceinline__ BkTerms prepare() const { return *this; }
  __device__ __forceinline__ int size_() const { return size; }

  __device__ __forceinline__ int64_t resolve(int addr) const {
    unsigned x[K];
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const int t = (int)((unsigned)addr * (unsigned)m[i] + (unsigned)k[i]);
      x[i] = (unsigned)((t >> s[i]) & mask[i]);
    }
    unsigned row = (unsigned)base;
#pragma unroll
    for (int i = 0; i < K; ++i) row += (unsigned)c[i] * x[i];
    return addr >= 0 && addr < size ? (int64_t)(int)row : -1;
  }
};

// What a kernel takes by value to reach its program; prepare() gives what
// it resolves with:
//
// * BkDev: a pointer to the packed program (transforms.pack_kernel_program)
//   of a bucket of transforms.KERNEL_BUCKETS in device memory, loaded into
//   a BkProgram -- every program.
// * BkTerms<K>: the program's sum of terms, by value, when the host found
//   one (bk_terms); it takes precedence.
template <int R, int N>
struct BkDev {
  const int* g;
  __device__ __forceinline__ BkProgram<R, N> prepare() const {
    BkProgram<R, N> p;
    p.load(g);
    return p;
  }
};

// L lanes copy (or zero-fill, src == nullptr) one row in V-sized pieces,
// lane p taking pieces p, p + L, ...
template <typename V>
__device__ __forceinline__ void bk_copy_row(char* dst, const char* src,
                                            int row_bytes, int p, int L) {
  const int n = row_bytes / (int)sizeof(V);
  V* d = reinterpret_cast<V*>(dst);
  if (src == nullptr) {
    const V zero = V();
    for (int i = p; i < n; i += L) d[i] = zero;
    return;
  }
  const V* s = reinterpret_cast<const V*>(src);
  int i = p;
  for (; i + 3 * L < n; i += 4 * L) {   // four independent loads in flight
    const V v0 = s[i], v1 = s[i + L], v2 = s[i + 2 * L], v3 = s[i + 3 * L];
    d[i] = v0; d[i + L] = v1; d[i + 2 * L] = v2; d[i + 3 * L] = v3;
  }
  for (; i < n; i += L) d[i] = s[i];
}

__device__ __forceinline__ void bk_copy_row_vec(char* dst, const char* src,
                                                int row_bytes, int vec, int p,
                                                int L) {
  switch (vec) {
    case 16: bk_copy_row<uint4>(dst, src, row_bytes, p, L); break;
    case 8: bk_copy_row<uint2>(dst, src, row_bytes, p, L); break;
    case 4: bk_copy_row<uint32_t>(dst, src, row_bytes, p, L); break;
    case 2: bk_copy_row<uint16_t>(dst, src, row_bytes, p, L); break;
    default: bk_copy_row<uint8_t>(dst, src, row_bytes, p, L); break;
  }
}

// out[t, :] = table[BA(idx[t]), BO(idx[t]), :]; 2^lanes_log2 lanes a row.
template <class P>
__global__ void __launch_bounds__(BK_THREADS)
bk_gather_kernel(const char* __restrict__ table, const int* __restrict__ idx,
                 char* __restrict__ out, int T, int row_bytes, int vec,
                 int lanes_log2, const P prog) {
  const int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t t = g >> lanes_log2;
  if (t >= T) return;                       // ragged last block
  const int addr = __ldg(idx + t);
  const auto p = prog.prepare();
  const int64_t row = p.resolve(addr);
  bk_copy_row_vec(out + t * row_bytes,
                  row < 0 ? nullptr : table + row * row_bytes, row_bytes,
                  vec, (int)(g & ((1 << lanes_log2) - 1)), 1 << lanes_log2);
}

// Claims logical address a for write t in the block's hash of addresses
// (atomicCAS on the key, linear probing; the hash is at most half full) and
// raises the slot's winner to t; returns the slot.
__device__ __forceinline__ int bk_claim(int* s_key, int* s_win, int a, int t) {
  unsigned h = ((unsigned)a * 0x85ebca77u) >> (32 - BK_HASH_BITS);
  for (;;) {
    const int key = atomicCAS(&s_key[h], -1, a);
    if (key == -1 || key == a) break;
    h = (h + 1) & (BK_HASH - 1);
  }
  atomicMax(&s_win[h], t);
  return (int)h;
}

// The block that owns a logical address in a scatter over nb blocks.
__device__ __forceinline__ int bk_owner(int addr, int nb) {
  return (int)__umulhi((unsigned)addr * 2654435761u, (unsigned)nb);
}

// table[BA(idx[t]), BO(idx[t]), :] = values[t, :], last write wins.  Each
// block reads every index and takes the writes to the addresses it owns
// (bk_owner), so the writes to one address meet in one block; see the
// design note at the top.
template <class P>
__global__ void __launch_bounds__(BK_THREADS, 1)
bk_scatter_rows_kernel(char* __restrict__ table, const int* __restrict__ idx,
                       const char* __restrict__ values, int T, int row_bytes,
                       int vec, int lanes_log2, const P prog,
                       int* __restrict__ win) {
  __shared__ int s_key[BK_HASH], s_win[BK_HASH];
  // the block's writes: t, logical address, hash slot, resolved row
  __shared__ int s_t[BK_OWN], s_addr[BK_OWN], s_slot[BK_OWN], s_row[BK_OWN];
  __shared__ int s_n;
  const int tid = threadIdx.x, lane = tid & 31, nb = gridDim.x;
  const int me = blockIdx.x, L = 1 << lanes_log2;
  const auto p = prog.prepare();
  const int size = p.size_();
  for (int i = tid; i < BK_HASH; i += BK_THREADS) {
    s_key[i] = -1;
    s_win[i] = -1;
  }
  if (tid == 0) s_n = 0;
  __syncthreads();
  // 1. list the writes to the addresses this block owns (one atomic a warp)
  for (int base = 0; base < T; base += 4 * BK_THREADS) {
    int addr[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {        // four index loads in flight
      const int t = base + j * BK_THREADS + tid;
      addr[j] = t < T ? __ldg(idx + t) : -1;
    }
    unsigned m[4];
    int total = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int a = addr[j];
      m[j] = __ballot_sync(0xffffffffu,
                           a >= 0 && a < size && bk_owner(a, nb) == me);
      total += __popc(m[j]);
    }
    int k = 0;
    if (lane == 0 && total) k = atomicAdd(&s_n, total);
    k = __shfl_sync(0xffffffffu, k, 0);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int at = k + __popc(m[j] & ((1u << lane) - 1));
      if ((m[j] >> lane) & 1 && at < BK_OWN) {
        s_t[at] = base + j * BK_THREADS + tid;
        s_addr[at] = addr[j];
      }
      k += __popc(m[j]);
    }
  }
  __syncthreads();
  const int n = s_n;
  if (n <= BK_THREADS && vec == 16 && row_bytes <= 32) {
    // Rows of one or two 16-byte pieces (the swap's 32): the thread of a
    // write claims its address, resolves it and loads its row into
    // registers before the barrier, and stores it after if it won.
    const bool mine = tid < n;
    uint4 v0 = make_uint4(0, 0, 0, 0), v1 = v0;
    int t = 0, slot = 0;
    int64_t row = 0;
    if (mine) {
      const int a = s_addr[tid];
      t = s_t[tid];
      const uint4* src = reinterpret_cast<const uint4*>(values +
                                                        (int64_t)t * row_bytes);
      v0 = __ldg(src);
      if (row_bytes == 32) v1 = __ldg(src + 1);
      slot = bk_claim(s_key, s_win, a, t);
      row = p.resolve(a);
    }
    __syncthreads();
    if (mine && s_win[slot] == t) {
      uint4* dst = reinterpret_cast<uint4*>(table + row * row_bytes);
      dst[0] = v0;
      if (row_bytes == 32) dst[1] = v1;
    }
    return;
  }
  if (n <= BK_OWN) {
    // 2. a thread a write: claim its address, resolve it
    for (int k = tid; k < n; k += BK_THREADS) {
      const int t = s_t[k];
      // the row this write may copy, brought into L1 while the others
      // claim theirs
      asm volatile("prefetch.global.L1 [%0];" ::"l"(values +
                                                      (int64_t)t * row_bytes));
      s_slot[k] = bk_claim(s_key, s_win, s_addr[k], t);
      s_row[k] = (int)p.resolve(s_addr[k]);
    }
    __syncthreads();
    // 3. the last write of each address copies, L lanes a row
    for (int k = tid >> lanes_log2; k < n; k += BK_THREADS >> lanes_log2) {
      const int t = s_t[k];
      if (s_win[s_slot[k]] != t) continue;
      bk_copy_row_vec(table + (int64_t)s_row[k] * row_bytes,
                      values + (int64_t)t * row_bytes, row_bytes, vec,
                      tid & (L - 1), L);
    }
    return;
  }
  // Overflow (only when T > BK_OWN): the winner table win, one int a
  // logical address, zero between calls; the addresses are this block's
  // alone, so a block barrier orders it, and the block zeroes what it used.
  for (int t = tid; t < T; t += BK_THREADS) {
    const int a = __ldg(idx + t);
    if (a >= 0 && a < size && bk_owner(a, nb) == me)
      atomicMax(win + a, t + 1);
  }
  __syncthreads();
  for (int t = tid >> lanes_log2; t < T; t += BK_THREADS >> lanes_log2) {
    const int a = __ldg(idx + t);
    if (a < 0 || a >= size || bk_owner(a, nb) != me ||
        __ldcg(win + a) != t + 1)
      continue;
    bk_copy_row_vec(table + p.resolve(a) * row_bytes,
                    values + (int64_t)t * row_bytes, row_bytes, vec,
                    tid & (L - 1), L);
  }
  __syncthreads();
  for (int t = tid; t < T; t += BK_THREADS) {
    const int a = __ldg(idx + t);
    if (a >= 0 && a < size && bk_owner(a, nb) == me) win[a] = 0;
  }
}

// The key of a pair (address, column) of a table D wide: distinct pairs
// in range have distinct keys, and none is BK_EMPTY.
__device__ __forceinline__ unsigned long long bk_pair_key(int a, int c,
                                                          int D) {
  return (unsigned long long)(unsigned)a * (unsigned)D + (unsigned)c;
}

// The block that owns a pair in an element scatter over nb blocks, from
// the low 32 bits of the pair's key.
__host__ __device__ __forceinline__ int bk_pair_owner(unsigned lo, int nb) {
  return (int)(((unsigned long long)(lo * 2654435761u) * (unsigned)nb) >> 32);
}

// Claims a pair for write t in the block's hash of 2^BITS pairs (atomicCAS
// on the key, linear probing; never more than half full) and raises the
// slot's winner to t; returns the slot.
template <int BITS>
__device__ __forceinline__ int bk_claim_pair(unsigned long long* s_key,
                                             int* s_win,
                                             unsigned long long key, int t) {
  unsigned h = ((unsigned)key * 0x85ebca77u) >> (32 - BITS);
  for (;;) {
    const unsigned long long k = atomicCAS(&s_key[h], BK_EMPTY, key);
    if (k == BK_EMPTY || k == key) break;
    h = (h + 1) & ((1u << BITS) - 1);
  }
  atomicMax(&s_win[h], t);
  return (int)h;
}

// Threads a block of the element scatter past one warp: 512, so that one
// pass of sixteen pairs a thread covers the admit flush's 8,000 writes and
// sixteen warps hide each other's latency; 256 for the largest BkDev, whose
// resolve would spill under the 128 registers a thread of 512 may have.
template <class P>
struct BkElemThreads { static constexpr int value = 512; };
template <>
struct BkElemThreads<BkDev<32, 192>> { static constexpr int value = 256; };

// table[BA(idx[t]), BO(idx[t]), cols[t]] = values[t], last write wins (the
// design note at the top).  vec4: idx and cols lie on 16 bytes.
template <typename E, class P>
__global__ void __launch_bounds__(BkElemThreads<P>::value)
bk_scatter_elems_kernel(E* __restrict__ table, const int* __restrict__ idx,
                        const int* __restrict__ cols,
                        const E* __restrict__ values, int T, int D, int vec4,
                        const P prog) {
  const int tid = threadIdx.x;
  const auto p = prog.prepare();
  extern __shared__ unsigned long long bk_shared[];
  if (T <= BK_ELEM_PER_BLOCK) {
    // One block, a thread a write: the lanes of one pair in a warp find
    // each other with one match, and the highest of them is the warp's
    // last write of the pair.  In one warp it stores; in more, it claims
    // the pair and the last write of each pair stores after a barrier.
    int a = -1, c = -1;
    E v = E();
    if (tid < T) {
      a = __ldg(idx + tid);
      c = __ldg(cols + tid);
      v = values[tid];
    }
    const bool ok = (unsigned)a < (unsigned)p.size_() &&
                    (unsigned)c < (unsigned)D;
    const int64_t row = p.resolve(a);      // beside the match
    const unsigned long long key = ok ? bk_pair_key(a, c, D) : BK_EMPTY;
    const unsigned peers = __match_any_sync(0xffffffffu, key);
    bool last = ok && 31 - __clz(peers) == (tid & 31);
    if (T > 32) {
      unsigned long long* s_key = bk_shared;
      int* s_win = reinterpret_cast<int*>(s_key + BK_ELEM_ONE_HASH);
      for (int i = tid; i < BK_ELEM_ONE_HASH; i += blockDim.x) {
        s_key[i] = BK_EMPTY;
        s_win[i] = -1;
      }
      __syncthreads();
      int slot = 0;
      if (last)
        slot = bk_claim_pair<BK_ELEM_ONE_HASH_BITS>(s_key, s_win, key, tid);
      __syncthreads();
      last = last && s_win[slot] == tid;
    }
    if (last) table[row * D + c] = v;
    return;
  }
  constexpr int NT = BkElemThreads<P>::value, J = BK_ELEM_OWN / NT;
  unsigned long long* s_key = bk_shared;                   // the hash ...
  int* s_win = reinterpret_cast<int*>(s_key + BK_ELEM_HASH);  // ... winners
  int* s_t = s_win + BK_ELEM_HASH;           // the listed writes: t,
  int* s_a = s_t + BK_ELEM_OWN;              // address,
  int* s_c = s_a + BK_ELEM_OWN;              // column
  __shared__ int s_n;
  const int lane = tid & 31, nb = gridDim.x, me = blockIdx.x;
  const unsigned size = (unsigned)p.size_();
  for (int i = tid; i < BK_ELEM_HASH; i += NT) {
    s_key[i] = BK_EMPTY;
    s_win[i] = -1;
  }
  if (tid == 0) s_n = 0;
  __syncthreads();
  // All T writes in one pass; a block that owns more than BK_ELEM_OWN of
  // them walks them again in windows of BK_ELEM_OWN writes, in order, each
  // window's last writes storing after the previous window's.
  int span = T;
  for (int w0 = 0; w0 < T; w0 += span) {
    const int w1 = min(T, w0 + span);
    // 1. list the window's writes to pairs this block owns: sixteen pairs
    //    a thread in flight, a bit a pair, a scan of the counts across the
    //    warp and one shared atomic a warp
    for (int base = w0; base < w1; base += 16 * NT) {
      int a[16], c[16];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = base + 4 * (j * NT + tid);
        if (vec4 && t + 3 < w1) {
          const int4 av = __ldg(reinterpret_cast<const int4*>(idx + t));
          const int4 cv = __ldg(reinterpret_cast<const int4*>(cols + t));
          a[4 * j] = av.x; a[4 * j + 1] = av.y;
          a[4 * j + 2] = av.z; a[4 * j + 3] = av.w;
          c[4 * j] = cv.x; c[4 * j + 1] = cv.y;
          c[4 * j + 2] = cv.z; c[4 * j + 3] = cv.w;
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool in = t + e < w1;
            a[4 * j + e] = in ? __ldg(idx + t + e) : -1;
            c[4 * j + e] = in ? __ldg(cols + t + e) : -1;
          }
        }
      }
      unsigned mine = 0;
#pragma unroll
      for (int q = 0; q < 16; ++q)
        mine |= (unsigned)((unsigned)a[q] < size &&
                           (unsigned)c[q] < (unsigned)D &&
                           bk_pair_owner((unsigned)a[q] * (unsigned)D +
                                             (unsigned)c[q], nb) == me)
                << q;
      const int cnt = __popc(mine);
      int at = cnt;                              // inclusive scan
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, at, o);
        if (lane >= o) at += y;
      }
      int first = 0;
      if (lane == 31 && at) first = atomicAdd(&s_n, at);
      at += __shfl_sync(0xffffffffu, first, 31) - cnt;
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        if ((mine >> q) & 1) {
          const int t = base + 4 * ((q >> 2) * NT + tid) + (q & 3);
          if (at < BK_ELEM_OWN) {
            s_t[at] = t;
            s_a[at] = a[q];
            s_c[at] = c[q];
          }
          // the value this write may store, brought into L1 meanwhile
          asm volatile("prefetch.global.L1 [%0];" ::"l"(values + t));
          ++at;
        }
      }
    }
    __syncthreads();
    const int n = s_n;
    if (n > BK_ELEM_OWN) {        // only in the first pass: go by windows
      span = BK_ELEM_OWN;
      w0 = -span;
      __syncthreads();
      if (tid == 0) s_n = 0;
      __syncthreads();
      continue;
    }
    // 2. a thread a listed write (at most J): claim its pair, and beside
    //    it resolve its address and load its value
    int slot[J], tt[J];
    int64_t off[J];
    E v[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int k = tid + j * NT;
      tt[j] = -1;
      slot[j] = 0;
      off[j] = 0;
      v[j] = E();
      if (k < n) {
        const int t = s_t[k], a = s_a[k], c = s_c[k];
        tt[j] = t;
        v[j] = values[t];
        off[j] = p.resolve(a) * D + c;
        slot[j] = bk_claim_pair<BK_ELEM_HASH_BITS>(s_key, s_win,
                                                   bk_pair_key(a, c, D), t);
      }
    }
    __syncthreads();
    // 3. the last write of each pair stores
#pragma unroll
    for (int j = 0; j < J; ++j)
      if (tt[j] >= 0 && s_win[slot[j]] == tt[j]) table[off[j]] = v[j];
    if (w1 < T) {                 // a window follows: empty what this used
      __syncthreads();
#pragma unroll
      for (int j = 0; j < J; ++j) {
        if (tt[j] >= 0) {
          s_key[slot[j]] = BK_EMPTY;
          s_win[slot[j]] = -1;
        }
      }
      if (tid == 0) s_n = 0;
      __syncthreads();
    }
  }
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

// log2 of the lanes a row: the power of two that covers its pieces, <= 32.
static int bk_lanes_log2(int row_bytes, int vec) {
  const int pieces = row_bytes / vec;
  int l = 0;
  while (l < 5 && (1 << l) < pieces) ++l;
  return l;
}

// Blocks of a row scatter of T writes: about BK_PER_BLOCK writes each, at
// most BK_MAX_BLOCKS (every block reads all T indices).
static int bk_scatter_blocks(int T) {
  const int b = (T + BK_PER_BLOCK - 1) / BK_PER_BLOCK;
  return b < BK_MAX_BLOCKS ? b : BK_MAX_BLOCKS;
}

// Blocks of an element scatter of T writes: one (a thread a write) up to
// BK_ELEM_PER_BLOCK, else about BK_ELEM_PER_BLOCK writes each, at most
// BK_MAX_BLOCKS (every block reads all T pairs, so more blocks cost L2
// reads, but each lists and claims fewer).
static int bk_elem_blocks(int T) {
  const int b = (T + BK_ELEM_PER_BLOCK - 1) / BK_ELEM_PER_BLOCK;
  return b < BK_MAX_BLOCKS ? b : BK_MAX_BLOCKS;
}

// The three launches for one program source P.
template <class P>
struct BkLaunch {
  static void gather(const void* table, const void* idx, void* out, int T,
                     int row_bytes, const P& p, cudaStream_t s) {
    const int vec = bk_vec(table, out, row_bytes);
    const int l = bk_lanes_log2(row_bytes, vec);
    const int64_t threads = (int64_t)T << l;
    const int block = threads < BK_THREADS ? (int)((threads + 31) / 32 * 32)
                                           : BK_THREADS;
    bk_gather_kernel<P><<<(unsigned)((threads + block - 1) / block), block, 0,
                          s>>>((const char*)table, (const int*)idx, (char*)out,
                               T, row_bytes, vec, l, p);
  }
  static void scatter_rows(void* table, const void* idx, const void* values,
                           int T, int row_bytes, const P& p, int* win,
                           cudaStream_t s) {
    const int vec = bk_vec(table, values, row_bytes);
    bk_scatter_rows_kernel<P><<<bk_scatter_blocks(T), BK_THREADS, 0, s>>>(
        (char*)table, (const int*)idx, (const char*)values, T, row_bytes,
        vec, bk_lanes_log2(row_bytes, vec), p, win);
  }
  template <typename E>
  static void elems(void* table, const void* idx, const void* cols,
                    const void* values, int T, int D, const P& p,
                    cudaStream_t s) {
    const int vec4 = (((uintptr_t)idx | (uintptr_t)cols) & 15) == 0;
    const bool one = T <= BK_ELEM_PER_BLOCK;   // a thread a write
    const int threads = one ? (T + 31) / 32 * 32 : BkElemThreads<P>::value;
    const int shared = T <= 32 ? 0 : one ? BK_ELEM_ONE_SHARED : BK_ELEM_SHARED;
    bk_scatter_elems_kernel<E, P><<<bk_elem_blocks(T), threads, shared, s>>>(
        (E*)table, (const int*)idx, (const int*)cols, (const E*)values, T, D,
        vec4, p);
  }
  static int scatter_elems(void* table, const void* idx, const void* cols,
                           const void* values, int T, int D, int esize,
                           const P& p, cudaStream_t s) {
    switch (esize) {
      case 1: elems<uint8_t>(table, idx, cols, values, T, D, p, s); break;
      case 2: elems<uint16_t>(table, idx, cols, values, T, D, p, s); break;
      case 4: elems<uint32_t>(table, idx, cols, values, T, D, p, s); break;
      case 8: elems<uint64_t>(table, idx, cols, values, T, D, p, s); break;
      default: return (int)cudaErrorInvalidValue;
    }
    return 0;
  }
};

// Where the sum of terms begins in a program of `capacity` slots, or -1.
static int bk_terms_at(int capacity) {
  switch (capacity) {
    case 8: return BkLayout<8>::terms;
    case 32: return BkLayout<32>::terms;
    case 192: return BkLayout<192>::terms;
    default: return -1;
  }
}

// Calls f with the launches of BkTerms<K> and the packed program's sum of
// terms (transforms.kernel_terms) read into it.
template <int K, typename F>
static int bk_terms(const int* w, F f) {
  const int* tw = w + bk_terms_at(w[7]);
  BkTerms<K> p;
  p.size = w[5];
  p.base = tw[1];
  for (int i = 0; i < K; ++i) {
    const int* q = tw + 2 + 5 * i;
    p.m[i] = q[0];
    p.k[i] = q[1];
    p.s[i] = q[2];
    p.mask[i] = q[3];
    p.c[i] = q[4];
  }
  return f(BkLaunch<BkTerms<K>>(), p);
}

// Calls f with the launches and the program source for the packed program
// `host` (transforms.pack_kernel_program; `dev`: the same words in device
// memory): BkTerms when the host found a sum of terms, else BkDev of its
// bucket.
template <typename F>
static int bk_with_program(const int* host, const int* dev, F f) {
  const int n = host[0], regs = host[1], capacity = host[7];
  const int at = bk_terms_at(capacity);
  if (n < 0 || n > capacity || regs < 1 || at < 0)
    return (int)cudaErrorInvalidValue;
  switch (host[at]) {
    case 0: break;
    case 1: return bk_terms<1>(host, f);
    case 2: return bk_terms<2>(host, f);
    case 3: return bk_terms<3>(host, f);
    case 4: return bk_terms<4>(host, f);
    default: return (int)cudaErrorInvalidValue;
  }
  if (capacity == 8 && regs <= 4)
    return f(BkLaunch<BkDev<4, 8>>(), BkDev<4, 8>{dev});
  if (capacity == 32 && regs <= 16)
    return f(BkLaunch<BkDev<16, 32>>(), BkDev<16, 32>{dev});
  if (capacity == 192 && regs <= 32)
    return f(BkLaunch<BkDev<32, 192>>(), BkDev<32, 192>{dev});
  return (int)cudaErrorInvalidValue;
}

extern "C" {

// Words of a program packed for `capacity` instruction slots.
int bk_program_words(int capacity) {
  switch (capacity) {
    case 8: return BkLayout<8>::words;
    case 32: return BkLayout<32>::words;
    case 192: return BkLayout<192>::words;
    default: return -1;
  }
}

int bk_block_writes() { return BK_OWN; }

// The blocks of an element scatter of T writes, and the block of those nb
// that owns the pair key (address * D + column): the wrapper's twins
// (banked_gather.elems_blocks, pair_owner) are held to these.
int bk_elems_blocks(int T) { return bk_elem_blocks(T); }
int bk_elems_owner(long long key, int nb) {
  return bk_pair_owner((unsigned)key, nb);
}

// host, dev: the packed program in host and in device memory.
int bk_gather(const void* table, const void* idx, void* out, int T,
              int row_bytes, const void* host, const void* dev,
              void* stream) {
  if (T > 0 && row_bytes > 0) {
    const int err = bk_with_program((const int*)host, (const int*)dev,
                                    [&](auto l, const auto& p) {
      l.gather(table, idx, out, T, row_bytes, p, (cudaStream_t)stream);
      return 0;
    });
    if (err != 0) return err;
  }
  return (int)cudaGetLastError();
}

// win: the winner table (logical_size int32, zero), read only when a block
// owns more than bk_block_writes() writes, which needs T above it; may be
// null up to there.
int bk_scatter_rows(void* table, const void* idx, const void* values, int T,
                    int row_bytes, const void* host, const void* dev,
                    void* win, void* stream) {
  if (T > BK_OWN && win == nullptr) return (int)cudaErrorInvalidValue;
  if (T > 0 && row_bytes > 0) {
    const int err = bk_with_program((const int*)host, (const int*)dev,
                                    [&](auto l, const auto& p) {
      l.scatter_rows(table, idx, values, T, row_bytes, p, (int*)win,
                     (cudaStream_t)stream);
      return 0;
    });
    if (err != 0) return err;
  }
  return (int)cudaGetLastError();
}

int bk_scatter_elems(void* table, const void* idx, const void* cols,
                     const void* values, int T, int D, int esize,
                     const void* host, const void* dev, void* stream) {
  if (T > 0 && D > 0) {
    const int err = bk_with_program((const int*)host, (const int*)dev,
                                    [&](auto l, const auto& p) {
      return l.scatter_elems(table, idx, cols, values, T, D, esize, p,
                             (cudaStream_t)stream);
    });
    if (err != 0) return err;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
