// One chunk of the Mamba2 SSD scan for Hopper (sm_90a), on the tensor cores.
//
// Replaces the Pallas TPU kernel ssd_chunk of the JAX package
// (src/repro/kernels/ssd_chunk.py:61, pallas_call :69, body _ssd_kernel).
// For every (batch b, head h), with x (Q, P), dt and cum (Q,), B and C
// (Q, N) shared by the heads of a batch row, and the carried state
// S_prev (P, N):
//
//   L[i, j] = exp(cum_i - cum_j)  for j <= i, else 0 (exp never sees j > i)
//   y       = ((C B^T) o L) (dt o x) + exp(cum) o (C S_prev^T)        (Q, P)
//   S_new   = exp(cum_{Q-1}) S_prev + ((dt o x) o exp(cum_{Q-1} - cum))^T B
//                                                                     (P, N)
//
// float32 in and out.  x, dt, cum, B, C, S_prev and y are read and written
// through element strides, so the caller passes views of its chunk as they
// lie: x, B, C and S_prev need a unit-stride last dimension and a 16-byte
// aligned start for every row (TMA reads them; the wrapper copies an input
// that has not); dt, cum and y take any strides.  S_new is contiguous
// (B, H, P, N).
//
// Precision: 3xTF32.  Every operand v is split into v_hi = tf32(v) and
// v_lo = tf32(v - v_hi) (round to nearest, 10 stored mantissa bits each),
// and a product a b is taken as a_lo b_hi + a_hi b_lo + a_hi b_hi on the
// tensor cores (wgmma m64n64k8.tf32, float32 sums).  The dropped a_lo b_lo
// and the rounding of the lo parts are each within 2^-22 of |a b|, so a sum
// of products is near float32: a few 1e-6 of max |y| against the bound of
// 1e-4 that the plain float32 version holds it to.  TF32 alone (2^-11)
// would not meet it.
//
// Bound, at the mamba2-370m prefill shape (B 8, H 32, Q 256, P 64, N 128):
// about 53 MB moved once, 0.016 ms at 3.35 TB/s; 3.29 GFLOP with C B^T
// once per batch row, three tensor-core products each, 9.9 GFLOP at the
// card's 495 TFLOP/s of dense TF32: 0.020 ms.  So the products bound it
// (against 0.08 ms for 5.4 GFLOP of float32 FMA with C B^T per head, as
// the TPU kernel forms it).  What the design does:
//
// * C B^T once per (batch row, chunk).  One cooperative launch runs two
//   phases split by a grid barrier.  Phase 1 forms the causal 64 x 64 tiles
//   of C B^T of every batch row into a scratch buffer (B x T(T+1)/2 tiles,
//   T = ceil(Q / 64); 1.3 MB at the mamba2 shape, in L2), beside the S_new
//   items, which need no C B^T.  Phase 2 runs the y items, each reading its
//   row's tiles and applying its own head's L.
// * Every item is a 64 x 64 output tile and a walk over 64-deep k tiles:
//   y (b, h, 64 rows): the causal j tiles of W (dt o x), then the N/64
//   tiles of (exp(cum) o C) S_prev^T; S_new (b, h, 64 columns of N): the
//   Q/64 j tiles of u^T B; C B^T (b, i tile, j tile): the N/64 tiles of
//   C B^T.  One persistent block a SM takes items in turn; the y items go
//   heaviest first (the last i tile walks four times the j tiles of the
//   first), so the tail is light.
// * Three roles in a block of three warpgroups.  Warpgroup 0 issues the
//   copies through TMA (two boxes of 64 rows x 32 columns a tile, 128-byte
//   swizzled, zero outside the tensor) into a ring of three raw stages,
//   runs each tile's 24 wgmma, and writes an item's sums.  Warpgroups 1 and
//   2 stage a landed tile into one of two split buffers: they apply what is
//   elementwise (L, dt and the causal mask to C B^T, taking W (dt o x) as
//   (W o dt) x; exp(cum) to C; dt and the decay to the chunk's end to x),
//   split it, and store it in wgmma's K-major layout, transposing x and B
//   where k runs down their rows (TF32 wgmma reads no transposed operand).
//   Full and empty mbarriers hand the stages and buffers round, so the
//   copies run three tiles ahead and a tile is staged while the tensor
//   cores multiply the one before.
//
// P <= 64 and N <= 128 (every config of the repository); any Q >= 1.  The
// entry point builds the tensor maps, launches on the given stream,
// allocates nothing (the caller passes the scratch buffer of
// sc_scratch_floats floats), does not synchronize, and returns the
// launch's error (cudaErrorInvalidValue for a shape or layout it does not
// take).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace cg = cooperative_groups;

#define SC_T 64           // rows, columns and depth of a tile
#define SC_PMAX 64
#define SC_NMAX 128
#define SC_THREADS 384    // three warpgroups: products and copies; staging
#define SC_STAGERS 256    // the threads of warpgroups 1 and 2
#define SC_MAX_DEVICES 64
#define SC_TILE (SC_T * SC_T)
#define SC_RING 3         // raw stages: copies run three tiles ahead
// shared memory, from a 1024-byte aligned base: three raw stages (A, B:
// 64 x 64 float32 each as two TMA boxes of 64 rows x 32 columns, see
// raw_at), two split buffers (A_hi, A_lo, B_hi, B_lo: 64 x 64 TF32 each,
// K-major core matrices), the raw stages' vectors (three of 64 each), ten
// mbarriers
#define SC_RAW (2 * SC_TILE)
#define SC_SPLIT (4 * SC_TILE)
#define SC_VEC (3 * SC_T)
#define SC_SMEM_FLOATS \
  (SC_RING * SC_RAW + 2 * SC_SPLIT + SC_RING * SC_VEC + 20)

struct ScArgs {
  const float* x;
  const float* dt;
  const float* bm;
  const float* cm;
  const float* cum;
  const float* s_prev;
  float* y;
  float* s_new;
  float* g;               // C B^T tiles, written in phase 1, read in phase 2
  int B, H, Q, P, N, T;   // T = tiles of 64 along Q
  // element strides: x, dt, cum, y over (b, h, q); bm, cm over (b, q);
  // s_prev over (b, h, p)
  int64_t xs[3], dts[3], cums[3], ys[3], bms[2], cms[2], ss[3];
};

// The tensor maps the copies read through (TMA): x, B, C and S_prev as
// the caller's views lie, and the scratch buffer of C B^T tiles; each a
// 4-D map (innermost first) with boxes of 32 columns x 64 rows, 128-byte
// swizzled, zero outside the tensor.
struct ScMaps {
  CUtensorMap x;       // (P, Q, H, B)
  CUtensorMap bm;      // (N, Q, B, 1)
  CUtensorMap cm;      // (N, Q, B, 1)
  CUtensorMap s;       // (N, P, H, B)
  CUtensorMap g;       // (64, 64 x tiles, 1, 1)
};

// 4-byte copy, 0 when !in.
static __device__ __forceinline__ void cp4(float* dst, const float* src,
                                           bool in) {
  asm volatile(
      "cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(in ? 4 : 0)
      : "memory");
}

// An arrival on `bar` once every cp.async this thread started has landed.
static __device__ __forceinline__ void cp_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

// Float offset of element (r, c) of a raw tile as TMA writes it: columns
// 0..31 and 32..63 in two boxes of 64 rows of 128 bytes, the 16-byte
// chunks of row r permuted by XOR with r % 8 (the 128-byte swizzle), so
// that a warp reading one chunk of 8 rows, or 32 consecutive floats of a
// row, meets no bank twice.
static __device__ __forceinline__ int raw_at(int r, int c) {
  return (c >> 5) * (SC_T * 32) + r * 32 +
         (((((c >> 2) & 7) ^ (r & 7))) << 2) + (c & 3);
}

// One 64 x 64 raw tile: its two boxes at coordinates (c0, c1, c2, c3) and
// (c0 + 32, ...), landing on bar.
static __device__ __forceinline__ void load_tile(float* dst,
                                                 const CUtensorMap* map,
                                                 uint32_t bar, int c0,
                                                 int c1, int c2, int c3) {
  tma_load_4d(smem_u32(dst), map, bar, c0, c1, c2, c3);
  tma_load_4d(smem_u32(dst + SC_T * 32), map, bar, c0 + 32, c1, c2, c3);
}

// ---- the products -----------------------------------------------------------

static __device__ __forceinline__ void split_tf32(float v, float& hi,
                                                  float& lo) {
  uint32_t h, l;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(h) : "f"(v));
  const float r = v - __uint_as_float(h);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(l) : "f"(r));
  hi = __uint_as_float(h);
  lo = __uint_as_float(l);
}

// Float offset of element (row, k) of a 64 x 64 operand in the K-major
// layout without swizzle: core matrices of 8 rows x 4 k (16 bytes a row,
// 128 bytes each), the next 4 k 128 bytes on (LBO), the next 8 rows 2048
// bytes on (SBO).
static __device__ __forceinline__ int kmajor(int row, int k) {
  return (k >> 2) * 32 + (row >> 3) * 512 + (row & 7) * 4 + (k & 3);
}

static __device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(2048 >> 4) << 32);
}

// D (64 x 64, float32) += A (64 x 8) B (64 x 8)^T, TF32, both K-major in
// shared memory.
static __device__ __forceinline__ void wgmma_tf32(float (&d)[32], uint64_t da,
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// acc += A B^T over a split buffer, 3xTF32: eight k steps of
// a_lo b_hi + a_hi b_lo + a_hi b_hi, then waits for them.  Warpgroup 0.
static __device__ __forceinline__ void tile_products(float (&acc)[32],
                                                     const float* split) {
  const uint32_t base = smem_u32(split);
  const uint32_t a_hi = base, a_lo = base + 4 * SC_TILE,
                 b_hi = base + 8 * SC_TILE, b_lo = base + 12 * SC_TILE;
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < SC_T / 8; ++s) {
    const uint32_t o = 256 * s;          // k step s: core matrices 2s, 2s+1
    wgmma_tf32(acc, kmajor_desc(a_lo + o), kmajor_desc(b_hi + o));
    wgmma_tf32(acc, kmajor_desc(a_hi + o), kmajor_desc(b_lo + o));
    wgmma_tf32(acc, kmajor_desc(a_hi + o), kmajor_desc(b_hi + o));
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
}

// Calls f(row, col, value) for each sum a thread of warpgroup 0 holds (the
// wgmma m64n64 float32 layout): rows warp*16 + g (+ 8), columns
// n*8 + 2t (+ 1).
template <typename F>
static __device__ __forceinline__ void each_sum(const float (&acc)[32], F f) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r = warp * 16 + (lane >> 2), c = 2 * (lane & 3);
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    f(r, n * 8 + c, acc[n * 4 + 0]);
    f(r, n * 8 + c + 1, acc[n * 4 + 1]);
    f(r + 8, n * 8 + c, acc[n * 4 + 2]);
    f(r + 8, n * 8 + c + 1, acc[n * 4 + 3]);
  }
}

// ---- staging: raw tile -> what is elementwise, split, K-major ---------------

// The operand is the raw tile as it lies: element (row r, k c) is raw
// [r][c] times f(r, c).  A thread takes 4 pieces of 4 consecutive k; a
// warp's 32 lanes take 8 rows x 4 pieces, so 8 lanes' 16-byte stores
// fill 8 distinct slots of a core matrix.  All of a thread's reads go out
// before its stores (the buffers do not overlap).
template <typename F>
static __device__ __forceinline__ void stage_rows(float* __restrict__ hi,
                                                  float* __restrict__ lo,
                                                  const float* __restrict__ raw,
                                                  F f) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) - 4;
  float4 v[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int blk = u * 8 + warp;
    const int r = (blk & 7) * 8 + (lane & 7);
    const int c = ((blk >> 3) * 4 + (lane >> 3)) * 4;
    v[u] = *reinterpret_cast<const float4*>(raw + raw_at(r, c));
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int blk = u * 8 + warp;
    const int r = (blk & 7) * 8 + (lane & 7);
    const int c = ((blk >> 3) * 4 + (lane >> 3)) * 4;
    const float in[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
    float h[4], l[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) split_tf32(f(r, c + q, in[q]), h[q], l[q]);
    const int o = kmajor(r, c);
    *reinterpret_cast<float4*>(hi + o) = make_float4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<float4*>(lo + o) = make_float4(l[0], l[1], l[2], l[3]);
  }
}

// The operand is the raw tile's transpose: element (row c, k r) is raw
// [r][c] times f(r).  A thread reads 4 consecutive raw rows of one column
// (lanes on consecutive columns) and stores them as 16 bytes; all of its
// reads go out before its stores.
template <typename F>
static __device__ __forceinline__ void stage_cols(float* __restrict__ hi,
                                                  float* __restrict__ lo,
                                                  const float* __restrict__ raw,
                                                  F f) {
  float v[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int e = threadIdx.x - 128 + u * SC_STAGERS, c = e % SC_T,
              r = (e / SC_T) * 4;
#pragma unroll
    for (int q = 0; q < 4; ++q) v[u][q] = raw[raw_at(r + q, c)];
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int e = threadIdx.x - 128 + u * SC_STAGERS, c = e % SC_T,
              r = (e / SC_T) * 4;
    float h[4], l[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) split_tf32(v[u][q] * f(r + q), h[q], l[q]);
    const int o = kmajor(c, r);
    *reinterpret_cast<float4*>(hi + o) = make_float4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<float4*>(lo + o) = make_float4(l[0], l[1], l[2], l[3]);
  }
}

struct AsIs {
  __device__ __forceinline__ float operator()(int, int, float v) const {
    return v;
  }
};

struct One {
  __device__ __forceinline__ float operator()(int) const { return 1.f; }
};

// ---- items and their k tiles ------------------------------------------------

// What a k tile multiplies (A rows x B rows, both over k):
enum Kind {
  CB,      // A = C [i][n], B = B [j][n]: C B^T
  STATE,   // A = x^T [p][j] (o dt decay), B = B^T [n][j]: u^T B
  INTRA,   // A = C B^T [i][j] (o L o dt), B = x^T [p][j]: (W o dt) x
  INTER,   // A = C [i][n] (o exp(cum_i)), B = S_prev [p][n]: C S_prev^T
};

// Index of the causal tile (i, j), j <= i, among a batch row's T (T + 1) / 2.
static __device__ __forceinline__ int tri(int i, int j) {
  return i * (i + 1) / 2 + j;
}

// The place of the C B^T tile (i, j) of batch row b in the scratch buffer,
// in tiles of 64 x 64.
static __device__ __forceinline__ int cb_index(const ScArgs& a, int b, int i,
                                               int j) {
  return b * (a.T * (a.T + 1) / 2) + tri(i, j);
}

// One item of a phase: phase 1 holds the S_new items (b, h, 64 columns n0)
// then the C B^T tiles (b, ti, tj); phase 2 the y items (b, h, ti), the
// last i tile first.  nk: its k tiles.
struct Item {
  Kind kind;       // CB, STATE, or INTRA for a y item (INTER after ti + 1)
  int b, h, ti, tj, n0, nk;
};

template <int PHASE>
static __device__ __forceinline__ Item item_of(const ScArgs& a, int it) {
  Item m = {};
  const int BH = a.B * a.H, n_cols = (a.N + SC_T - 1) / SC_T;
  if (PHASE == 1 && it < BH * n_cols) {
    const int bh = it / n_cols;
    m.kind = STATE;
    m.b = bh / a.H;
    m.h = bh % a.H;
    m.n0 = (it % n_cols) * SC_T;
    m.nk = a.T;
  } else if (PHASE == 1) {
    const int k = it - BH * n_cols, per_row = a.T * (a.T + 1) / 2;
    int ti = 0, r = k % per_row;
    while (r > ti) r -= ++ti;            // r-th tile of row ti: tj = r
    m.kind = CB;
    m.b = k / per_row;
    m.ti = ti;
    m.tj = r;
    m.nk = n_cols;
  } else {
    const int bh = it % BH;
    m.kind = INTRA;
    m.b = bh / a.H;
    m.h = bh % a.H;
    m.ti = a.T - 1 - it / BH;
    m.nk = m.ti + 1 + n_cols;
  }
  return m;
}

template <int PHASE>
static __device__ __forceinline__ int phase_items(const ScArgs& a) {
  const int BH = a.B * a.H, n_cols = (a.N + SC_T - 1) / SC_T;
  return PHASE == 1 ? BH * n_cols + a.B * (a.T * (a.T + 1) / 2)
                    : BH * a.T;
}

// Phase 1 holds CB and STATE tiles, phase 2 INTRA and INTER ones; the
// phase is a template parameter so that each holds only its kinds' code.
template <int PHASE>
static __device__ __forceinline__ Kind kind_of(const Item& m, int k) {
  if (PHASE == 1) return m.kind == CB ? CB : STATE;
  return k <= m.ti ? INTRA : INTER;
}

// A position in a block's walk over its items' k tiles.
struct Cursor {
  int it, k;
  Item m;
};

template <int PHASE>
static __device__ __forceinline__ Cursor advance(const ScArgs& a,
                                                 Cursor c) {
  if (++c.k == c.m.nk) {
    c.it += gridDim.x;
    c.k = 0;
    if (c.it < phase_items<PHASE>(a)) c.m = item_of<PHASE>(a, c.it);
  }
  return c;
}

// Starts the copies of a k tile into a raw stage and its vectors
// (warpgroup 0): thread 0 the two tiles through TMA, which arrive on bar
// with their 32 KB, threads 0..63 the vectors its kind reads (STATE: dt_j,
// cum_j; INTRA: cum_i, cum_j, dt_j; INTER: cum_i), which then arrive on
// bar as they land.
template <int PHASE>
static __device__ __forceinline__ void issue_tile(const ScArgs& a,
                                                  const ScMaps& maps,
                                                  const Cursor& cur,
                                                  float* raw, float* vec,
                                                  uint32_t bar) {
  const Item& m = cur.m;
  const int k = cur.k, u = threadIdx.x;
  float* As = raw;
  float* Bs = raw + SC_TILE;
  const float* cumb = a.cum + m.b * a.cums[0] + m.h * a.cums[1];
  const float* dtb = a.dt + m.b * a.dts[0] + m.h * a.dts[1];
  const Kind kind = kind_of<PHASE>(m, k);
  if (u == 0) {
    mbar_expect_tx(bar, 2 * SC_TILE * sizeof(float));
    if (kind == CB) {
      load_tile(As, &maps.cm, bar, k * SC_T, m.ti * SC_T, m.b, 0);
      load_tile(Bs, &maps.bm, bar, k * SC_T, m.tj * SC_T, m.b, 0);
    } else if (kind == STATE) {
      load_tile(As, &maps.x, bar, 0, k * SC_T, m.h, m.b);
      load_tile(Bs, &maps.bm, bar, m.n0, k * SC_T, m.b, 0);
    } else if (kind == INTRA) {
      load_tile(As, &maps.g, bar, 0, cb_index(a, m.b, m.ti, k) * SC_T, 0, 0);
      load_tile(Bs, &maps.x, bar, 0, k * SC_T, m.h, m.b);
    } else {
      const int n0 = (k - m.ti - 1) * SC_T;
      load_tile(As, &maps.cm, bar, n0, m.ti * SC_T, m.b, 0);
      load_tile(Bs, &maps.s, bar, n0, 0, m.h, m.b);
    }
  }
  if (u < SC_T) {
    if (kind == STATE) {
      const int j = k * SC_T + u;
      cp4(vec + u, j < a.Q ? dtb + j * a.dts[2] : dtb, j < a.Q);
      cp4(vec + SC_T + u, j < a.Q ? cumb + j * a.cums[2] : cumb, j < a.Q);
    } else if (kind == INTRA) {
      const int i = m.ti * SC_T + u, j = k * SC_T + u;
      cp4(vec + u, i < a.Q ? cumb + i * a.cums[2] : cumb, i < a.Q);
      cp4(vec + SC_T + u, j < a.Q ? cumb + j * a.cums[2] : cumb, j < a.Q);
      cp4(vec + 2 * SC_T + u, j < a.Q ? dtb + j * a.dts[2] : dtb, j < a.Q);
    } else if (kind == INTER) {
      const int i = m.ti * SC_T + u;
      cp4(vec + u, i < a.Q ? cumb + i * a.cums[2] : cumb, i < a.Q);
    }
    cp_arrive(bar);
  }
}

// Writes a landed k tile into a split buffer as the products read it.
template <int PHASE>
static __device__ __forceinline__ void stage_tile(const ScArgs& a,
                                                  const Cursor& cur,
                                                  const float* raw,
                                                  const float* vec,
                                                  float* split,
                                                  float cum_last) {
  const Item& m = cur.m;
  const int k = cur.k;
  const float* As = raw;
  const float* Bs = raw + SC_TILE;
  const float* v0 = vec;
  const float* v1 = v0 + SC_T;
  const float* v2 = v1 + SC_T;
  float* a_hi = split;
  float* a_lo = split + SC_TILE;
  float* b_hi = split + 2 * SC_TILE;
  float* b_lo = split + 3 * SC_TILE;
  const Kind kind = kind_of<PHASE>(m, k);
  if (kind == CB) {
    stage_rows(a_hi, a_lo, As, AsIs());
    stage_rows(b_hi, b_lo, Bs, AsIs());
  } else if (kind == STATE) {
    // x [j][p] -> A [p][j], times dt_j and the decay to the chunk's end
    // (rows past the chunk read dt 0)
    stage_cols(a_hi, a_lo, As, [&](int j) {
      return v0[j] != 0.f ? v0[j] * __expf(cum_last - v1[j]) : 0.f;
    });
    stage_cols(b_hi, b_lo, Bs, One());
  } else if (kind == INTRA) {
    // (C B^T) exp(cum_i - cum_j) dt_j for j <= i, masked before exp (a row
    // in the chunk sees only columns in it); x [j][p] -> B [p][j]
    const int diag = (m.ti - k) * SC_T, rows = a.Q - m.ti * SC_T;
    stage_rows(a_hi, a_lo, As, [&](int r, int c, float v) {
      return c <= r + diag && r < rows ? v * __expf(v0[r] - v1[c]) * v2[c]
                                       : 0.f;
    });
    stage_cols(b_hi, b_lo, Bs, One());
  } else {
    stage_rows(a_hi, a_lo, As,
               [&](int r, int, float v) { return v * __expf(v0[r]); });
    stage_rows(b_hi, b_lo, Bs, AsIs());
  }
  // the generic-proxy stores above, before the async-proxy reads of wgmma
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// exp(cum_last) S_prev at the S_new sums this thread of warpgroup 0 holds
// (0 for an item of another kind), loaded before its last products.
static __device__ __forceinline__ void state_carry(const ScArgs& a,
                                                   const Item& m,
                                                   float (&carry)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) carry[i] = 0.f;
  if (m.kind != STATE) return;
  const float* cumb = a.cum + m.b * a.cums[0] + m.h * a.cums[1];
  const float decay = expf(cumb[(int64_t)(a.Q - 1) * a.cums[2]]);
  const float* sb = a.s_prev + m.b * a.ss[0] + m.h * a.ss[1];
  int i = 0;
  each_sum(carry, [&](int p, int c, float) {
    const int n = m.n0 + c;
    carry[i++] = p < a.P && n < a.N ? sb[p * a.ss[2] + n] : 0.f;
  });
#pragma unroll
  for (int q = 0; q < 32; ++q) carry[q] *= decay;
}

// Writes an item's sums (warpgroup 0); carry: see state_carry.
template <int PHASE>
static __device__ __forceinline__ void finish(const ScArgs& a, const Item& m,
                                              const float (&acc)[32],
                                              const float (&carry)[32]) {
  if (PHASE == 1 && m.kind == CB) {
    float* out = a.g + (int64_t)cb_index(a, m.b, m.ti, m.tj) * SC_TILE;
    each_sum(acc, [&](int r, int c, float v) { out[r * SC_T + c] = v; });
  } else if (PHASE == 1) {
    float* so = a.s_new + ((int64_t)m.b * a.H + m.h) * a.P * a.N;
    int i = 0;
    each_sum(acc, [&](int p, int c, float v) {
      const int n = m.n0 + c;
      const float s = carry[i++] + v;
      if (p < a.P && n < a.N) so[(int64_t)p * a.N + n] = s;
    });
  } else {
    const int i0 = m.ti * SC_T;
    float* yb = a.y + m.b * a.ys[0] + m.h * a.ys[1];
    each_sum(acc, [&](int r, int p, float v) {
      if (i0 + r < a.Q && p < a.P) yb[(i0 + r) * a.ys[2] + p] = v;
    });
  }
}

// A phase: the block walks its items it = blockIdx.x, + gridDim.x, ...
// tile by tile, counting tiles on from t (across both phases, for the
// barriers' parities); returns the count after it.  Two roles hand three
// raw stages (index t % 3) and two split buffers (t % 2) round on
// mbarriers.  Warpgroup 0 waits on split_full, runs tile t's products on
// the tensor cores meanwhile the stagers stage tile t + 1, arrives on
// split_empty, writes an item's sums after its last tile, and starts the
// copies of tile t + 3 into raw stage t % 3 (the stagers have read it:
// raw_empty), which arrive on raw_full as they land.  Warpgroups 1 and 2
// wait on raw_full and split_empty (the products of tile t - 2 are done),
// stage tile t and arrive on split_full and raw_empty.
template <int PHASE>
static __device__ __forceinline__ int run_phase(const ScArgs& a,
                                                const ScMaps& maps,
                                                float* smem, uint32_t bars,
                                                int t) {
  const int n_items = phase_items<PHASE>(a);
  if ((int)blockIdx.x >= n_items) return t;
  float* const raw0 = smem;              // raw stage t % SC_RING
  float* const split0 = smem + SC_RING * SC_RAW;     // split buffer t % 2
  float* const vec0 = split0 + 2 * SC_SPLIT;         // vectors t % SC_RING
  // mbarriers, 8 bytes apart: two split_full, two split_empty, three
  // raw_full, three raw_empty
  const uint32_t split_full = bars, split_empty = bars + 16,
                 raw_full = bars + 32, raw_empty = bars + 56;
  Cursor cur;
  cur.it = blockIdx.x;
  cur.k = 0;
  cur.m = item_of<PHASE>(a, cur.it);
  if (threadIdx.x < 128) {
    // ---- warpgroup 0: copies and products -----------------------------------
    Cursor pre = cur;                    // the next tile to copy
    for (int u = 0; u < SC_RING && pre.it < n_items; ++u) {
      const int r = (t + u) % SC_RING;
      issue_tile<PHASE>(a, maps, pre, raw0 + r * SC_RAW, vec0 + r * SC_VEC,
                        raw_full + 8 * r);
      pre = advance<PHASE>(a, pre);
    }
    float acc[32], carry[32];            // carry: phase 1 only
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    for (; cur.it < n_items; ++t) {
      if (PHASE == 1 && cur.k == cur.m.nk - 1) state_carry(a, cur.m, carry);
      mbar_wait(split_full + 8 * (t & 1), (t >> 1) & 1);
      tile_products(acc, split0 + (t & 1) * SC_SPLIT);
      mbar_arrive(split_empty + 8 * (t & 1));
      if (cur.k == cur.m.nk - 1) {
        finish<PHASE>(a, cur.m, acc, carry);
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[i] = 0.f;
      }
      if (pre.it < n_items) {            // tile t + 3, into the stage of t
        const int r = t % SC_RING;
        mbar_wait(raw_empty + 8 * r, (t / SC_RING) & 1);
        issue_tile<PHASE>(a, maps, pre, raw0 + r * SC_RAW, vec0 + r * SC_VEC,
                          raw_full + 8 * r);
        pre = advance<PHASE>(a, pre);
      }
      cur = advance<PHASE>(a, cur);
    }
  } else {
    // ---- warpgroups 1 and 2: staging ----------------------------------------
    float cum_last = 0.f;
    for (; cur.it < n_items; ++t) {
      if (PHASE == 1 && cur.k == 0 && cur.m.kind == STATE)
        cum_last = a.cum[cur.m.b * a.cums[0] + cur.m.h * a.cums[1] +
                         (int64_t)(a.Q - 1) * a.cums[2]];
      const int r = t % SC_RING;
      mbar_wait(raw_full + 8 * r, (t / SC_RING) & 1);
      if (t >= 2)                        // the products of t - 2 are done
        mbar_wait(split_empty + 8 * (t & 1), ((t >> 1) + 1) & 1);
      stage_tile<PHASE>(a, cur, raw0 + r * SC_RAW, vec0 + r * SC_VEC,
                        split0 + (t & 1) * SC_SPLIT, cum_last);
      mbar_arrive(split_full + 8 * (t & 1));
      mbar_arrive(raw_empty + 8 * r);
      cur = advance<PHASE>(a, cur);
    }
  }
  return t;
}

__global__ void __launch_bounds__(SC_THREADS, 1)
sc_ssd_chunk_kernel(const __grid_constant__ ScMaps maps, const ScArgs a) {
  extern __shared__ __align__(1024) float smem[];
  if (smem_u32(smem) & 1023) __trap();   // the swizzled boxes need it
  const uint32_t bars =
      smem_u32(smem + SC_RING * SC_RAW + 2 * SC_SPLIT + SC_RING * SC_VEC);
  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(bars + 8 * s, SC_STAGERS);       // split_full: the stagers
      mbar_init(bars + 16 + 8 * s, 128);         // split_empty: warpgroup 0
    }
    for (int s = 0; s < SC_RING; ++s) {
      mbar_init(bars + 32 + 8 * s, 1 + SC_T);    // raw_full: TMA, vectors
      mbar_init(bars + 56 + 8 * s, SC_STAGERS);  // raw_empty: the stagers
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  int t = run_phase<1>(a, maps, smem, bars, 0);  // S_new, tiles of C B^T
  // the tiles of C B^T were stored by the generic proxy; phase 2 reads them
  // through TMA, the async proxy
  asm volatile("fence.proxy.async;\n" ::: "memory");
  __syncthreads();
  cg::this_grid().sync();
  run_phase<2>(a, maps, smem, bars, t);  // y
}

static const size_t SC_SMEM = sizeof(float) * SC_SMEM_FLOATS;

// Blocks of the kernel the card holds at once, found once per device (also
// opts in to the shared memory above 48 KB).
static int sc_resident_blocks(int* out) {
  static int cached[SC_MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= SC_MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!cached[dev]) {
    err = cudaFuncSetAttribute(sc_ssd_chunk_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)SC_SMEM);
    if (err != cudaSuccess) return (int)err;
    int n = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, sc_ssd_chunk_kernel, SC_THREADS, SC_SMEM);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    if (n < 1) return (int)cudaErrorInvalidConfiguration;
    cached[dev] = n * sms;
  }
  *out = cached[dev];
  return 0;
}

// A 4-D float32 map: sizes d (innermost first), element strides st of the
// three outer dimensions; boxes of 32 x 64 x 1 x 1, 128-byte swizzled.
static int sc_map(CUtensorMap* map, const void* ptr, const long long (&d)[4],
                  const long long (&st)[3]) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  const cuuint64_t dims[4] = {(cuuint64_t)d[0], (cuuint64_t)d[1],
                              (cuuint64_t)d[2], (cuuint64_t)d[3]};
  const cuuint64_t strides[3] = {(cuuint64_t)st[0] * 4, (cuuint64_t)st[1] * 4,
                                 (cuuint64_t)st[2] * 4};
  const cuuint32_t box[4] = {32, SC_T, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                        const_cast<void*>(ptr), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 10000 + (int)r;
}

// A 16-byte aligned start and strides that keep every row on 16 bytes.
static bool sc_aligned(const void* p, const long long* strides, int n) {
  if ((uintptr_t)p % 16) return false;
  for (int i = 0; i < n; ++i)
    if (strides[i] % 4) return false;
  return true;
}

extern "C" {

// Floats of the C B^T scratch buffer for a (B, Q) chunk.
long long sc_scratch_floats(int B, int Q) {
  const long long T = (Q + SC_T - 1) / SC_T;
  return (long long)B * (T * (T + 1) / 2) * SC_T * SC_T;
}

// strides: 19 element strides, in order x (b, h, q), dt (b, h, q), bm (b, q),
// cm (b, q), cum (b, h, q), s_prev (b, h, p), y (b, h, q).
int sc_ssd_chunk(const void* x, const void* dt, const void* bm, const void* cm,
                 const void* cum, const void* s_prev, void* y, void* s_new,
                 void* scratch, int B, int H, int Q, int P, int N,
                 const long long* strides, void* stream) {
  if (B < 0 || H < 0 || Q < 1 || P < 1 || P > SC_PMAX || N < 1 ||
      N > SC_NMAX || strides == nullptr)
    return (int)cudaErrorInvalidValue;
  const long long* s = strides;
  if (!sc_aligned(x, s, 3) || !sc_aligned(bm, s + 6, 2) ||
      !sc_aligned(cm, s + 8, 2) || !sc_aligned(s_prev, s + 13, 3) ||
      !sc_aligned(scratch, s, 0))
    return (int)cudaErrorInvalidValue;
  if ((int64_t)B * H == 0) return (int)cudaGetLastError();
  const int T = (Q + SC_T - 1) / SC_T;
  if ((int64_t)B * H * T * 2 > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  ScArgs a;
  a.x = (const float*)x; a.dt = (const float*)dt; a.bm = (const float*)bm;
  a.cm = (const float*)cm; a.cum = (const float*)cum;
  a.s_prev = (const float*)s_prev; a.y = (float*)y; a.s_new = (float*)s_new;
  a.g = (float*)scratch;
  a.B = B; a.H = H; a.Q = Q; a.P = P; a.N = N; a.T = T;
  for (int i = 0; i < 3; ++i) a.xs[i] = *s++;
  for (int i = 0; i < 3; ++i) a.dts[i] = *s++;
  for (int i = 0; i < 2; ++i) a.bms[i] = *s++;
  for (int i = 0; i < 2; ++i) a.cms[i] = *s++;
  for (int i = 0; i < 3; ++i) a.cums[i] = *s++;
  for (int i = 0; i < 3; ++i) a.ss[i] = *s++;
  for (int i = 0; i < 3; ++i) a.ys[i] = *s++;
  int resident = 0;
  int err = sc_resident_blocks(&resident);
  if (err != 0) return err;
  ScMaps maps;
  const long long tiles = sc_scratch_floats(B, Q) / (SC_T * SC_T);
  if ((err = sc_map(&maps.x, x, {P, Q, H, B}, {a.xs[2], a.xs[1], a.xs[0]})) ||
      (err = sc_map(&maps.bm, bm, {N, Q, B, 1},
                    {a.bms[1], a.bms[0], a.bms[0] * B})) ||
      (err = sc_map(&maps.cm, cm, {N, Q, B, 1},
                    {a.cms[1], a.cms[0], a.cms[0] * B})) ||
      (err = sc_map(&maps.s, s_prev, {N, P, H, B},
                    {a.ss[2], a.ss[1], a.ss[0]})) ||
      (err = sc_map(&maps.g, scratch, {SC_T, SC_T * tiles, 1, 1},
                    {SC_T, SC_T * SC_T * tiles, SC_T * SC_T * tiles})))
    return err;
  const int n_cols = (N + SC_T - 1) / SC_T;
  const int items1 = B * H * n_cols + B * T * (T + 1) / 2;
  const int items2 = B * H * T;
  const int items = items1 > items2 ? items1 : items2;
  void* params[] = {&maps, &a};
  return (int)cudaLaunchCooperativeKernel(
      (const void*)sc_ssd_chunk_kernel,
      dim3(resident < items ? resident : items), dim3(SC_THREADS), params,
      SC_SMEM, (cudaStream_t)stream);
}

// Registers a thread, dynamic shared memory (bytes) and blocks resident on
// one SM, as the runtime reports them for the launch above.
int sc_kernel_info(int* registers, int* shared_bytes, int* blocks_per_sm) {
  int resident = 0, sms = 0, dev = 0;
  const int err = sc_resident_blocks(&resident);
  if (err != 0) return err;
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, sc_ssd_chunk_kernel);
  if (e != cudaSuccess) return (int)e;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  *registers = attr.numRegs;
  *shared_bytes = (int)SC_SMEM;
  *blocks_per_sm = resident / sms;
  return 0;
}

}  // extern "C"
