// Flash attention (online softmax over key tiles) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel flash_attention of the JAX package
// (src/repro/kernels/flash_attention.py:79, pallas_call :100, body
// _flash_kernel :34) and the GQA fold of its wrapper ops.mha
// (src/repro/kernels/ops.py:26).  For every (batch b, head h) and query row i:
//
//   s[i, j] = (float(q[i]) * scale) . float(k[j])                 float32
//   keep    = j < kv_len  &&  (causal: j <= i)  &&  (window > 0: i - j < window)
//   s       = keep ? s : -1e30          (NEG_INF, never -inf: exp(m - m) is 0)
//   o[i]    = sum_j exp(s - m) v[j] / max(sum_j exp(s - m), 1e-30)
//
// with the running max m, the running sum l and a float32 accumulator carried
// across the key tiles, as _flash_kernel carries them across its k grid axis.
// Positions count from 0 for q and k alike (the TPU kernel has no q offset).
//
// Layouts: q (B, Sq, H, D), k and v (B, Sk, Hkv, D), each read through its
// element strides (batch, row, head; the last dimension is contiguous), so
// the model's (B, S, H, D) tensors and the (BH, S, D) form of the JAX
// function (H = Hkv = 1) need no copy.  The kv head of query head h is
// h / (H / Hkv): k and v are never repeated.  o is (B, Sq, H, D),
// contiguous.  One dtype for q, k, v and o.
//
// Bound.  At qwen2-7b's prefill (B 4, H 28, S 2048, D 128, causal) the
// useful work is 4 D per unmasked (i, j) pair, 1.2e11 FLOP a call, against
// 59 MB of q, k, v and o: 0.12 ms at the card's 989 TFLOP/s of dense bf16
// tensor-core math, 0.018 ms at 3.35 TB/s -- bound by operations, so both
// products belong on the tensor cores.
//
// Two kernels:
//
// * bfloat16, every shape the models run (fa_hopper, below): both products
//   on the tensor cores with wgmma, tiles brought in by TMA behind
//   mbarriers, one producer warpgroup and two consumer warpgroups.  It takes
//   D a multiple of 16 (at most 256), a 16-byte aligned base and strides
//   that are multiples of 8 elements (what TMA reads); the wrapper makes an
//   aligned, zero-padded copy of an input that is not.
// * float32 (fa_kernel): wgmma has no float32 mode, and TF32 (10 mantissa
//   bits) would break the float32 bound of 2e-5, so float32 keeps the SIMT
//   kernel: float32 FMA from shared memory, any D <= 256, any strides.  No
//   model runs attention in float32; the tests and the smoke run hold it to
//   its plain version.
//
// Beside them, fa_blind_rows fills the rows that see no key (below); no
// model's call has one.
//
// The entry points launch on the given stream, allocate nothing, do not
// synchronize, and return cudaGetLastError() (cudaErrorInvalidValue for
// arguments it does not take, 10000 + the CUresult when a tensor map cannot
// be encoded).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

// ===========================================================================
// float32: the SIMT kernel.  One block of 256 threads (16 x 16) per (b, h,
// tile of 64 query rows); the grid walks a (b, h)'s tiles from the last (the
// most keys under a causal mask) to the first.  The block keeps q * scale
// transposed in shared memory and walks only the key tiles that hold an
// unmasked key.  Per key tile: K (transposed) into shared memory, the 64 x 64
// score tile in registers (4 x 4 a thread), mask, row max and row sum by
// shuffles within the 16 threads of a row, rescale of the accumulator, P
// (transposed) and then V into shared memory (V takes K's place), and P V
// into the accumulator (4 rows x DC columns a thread, columns tx + 16 c).
// Loads are zero-filled past the ends, so a padded row or key never brings
// NaN into a sum.
// ===========================================================================

#define FA_T 64            // query rows and keys of a tile
#define FA_LD (FA_T + 4)   // leading dimension of the transposed tiles
#define FA_THREADS 256
#define FA_DMAX 256
#define FA_NEG_INF (-1e30f)
#define FA_MAX_DEVICES 64

struct FaArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int H, Hkv, Sq, Sk, D;
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh;   // element strides
  int causal, window, kv_len;
  float scale;
};

static __device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

static __device__ __forceinline__ float to_f(float x) { return x; }
template <typename T> static __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}

// floats of shared memory for head size D and DC columns a thread
static __host__ __device__ size_t fa_smem_floats(int D, int DC) {
  const size_t kt = (size_t)D * FA_LD, vt = (size_t)FA_T * 16 * DC;
  return (size_t)D * FA_LD + (kt > vt ? kt : vt) + (size_t)FA_T * FA_LD;
}

template <typename T, int DC>
__global__ void __launch_bounds__(FA_THREADS)
fa_kernel(const FaArgs a) {
  constexpr int DV = 16 * DC;          // width of the V tile (D, padded)
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int D = a.D;
  float* Qt = smem;                    // [D][FA_LD]: q * scale, transposed
  float* KV = Qt + D * FA_LD;          // [D][FA_LD] K^T, then [FA_T][DV] V
  const int kv_floats = D * FA_LD > FA_T * DV ? D * FA_LD : FA_T * DV;
  float* Pt = KV + kv_floats;          // [FA_T][FA_LD]: P^T

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int nq = (a.Sq + FA_T - 1) / FA_T;
  int64_t id = blockIdx.x;
  const int qt = nq - 1 - (int)(id % nq);
  id /= nq;
  const int h = (int)(id % a.H);
  const int64_t b = id / a.H;
  const int hk = h / (a.H / a.Hkv);
  const int i0 = qt * FA_T;

  const T* qp = static_cast<const T*>(a.q) + b * a.qb + (int64_t)h * a.qh;
  const T* kp = static_cast<const T*>(a.k) + b * a.kb + (int64_t)hk * a.kh;
  const T* vp = static_cast<const T*>(a.v) + b * a.vb + (int64_t)hk * a.vh;

  for (int e = tid; e < FA_T * DV; e += FA_THREADS) {
    const int i = e / DV, d = e % DV, gi = i0 + i;
    if (d < D)
      Qt[d * FA_LD + i] =
          gi < a.Sq ? to_f(qp[(int64_t)gi * a.qs + d]) * a.scale : 0.f;
  }

  // the key tiles that hold an unmasked key for some row of this tile
  const int kv_eff = a.kv_len < a.Sk ? a.kv_len : a.Sk;
  const int i_last = (i0 + FA_T < a.Sq ? i0 + FA_T : a.Sq) - 1;
  int k_end = kv_eff;
  if (a.causal && i_last + 1 < k_end) k_end = i_last + 1;
  int k_begin = 0;
  if (a.window > 0 && i0 - a.window + 1 > 0) k_begin = i0 - a.window + 1;

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = FA_NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[r][c] = 0.f;
  }

  for (int j0 = k_begin; j0 < k_end; j0 += FA_T) {
    __syncthreads();                   // the last tile's reads of V, P done
    float* Kt = KV;
    for (int e = tid; e < FA_T * DV; e += FA_THREADS) {
      const int j = e / DV, d = e % DV, gj = j0 + j;
      if (d < D)
        Kt[d * FA_LD + j] = gj < k_end ? to_f(kp[(int64_t)gj * a.ks + d]) : 0.f;
    }
    __syncthreads();

    // scores: rows ty*4 + r, keys tx*4 + c
    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 qa = ld4(Qt + d * FA_LD + ty * 4);
      const float4 kb = ld4(Kt + d * FA_LD + tx * 4);
      const float qr[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kc[4] = {kb.x, kb.y, kb.z, kb.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = fmaf(qr[r], kc[c], s[r][c]);
    }

    // mask, then the online softmax of each row across its 16 threads
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int gi = i0 + ty * 4 + r;
      float mx = FA_NEG_INF;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int gj = j0 + tx * 4 + c;
        bool keep = gj < kv_eff;
        if (a.causal) keep = keep && gj <= gi;
        if (a.window > 0) keep = keep && gi - gj < a.window;
        s[r][c] = keep ? s[r][c] : FA_NEG_INF;
        mx = fmaxf(mx, s[r][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float corr = expf(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = expf(s[r][c] - m_new);
        sum += s[r][c];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[r] = l[r] * corr + sum;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[r][c] *= corr;
    }
    __syncthreads();                   // every read of K^T is done

    float* Vs = KV;
    for (int e = tid; e < FA_T * DV; e += FA_THREADS) {
      const int j = e / DV, d = e % DV, gj = j0 + j;
      Vs[e] = (gj < k_end && d < D) ? to_f(vp[(int64_t)gj * a.vs + d]) : 0.f;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<float4*>(Pt + (tx * 4 + c) * FA_LD + ty * 4) =
          make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
    __syncthreads();

    // acc += P V: rows ty*4 + r, columns tx + 16 c
    const int jn = k_end - j0 < FA_T ? k_end - j0 : FA_T;
    for (int j = 0; j < jn; ++j) {
      const float4 pa = ld4(Pt + j * FA_LD + ty * 4);
      const float pr[4] = {pa.x, pa.y, pa.z, pa.w};
      const float* vrow = Vs + j * DV + tx;
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float vv = vrow[16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[r][c] = fmaf(pr[r], vv, acc[r][c]);
      }
    }
  }

  T* op = static_cast<T*>(a.o) + (b * a.Sq * a.H + h) * (int64_t)D;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int gi = i0 + ty * 4 + r;
    if (gi >= a.Sq) continue;
    const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = tx + 16 * c;
      if (d < D) op[(int64_t)gi * a.H * D + d] = from_f<T>(acc[r][c] / den);
    }
  }
}

template <typename T, int DC>
static int fa_launch(const FaArgs& a, int64_t blocks, cudaStream_t stream) {
  // The opt-in above 48 KB is set once per device and instantiation, for the
  // largest head size the instantiation takes, not on every launch.
  static bool opted_in[FA_MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= FA_MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!opted_in[dev]) {
    err = cudaFuncSetAttribute(
        fa_kernel<T, DC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(sizeof(float) * fa_smem_floats(16 * DC, DC)));
    if (err != cudaSuccess) return (int)err;
    opted_in[dev] = true;
  }
  const size_t smem = sizeof(float) * fa_smem_floats(a.D, DC);
  fa_kernel<T, DC><<<(unsigned)blocks, FA_THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
static int fa_dispatch(const FaArgs& a, int64_t blocks, cudaStream_t stream) {
  const int dc = (a.D + 15) / 16;
  if (dc <= 2) return fa_launch<T, 2>(a, blocks, stream);
  if (dc <= 4) return fa_launch<T, 4>(a, blocks, stream);
  if (dc <= 5) return fa_launch<T, 5>(a, blocks, stream);
  if (dc <= 8) return fa_launch<T, 8>(a, blocks, stream);
  return fa_launch<T, 16>(a, blocks, stream);
}

// ===========================================================================
// bfloat16: the Hopper kernel.
//
// One block per (b, h, tile of 128 query rows), 384 threads in three
// warpgroups.  Warpgroups 0 and 1 consume, 64 query rows each (the M of
// wgmma); warpgroup 2 produces: one of its threads issues every TMA load,
// and the warpgroup hands its registers to the consumers (setmaxnreg 24 and
// 240).  As in the SIMT kernel, the grid walks a (b, h)'s query tiles from
// the last to the first, and a block walks only the key tiles that hold a
// key some row of it may see: from the window's start (aligned down to the
// key tile) to the causal diagonal or kv_len -- a sliding-window layer costs
// its window, not the sequence.
//
// Shared memory holds bf16 tiles as TMA writes them, 128-byte swizzled, in
// boxes of 64 columns: Q (128 rows) once, and a ring of two stages of K and
// V (BN keys each; BN 128 for D <= 128, 64 above, so that D 256 needs
// 64 + 4 x 32 KB = 192 KB, one block an SM).  K and V of a stage have a full barrier each
// (one arrival and the bytes of the loads) and share an empty barrier that
// every consumer warp arrives on once its last wgmma reading the stage has
// finished (wgmma.wait_group 0).  TMA zero-fills the rows of a tile past
// Sq or Sk and the columns of a box past D.
//
// Per key tile, in each consumer warpgroup:
//   S = Q K^T      wgmma m64nBNk16, Q and K from shared memory (both
//                  K-major), float32 sums, over D in steps of 16;
//   S *= scale * log2(e); the mask only on tiles that cross the diagonal,
//                  the window's edge, kv_len or the end of the keys;
//   online softmax in registers: a thread holds two rows (r and r + 8), each
//                  spread over the four threads of a quad, so the row max
//                  takes two shuffles (xor 1, 2); the row sum stays a
//                  partial sum per thread until the end;
//   O += P V       P rounded to bf16 in registers (the accumulator layout
//                  of S is the A-operand layout of P), V from shared memory
//                  transposed (it is stored keys-major), one wgmma per box
//                  of 64 columns (N 64, or 16..48 for the last box) and 16
//                  keys, float32 in registers (D / 2 a thread).
// At the end O / max(l, 1e-30) is rounded to bf16 (nearest even) and stored.
// The two consumer warpgroups run the same schedule unsynchronised, so one
// warpgroup's softmax overlaps the other's products; inside a warpgroup the
// steps run in turn (issuing the next S before the softmax made ptxas
// serialise the wgmma, C7520, and was slower).
// ===========================================================================

#define FH_ROWS 128
#define FH_THREADS 384
#define FH_STAGES 2
#define FH_CONSUMER_REGS 240
#define FH_PRODUCER_REGS 24

struct FhArgs {
  void* o;
  int H, Hkv, Sq, Sk, D;
  int causal, window, kv_len;
  float scale_log2;              // scale * log2(e)
};

// byte offsets in shared memory (from a 1024-byte aligned base)
template <int DC, int BN>
struct FhSmem {
  static constexpr uint32_t box_q = FH_ROWS * 128;   // one 64-column box
  static constexpr uint32_t box_kv = BN * 128;
  static constexpr uint32_t q_bytes = DC * box_q;
  static constexpr uint32_t kv_bytes = DC * box_kv;  // one K or V tile
  static constexpr uint32_t k_off = q_bytes;         // + stage * kv_bytes
  static constexpr uint32_t v_off = k_off + FH_STAGES * kv_bytes;
  static constexpr uint32_t bar_off = v_off + FH_STAGES * kv_bytes;
  // q_full, k_full[stages], v_full[stages], empty[stages]
  static constexpr uint32_t bytes = bar_off + 8 * (1 + 3 * FH_STAGES) + 1024;
};

static __device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

static __device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // nearest even
  return *reinterpret_cast<uint32_t*>(&v);
}

// The products are issued as straight runs of wgmma with widths known at
// compile time: a branch between two wgmma makes ptxas wait for the first
// before it issues the second.  NL is the number of 16-column pieces of the
// last 64-column box (D = 64 (DC - 1) + 16 NL).

// S = Q K^T over D: 4 k steps of 16 in every box but the last, NL in it
template <int DC, int BN, int NL>
static __device__ __forceinline__ void wgmma_qk(float (&s)[BN / 2],
                                                uint32_t q, uint32_t k) {
#pragma unroll
  for (int c = 0; c < DC; ++c)
#pragma unroll
    for (int u = 0; u < (c < DC - 1 ? 4 : NL); ++u) {
      const uint64_t da = sw128_desc(q + c * FH_ROWS * 128 + u * 32, 0);
      const uint64_t db = sw128_desc(k + c * BN * 128 + u * 32, 0);
      if constexpr (BN == 128)
        wgmma_ss_n128(s, da, db, c + u > 0);
      else
        wgmma_ss_n64(s, da, db, c + u > 0);
    }
}

template <int N>
static __device__ __forceinline__ void wgmma_rs(float (&o)[32],
                                                const uint32_t (&p)[4],
                                                uint64_t db) {
  if constexpr (N == 64)
    wgmma_rs_n64(o, p, db);
  else if constexpr (N == 48)
    wgmma_rs_n48(o, p, db);
  else if constexpr (N == 32)
    wgmma_rs_n32(o, p, db);
  else
    wgmma_rs_n16(o, p, db);
}

// O += P V: per 16 keys, one wgmma per box of 64 columns (16 NL in the last)
template <int DC, int BN, int NL>
static __device__ __forceinline__ void wgmma_pv(float (&o)[DC][32],
                                                const uint32_t (&p)[BN / 16][4],
                                                uint32_t v) {
#pragma unroll
  for (int u = 0; u < BN / 16; ++u)
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const uint64_t db = sw128_desc(v + c * BN * 128 + u * 16 * 128,
                                     BN * 128);
      if (c < DC - 1)
        wgmma_rs<64>(o[c], p[u], db);
      else
        wgmma_rs<16 * NL>(o[c], p[u], db);
    }
}

template <int DC, int BN>
__global__ void __launch_bounds__(FH_THREADS, 1)
fa_hopper(const __grid_constant__ CUtensorMap tq,
          const __grid_constant__ CUtensorMap tk,
          const __grid_constant__ CUtensorMap tv, const FhArgs a) {
  using L = FhSmem<DC, BN>;
  extern __shared__ __align__(1024) unsigned char fh_smem[];
  const uint32_t base = (smem_u32(fh_smem) + 1023u) & ~1023u;
  const uint32_t sQ = base, sK = base + L::k_off, sV = base + L::v_off;
  const uint32_t q_full = base + L::bar_off;
  const uint32_t k_full = q_full + 8;                   // + 8 * stage
  const uint32_t v_full = k_full + 8 * FH_STAGES;
  const uint32_t empty = v_full + 8 * FH_STAGES;

  const int tid = threadIdx.x;
  const int nq = (a.Sq + FH_ROWS - 1) / FH_ROWS;
  int64_t id = blockIdx.x;
  const int qt = nq - 1 - (int)(id % nq);
  id /= nq;
  const int h = (int)(id % a.H);
  const int b = (int)(id / a.H);
  const int hk = h / (a.H / a.Hkv);
  const int i0 = qt * FH_ROWS;

  // the key tiles that hold an unmasked key for some row of this block
  const int kv_eff = a.kv_len < a.Sk ? a.kv_len : a.Sk;
  const int i_last = (i0 + FH_ROWS < a.Sq ? i0 + FH_ROWS : a.Sq) - 1;
  int k_end = kv_eff;
  if (a.causal && i_last + 1 < k_end) k_end = i_last + 1;
  int k_begin = 0;
  if (a.window > 0 && i0 - a.window + 1 > 0) k_begin = i0 - a.window + 1;
  const int t_begin = k_begin / BN;
  const int n_tiles = (k_end + BN - 1) / BN - t_begin;

  if (tid == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < FH_STAGES; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);     // the eight consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {
    // ---- producer ----------------------------------------------------------
    regs_dealloc<FH_PRODUCER_REGS>();
    if (tid == 256) {
      mbar_expect_tx(q_full, L::q_bytes);
#pragma unroll
      for (int c = 0; c < DC; ++c)
        tma_load_4d(sQ + c * L::box_q, &tq, q_full, 64 * c, h, i0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % FH_STAGES;
        const uint32_t phase = (uint32_t)(t / FH_STAGES) & 1u;
        const int j0 = (t_begin + t) * BN;
        mbar_wait(empty + 8 * s, phase ^ 1u);   // the first round passes
        mbar_expect_tx(k_full + 8 * s, L::kv_bytes);
#pragma unroll
        for (int c = 0; c < DC; ++c)
          tma_load_4d(sK + s * L::kv_bytes + c * L::box_kv, &tk,
                      k_full + 8 * s, 64 * c, hk, j0, b);
        mbar_expect_tx(v_full + 8 * s, L::kv_bytes);
#pragma unroll
        for (int c = 0; c < DC; ++c)
          tma_load_4d(sV + s * L::kv_bytes + c * L::box_kv, &tv,
                      v_full + 8 * s, 64 * c, hk, j0, b);
      }
    }
  } else {
    // ---- consumers ---------------------------------------------------------
    regs_alloc<FH_CONSUMER_REGS>();
    const int wg = tid >> 7, lane = tid & 31;
    const int r0 = i0 + 64 * wg;                         // first row of wg
    const int rowA = r0 + 16 * ((tid >> 5) & 3) + (lane >> 2);
    const int rowB = rowA + 8;
    const int cq = 2 * (lane & 3);                       // column in an 8
    // the keys this warpgroup's rows may see
    int ke = kv_eff;
    if (a.causal) {
      const int last = (r0 + 63 < a.Sq ? r0 + 63 : a.Sq - 1);
      if (last + 1 < ke) ke = last + 1;
    }
    int kb = 0;
    if (a.window > 0 && r0 - a.window + 1 > 0) kb = r0 - a.window + 1;
    const bool has_rows = r0 < a.Sq;
    const int nl = (a.D - 64 * (DC - 1)) / 16;   // pieces of the last box

    float o[DC][32];
#pragma unroll
    for (int c = 0; c < DC; ++c)
#pragma unroll
      for (int e = 0; e < 32; ++e) o[c][e] = 0.f;
    float s[BN / 2];
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) s[e] = 0.f;
    float mA = FA_NEG_INF, mB = FA_NEG_INF, lA = 0.f, lB = 0.f;
    const uint32_t qa = sQ + wg * 64 * 128;

    mbar_wait(q_full, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int st = t % FH_STAGES;
      const uint32_t phase = (uint32_t)(t / FH_STAGES) & 1u;
      const int j0 = (t_begin + t) * BN;
      const bool active = has_rows && j0 < ke && j0 + BN > kb;
      uint32_t p[BN / 16][4];

      mbar_wait(k_full + 8 * st, phase);
      if (active) {
        const uint32_t kt = sK + st * L::kv_bytes;
        fence_regs(s);
        wgmma_fence();
        if (nl == 4)
          wgmma_qk<DC, BN, 4>(s, qa, kt);
        else if (nl == 3)
          wgmma_qk<DC, BN, 3>(s, qa, kt);
        else if (nl == 2)
          wgmma_qk<DC, BN, 2>(s, qa, kt);
        else
          wgmma_qk<DC, BN, 1>(s, qa, kt);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);

        // scale, mask where a key of the tile may be hidden, row max
        const bool open = j0 + BN <= kv_eff &&
                          (!a.causal || j0 + BN - 1 <= r0) &&
                          (a.window == 0 || r0 + 63 - j0 < a.window);
        const float sl = a.scale_log2;
#pragma unroll
        for (int e = 0; e < BN / 2; ++e) s[e] *= sl;
        if (!open) {
#pragma unroll
          for (int j = 0; j < BN / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int key = j0 + 8 * j + cq + e;
              bool kx = key < kv_eff, ky = kx;
              if (a.causal) {
                kx = kx && key <= rowA;
                ky = ky && key <= rowB;
              }
              if (a.window > 0) {
                kx = kx && rowA - key < a.window;
                ky = ky && rowB - key < a.window;
              }
              if (!kx) s[4 * j + e] = FA_NEG_INF;
              if (!ky) s[4 * j + 2 + e] = FA_NEG_INF;
            }
        }
        float mxA = FA_NEG_INF, mxB = FA_NEG_INF;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            mxA = fmaxf(mxA, s[4 * j + e]);
            mxB = fmaxf(mxB, s[4 * j + 2 + e]);
          }
        mxA = fmaxf(mxA, __shfl_xor_sync(0xffffffffu, mxA, 1));
        mxA = fmaxf(mxA, __shfl_xor_sync(0xffffffffu, mxA, 2));
        mxB = fmaxf(mxB, __shfl_xor_sync(0xffffffffu, mxB, 1));
        mxB = fmaxf(mxB, __shfl_xor_sync(0xffffffffu, mxB, 2));
        const float nA = fmaxf(mA, mxA), nB = fmaxf(mB, mxB);
        const float cA = ex2(mA - nA), cB = ex2(mB - nB);
        mA = nA;
        mB = nB;
        float sumA = 0.f, sumB = 0.f;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            s[4 * j + e] = ex2(s[4 * j + e] - nA);
            s[4 * j + 2 + e] = ex2(s[4 * j + 2 + e] - nB);
            sumA += s[4 * j + e];
            sumB += s[4 * j + 2 + e];
          }
        }
        lA = lA * cA + sumA;
        lB = lB * cB + sumB;
#pragma unroll
        for (int c = 0; c < DC; ++c)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            o[c][4 * j] *= cA;
            o[c][4 * j + 1] *= cA;
            o[c][4 * j + 2] *= cB;
            o[c][4 * j + 3] *= cB;
          }
        // P in the A-operand layout: 16 keys = S's 8-column blocks 2u, 2u+1
#pragma unroll
        for (int u = 0; u < BN / 16; ++u) {
          p[u][0] = pack_bf16(s[8 * u], s[8 * u + 1]);
          p[u][1] = pack_bf16(s[8 * u + 2], s[8 * u + 3]);
          p[u][2] = pack_bf16(s[8 * u + 4], s[8 * u + 5]);
          p[u][3] = pack_bf16(s[8 * u + 6], s[8 * u + 7]);
        }
      }

      mbar_wait(v_full + 8 * st, phase);
      if (active) {
        const uint32_t vt = sV + st * L::kv_bytes;
#pragma unroll
        for (int c = 0; c < DC; ++c) fence_regs(o[c]);
        wgmma_fence();
        if (nl == 4)
          wgmma_pv<DC, BN, 4>(o, p, vt);
        else if (nl == 3)
          wgmma_pv<DC, BN, 3>(o, p, vt);
        else if (nl == 2)
          wgmma_pv<DC, BN, 2>(o, p, vt);
        else
          wgmma_pv<DC, BN, 1>(o, p, vt);
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int c = 0; c < DC; ++c) fence_regs(o[c]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * st);   // this warp is done
    }

    if (has_rows) {
      lA += __shfl_xor_sync(0xffffffffu, lA, 1);
      lA += __shfl_xor_sync(0xffffffffu, lA, 2);
      lB += __shfl_xor_sync(0xffffffffu, lB, 1);
      lB += __shfl_xor_sync(0xffffffffu, lB, 2);
      const float dA = fmaxf(lA, 1e-30f), dB = fmaxf(lB, 1e-30f);
      __nv_bfloat16* op = static_cast<__nv_bfloat16*>(a.o) +
                          ((int64_t)b * a.Sq * a.H + h) * (int64_t)a.D;
      const int64_t rs = (int64_t)a.H * a.D;
#pragma unroll
      for (int c = 0; c < DC; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = 64 * c + 8 * j + cq;
          if (col >= a.D) continue;
          if (rowA < a.Sq)
            *reinterpret_cast<uint32_t*>(op + rowA * rs + col) =
                pack_bf16(o[c][4 * j] / dA, o[c][4 * j + 1] / dA);
          if (rowB < a.Sq)
            *reinterpret_cast<uint32_t*>(op + rowB * rs + col) =
                pack_bf16(o[c][4 * j + 2] / dB, o[c][4 * j + 3] / dB);
        }
    }
  }
}

// ---- host side -------------------------------------------------------------

// A 4-D map over a bf16 (B, S, heads, D) tensor with element strides sb,
// ss, sh (innermost first for TMA: D, heads, S, B), boxes of 64 columns x
// one head x `rows` rows x one batch row, 128-byte swizzled.
static int fh_map(CUtensorMap* map, const void* ptr, int D, int heads, int S,
                  int B, long long sh, long long ss, long long sb, int rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 10000 + (int)r;
}

template <int DC, int BN>
static int fh_opt_in() {
  // The opt-in to dynamic shared memory above 48 KB, once per device.
  static bool opted_in[FA_MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= FA_MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!opted_in[dev]) {
    err = cudaFuncSetAttribute(fa_hopper<DC, BN>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)FhSmem<DC, BN>::bytes);
    if (err != cudaSuccess) return (int)err;
    opted_in[dev] = true;
  }
  return 0;
}

template <int DC, int BN>
static int fh_launch(const void* q, const void* k, const void* v,
                     const FhArgs& a, int B, long long qb, long long qs,
                     long long qh, long long kb, long long ks, long long kh,
                     long long vb, long long vs, long long vh, int64_t blocks,
                     cudaStream_t stream) {
  int err = fh_opt_in<DC, BN>();
  if (err) return err;
  CUtensorMap tq, tk, tv;
  if ((err = fh_map(&tq, q, a.D, a.H, a.Sq, B, qh, qs, qb, FH_ROWS))) return err;
  if ((err = fh_map(&tk, k, a.D, a.Hkv, a.Sk, B, kh, ks, kb, BN))) return err;
  if ((err = fh_map(&tv, v, a.D, a.Hkv, a.Sk, B, vh, vs, vb, BN))) return err;
  fa_hopper<DC, BN><<<(unsigned)blocks, FH_THREADS, FhSmem<DC, BN>::bytes,
                      stream>>>(tq, tk, tv, a);
  return (int)cudaGetLastError();
}

// registers a thread at launch, dynamic shared memory and resident blocks
// per SM of the instantiation that takes head size D
template <int DC, int BN>
static int fh_info(int* regs, int* smem, int* blocks_per_sm) {
  int err = fh_opt_in<DC, BN>();
  if (err) return err;
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, fa_hopper<DC, BN>);
  if (e != cudaSuccess) return (int)e;
  *regs = attr.numRegs;
  *smem = (int)FhSmem<DC, BN>::bytes;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, fa_hopper<DC, BN>, FH_THREADS, FhSmem<DC, BN>::bytes);
  return (int)e;
}

// ===========================================================================
// Rows that see no key (kv_len < 1, or a window with Sq > kv_len + window -
// 1).  The JAX oracle masks every score of such a row to -1e30, so its
// softmax weighs all Sk keys alike and the row is the mean of v over all Sk
// rows, in float32, cast to the output's type.  The wrapper finds the first
// such row from (Sq, Sk, kv_len, window) -- they are the last rows -- and
// launches this kernel only when there is one; the attention kernels leave
// those rows at zero (no key tile holds a key they may see) or, for kv_len <
// 1, are not launched.  No model's call has such a row.  One block a
// (batch, head), a thread a column, the sum over the keys in order; bound
// by the Sk x D elements of v it reads, a few microseconds at any size the
// models use.
// ===========================================================================

static __device__ __forceinline__ float fb_f(float x) { return x; }
static __device__ __forceinline__ float fb_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> static __device__ __forceinline__ T fb_to(float x);
template <> __device__ __forceinline__ float fb_to<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 fb_to<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(128)
fa_blind_rows_kernel(const T* __restrict__ v, T* __restrict__ o, int H,
                     int Hkv, int Sq, int Sk, int D, long long vb,
                     long long vs, long long vh, int row0) {
  const int h = blockIdx.x % H, b = blockIdx.x / H;
  const T* vp = v + b * vb + (long long)(h / (H / Hkv)) * vh;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float sum = 0.f;
    for (int j = 0; j < Sk; ++j) sum += fb_f(vp[(long long)j * vs + d]);
    const T mean = fb_to<T>(sum / (float)Sk);
    T* op = o + ((long long)b * Sq * H + h) * D + d;
    for (int i = row0; i < Sq; ++i) op[(long long)i * H * D] = mean;
  }
}

extern "C" {

// dtype: 0 float32, 1 bfloat16.  Strides in elements.
int fa_flash_attention(const void* q, const void* k, const void* v, void* o,
                       int B, int H, int Hkv, int Sq, int Sk, int D,
                       long long qb, long long qs, long long qh, long long kb,
                       long long ks, long long kh, long long vb, long long vs,
                       long long vh, int causal, int window, int kv_len,
                       float scale, int dtype, void* stream) {
  if (B < 1 || H < 1 || Hkv < 1 || H % Hkv != 0 || Sq < 1 || Sk < 1 ||
      D < 1 || D > FA_DMAX || window < 0 || kv_len < 1 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1) {
    // what TMA reads: 16-byte aligned bases and strides, D a multiple of 16
    const long long strides[9] = {qb, qs, qh, kb, ks, kh, vb, vs, vh};
    bool ok = D % 16 == 0 && (uintptr_t)q % 16 == 0 &&
              (uintptr_t)k % 16 == 0 && (uintptr_t)v % 16 == 0;
    for (int i = 0; i < 9; ++i) ok = ok && strides[i] > 0 && strides[i] % 8 == 0;
    const int64_t blocks = (int64_t)((Sq + FH_ROWS - 1) / FH_ROWS) * H * B;
    if (!ok || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    FhArgs a;
    a.o = o;
    a.H = H; a.Hkv = Hkv; a.Sq = Sq; a.Sk = Sk; a.D = D;
    a.causal = causal != 0; a.window = window; a.kv_len = kv_len;
    a.scale_log2 = scale * 1.4426950408889634f;
    const int dc = (D + 63) / 64;
    if (dc == 1)
      return fh_launch<1, 128>(q, k, v, a, B, qb, qs, qh, kb, ks, kh, vb, vs,
                               vh, blocks, st);
    if (dc == 2)
      return fh_launch<2, 128>(q, k, v, a, B, qb, qs, qh, kb, ks, kh, vb, vs,
                               vh, blocks, st);
    if (dc == 3)
      return fh_launch<3, 64>(q, k, v, a, B, qb, qs, qh, kb, ks, kh, vb, vs,
                              vh, blocks, st);
    return fh_launch<4, 64>(q, k, v, a, B, qb, qs, qh, kb, ks, kh, vb, vs, vh,
                            blocks, st);
  }
  const int64_t nq = (Sq + FA_T - 1) / FA_T;
  const int64_t blocks = nq * H * B;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  FaArgs a;
  a.q = q; a.k = k; a.v = v; a.o = o;
  a.H = H; a.Hkv = Hkv; a.Sq = Sq; a.Sk = Sk; a.D = D;
  a.qb = qb; a.qs = qs; a.qh = qh;
  a.kb = kb; a.ks = ks; a.kh = kh;
  a.vb = vb; a.vs = vs; a.vh = vh;
  a.causal = causal != 0; a.window = window; a.kv_len = kv_len;
  a.scale = scale;
  return fa_dispatch<float>(a, blocks, st);
}

// The bf16 kernel that takes head size D: registers a thread at launch (the
// consumers raise theirs to 240 with setmaxnreg), dynamic shared memory in
// bytes, and blocks resident on one SM.  Returns a CUDA error code.
int fa_bf16_kernel_info(int D, int* regs, int* smem, int* blocks_per_sm) {
  if (D < 1 || D > FA_DMAX) return (int)cudaErrorInvalidValue;
  const int dc = (D + 63) / 64;
  if (dc == 1) return fh_info<1, 128>(regs, smem, blocks_per_sm);
  if (dc == 2) return fh_info<2, 128>(regs, smem, blocks_per_sm);
  if (dc == 3) return fh_info<3, 64>(regs, smem, blocks_per_sm);
  return fh_info<4, 64>(regs, smem, blocks_per_sm);
}

// Rows row0 .. Sq - 1 of o (B, Sq, H, D), contiguous: the mean of v (B, Sk,
// Hkv, D, element strides vb, vs, vh) over its Sk rows, per (batch, head).
// dtype: 0 float32, 1 bfloat16.
int fa_blind_rows(const void* v, void* o, int B, int H, int Hkv, int Sq,
                  int Sk, int D, long long vb, long long vs, long long vh,
                  int row0, int dtype, void* stream) {
  if (B < 1 || H < 1 || Hkv < 1 || H % Hkv != 0 || Sq < 1 || Sk < 1 ||
      D < 1 || row0 < 0 || row0 >= Sq || (dtype != 0 && dtype != 1) ||
      (int64_t)B * H > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    fa_blind_rows_kernel<__nv_bfloat16><<<B * H, 128, 0, st>>>(
        (const __nv_bfloat16*)v, (__nv_bfloat16*)o, H, Hkv, Sq, Sk, D, vb, vs,
        vh, row0);
  else
    fa_blind_rows_kernel<float><<<B * H, 128, 0, st>>>(
        (const float*)v, (float*)o, H, Hkv, Sq, Sk, D, vb, vs, vh, row0);
  return (int)cudaGetLastError();
}

}  // extern "C"
