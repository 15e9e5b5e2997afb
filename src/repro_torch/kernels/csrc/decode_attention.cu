// Decode attention for Hopper (sm_90a): a few query rows against a KV cache.
//
// Replaces no TPU kernel: the JAX package's decode attention
// (src/repro/models/layers.py, decode_attention) is plain jnp, and so is
// its twin here, repro_torch.models.layers.decode_attention, which stays the
// CPU path and the oracle.  It was added because that plain version, run on
// the card, casts every row of the cache buffer to float32 and masks the
// rows past kv_len afterwards: ~25 launches and ~6 GB of traffic a layer at
// olmoe-1b-7b's decode (64 rows, a 4096-row buffer), where the work needs
// the valid rows read once.  For every (batch b, query head h) and query row
// i at position p = q_offset + i:
//
//   s[i, j] = (float(q[i]) * scale) . float(k[j])                 float32
//   keep    = j < kv_len  &&  (causal: j <= p)  &&  (window > 0: p - j < window)
//   o[i]    = sum_keep exp(s - m) v[j] / max(sum_keep exp(s - m), 1e-30)
//
// A masked key adds exactly 0, as the plain version's -1e30 does.  A row
// that keeps no key (a position past kv_len + window - 1) gets what the plain
// version gives it, every score masked alike: the mean of v over all Sk rows
// (its scores taken as 0 over [0, Sk)).  No model's call has such a row.
// Layouts: q and o (B, Sq, H, D), k and v (B, Smax, Hkv, D), bfloat16,
// contiguous, as the cache buffers lie; query head h reads kv head
// h / (H / Hkv).  Everything after the loads is float32 FMA: no tensor
// cores, P is never rounded, the output is cast to bfloat16 once.
//
// Bound: bytes.  A call reads B x L x Hkv x D x 2 bytes of K and as many of
// V, L the keys its rows keep (kv_len, or the window), plus q and o: at
// olmoe's decode 524,288 x L bytes a layer, 1.4 GB at L = 2,700, 0.42 ms at
// 3.35 TB/s.  The arithmetic is 2 FMA a key and head per element of D,
// 1-2 FLOP a byte, far under float32's 67 TFLOP/s.
//
// Design, for that bound.  One block a (batch, kv head, split of the keys):
// it holds every query row and every head of the kv head's group (R = Sq x
// H / Hkv rows, at most 32), so K and V are read once for all of them.  It
// walks its keys in tiles of 64 positions, double-buffered in shared memory
// by cp.async, 16 bytes a thread, neighbouring threads on neighbouring
// addresses (a position's D values are contiguous).  A tile's scores: two
// threads a position (each half of D against q in shared memory, float32,
// scaled once); its online softmax: a warp a row; its P.V: a thread a pair of
// columns and a share of the tile's positions, R accumulators each.  The
// blocks cover only the keys the rows keep: the union of the rows' ranges.
// Where B x Hkv blocks would leave the card's SMs idle (qwen2-7b at batch 8:
// 32 pairs), the wrapper cuts the keys into splits of whole tiles; each
// split's block writes its partial (m, l, o) to a workspace, and the last
// of a pair's blocks to finish (a counter a pair, reset by it) merges them
// in split order and writes the output, inside the same launch: one launch
// a layer.
//
// The entry point launches on the given stream, allocates nothing, does not
// synchronize, and returns cudaGetLastError() (cudaErrorInvalidValue for
// arguments it does not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define DA_THREADS 128
#define DA_TILE 64              // key positions a tile
#define DA_MAX_SQ 4
#define DA_MAX_ROWS 32          // Sq x (H / Hkv)
#define DA_MAX_SPLITS 32
#define DA_MAX_DEVICES 64

struct DaArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* out;
  float* part;                  // (pairs, splits, R, D + 2): o, then m, l
  int* count;                   // (pairs,): splits finished, 0 between calls
  int B, Sq, H, Hkv, Sk;
  long long q_offset, kv_end;   // kv_end: min(kv_len, Sk)
  int causal, window;
  int jlo, jhi;                 // the union of the rows' key ranges
  int tiles_per_split, splits;
  float scale;
};

// Shared memory of one block: K and V tiles in two stages, rows padded by
// 16 bytes so that the score phase's 16-byte reads of 8 consecutive
// positions fall in distinct banks; q scaled in float32; the tile's scores
// by half of D (the first half then holds P); each row's m, l and the
// tile's rescale.
template <int D, int RB>
struct DaSmem {
  static constexpr int pitch = D + 8;                          // bf16
  static constexpr int stages = 2 * 2 * DA_TILE * pitch * 2;   // bytes
  static constexpr int reduce = (DA_THREADS / (D / 2)) * RB * D * 4;
  static constexpr int kv = stages > reduce ? stages : reduce;
  static constexpr int qs = RB * D * 4;
  static constexpr int sp = 2 * RB * DA_TILE * 4;
  static constexpr int stats = 3 * RB * 4 + 3 * DA_MAX_SQ * 4;
  static constexpr int bytes = kv + qs + sp + stats;
  // after the last tile the K/V stages (widened where D = 32 needs it)
  // hold the column groups' partial sums, and the score buffers the
  // merge's weights
  static_assert(DA_MAX_SPLITS * RB * 4 <= sp, "merge space");
};

__device__ __forceinline__ void da_cp16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void da_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void da_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The n positions from j0 of one (batch, kv head) into a stage.
template <int D>
__device__ __forceinline__ void da_load_tile(__nv_bfloat16* ks,
                                             __nv_bfloat16* vs,
                                             const DaArgs& a, int b, int kvh,
                                             int j0, int n) {
  constexpr int chunks = D / 8, pitch = DaSmem<D, 1>::pitch;
  for (int c = threadIdx.x; c < n * chunks; c += DA_THREADS) {
    const int t = c / chunks, part = c - t * chunks;
    const size_t g =
        ((size_t)((size_t)b * a.Sk + j0 + t) * a.Hkv + kvh) * D + part * 8;
    da_cp16(ks + t * pitch + part * 8, a.k + g);
    da_cp16(vs + t * pitch + part * 8, a.v + g);
  }
}

__device__ __forceinline__ float da_lo(unsigned w) {
  return __uint_as_float(w << 16);
}

__device__ __forceinline__ float da_hi(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}

template <int D, int RB>
__global__ void __launch_bounds__(DA_THREADS)
da_decode_attention_kernel(const DaArgs a) {
  using S = DaSmem<D, RB>;
  constexpr int pitch = S::pitch;
  constexpr int U = D / 2;              // P.V: a thread a pair of columns
  constexpr int G = DA_THREADS / U;     // ... and one of G position groups
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* kv = reinterpret_cast<__nv_bfloat16*>(smem);
  float* qs = reinterpret_cast<float*>(smem + S::kv);
  float* sp = reinterpret_cast<float*>(smem + S::kv + S::qs);
  float* ms = reinterpret_cast<float*>(smem + S::kv + S::qs + S::sp);
  float* ls = ms + RB;
  float* as = ls + RB;
  int* rlo = reinterpret_cast<int*>(as + RB);
  int* rhi = rlo + DA_MAX_SQ;
  int* rflat = rhi + DA_MAX_SQ;

  const int tid = threadIdx.x;
  const int split = blockIdx.x % a.splits;
  const int pair = blockIdx.x / a.splits;
  const int kvh = pair % a.Hkv, b = pair / a.Hkv;
  const int rep = a.H / a.Hkv, R = a.Sq * rep;
  const int start = a.jlo + split * a.tiles_per_split * DA_TILE;
  const int end = min(a.jhi, start + a.tiles_per_split * DA_TILE);
  const int ntiles = (end - start + DA_TILE - 1) / DA_TILE;

  if (ntiles > 0) {
    da_load_tile<D>(kv, kv + DA_TILE * pitch, a, b, kvh, start,
                    min(DA_TILE, end - start));
  }
  da_commit();

  // each query row's keys: [lo, hi), or all Sk of them for a row that
  // keeps none (flat: every score 0)
  if (tid < a.Sq) {
    const long long p = a.q_offset + tid;
    long long lo = 0, hi = a.kv_end;
    if (a.causal) hi = hi < p + 1 ? hi : p + 1;
    if (a.window > 0 && p - a.window + 1 > lo) lo = p - a.window + 1;
    const bool flat = hi <= lo;
    rlo[tid] = flat ? 0 : (int)lo;
    rhi[tid] = flat ? a.Sk : (int)hi;
    rflat[tid] = flat;
  }
  for (int e = tid; e < R * D; e += DA_THREADS) {
    const int r = e / D, d = e - r * D;
    const int i = r / rep, g = r - i * rep;
    const size_t at = (((size_t)b * a.Sq + i) * a.H + kvh * rep + g) * D + d;
    qs[r * D + d] = __bfloat162float(a.q[at]) * a.scale;
  }
  if (tid < R) {
    ms[tid] = -INFINITY;
    ls[tid] = 0.f;
  }

  float o[RB][2];
#pragma unroll
  for (int r = 0; r < RB; ++r) o[r][0] = o[r][1] = 0.f;

  const int lane = tid & 31, warp = tid >> 5;
  for (int it = 0; it < ntiles; ++it) {
    const int j0 = start + it * DA_TILE;
    const int n = min(DA_TILE, end - j0);
    if (it + 1 < ntiles) {
      __nv_bfloat16* nk = kv + ((it + 1) & 1) * 2 * DA_TILE * pitch;
      da_load_tile<D>(nk, nk + DA_TILE * pitch, a, b, kvh, j0 + DA_TILE,
                      min(DA_TILE, end - j0 - DA_TILE));
      da_commit();
      da_wait<1>();
    } else {
      da_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* ks = kv + (it & 1) * 2 * DA_TILE * pitch;
    const __nv_bfloat16* vs = ks + DA_TILE * pitch;

    // scores: position t, half h of D; every thread of a warp on one half
    {
      const int t = tid % DA_TILE, h = tid / DA_TILE;
      float acc[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r) acc[r] = 0.f;
      if (t < n) {
        const __nv_bfloat16* krow = ks + t * pitch + h * (D / 2);
        const float* qh = qs + h * (D / 2);
#pragma unroll
        for (int c = 0; c < D / 16; ++c) {
          const uint4 w = *reinterpret_cast<const uint4*>(krow + c * 8);
          const float kf[8] = {da_lo(w.x), da_hi(w.x), da_lo(w.y), da_hi(w.y),
                               da_lo(w.z), da_hi(w.z), da_lo(w.w),
                               da_hi(w.w)};
#pragma unroll
          for (int r = 0; r < RB; ++r) {
            if (r < R) {
              const float4 q0 =
                  *reinterpret_cast<const float4*>(qh + r * D + c * 8);
              const float4 q1 =
                  *reinterpret_cast<const float4*>(qh + r * D + c * 8 + 4);
              float s = acc[r];
              s = fmaf(q0.x, kf[0], s);
              s = fmaf(q0.y, kf[1], s);
              s = fmaf(q0.z, kf[2], s);
              s = fmaf(q0.w, kf[3], s);
              s = fmaf(q1.x, kf[4], s);
              s = fmaf(q1.y, kf[5], s);
              s = fmaf(q1.z, kf[6], s);
              s = fmaf(q1.w, kf[7], s);
              acc[r] = s;
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < RB; ++r)
        if (r < R) sp[(h * RB + r) * DA_TILE + t] = acc[r];
    }
    __syncthreads();

    // online softmax: a warp a row, a lane two positions
    for (int r = warp; r < R; r += DA_THREADS / 32) {
      const int i = r / rep;
      const int lo = rlo[i], hi = rhi[i];
      const bool flat = rflat[i];
      float s[2], mx = -INFINITY;
      bool ok[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int t = lane + 32 * e, j = j0 + t;
        ok[e] = t < n && j >= lo && j < hi;
        s[e] = flat ? 0.f : sp[r * DA_TILE + t] + sp[(RB + r) * DA_TILE + t];
        if (ok[e]) mx = fmaxf(mx, s[e]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = ms[r];
      const float m_new = fmaxf(m_old, mx);
      float p[2] = {0.f, 0.f};
      if (m_new != -INFINITY) {
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (ok[e]) p[e] = expf(s[e] - m_new);
      }
      float sum = p[0] + p[1];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      sp[r * DA_TILE + lane] = p[0];
      sp[r * DA_TILE + lane + 32] = p[1];
      if (lane == 0) {
        const float alpha = m_new == -INFINITY ? 1.f : expf(m_old - m_new);
        ms[r] = m_new;
        ls[r] = ls[r] * alpha + sum;
        as[r] = alpha;
      }
    }
    __syncthreads();

    // P.V: columns 2u, 2u + 1 over the positions t = g, g + G, ...
    {
      const int u = tid % U, g = tid / U;
      if (g < G) {
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          if (r < R) {
            const float al = as[r];
            o[r][0] *= al;
            o[r][1] *= al;
          }
        }
        for (int t = g; t < n; t += G) {
          const unsigned w =
              *reinterpret_cast<const unsigned*>(vs + t * pitch + 2 * u);
          const float v0 = da_lo(w), v1 = da_hi(w);
#pragma unroll
          for (int r = 0; r < RB; ++r) {
            if (r < R) {
              const float pr = sp[r * DA_TILE + t];
              o[r][0] = fmaf(pr, v0, o[r][0]);
              o[r][1] = fmaf(pr, v1, o[r][1]);
            }
          }
        }
      }
    }
    __syncthreads();
  }

  // the position groups' partial sums, through the K/V stages
  float* red = reinterpret_cast<float*>(smem);
  {
    const int u = tid % U, g = tid / U;
    if (g < G) {
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        if (r < R) {
          red[(g * R + r) * D + 2 * u] = o[r][0];
          red[(g * R + r) * D + 2 * u + 1] = o[r][1];
        }
      }
    }
  }
  __syncthreads();

  if (a.splits == 1) {
    for (int e = tid; e < R * D; e += DA_THREADS) {
      const int r = e / D, d = e - r * D;
      float acc = 0.f;
#pragma unroll
      for (int g = 0; g < G; ++g) acc += red[(g * R + r) * D + d];
      const int i = r / rep, gh = r - i * rep;
      const size_t at =
          (((size_t)b * a.Sq + i) * a.H + kvh * rep + gh) * D + d;
      a.out[at] = __float2bfloat16_rn(acc / fmaxf(ls[r], 1e-30f));
    }
    return;
  }

  // this split's partial (o, m, l), then the last of the pair's splits to
  // finish merges them all
  float* mine = a.part + ((size_t)pair * a.splits + split) * R * (D + 2);
  for (int e = tid; e < R * D; e += DA_THREADS) {
    const int r = e / D, d = e - r * D;
    float acc = 0.f;
#pragma unroll
    for (int g = 0; g < G; ++g) acc += red[(g * R + r) * D + d];
    mine[r * (D + 2) + d] = acc;
  }
  if (tid < R) {
    mine[tid * (D + 2) + D] = ms[tid];
    mine[tid * (D + 2) + D + 1] = ls[tid];
  }
  __threadfence();
  __syncthreads();
  __shared__ int last;
  if (tid == 0) last = atomicAdd(a.count + pair, 1) == a.splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();

  const float* all = a.part + (size_t)pair * a.splits * R * (D + 2);
  float* wt = sp;                       // (splits, R) weights, then L
  if (tid < R) {
    float m = -INFINITY;
    for (int s = 0; s < a.splits; ++s)
      m = fmaxf(m, __ldcg(all + ((size_t)s * R + tid) * (D + 2) + D));
    float l = 0.f;
    for (int s = 0; s < a.splits; ++s) {
      const float* row = all + ((size_t)s * R + tid) * (D + 2);
      const float ms_ = __ldcg(row + D);
      const float w = ms_ == -INFINITY ? 0.f : expf(ms_ - m);
      wt[s * R + tid] = w;
      l = fmaf(w, __ldcg(row + D + 1), l);
    }
    ls[tid] = l;
  }
  __syncthreads();
  for (int e = tid; e < R * D; e += DA_THREADS) {
    const int r = e / D, d = e - r * D;
    float acc = 0.f;
    for (int s = 0; s < a.splits; ++s)
      acc = fmaf(wt[s * R + r], __ldcg(all + ((size_t)s * R + r) * (D + 2) + d),
                 acc);
    const int i = r / rep, gh = r - i * rep;
    const size_t at = (((size_t)b * a.Sq + i) * a.H + kvh * rep + gh) * D + d;
    a.out[at] = __float2bfloat16_rn(acc / fmaxf(ls[r], 1e-30f));
  }
  if (tid == 0) a.count[pair] = 0;
}

template <int D, int RB>
static int da_launch(const DaArgs& a, int blocks, cudaStream_t stream) {
  // the opt-in to dynamic shared memory above 48 KB, once per device
  static bool opted_in[DA_MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= DA_MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!opted_in[dev]) {
    err = cudaFuncSetAttribute(da_decode_attention_kernel<D, RB>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               DaSmem<D, RB>::bytes);
    if (err != cudaSuccess) return (int)err;
    opted_in[dev] = true;
  }
  da_decode_attention_kernel<D, RB>
      <<<blocks, DA_THREADS, DaSmem<D, RB>::bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int D>
static int da_launch_rows(const DaArgs& a, int R, int blocks,
                          cudaStream_t stream) {
  if (R <= 1) return da_launch<D, 1>(a, blocks, stream);
  if (R <= 2) return da_launch<D, 2>(a, blocks, stream);
  if (R <= 4) return da_launch<D, 4>(a, blocks, stream);
  if (R <= 8) return da_launch<D, 8>(a, blocks, stream);
  if (R <= 16) return da_launch<D, 16>(a, blocks, stream);
  return da_launch<D, 32>(a, blocks, stream);
}

extern "C" {

int da_decode_attention(const void* q, const void* k, const void* v,
                        void* out, void* part, void* count, int B, int Sq,
                        int H, int Hkv, int Sk, int D, long long q_offset,
                        long long kv_end, int causal, int window, int jlo,
                        int jhi, int tiles_per_split, int splits, float scale,
                        void* stream) {
  if (B < 1 || Sq < 1 || Sq > DA_MAX_SQ || Hkv < 1 || H % Hkv != 0 ||
      Sq * (H / Hkv) > DA_MAX_ROWS || Sk < 1 || window < 0 || jlo < 0 ||
      jhi > Sk || jlo >= jhi || tiles_per_split < 1 || splits < 1 ||
      splits > DA_MAX_SPLITS ||
      (long long)(splits - 1) * tiles_per_split * DA_TILE >= jhi - jlo ||
      (splits > 1 && (part == nullptr || count == nullptr)))
    return (int)cudaErrorInvalidValue;
  DaArgs a;
  a.q = (const __nv_bfloat16*)q;
  a.k = (const __nv_bfloat16*)k;
  a.v = (const __nv_bfloat16*)v;
  a.out = (__nv_bfloat16*)out;
  a.part = (float*)part;
  a.count = (int*)count;
  a.B = B;
  a.Sq = Sq;
  a.H = H;
  a.Hkv = Hkv;
  a.Sk = Sk;
  a.q_offset = q_offset;
  a.kv_end = kv_end;
  a.causal = causal;
  a.window = window;
  a.jlo = jlo;
  a.jhi = jhi;
  a.tiles_per_split = tiles_per_split;
  a.splits = splits;
  a.scale = scale;
  const int R = Sq * (H / Hkv), blocks = B * Hkv * splits;
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 32: return da_launch_rows<32>(a, R, blocks, st);
    case 64: return da_launch_rows<64>(a, R, blocks, st);
    case 80: return da_launch_rows<80>(a, R, blocks, st);
    case 128: return da_launch_rows<128>(a, R, blocks, st);
    case 240: return da_launch_rows<240>(a, R, blocks, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
