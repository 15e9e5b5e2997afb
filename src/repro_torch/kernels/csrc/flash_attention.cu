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
// contiguous.  float32 or bfloat16 in (one dtype for q, k, v and o); the
// tiles are float32 in shared memory; any D <= 256, any Sq and Sk.
//
// Bound.  At qwen2-7b's prefill (B 4, H 28, S 2048, D 128, causal) the
// useful work is 4 D per unmasked (i, j) pair, 1.2e11 FLOP a call, against
// 59 MB of q, k, v and o: 0.12 ms at the card's 989 TFLOP/s of dense bf16
// tensor-core math, 0.018 ms at 3.35 TB/s -- bound by operations.  This
// first kernel uses no tensor cores: it runs float32 FMA from shared memory,
// whose peak (67 TFLOP/s) is 15x lower, so it cannot come near that bound;
// wgmma, TMA and a persistent grid are the next step.
//
// Design.  One block of 256 threads (16 x 16) per (b, h, tile of 64 query
// rows); the grid walks a (b, h)'s tiles from the last (the most keys under
// a causal mask) to the first.  The block keeps q * scale transposed in
// shared memory and walks only the key tiles that hold an unmasked key:
// from max(0, i0 - window + 1) (window > 0) up to min(kv_len, Sk) and, when
// causal, up to its last row -- so a sliding-window layer costs what its
// window holds, not what the sequence does.  Per key tile: K (transposed)
// into shared memory, the 64 x 64 score tile in registers (4 x 4 a thread),
// mask, row max and row sum by shuffles within the 16 threads of a row,
// rescale of the accumulator, P (transposed) and then V into shared memory
// (V takes K's place), and P V into the accumulator (4 rows x DC columns a
// thread, columns tx + 16 c).  Loads are zero-filled past the ends, so a
// padded row or key never brings NaN into a sum.
//
// The entry point launches on the given stream, allocates nothing, does not
// synchronize, and returns cudaGetLastError() (cudaErrorInvalidValue for
// arguments it does not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
static __device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> static __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);   // round to nearest even, as torch casts
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
  cudaStream_t st = (cudaStream_t)stream;
  return dtype == 0 ? fa_dispatch<float>(a, blocks, st)
                    : fa_dispatch<__nv_bfloat16>(a, blocks, st);
}

}  // extern "C"
