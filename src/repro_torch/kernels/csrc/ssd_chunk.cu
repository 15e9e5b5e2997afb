// One chunk of the Mamba2 SSD scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ssd_chunk of the JAX package
// (src/repro/kernels/ssd_chunk.py:61, body _ssd_kernel).  For every
// (batch b, head h), with x (Q, P), dt and cum (Q,), B and C (Q, N) shared by
// the heads of a batch row, and the carried state S_prev (P, N):
//
//   L[i, j] = exp(cum_i - cum_j)  for j <= i, else 0 (exp never sees j > i)
//   y       = ((C B^T) o L) (dt o x) + exp(cum) o (C S_prev^T)        (Q, P)
//   S_new   = exp(cum_{Q-1}) S_prev + ((dt o x) o exp(cum_{Q-1} - cum))^T B
//                                                                     (P, N)
//
// float32 in and out; layouts x/y (B, H, Q, P), dt/cum (B, H, Q), B/C
// (B, Q, N), S_prev/S_new (B, H, P, N), all contiguous.
//
// Bound: operations.  At the mamba2-370m prefill shape (B 8, H 32, Q 256,
// P 64, N 128) the causal half of C B^T, the (Q, Q) by (Q, P) product and
// the two (Q, N) by (N, P) products are about 5.4 GFLOP a call when C B^T is
// formed per head, as here and on the TPU, against about 53 MB moved once:
// 0.08 ms at the card's 67 TFLOP/s of float32 FMA against 0.016 ms at
// 3.35 TB/s.  (Formed once per batch row, C B^T would drop to 1/H of its
// share: a later optimisation, with tensor cores.)
//
// The TPU kernel holds the whole (Q, Q) score matrix of a (b, h) in VMEM;
// at Q = 256 that is 256 KB, more than the 227 KB of shared memory a Hopper
// block may have.  So the work is tiled over Q, in 64-row tiles, and one
// launch covers two kinds of block:
//
// * blockIdx.y < n_tiles: the y rows i0 .. i0+63 of one (b, h).  C_i stays
//   in shared memory, transposed; the block walks the causal column tiles
//   j0 <= i0 only, loads B_j (transposed), dt o x_j and cum_j, forms the
//   64 x 64 tile of (C B^T) o L in registers (masked before exp), parks it in
//   shared memory and adds its product with dt o x_j into the y tile; last
//   it adds exp(cum_i) (C_i S_prev^T).
// * blockIdx.y == n_tiles: S_new of one (b, h), a reduction over all Q rows
//   in 64-row steps of u = dt o x o exp(cum_{Q-1} - cum) and B.
//
// 256 threads a block, as 16 x 16, each with a 4 x 4 (y, W) or 4 x 8
// (S_new) tile of sums in registers; the shared tiles are laid out so that
// each thread reads 16 bytes at a time and a warp's reads of a row are
// contiguous or broadcast.  Plain FMA in float32, no tensor cores, so the
// result matches the float32 plain version to rounding.  P <= 64 and
// N <= 128 (every config of the repository); any Q >= 1.
//
// The entry point launches on the given stream, allocates nothing, does not
// synchronize, and returns cudaGetLastError() (cudaErrorInvalidValue for a
// shape it does not take).

#include <cuda_runtime.h>
#include <stdint.h>

#define SC_T 64           // rows (and columns) of a tile
#define SC_LD (SC_T + 4)  // leading dimension of the transposed tiles
#define SC_PMAX 64
#define SC_NMAX 128
#define SC_MAX_DEVICES 64
#define SC_THREADS 256

static __device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__global__ void __launch_bounds__(SC_THREADS, 2)
sc_ssd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ bm, const float* __restrict__ cm,
                    const float* __restrict__ cum,
                    const float* __restrict__ s_prev, float* __restrict__ y,
                    float* __restrict__ s_new, int H, int Q, int P, int N) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int64_t bh = blockIdx.x;
  const int64_t b = bh / H;
  const int n_tiles = (Q + SC_T - 1) / SC_T;
  const float* xb = x + bh * Q * P;
  const float* dtb = dt + bh * Q;
  const float* cumb = cum + bh * Q;
  const float* bb = bm + b * Q * N;
  const float* cb = cm + b * Q * N;
  const float* sb = s_prev + bh * P * N;

  if ((int)blockIdx.y == n_tiles) {
    // ---- S_new = exp(cum_last) S_prev + u^T B, u = dt o x o decay --------
    float* Us = smem;                    // [SC_T][SC_PMAX]
    float* Bs = smem + SC_T * SC_PMAX;   // [SC_T][SC_NMAX]
    const float cum_last = cumb[Q - 1];
    float acc[4][8];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
    for (int j0 = 0; j0 < Q; j0 += SC_T) {
      __syncthreads();                   // the last step's reads are done
      for (int e = tid; e < SC_T * SC_PMAX; e += SC_THREADS) {
        const int j = e / SC_PMAX, p = e % SC_PMAX, gj = j0 + j;
        Us[e] = (gj < Q && p < P)
                    ? xb[(int64_t)gj * P + p] * dtb[gj] *
                          expf(cum_last - cumb[gj])
                    : 0.f;
      }
      for (int e = tid; e < SC_T * SC_NMAX; e += SC_THREADS) {
        const int j = e / SC_NMAX, n = e % SC_NMAX, gj = j0 + j;
        Bs[e] = (gj < Q && n < N) ? bb[(int64_t)gj * N + n] : 0.f;
      }
      __syncthreads();
      const int jn = min(SC_T, Q - j0);
      for (int j = 0; j < jn; ++j) {
        const float4 u = ld4(Us + j * SC_PMAX + ty * 4);
        const float4 b0 = ld4(Bs + j * SC_NMAX + tx * 4);
        const float4 b1 = ld4(Bs + j * SC_NMAX + 64 + tx * 4);
        const float ur[4] = {u.x, u.y, u.z, u.w};
        const float bc[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(ur[r], bc[c], acc[r][c]);
      }
    }
    const float decay = expf(cum_last);
    float* so = s_new + bh * P * N;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int p = ty * 4 + r;
      if (p >= P) continue;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int n = tx * 4 + (c & 3) + (c >> 2) * 64;
        if (n < N) {
          const int64_t o = (int64_t)p * N + n;
          so[o] = decay * sb[o] + acc[r][c];
        }
      }
    }
    return;
  }

  // ---- y rows i0 .. i0+63 ------------------------------------------------
  float* Ct = smem;                       // [N][SC_LD]: C_i transposed
  float* Bt = Ct + N * SC_LD;             // [N][SC_LD]: B_j, then S_prev^T
  float* Xs = Bt + N * SC_LD;             // [SC_T][SC_PMAX]: dt o x_j
  float* Wt = Xs + SC_T * SC_PMAX;        // [SC_T][SC_LD]: W^T tile
  float* cum_i = Wt + SC_T * SC_LD;       // [SC_T]
  float* cum_j = cum_i + SC_T;            // [SC_T]
  const int i0 = blockIdx.y * SC_T;

  for (int e = tid; e < SC_T * N; e += SC_THREADS) {
    const int i = e / N, n = e % N, gi = i0 + i;
    Ct[n * SC_LD + i] = gi < Q ? cb[(int64_t)gi * N + n] : 0.f;
  }
  for (int i = tid; i < SC_T; i += SC_THREADS)
    cum_i[i] = i0 + i < Q ? cumb[i0 + i] : 0.f;

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  for (int j0 = 0; j0 <= i0; j0 += SC_T) {   // causal column tiles only
    __syncthreads();                      // the last step's reads are done
    for (int e = tid; e < SC_T * N; e += SC_THREADS) {
      const int j = e / N, n = e % N, gj = j0 + j;
      Bt[n * SC_LD + j] = gj < Q ? bb[(int64_t)gj * N + n] : 0.f;
    }
    for (int e = tid; e < SC_T * SC_PMAX; e += SC_THREADS) {
      const int j = e / SC_PMAX, p = e % SC_PMAX, gj = j0 + j;
      Xs[e] = (gj < Q && p < P) ? xb[(int64_t)gj * P + p] * dtb[gj] : 0.f;
    }
    for (int j = tid; j < SC_T; j += SC_THREADS)
      cum_j[j] = j0 + j < Q ? cumb[j0 + j] : 0.f;
    __syncthreads();

    // W[i, j] = (C_i . B_j) exp(cum_i - cum_j), rows ty*4.., columns tx*4..
    float w[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) w[r][c] = 0.f;
    for (int n = 0; n < N; ++n) {
      const float4 a = ld4(Ct + n * SC_LD + ty * 4);
      const float4 v = ld4(Bt + n * SC_LD + tx * 4);
      const float ar[4] = {a.x, a.y, a.z, a.w};
      const float vc[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) w[r][c] = fmaf(ar[r], vc[c], w[r][c]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int li = ty * 4 + r, gi = i0 + li;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int lj = tx * 4 + c, gj = j0 + lj;
        // mask before exp: cum_i - cum_j > 0 above the diagonal may overflow
        w[r][c] = (gj <= gi && gi < Q)
                      ? w[r][c] * expf(cum_i[li] - cum_j[lj]) : 0.f;
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<float4*>(Wt + (tx * 4 + c) * SC_LD + ty * 4) =
          make_float4(w[0][c], w[1][c], w[2][c], w[3][c]);
    __syncthreads();

    // y tile += W (dt o x_j), rows ty*4.., columns p = tx*4..
    const int jn = min(SC_T, Q - j0);
    for (int j = 0; j < jn; ++j) {
      const float4 a = ld4(Wt + j * SC_LD + ty * 4);
      const float4 v = ld4(Xs + j * SC_PMAX + tx * 4);
      const float ar[4] = {a.x, a.y, a.z, a.w};
      const float vc[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(ar[r], vc[c], acc[r][c]);
    }
  }

  // y tile += exp(cum_i) (C_i S_prev^T); S_prev^T goes where B_j was
  __syncthreads();
  float* St = Bt;                          // [N][SC_LD]: St[n][p]
  for (int e = tid; e < P * N; e += SC_THREADS) {
    const int p = e / N, n = e % N;
    St[n * SC_LD + p] = sb[e];
  }
  for (int e = tid; e < N * (SC_PMAX - P); e += SC_THREADS) {
    const int n = e / (SC_PMAX - P), p = P + e % (SC_PMAX - P);
    St[n * SC_LD + p] = 0.f;
  }
  __syncthreads();
  float yi[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) yi[r][c] = 0.f;
  for (int n = 0; n < N; ++n) {
    const float4 a = ld4(Ct + n * SC_LD + ty * 4);
    const float4 v = ld4(St + n * SC_LD + tx * 4);
    const float ar[4] = {a.x, a.y, a.z, a.w};
    const float vc[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) yi[r][c] = fmaf(ar[r], vc[c], yi[r][c]);
  }
  float* yb = y + bh * Q * P;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int li = ty * 4 + r, gi = i0 + li;
    if (gi >= Q) continue;
    const float e = expf(cum_i[li]);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int p = tx * 4 + c;
      if (p < P) yb[(int64_t)gi * P + p] = acc[r][c] + e * yi[r][c];
    }
  }
}

static size_t sc_smem_bytes(int N) {
  const size_t y_block = 2 * (size_t)N * SC_LD + SC_T * SC_PMAX +
                         SC_T * SC_LD + 2 * SC_T;
  const size_t s_block = SC_T * SC_PMAX + SC_T * SC_NMAX;
  return sizeof(float) * (y_block > s_block ? y_block : s_block);
}

extern "C" {

int sc_ssd_chunk(const void* x, const void* dt, const void* bm, const void* cm,
                 const void* cum, const void* s_prev, void* y, void* s_new,
                 int B, int H, int Q, int P, int N, void* stream) {
  if (B < 0 || H < 0 || Q < 1 || P < 1 || P > SC_PMAX || N < 1 ||
      N > SC_NMAX)
    return (int)cudaErrorInvalidValue;
  if ((int64_t)B * H == 0) return (int)cudaGetLastError();
  if ((int64_t)B * H > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // The opt-in above 48 KB is set once per device, for the largest size any
  // N takes, not on every launch.
  static bool smem_opted_in[SC_MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= SC_MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!smem_opted_in[dev]) {
    err = cudaFuncSetAttribute(sc_ssd_chunk_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)sc_smem_bytes(SC_NMAX));
    if (err != cudaSuccess) return (int)err;
    smem_opted_in[dev] = true;
  }
  const size_t smem = sc_smem_bytes(N);
  const int n_tiles = (Q + SC_T - 1) / SC_T;
  const dim3 grid((unsigned)(B * H), (unsigned)(n_tiles + 1));
  sc_ssd_chunk_kernel<<<grid, SC_THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)dt, (const float*)bm, (const float*)cm,
      (const float*)cum, (const float*)s_prev, (float*)y, (float*)s_new, H, Q,
      P, N);
  return (int)cudaGetLastError();
}

}  // extern "C"
