// Mamba2 SSD (state-space duality) chunked scan from a zero state: the
// prefill of every ssm / hybrid layer.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py::ssd_scan_pallas.
// For each (batch b, head h) it computes, over the sequence,
//
//   S_t = exp(a_t) S_{t-1} + dt_t x_t B_tᵀ       (P x N state, S_0 = 0)
//   y_t = S_t C_t
//
// and returns y (B, S, H, P) float32 and the final state (B, H, P, N)
// float32.  Inputs: x (B, S, H, P) and Bm / Cm (B, S, H, N) in float32 or
// bfloat16 (one type), dt and a = dt * A (B, S, H) float32, all addressed
// by strides (the last dim contiguous), so B and C may be broadcast from
// their groups with a zero head stride.  Like the TPU kernel it walks the
// sequence in chunks and, within a chunk of L rows, uses the duality
//
//   y     = (tril(exp(Acum_i - Acum_j)) ∘ (C Bᵀ) ∘ dt_j) X + exp(Acum) ∘ (C Sᵀ)
//   S'    = exp(a_sum) S + Xᵀ (B ∘ dt ∘ exp(a_sum - Acum))
//
// with Acum the inclusive cumulative sum of a within the chunk.  Every
// decay is exp of a difference that is <= 0 (dt > 0, A < 0), formed per
// pair, never as exp(Acum_i) / exp(Acum_j), which would be 0/0 over long
// spans; the mask is applied before the product.
//
// What differs from the TPU kernel: the TPU chunk is the caller's
// (``chunk`` if it divides S, else all of S: a 2,000-token prompt is one
// 2,000 x 2,000 tile in VMEM).  Here the chunk is the kernel's own, LC = 64
// rows, whatever ``chunk`` the wrapper was given: chunking is only a tiling
// of the same recurrence, so the result agrees with the reference's up to
// float32 rounding (the decay sums are taken over 64 rows, not 256).  The
// TPU grid's sequential chunk axis becomes a loop inside one block per
// (b, h), with the (P, N) state resident in shared memory.
//
// What bounds it on an H100: operations.  Per (b, h) and chunk of L rows
// the four products cost 2 L² N + 2 L² P + 4 L N P flops against
// (P + 2 N) elements and 8 bytes (dt, a) read and 4 P bytes written per
// row, about 45 flops per byte at Mamba2-2.7B's P 64, N 128 in float32 —
// above float32's ridge on this card (67 TFLOP/s over 3.35 TB/s: 20).
// What the design does about it: each thread owns a 4 x 4 (C Bᵀ), a
// 4 x P/16 (y) and a P/16 x 8 (state) micro-tile of registers, so every
// value read from shared memory feeds 4-8 FMAs; rows padded to an odd
// stride keep the half-warps' column reads free of bank conflicts.  The
// grid is B x H blocks: 50 (Hymba-1.5B) or 80 (Mamba2-2.7B) at batch 1, on
// 132 SMs — a third of the card idles.  Plain FMA arithmetic in float32;
// tensor-core tiles and a split of the sequence across blocks are later
// work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int LC = 64;  // rows per chunk
constexpr int NT = 256;  // threads per block: 16 x 16
constexpr int MAX_N = 128;  // state width: 8 column groups of 16
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

struct SsdArgs {
  const void* x;  // element (b, s, h, p) at b*x_sb + s*x_ss + h*x_sh + p
  const float* dt;  // element (b, s, h) at b*t_sb + s*t_ss + h*t_sh
  const float* a;  // same strides as dt
  const void* bm;  // element (b, s, h, n) at b*b_sb + s*b_ss + h*b_sh + n
  const void* cm;  // same strides as bm
  float* y;  // (B, S, H, P) contiguous
  float* fin;  // (B, H, P, N) contiguous
  int H, S, N;
  long long x_sb, x_ss, x_sh, t_sb, t_ss, t_sh, b_sb, b_ss, b_sh;
};

// shared floats: X (LC x P), B and C (LC x ldn), M (LC x LC), the state
// (P x ldn), dt and Acum (LC each); ldn = N | 1 (odd)
__host__ __device__ constexpr int smem_floats(int P, int N) {
  return LC * P + 2 * LC * (N | 1) + LC * LC + P * (N | 1) + 2 * LC;
}

template <typename T, int P>
__global__ void __launch_bounds__(NT) ssd_kernel(SsdArgs g) {
  constexpr int PC = P / 16;  // y columns / state rows per thread
  constexpr int NC = MAX_N / 16;  // state column groups
  extern __shared__ float smem[];
  const int N = g.N, ldn = N | 1;
  float* sX = smem;
  float* sB = sX + LC * P;  // B, then W = B * dt * exp(a_sum - Acum)
  float* sC = sB + LC * ldn;
  float* sM = sC + LC * ldn;
  float* sS = sM + LC * LC;
  float* sDt = sS + P * ldn;
  float* sAc = sDt + LC;  // a, then its inclusive cumulative sum

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const T* x = static_cast<const T*>(g.x);
  const T* bm = static_cast<const T*>(g.bm);
  const T* cm = static_cast<const T*>(g.cm);
  const long long x_base = b * g.x_sb + h * g.x_sh;
  const long long t_base = b * g.t_sb + h * g.t_sh;
  const long long b_base = b * g.b_sb + h * g.b_sh;

  for (int i = tid; i < P * ldn; i += NT) sS[i] = 0.f;

  for (int s0 = 0; s0 < g.S; s0 += LC) {
    const int len = min(LC, g.S - s0);
    __syncthreads();  // the previous chunk's readers of the tiles are done
    for (int i = tid; i < LC * P; i += NT) {
      const int r = i / P, c = i % P;
      sX[i] = r < len ? to_f(x[x_base + (s0 + r) * g.x_ss + c]) : 0.f;
    }
    for (int i = tid; i < LC * N; i += NT) {
      const int r = i / N, c = i % N;
      const long long off = b_base + (s0 + r) * g.b_ss + c;
      sB[r * ldn + c] = r < len ? to_f(bm[off]) : 0.f;
      sC[r * ldn + c] = r < len ? to_f(cm[off]) : 0.f;
    }
    if (tid < LC) {
      const long long off = t_base + (s0 + tid) * g.t_ss;
      sDt[tid] = tid < len ? g.dt[off] : 0.f;
      sAc[tid] = tid < len ? g.a[off] : 0.f;  // rows past len: Acum flat
    }
    __syncthreads();

    // inclusive cumsum of a: warp 0, two rows per lane
    if (tid < 32) {
      const float v0 = sAc[2 * tid], v1 = sAc[2 * tid + 1];
      float incl = v0 + v1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(FULL, incl, off);
        if (tid >= off) incl += o;
      }
      float excl = __shfl_up_sync(FULL, incl, 1);
      if (tid == 0) excl = 0.f;
      sAc[2 * tid] = excl + v0;
      sAc[2 * tid + 1] = excl + v0 + v1;
    }
    __syncthreads();

    // M = tril(exp(Acum_i - Acum_j)) ∘ (C Bᵀ) ∘ dt_j; rows i = ty + 16r,
    // columns j = tx + 16c
    {
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = sC[(ty + 16 * r) * ldn + n];
#pragma unroll
        for (int c = 0; c < 4; ++c) bv[c] = sB[(tx + 16 * c) * ldn + n];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] += cv[r] * bv[c];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ty + 16 * r;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = tx + 16 * c;
          sM[i * LC + j] =
              j <= i ? expf(sAc[i] - sAc[j]) * acc[r][c] * sDt[j] : 0.f;
        }
      }
    }
    __syncthreads();

    // y = exp(Acum_i) (C Sᵀ) + M X; rows i = ty + 16r, columns p = tx + 16c
    {
      float acc[4][PC];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < PC; ++c) acc[r][c] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[4], sv[PC];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = sC[(ty + 16 * r) * ldn + n];
#pragma unroll
        for (int c = 0; c < PC; ++c) sv[c] = sS[(tx + 16 * c) * ldn + n];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < PC; ++c) acc[r][c] += cv[r] * sv[c];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float e = expf(sAc[ty + 16 * r]);
#pragma unroll
        for (int c = 0; c < PC; ++c) acc[r][c] *= e;
      }
      const int jend = min(len, ty + 16 * 3 + 1);  // M is 0 past a row's i
      for (int j = 0; j < jend; ++j) {
        float mv[4], xv[PC];
#pragma unroll
        for (int r = 0; r < 4; ++r) mv[r] = sM[(ty + 16 * r) * LC + j];
#pragma unroll
        for (int c = 0; c < PC; ++c) xv[c] = sX[j * P + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < PC; ++c) acc[r][c] += mv[r] * xv[c];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ty + 16 * r;
        if (i < len) {
          float* yrow = g.y + ((static_cast<long long>(b) * g.S + s0 + i) * g.H + h) * P;
#pragma unroll
          for (int c = 0; c < PC; ++c) yrow[tx + 16 * c] = acc[r][c];
        }
      }
    }
    // W = B ∘ dt ∘ exp(a_sum - Acum), in place of B (read by no one above)
    const float a_sum = sAc[LC - 1];
    for (int i = tid; i < len * N; i += NT) {
      const int r = i / N, c = i % N;
      sB[r * ldn + c] *= sDt[r] * expf(a_sum - sAc[r]);
    }
    __syncthreads();

    // S' = exp(a_sum) S + Xᵀ W; state rows p = ty + 16r, columns
    // n = tx + 16c
    {
      const float decay = expf(a_sum);
      float acc[PC][NC];
      bool live[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) live[c] = tx + 16 * c < N;
#pragma unroll
      for (int r = 0; r < PC; ++r)
#pragma unroll
        for (int c = 0; c < NC; ++c)
          acc[r][c] = live[c] ? sS[(ty + 16 * r) * ldn + tx + 16 * c] * decay : 0.f;
      for (int j = 0; j < len; ++j) {
        float xv[PC], wv[NC];
#pragma unroll
        for (int r = 0; r < PC; ++r) xv[r] = sX[j * P + ty + 16 * r];
#pragma unroll
        for (int c = 0; c < NC; ++c) wv[c] = live[c] ? sB[j * ldn + tx + 16 * c] : 0.f;
#pragma unroll
        for (int r = 0; r < PC; ++r)
#pragma unroll
          for (int c = 0; c < NC; ++c) acc[r][c] += xv[r] * wv[c];
      }
#pragma unroll
      for (int r = 0; r < PC; ++r)
#pragma unroll
        for (int c = 0; c < NC; ++c)
          if (live[c]) sS[(ty + 16 * r) * ldn + tx + 16 * c] = acc[r][c];
    }
  }
  __syncthreads();
  float* fin = g.fin + (static_cast<long long>(b) * g.H + h) * P * N;
  for (int i = tid; i < P * N; i += NT) fin[i] = sS[(i / N) * ldn + i % N];
}

template <typename T, int P>
cudaError_t launch(const SsdArgs& g, int B, cudaStream_t stream) {
  const int bytes = smem_floats(P, g.N) * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<T, P>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  ssd_kernel<T, P><<<dim3(g.H, B), NT, bytes, stream>>>(g);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int P, const SsdArgs& g, int B, cudaStream_t st) {
  switch (P) {
    case 16: return launch<T, 16>(g, B, st);
    case 32: return launch<T, 32>(g, B, st);
    case 64: return launch<T, 64>(g, B, st);
    default: return launch<T, 128>(g, B, st);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, Bm and Cm; dt, a, y and the final
// state are float32).  P must be 16, 32, 64 or 128 and 1 <= N <= 128.
// Returns a cudaError_t (0 on success); the Python wrapper raises on any
// other value.
extern "C" int ssd_scan_launch(
    int dtype, int P, const void* x, const void* dt, const void* a,
    const void* bm, const void* cm, void* y, void* fin, int B, int S, int H,
    int N, long long x_sb, long long x_ss, long long x_sh, long long t_sb,
    long long t_ss, long long t_sh, long long b_sb, long long b_ss,
    long long b_sh, void* stream) {
  if ((P != 16 && P != 32 && P != 64 && P != 128) || N < 1 || N > MAX_N ||
      (dtype != 0 && dtype != 1) || S < 0 || H < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  SsdArgs g;
  g.x = x;
  g.dt = static_cast<const float*>(dt);
  g.a = static_cast<const float*>(a);
  g.bm = bm;
  g.cm = cm;
  g.y = static_cast<float*>(y);
  g.fin = static_cast<float*>(fin);
  g.H = H;
  g.S = S;
  g.N = N;
  g.x_sb = x_sb;
  g.x_ss = x_ss;
  g.x_sh = x_sh;
  g.t_sb = t_sb;
  g.t_ss = t_ss;
  g.t_sh = t_sh;
  g.b_sb = b_sb;
  g.b_ss = b_ss;
  g.b_sh = b_sh;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 0 ? dispatch<float>(P, g, B, st)
                                     : dispatch<__nv_bfloat16>(P, g, B, st);
  return static_cast<int>(err);
}
