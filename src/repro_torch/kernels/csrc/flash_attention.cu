// Blockwise causal / sliding-window GQA flash attention (prefill).
//
// Replaces the TPU kernels src/repro/kernels/flash_attention.py::
// flash_attention_bhsd (generic: head-major q (B, Hq, Sq, D) and k/v
// (B, Hkv, Sk, D)) and ::flash_attention_merged_bsd (the paper's merged
// prefill fast path: the RoPE'd residual stream viewed (B, Sq, Hq, D) is
// the query and K*/V* are read in their native (B, Sk, Hkv, D) layout).
// One CUDA body serves both: the layouts differ only in strides.  The
// output is written in the query's layout.
//
// Semantics kept from the TPU kernel: positions are arange (row i of q is
// position i, column j of k is position j); a pair is attendable iff
// (not causal or j <= i) and (window == 0 or i - j < window); masked
// scores go to NEG before the row max and their probabilities are then
// zeroed; a row with nothing to attend to is exactly 0.
//
// What bounds it on an H100: operations at long prompts, the K/V/Q bytes at
// short ones (4 * D flops per attendable pair per head against
// 2 * D * elem bytes per kv row).  What the design does about it:
//   * one block per (q tile of 32 rows, q head, batch) walks kv tiles of 64
//     only over the causal / window band: tiles wholly outside it are never
//     loaded or computed (the TPU kernel's block skip);
//   * the q tile and each K (transposed) / V tile live in shared memory as
//     float32; each thread owns a 2 x 4 score micro-tile and a 2 x D/16
//     output micro-tile, and the row max / sum reduce over 16 lanes by warp
//     shuffles;
//   * ragged Sq / Sk tails are masked in the kernel, so any prompt length
//     runs at full tile size (no divisor search for a block size).
// Plain FMA arithmetic in float32 whatever the input type (bf16 or f32);
// tensor-core (wgmma / mma.sync) tiles are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr float NEG = -1e30f;
constexpr int BQ = 32;  // query rows per block
constexpr int BK = 64;  // keys per tile
constexpr int NT = 256;  // threads per block: 16 row pairs x 16 lanes
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct FlashArgs {
  const void* q;  // element (b, i, h, d) at b*q_sb + i*q_ss + h*q_sh + d
  const void* k;  // element (b, j, h, d) at b*k_sb + j*k_ss + h*k_sh + d
  const void* v;  // same strides as k
  void* out;  // same strides as q
  int Hq, Hkv, Sq, Sk, causal, window;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh;
};

template <int D>
constexpr int smem_floats() {
  return BQ * (D + 1) + D * (BK + 1) + BK * D + BQ * (BK + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_kernel(FlashArgs a) {
  constexpr int NC = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;  // BQ x (D + 1), pre-scaled
  float* sKt = sQ + BQ * (D + 1);  // D x (BK + 1), K transposed
  float* sV = sKt + D * (BK + 1);  // BK x D
  float* sP = sV + BK * D;  // BQ x (BK + 1), probabilities

  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv);
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int r0 = 2 * ty;  // this thread's rows: r0, r0 + 1
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  const long long q_base = b * a.q_sb + h * a.q_sh;
  const long long kv_base = b * a.k_sb + hk * a.k_sh;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, c = i % D, row = q0 + r;
    sQ[r * (D + 1) + c] = row < a.Sq ? to_f(q[q_base + row * a.q_ss + c]) * scale : 0.f;
  }

  // the kv band this q tile can see
  int kend = a.Sk;
  if (a.causal) kend = min(kend, q0 + BQ);
  int kbeg = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  kbeg = (kbeg / BK) * BK;

  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  float acc[2][NC];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;

  for (int k0 = kbeg; k0 < kend; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < BK * D; i += NT) {
      const int j = i / D, c = i % D, col = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (col < a.Sk) {
        const long long off = kv_base + col * a.k_ss + c;
        kx = to_f(k[off]);
        vx = to_f(v[off]);
      }
      sKt[c * (BK + 1) + j] = kx;
      sV[j * D + c] = vx;
    }
    __syncthreads();

    float s[2][4];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) s[r][cc] = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      const float qa = sQ[r0 * (D + 1) + c], qb = sQ[(r0 + 1) * (D + 1) + c];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float kk = sKt[c * (BK + 1) + tx + 16 * cc];
        s[0][cc] += qa * kk;
        s[1][cc] += qb * kk;
      }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + r0 + r;
      bool ok[4];
      float mx = NEG;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int col = k0 + tx + 16 * cc;
        ok[cc] = col < a.Sk && (!a.causal || col <= row) &&
                 (a.window <= 0 || row - col < a.window);
        s[r][cc] = ok[cc] ? s[r][cc] : NEG;
        mx = fmaxf(mx, s[r][cc]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
      const float m_next = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_next);
      float sum = 0.f;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float p = ok[cc] ? expf(s[r][cc] - m_next) : 0.f;
        sP[(r0 + r) * (BK + 1) + tx + 16 * cc] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(FULL, sum, off);
      l[r] = l[r] * alpha + sum;
      m[r] = m_next;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] *= alpha;
    }
    __syncthreads();

    for (int j = 0; j < BK; ++j) {
      const float pa = sP[r0 * (BK + 1) + j], pb = sP[(r0 + 1) * (BK + 1) + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float vv = sV[j * D + tx + 16 * c];
        acc[0][c] += pa * vv;
        acc[1][c] += pb * vv;
      }
    }
  }

  T* out = static_cast<T*>(a.out);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + r;
    if (row < a.Sq) {
      const float inv = 1.f / (l[r] == 0.f ? 1.f : l[r]);
#pragma unroll
      for (int c = 0; c < NC; ++c)
        out[q_base + row * a.q_ss + tx + 16 * c] = from_f<T>(acc[r][c] * inv);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const FlashArgs& a, int B, cudaStream_t stream) {
  const int bytes = smem_floats<D>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + BQ - 1) / BQ, a.Hq, B);
  flash_kernel<T, D><<<grid, NT, bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  D must be 64 or 128.  Returns a
// cudaError_t (0 on success); the Python wrapper raises on any other value.
extern "C" int flash_attention_launch(
    int dtype, int D, const void* q, const void* k, const void* v, void* out,
    int B, int Hq, int Hkv, int Sq, int Sk, int q_sb, int q_ss, int q_sh,
    int k_sb, int k_ss, int k_sh, int causal, int window, void* stream) {
  if ((D != 64 && D != 128) || (dtype != 0 && dtype != 1) || Hkv < 1 ||
      Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (Sq == 0 || B == 0) return static_cast<int>(cudaSuccess);
  FlashArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = out;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.Sq = Sq;
  a.Sk = Sk;
  a.causal = causal;
  a.window = window;
  a.q_sb = q_sb;
  a.q_ss = q_ss;
  a.q_sh = q_sh;
  a.k_sb = k_sb;
  a.k_ss = k_ss;
  a.k_sh = k_sh;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = D == 64 ? launch<float, 64>(a, B, st) : launch<float, 128>(a, B, st);
  else
    err = D == 64 ? launch<__nv_bfloat16, 64>(a, B, st)
                  : launch<__nv_bfloat16, 128>(a, B, st);
  return static_cast<int>(err);
}
