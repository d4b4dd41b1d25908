// One-token GQA decode attention against a position-tagged KV cache.
//
// Replaces the TPU kernels src/repro/kernels/decode_attention.py::
// decode_attention_bhsd (generic: grouped query (B, Hkv, G, D), head-major
// cache (B, Hkv, S, D)) and ::decode_attention_merged_bsd (the paper's
// merged fast path: the RoPE'd residual stream (B, Hq, D) is the query and
// K*/V* are read in the serving cache's native (B, S, Hkv, D) layout).  One
// CUDA body serves both: the layouts differ only in strides.
//
// Semantics kept from the TPU kernel: a slot is attendable iff
// kv_pos >= 0, kv_pos <= q_pos and (window == 0 or q_pos - kv_pos < window);
// masked scores go to NEG before the row max and their probabilities are
// then zeroed; a row with nothing to attend to (denominator 0) is exactly 0.
//
// What bounds it on an H100: bytes.  Each step reads every attendable K/V
// row once (B * S * Hkv * D * 2 elements) and does 4 * G * D flops per
// row, far below the ~295 flop/byte ridge.  What the design does about it:
//   * one block per (batch, kv head, kv split) loads each K/V row ONCE for
//     all G query heads that share that kv head;
//   * the kv axis is split over blocks (flash-decoding) so B * Hkv * splits
//     blocks fill the 132 SMs at B = 4; a second pass combines the partial
//     (m, l, acc) of the splits.  The TPU walks the kv axis sequentially
//     inside one grid row, which on this card would leave most SMs idle;
//   * rows whose slot is masked (empty, future, out of window) are never
//     loaded: only the position array is read for them.
// Plain FMA arithmetic in float32, whatever the input type (bf16 or f32).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr float NEG = -1e30f;
constexpr int NT = 128;  // threads per block
constexpr int NWARP = NT / 32;
constexpr int TK = 64;  // keys per tile
constexpr int MAX_G = 8;  // query heads per kv head
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct DecodeArgs {
  const void* q;  // element (b, h, g, d) at b*q_sb + h*q_sh + g*D + d
  const void* k;  // element (b, h, s, d) at b*k_sb + h*k_sh + s*k_ss + d
  const void* v;  // same strides as k
  const int* kv_pos;  // (B, S)
  const int* q_pos;  // (B,)
  void* out;  // same strides as q
  float* ws_acc;  // (B, Hkv, n_split, G, D) unnormalised partial outputs
  float* ws_ml;  // (B, Hkv, n_split, G, 2) partial row max and sum
  int B, Hkv, G, S, window, n_split, chunk;
  long long q_sb, q_sh, k_sb, k_sh, k_ss;
};

// Pass 1: one block per (split, kv head, batch) runs the online softmax over
// its kv range and leaves (m, l, acc) for the G query heads in the workspace.
template <typename T, int D>
__global__ void __launch_bounds__(NT) decode_split_kernel(DecodeArgs a) {
  constexpr int EPL = D / 32;  // elements per lane in the score pass
  constexpr int KP = NT / D;  // key partitions in the P.V pass
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int G = a.G, S = a.S;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int d = tid % D, kpart = tid / D;

  __shared__ float s_p[MAX_G][TK];  // scores, then probabilities
  __shared__ int s_ok[TK];
  __shared__ float s_m[MAX_G], s_l[MAX_G], s_alpha[MAX_G];
  __shared__ float s_red[KP][MAX_G][D];

  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  const int qp = a.q_pos[b];
  const long long kv_base = b * a.k_sb + h * a.k_sh;

  float qreg[MAX_G][EPL];
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) {
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      qreg[g][e] = g < G
          ? to_f(q[b * a.q_sb + h * a.q_sh + g * D + lane * EPL + e]) * scale
          : 0.f;
    }
  }
  float acc[MAX_G];
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) acc[g] = 0.f;
  if (tid < MAX_G) {
    s_m[tid] = NEG;
    s_l[tid] = 0.f;
  }

  const int s0 = split * a.chunk;
  const int s1 = min(S, s0 + a.chunk);
  for (int t0 = s0; t0 < s1; t0 += TK) {
    // scores: one warp per key, lanes split D, butterfly sum
    for (int j = warp; j < TK; j += NWARP) {
      const int s = t0 + j;
      int ok = 0;
      if (s < s1) {
        const int kp = a.kv_pos[b * S + s];
        ok = kp >= 0 && kp <= qp && (a.window <= 0 || qp - kp < a.window);
      }
      float dot[MAX_G];
#pragma unroll
      for (int g = 0; g < MAX_G; ++g) dot[g] = 0.f;
      if (ok) {  // uniform across the warp
        const T* kr = k + kv_base + s * a.k_ss + lane * EPL;
        float kf[EPL];
#pragma unroll
        for (int e = 0; e < EPL; ++e) kf[e] = to_f(kr[e]);
#pragma unroll
        for (int g = 0; g < MAX_G; ++g) {
#pragma unroll
          for (int e = 0; e < EPL; ++e) dot[g] += qreg[g][e] * kf[e];
        }
#pragma unroll
        for (int g = 0; g < MAX_G; ++g) {
          if (g < G) {
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
              dot[g] += __shfl_xor_sync(FULL, dot[g], off);
          }
        }
      }
      if (lane == 0) {
        s_ok[j] = ok;
#pragma unroll
        for (int g = 0; g < MAX_G; ++g)
          if (g < G) s_p[g][j] = ok ? dot[g] : NEG;
      }
    }
    __syncthreads();

    // online softmax update, one warp per query head
    for (int g = warp; g < G; g += NWARP) {
      float mx = NEG;
      for (int j = lane; j < TK; j += 32) mx = fmaxf(mx, s_p[g][j]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
      const float m_prev = s_m[g];
      const float m_next = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < TK; j += 32) {
        const float p = s_ok[j] ? expf(s_p[g][j] - m_next) : 0.f;
        s_p[g][j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(FULL, sum, off);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_prev - m_next);
        s_alpha[g] = alpha;
        s_l[g] = s_l[g] * alpha + sum;
        s_m[g] = m_next;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P.V, one output column per thread
#pragma unroll
    for (int g = 0; g < MAX_G; ++g)
      if (g < G) acc[g] *= s_alpha[g];
    for (int j = kpart; j < TK; j += KP) {
      if (!s_ok[j]) continue;  // p == 0: the row is never loaded
      const float vv = to_f(v[kv_base + (t0 + j) * a.k_ss + d]);
#pragma unroll
      for (int g = 0; g < MAX_G; ++g)
        if (g < G) acc[g] += s_p[g][j] * vv;
    }
    __syncthreads();
  }

  if (KP > 1) {
#pragma unroll
    for (int g = 0; g < MAX_G; ++g)
      if (g < G) s_red[kpart][g][d] = acc[g];
    __syncthreads();
    if (kpart == 0) {
#pragma unroll
      for (int g = 0; g < MAX_G; ++g) {
        float t = 0.f;
        for (int p = 0; p < KP; ++p) t += g < G ? s_red[p][g][d] : 0.f;
        acc[g] = t;
      }
    }
  }
  const long long row = (static_cast<long long>(b) * a.Hkv + h) * a.n_split + split;
  if (kpart == 0) {
#pragma unroll
    for (int g = 0; g < MAX_G; ++g)
      if (g < G) a.ws_acc[(row * G + g) * D + d] = acc[g];
  }
  if (tid < G) {
    a.ws_ml[(row * G + tid) * 2 + 0] = s_m[tid];
    a.ws_ml[(row * G + tid) * 2 + 1] = s_l[tid];
  }
}

// Pass 2: one block per (query head in group, kv head, batch) combines the
// splits' partial softmax states and writes the normalised output row.
template <typename T, int D>
__global__ void __launch_bounds__(D) decode_combine_kernel(DecodeArgs a) {
  const int g = blockIdx.x, h = blockIdx.y, b = blockIdx.z, d = threadIdx.x;
  const int G = a.G;
  const long long base = (static_cast<long long>(b) * a.Hkv + h) * a.n_split;
  float M = NEG;
  for (int s = 0; s < a.n_split; ++s)
    M = fmaxf(M, a.ws_ml[((base + s) * G + g) * 2]);
  float L = 0.f, o = 0.f;
  for (int s = 0; s < a.n_split; ++s) {
    const float w = expf(a.ws_ml[((base + s) * G + g) * 2] - M);
    L += a.ws_ml[((base + s) * G + g) * 2 + 1] * w;
    o += a.ws_acc[((base + s) * G + g) * D + d] * w;
  }
  T* out = static_cast<T*>(a.out);
  out[b * a.q_sb + h * a.q_sh + g * D + d] = from_f<T>(o / (L == 0.f ? 1.f : L));
}

template <typename T, int D>
cudaError_t launch(const DecodeArgs& a, cudaStream_t stream) {
  decode_split_kernel<T, D><<<dim3(a.n_split, a.Hkv, a.B), NT, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<T, D><<<dim3(a.G, a.Hkv, a.B), D, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  D must be 64 or 128, G at most 8.
// Returns a cudaError_t (0 on success); the Python wrapper raises on any
// other value.
extern "C" int decode_attention_launch(
    int dtype, int D, const void* q, const void* k, const void* v,
    const void* kv_pos, const void* q_pos, void* out, void* ws_acc,
    void* ws_ml, int B, int Hkv, int G, int S, int q_sb, int q_sh, int k_sb,
    int k_sh, int k_ss, int window, int n_split, int chunk, void* stream) {
  if (G < 1 || G > MAX_G || (D != 64 && D != 128) || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  DecodeArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.kv_pos = static_cast<const int*>(kv_pos);
  a.q_pos = static_cast<const int*>(q_pos);
  a.out = out;
  a.ws_acc = static_cast<float*>(ws_acc);
  a.ws_ml = static_cast<float*>(ws_ml);
  a.B = B;
  a.Hkv = Hkv;
  a.G = G;
  a.S = S;
  a.window = window;
  a.n_split = n_split;
  a.chunk = chunk;
  a.q_sb = q_sb;
  a.q_sh = q_sh;
  a.k_sb = k_sb;
  a.k_sh = k_sh;
  a.k_ss = k_ss;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = D == 64 ? launch<float, 64>(a, st) : launch<float, 128>(a, st);
  else
    err = D == 64 ? launch<__nv_bfloat16, 64>(a, st)
                  : launch<__nv_bfloat16, 128>(a, st);
  return static_cast<int>(err);
}
