// One-token GQA decode attention against a position-tagged KV cache, a
// paged KV pool, or an int8 paged pool.
//
// Replaces six TPU kernels of src/repro/kernels/decode_attention.py:
//   * decode_attention_bhsd (generic: grouped query (B, Hkv, G, D),
//     head-major cache (B, Hkv, S, D));
//   * decode_attention_merged_bsd (the paper's merged fast path: the RoPE'd
//     residual stream (B, Hq, D) is the query and K*/V* are read in the
//     serving cache's native (B, S, Hkv, D) layout);
//   * decode_attention_paged_bhsd and decode_attention_paged_merged_bsd
//     (the same two queries over a pool of pages (NB, bs, Hkv, D) behind a
//     block table (B, MB): logical key s of slot b lives on page
//     bt[b, s / bs] at row s % bs);
//   * decode_attention_paged_q8_bhsd and decode_attention_paged_q8_merged_bsd
//     (the paged pair over int8 pages with one float32 scale per (page, kv
//     head), scales (NB, Hkv)).
// One CUDA body serves all six, specialised at compile time by the
// ``Paged`` flag and the K/V element type ``KV`` (the query's type, or
// int8_t for the q8 pool): the dense layouts differ only in strides, the
// paged layout only in how a key's row address and position are found
// (``kv_row``), and the q8 pool only in the dequant where a row is loaded.
//
// Semantics kept from the TPU kernels: a key is attendable iff its
// position p satisfies p >= 0, p <= q_pos and (window == 0 or
// q_pos - p < window); masked scores go to NEG before the row max and their
// probabilities are then zeroed; a row with nothing to attend to
// (denominator 0) is exactly 0.  Dense positions are read from kv_pos
// (B, S).  Paged positions are computed here from the table and q_pos, as
// the TPU kernel's _paged_kpos does: absolute addressing (ring == 0) puts
// table slot j at block j; ring addressing (a windowed table of exactly
// ring slots, src/repro/kernels/paging.py) puts slot j at absolute block
// b = lb - ((lb + ring - j) % ring), lb = q_pos / bs, masked when b < 0.
// Offsets of the current block beyond q_pos are hidden by the causal mask.
// The q8 pool is dequantized as float(int8) * scale[page, h] in float32,
// as the TPU kernels do.
//
// What bounds it on an H100: bytes.  Each step reads every attendable K/V
// row once (2 * rows * Hkv * D elements: 2 or 4 bytes each, 1 byte on the
// q8 pool plus two 4-byte scales per attended page and head) and does
// 4 * G * D flops per row and kv head, far below the ~295 flop/byte ridge.
// What the design does about it:
//   * one block per (batch, kv head, kv split) loads each K/V row ONCE for
//     all G query heads that share that kv head;
//   * the kv axis (S, or MB * bs for a table) is split over blocks
//     (flash-decoding) so B * Hkv * splits blocks fill the 132 SMs at B = 4;
//     a second pass combines the partial (m, l, acc) of the splits.  The
//     TPU walks the kv axis sequentially inside one grid row, which on this
//     card would leave most SMs idle;
//   * keys that are masked (empty, future, out of window) or that lie on an
//     unmapped table entry (-1) are never loaded: only the position array
//     or the table entry is read for them, and on the q8 pool neither is
//     the page's scale.  (The TPU kernels load page max(bt, 0) and its
//     scale for an unmapped entry and mask it.)  Pages are gathered row by
//     row in the native (..., Hkv, D) layout, each warp reading one head
//     row (128 or 256 bytes; 64 or 128 on the q8 pool);
//   * the q8 pool's rows go from device memory straight into registers and
//     are dequantized there: no float copy of the pool exists.
// Plain FMA arithmetic in float32, whatever the input type (bf16 or f32).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr float NEG = -1e30f;
constexpr int NT = 128;  // threads per block
constexpr int NWARP = NT / 32;
constexpr int TK = 64;  // keys per tile
constexpr int MAX_G = 8;  // query heads per kv head
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct DecodeArgs {
  const void* q;  // element (b, h, g, d) at b*q_sb + h*q_sh + g*D + d
  // dense: element (b, h, s, d) at b*k_sb + h*k_sh + s*k_ss + d;
  // paged: element (page, r, h, d) at page*k_sb + r*k_ss + h*k_sh + d
  const void* k;
  const void* v;  // same strides as k
  const int* kv_pos;  // dense: (B, S) positions, -1 empty
  const int* bt;  // paged: (B, MB) block table, -1 unmapped
  const float* k_scale;  // paged q8: (NB, Hkv) scale of each page and head
  const float* v_scale;
  const int* q_pos;  // (B,)
  void* out;  // same strides as q
  float* ws_acc;  // (B, Hkv, n_split, G, D) unnormalised partial outputs
  float* ws_ml;  // (B, Hkv, n_split, G, 2) partial row max and sum
  int B, Hkv, G, S, window, n_split, chunk;
  int MB, bs, ring;  // paged: table width, page size, ring slots (0: absolute)
  long long q_sb, q_sh, k_sb, k_sh, k_ss;
};

// Offset of key s's K/V head row for (b, h), or -1 when the key is masked
// (empty slot or unmapped entry, future position, out of window); ``page``
// is set to the key's physical page (paged only).  Uniform across a warp:
// every lane reads the same position or table entry.
template <bool Paged>
__device__ __forceinline__ long long kv_row(const DecodeArgs& a, int b, int h,
                                            int s, int qp, int& page) {
  int pos;
  long long row;
  if (Paged) {
    const int j = s / a.bs, r = s - j * a.bs;
    page = a.bt[b * a.MB + j];
    if (page < 0) return -1;
    int blk = j;
    if (a.ring > 0) {
      const int lb = qp / a.bs;
      blk = lb - (lb + a.ring - j) % a.ring;
      if (blk < 0) return -1;
    }
    pos = blk * a.bs + r;
    row = page * a.k_sb + r * a.k_ss + h * a.k_sh;
  } else {
    pos = a.kv_pos[b * a.S + s];
    if (pos < 0) return -1;
    row = b * a.k_sb + h * a.k_sh + s * a.k_ss;
  }
  const bool ok = pos <= qp && (a.window <= 0 || qp - pos < a.window);
  return ok ? row : -1;
}

// Pass 1: one block per (split, kv head, batch) runs the online softmax over
// its kv range and leaves (m, l, acc) for the G query heads in the workspace.
template <typename T, typename KV, int D, bool Paged>
__global__ void __launch_bounds__(NT) decode_split_kernel(DecodeArgs a) {
  constexpr bool Q8 = std::is_same<KV, int8_t>::value;
  constexpr int EPL = D / 32;  // elements per lane in the score pass
  constexpr int KP = NT / D;  // key partitions in the P.V pass
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int G = a.G, S = a.S;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int d = tid % D, kpart = tid / D;

  __shared__ float s_p[MAX_G][TK];  // scores, then probabilities
  __shared__ long long s_row[TK];  // kv_row of each key, -1 masked
  __shared__ float s_vs[Q8 ? TK : 1];  // q8: V scale of each key's page
  __shared__ float s_m[MAX_G], s_l[MAX_G], s_alpha[MAX_G];
  __shared__ float s_red[KP][MAX_G][D];

  const T* q = static_cast<const T*>(a.q);
  const KV* k = static_cast<const KV*>(a.k);
  const KV* v = static_cast<const KV*>(a.v);
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  const int qp = a.q_pos[b];

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
      int page = 0;
      const long long row = s < s1 ? kv_row<Paged>(a, b, h, s, qp, page) : -1;
      const bool ok = row >= 0;
      float dot[MAX_G];
#pragma unroll
      for (int g = 0; g < MAX_G; ++g) dot[g] = 0.f;
      float vsc = 1.f;
      if (ok) {  // uniform across the warp
        const KV* kr = k + row + lane * EPL;
        float kf[EPL];
        if constexpr (Q8) {  // the scales of mapped, attendable pages only
          const float ksc = a.k_scale[page * a.Hkv + h];
          vsc = a.v_scale[page * a.Hkv + h];
#pragma unroll
          for (int e = 0; e < EPL; ++e) kf[e] = to_f(kr[e]) * ksc;
        } else {
#pragma unroll
          for (int e = 0; e < EPL; ++e) kf[e] = to_f(kr[e]);
        }
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
        s_row[j] = row;
        if constexpr (Q8) s_vs[j] = vsc;
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
        const float p = s_row[j] >= 0 ? expf(s_p[g][j] - m_next) : 0.f;
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
      if (s_row[j] < 0) continue;  // p == 0: the row is never loaded
      float vv = to_f(v[s_row[j] + d]);
      if constexpr (Q8) vv *= s_vs[j];
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

template <typename T, typename KV, int D, bool Paged>
cudaError_t launch(const DecodeArgs& a, cudaStream_t stream) {
  decode_split_kernel<T, KV, D, Paged><<<dim3(a.n_split, a.Hkv, a.B), NT, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<T, D><<<dim3(a.G, a.Hkv, a.B), D, 0, stream>>>(a);
  return cudaGetLastError();
}

// K/V element type: the query's, or int8 on the q8 pool
template <typename T, bool Q8>
using KVOf = typename std::conditional<Q8, int8_t, T>::type;

template <bool Paged, bool Q8>
int dispatch(int dtype, int D, const DecodeArgs& a, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using F = float;
  using H = __nv_bfloat16;
  cudaError_t err;
  if (dtype == 0)
    err = D == 64 ? launch<F, KVOf<F, Q8>, 64, Paged>(a, st)
                  : launch<F, KVOf<F, Q8>, 128, Paged>(a, st);
  else
    err = D == 64 ? launch<H, KVOf<H, Q8>, 64, Paged>(a, st)
                  : launch<H, KVOf<H, Q8>, 128, Paged>(a, st);
  return static_cast<int>(err);
}

bool bad_common(int dtype, int D, int G) {
  return G < 1 || G > MAX_G || (D != 64 && D != 128) || (dtype != 0 && dtype != 1);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  D must be 64 or 128, G at most 8.
// Each launch function returns a cudaError_t (0 on success); the Python
// wrapper raises on any other value.

// Dense: position-tagged cache, strides as in DecodeArgs.
extern "C" int decode_attention_launch(
    int dtype, int D, const void* q, const void* k, const void* v,
    const void* kv_pos, const void* q_pos, void* out, void* ws_acc,
    void* ws_ml, int B, int Hkv, int G, int S, int q_sb, int q_sh, int k_sb,
    int k_sh, int k_ss, int window, int n_split, int chunk, void* stream) {
  if (bad_common(dtype, D, G)) return static_cast<int>(cudaErrorInvalidValue);
  DecodeArgs a = {};
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
  return dispatch<false, false>(dtype, D, a, stream);
}

namespace {

// Paged: pools (NB, bs, Hkv, D) contiguous, block table (B, MB) int32;
// ring is 0 (absolute addressing) or the table's ring size.  The q8 pool
// adds its (NB, Hkv) float32 scales.
template <bool Q8>
int paged(int dtype, int D, const void* q, const void* k_pool,
          const void* v_pool, const void* k_scale, const void* v_scale,
          const void* block_tables, const void* q_pos, void* out,
          void* ws_acc, void* ws_ml, int B, int Hkv, int G, int MB, int bs,
          int ring, int q_sb, int q_sh, int window, int n_split, int chunk,
          void* stream) {
  if (bad_common(dtype, D, G) || MB < 1 || bs < 1 || ring < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  DecodeArgs a = {};
  a.q = q;
  a.k = k_pool;
  a.v = v_pool;
  a.k_scale = static_cast<const float*>(k_scale);
  a.v_scale = static_cast<const float*>(v_scale);
  a.bt = static_cast<const int*>(block_tables);
  a.q_pos = static_cast<const int*>(q_pos);
  a.out = out;
  a.ws_acc = static_cast<float*>(ws_acc);
  a.ws_ml = static_cast<float*>(ws_ml);
  a.B = B;
  a.Hkv = Hkv;
  a.G = G;
  a.S = MB * bs;
  a.MB = MB;
  a.bs = bs;
  a.ring = ring;
  a.window = window;
  a.n_split = n_split;
  a.chunk = chunk;
  a.q_sb = q_sb;
  a.q_sh = q_sh;
  a.k_ss = static_cast<long long>(Hkv) * D;
  a.k_sh = D;
  a.k_sb = a.k_ss * bs;
  return dispatch<true, Q8>(dtype, D, a, stream);
}

}  // namespace

extern "C" int decode_attention_paged_launch(
    int dtype, int D, const void* q, const void* k_pool, const void* v_pool,
    const void* block_tables, const void* q_pos, void* out, void* ws_acc,
    void* ws_ml, int B, int Hkv, int G, int MB, int bs, int ring, int q_sb,
    int q_sh, int window, int n_split, int chunk, void* stream) {
  return paged<false>(dtype, D, q, k_pool, v_pool, nullptr, nullptr,
                      block_tables, q_pos, out, ws_acc, ws_ml, B, Hkv, G, MB,
                      bs, ring, q_sb, q_sh, window, n_split, chunk, stream);
}

// q8: int8 pools, float32 scales (NB, Hkv); dtype is the query's.
extern "C" int decode_attention_paged_q8_launch(
    int dtype, int D, const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* block_tables,
    const void* q_pos, void* out, void* ws_acc, void* ws_ml, int B, int Hkv,
    int G, int MB, int bs, int ring, int q_sb, int q_sh, int window,
    int n_split, int chunk, void* stream) {
  return paged<true>(dtype, D, q, k_pool, v_pool, k_scale, v_scale,
                     block_tables, q_pos, out, ws_acc, ws_ml, B, Hkv, G, MB,
                     bs, ring, q_sb, q_sh, window, n_split, chunk, stream);
}
