// Blockwise causal / sliding-window GQA flash attention (prefill).
//
// Replaces the TPU kernels src/repro/kernels/flash_attention.py::
// flash_attention_bhsd (generic: head-major q (B, Hq, Sq, D) and k/v
// (B, Hkv, Sk, D)), ::flash_attention_merged_bsd (the paper's merged
// prefill fast path: the RoPE'd residual stream viewed (B, Sq, Hq, D) is
// the query and K*/V* are read in their native (B, Sk, Hkv, D) layout) and
// ::flash_attention_merged_q8_bsd (the merged path over int8 K*/V* with
// one float32 scale per (page of sg rows, kv head), scales
// (B, Sk / sg, Hkv): the in-flight sequence at the paged_q8 pool's
// quantization).  The layouts differ only in strides, and the q8 variant
// only in how a K/V tile is widened and scaled.  The output is written in
// the query's layout and type.
//
// Semantics kept from the TPU kernel: positions are arange (row i of q is
// position i, column j of k is position j); a pair is attendable iff
// (not causal or j <= i) and (window == 0 or i - j < window); masked
// scores go to NEG before the row max and their probabilities are then
// zeroed; a row with nothing to attend to is exactly 0; ragged Sq / Sk
// tails are masked in the kernel, so any prompt length runs at full tile
// size; GQA maps query head h to kv head h / (Hq / Hkv).  Key column j of
// the q8 variant is worth float(int8) * scale[b, j / sg, h] in float32, as
// the TPU kernel's dequant gives; each key finds its own page's scale, so
// a tile need not align to pages.
//
// What bounds it on an H100: operations at long prompts (4 * D flops per
// attendable pair per query head: 989 TFLOP/s in bf16), the Q/K/V bytes at
// short ones.  Tiles wholly outside the causal / window band are never
// loaded or computed (the TPU kernel's block skip).  Two bodies, chosen at
// compile time by the element type:
//
//   * bfloat16: tensor cores.  A warpgroup (128 threads) owns 64 query
//     rows of one head.  S = Q K^T and O += P V run as wgmma.mma_async on
//     bf16 operands with float32 accumulators: Q is held in registers as
//     the A operand of Q K^T, each K tile is the K-major B operand, V the
//     MN-major one (wgmma's transpose bit), and P goes from the S
//     accumulators to bf16 registers as the A operand of P V.  K/V tiles of
//     64 keys are laid out in the 128-byte swizzle the wgmma descriptors
//     name (one 64-column atom per 64 of D) and fetched with 16-byte
//     cp.async copies into a ring of three stages, two steps ahead; rows
//     past Sk are zero-filled.  A software pipeline keeps the tensor cores
//     fed: step t starts S_t = Q K_t and then P_{t-1} V_{t-1}, and runs the
//     online softmax of S_t (row max, sum, rescale on the accumulator
//     fragment, quad shuffles, ex2 on pre-scaled scores) while
//     P_{t-1} V_{t-1} is on the tensor cores; O is rescaled while S_t
//     runs.  Only tiles that cross the band's edge or the Sk tail build a
//     mask.  The q tiles with the most keys are launched first.  When the
//     grid still fills the card, a block pairs two query heads of one kv
//     group (two warpgroups) so that each K/V tile is loaded once for both.
//     q8: the int8 tiles land in two staging slots by cp.async and are
//     widened to bf16 in shared memory (int8 values are exact in bf16);
//     the k scale multiplies score column j and the v scale probability
//     column j in float32, so no float copy of K/V exists in device
//     memory, and a scale is read only for keys that some row of the tile
//     may attend.  P is rounded to bf16 before P V, as the tensor cores
//     need.  Still open at long prompts, where it stays below SDPA's rate
//     (PERF.md): a TMA producer warp, ping-pong scheduling of two consumer
//     warpgroups, a persistent grid.
//     Head dim 80 (HuBERT-XLarge: 1280 / 16 heads) is not a whole number of
//     64-column swizzle atoms.  Its K/V tiles are laid out as D 128 (two
//     atoms, columns 80..127 never written): Q K^T runs the five 16-column
//     k blocks it needs, all inside the swizzle pattern D 128 uses, and
//     P V runs at N 128, whose output columns 80..127 (fed by the unwritten
//     V columns) are dropped.  The waste: 48 of every 128 P V columns
//     (1.3x the tensor work of Q K^T + P V at D 80) and 37.5% of each
//     K/V tile's shared memory.
//   * float32: plain FMA in float32 (wgmma would take float32 as TF32,
//     about three decimal digits).  One block per 32 query rows walks kv
//     tiles of 64 held as float32 in shared memory (q8: dequantized on the
//     way in); each thread owns a 2 x 4 score and a 2 x D/16 output
//     micro-tile, and the row max / sum reduce over 16 lanes by shuffles.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr float NEG = -1e30f;
constexpr int BQ = 32;  // query rows per block
constexpr int BK = 64;  // keys per tile
constexpr int NT = 256;  // threads per block: 16 row pairs x 16 lanes
constexpr unsigned FULL = 0xffffffffu;

// the FMA body's element conversions (it is instantiated for float32 only)
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

struct FlashArgs {
  const void* q;  // element (b, i, h, d) at b*q_sb + i*q_ss + h*q_sh + d
  const void* k;  // element (b, j, h, d) at b*k_sb + j*k_ss + h*k_sh + d
  const void* v;  // same strides as k
  void* out;  // same strides as q
  // q8: (B, n_sg, Hkv); key j of batch b and kv head h dequantizes with
  // scale[(b * n_sg + j / sg) * Hkv + h]
  const float* k_scale;
  const float* v_scale;
  int Hq, Hkv, Sq, Sk, causal, window, sg, n_sg;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh;
};

template <int D>
constexpr int smem_floats() {
  return BQ * (D + 1) + D * (BK + 1) + BK * D + BQ * (BK + 1);
}

template <typename T, typename KV, int D>
__global__ void __launch_bounds__(NT) flash_kernel(FlashArgs a) {
  constexpr bool Q8 = std::is_same<KV, int8_t>::value;
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
  const KV* k = static_cast<const KV*>(a.k);
  const KV* v = static_cast<const KV*>(a.v);
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
        if constexpr (Q8) {
          const long long si =
              (static_cast<long long>(b) * a.n_sg + col / a.sg) * a.Hkv + hk;
          kx = to_f(k[off]) * a.k_scale[si];
          vx = to_f(v[off]) * a.v_scale[si];
        } else {
          kx = to_f(k[off]);
          vx = to_f(v[off]);
        }
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

template <typename T, typename KV, int D>
cudaError_t launch(const FlashArgs& a, int B, cudaStream_t stream) {
  const int bytes = smem_floats<D>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, KV, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + BQ - 1) / BQ, a.Hq, B);
  flash_kernel<T, KV, D><<<grid, NT, bytes, stream>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16 body: wgmma tiles fed by a cp.async ring
// ---------------------------------------------------------------------------

constexpr int WQ = 64;  // query rows per block: a warpgroup's wgmma M
constexpr int WK = 64;  // keys per tile
constexpr int WT = 128;  // threads per warpgroup
constexpr int ATOM = WQ * 128;  // bytes of 64 rows x 64 bf16 columns
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk c (8 bf16 columns) of row r in a 64-row
// tile in wgmma's 128-byte swizzle: 64-column atoms of 64 rows x 128 B
// side by side, the chunk index XORed with the row's index mod 8.
__device__ __forceinline__ int swz(int r, int c) {
  return (c >> 3) * ATOM + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// 16 bytes global -> shared, zero-filled when !valid (src is then not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// make generic-proxy writes to shared memory (cp.async, st.shared) visible
// to wgmma's async-proxy reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets, all in 16-byte units.  The K-major K
// tile: the stride offset is 1024 B, 8 rows of 128 B (the leading offset
// is not read).  The MN-major V tile: leading offset = one 64-column atom
// of D, stride offset = 8 keys of 128 B.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// 2^x on the special-function unit (flushes denormals to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
// keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma that owns the registers
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// m64nNk16, f32 += bf16 x bf16, A from registers (the m16n8k16 A fragment
// of each warp's 16 rows), B from shared memory: K-major (Q K^T; scale_d
// == 0 overwrites d) or MN-major, i.e. transposed (P V; d accumulated).
// Thread (warp w, lane 4g + t) holds d[4i + 2h + e] = C[16w + g + 8h]
// [8i + 2t + e].
__device__ __forceinline__ void wgmma_rs_n64_kmajor(float (&d)[32],
                                                     const uint32_t (&a)[4],
                                                     uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&x);
}

// Columns of a bf16 K/V tile in shared memory: D rounded up to whole
// 64-column swizzle atoms (D 80 is laid out as D 128)
__host__ __device__ constexpr int tile_cols(int D) {
  return (D + 63) / 64 * 64;
}

// Shared memory of the bf16 body: NS stages of K and V tiles (bf16,
// swizzled), plus for q8 two int8 staging slots each for K and V and the
// tile's 64 k and 64 v scales; 1024 B of slack align the tiles to the
// swizzle pattern.  (Q lives in registers.)
template <bool Q8, int D>
constexpr int wg_smem_bytes() {
  return 1024 + 2 * (Q8 ? 1 : 3) * WQ * tile_cols(D) * 2 +
         (Q8 ? 4 * WK * D + 2 * WK * 4 : 0);
}

// NWG warpgroups per block, one per query head: NWG = 2 pairs two heads of
// one kv group, which then share every K/V tile (half the K/V traffic)
template <typename KV, int D, int NWG>
__global__ void __launch_bounds__(NWG * WT) flash_wgmma_kernel(FlashArgs a) {
  using T = __nv_bfloat16;
  constexpr bool Q8 = std::is_same<KV, int8_t>::value;
  // stages of the bf16 K/V tiles: fp tiles land by cp.async two steps
  // ahead; q8 tiles land in two staging slots and are widened just before
  // their step
  constexpr int NS = Q8 ? 1 : 3;
  constexpr int DS = tile_cols(D);  // columns of a tile in shared memory
  constexpr int TILE = WQ * DS * 2;  // bytes of a 64 x DS bf16 tile
  constexpr int CH = D / 8;  // 16-byte chunks in a bf16 row
  constexpr int CH8 = D / 16;  // 16-byte chunks in an int8 row
  constexpr int NO = DS / 2;  // output accumulators per thread (P V at N DS)
  constexpr int NTH = NWG * WT;  // threads per block
  static_assert(WT == 2 * WK, "one thread per k or v scale of a tile");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sK =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* sV = sK + NS * TILE;
  int8_t* sK8 = reinterpret_cast<int8_t*>(sV + NS * TILE);  // q8 staging
  int8_t* sV8 = sK8 + 2 * WK * D;
  float* sKs = reinterpret_cast<float*>(sV8 + 2 * WK * D);
  float* sVs = sKs + WK;

  const int tid = threadIdx.x;
  const int h = blockIdx.x * NWG + tid / WT, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * WQ;  // most keys first
  const int hk = h / (a.Hq / a.Hkv);  // the same for the block's heads
  const int warp = (tid % WT) >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = q0 + 16 * warp + g;  // this thread's rows: row0, row0 + 8
  const T* q = static_cast<const T*>(a.q);
  const KV* k = static_cast<const KV*>(a.k);
  const KV* v = static_cast<const KV*>(a.v);
  const long long q_base = b * a.q_sb + h * a.q_sh;
  const long long kv_base = b * a.k_sb + hk * a.k_sh;
  const float sc = LOG2E / sqrtf(static_cast<float>(D));  // exp -> exp2

  // the kv band this q tile can see
  const int rlast = min(q0 + WQ, a.Sq) - 1;
  int kend = a.Sk;
  if (a.causal) kend = min(kend, rlast + 1);
  int kbeg = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  kbeg = (kbeg / WK) * WK;
  const int nt = kend > kbeg ? (kend - kbeg + WK - 1) / WK : 0;

  // tile `it` of K or V: into bf16 stage it % NS, or into int8 staging
  // slot g % 2 of the load group g it travels in (K_t: g = t, V_t: t + 1)
  auto load_kv = [&](const KV* src, int it, bool is_v) {
    const int k0 = kbeg + it * WK;
    if constexpr (Q8) {
      int8_t* dst = (is_v ? sV8 : sK8) + ((it + is_v) & 1) * WK * D;
      for (int i = tid; i < WK * CH8; i += NTH) {
        const int r = i / CH8, c = i % CH8, col = k0 + r;
        const bool ok = col < a.Sk;
        cp_async16(smem_addr(dst + r * D + c * 16),
                   src + kv_base + static_cast<long long>(ok ? col : 0) *
                   a.k_ss + c * 16, ok);
      }
    } else {
      const uint32_t dst = smem_addr((is_v ? sV : sK) + (it % NS) * TILE);
      for (int i = tid; i < WK * CH; i += NTH) {
        const int r = i / CH, c = i % CH, col = k0 + r;
        const bool ok = col < a.Sk;
        cp_async16(dst + swz(r, c),
                   src + kv_base + static_cast<long long>(ok ? col : 0) *
                   a.k_ss + c * 8, ok);
      }
    }
  };
  // q8: widen the int8 tile in staging slot `slot` into the bf16 K or V
  // tile
  auto widen = [&](int slot, bool is_v) {
    const int8_t* src = (is_v ? sV8 : sK8) + slot * WK * D;
    unsigned char* dst = is_v ? sV : sK;
    for (int i = tid; i < WK * CH8; i += NTH) {
      const int r = i / CH8, c = i % CH8;
      const int4 raw = *reinterpret_cast<const int4*>(src + r * D + c * 16);
      const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
      uint32_t w[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) w[j] = pack_bf16(e[2 * j], e[2 * j + 1]);
      *reinterpret_cast<uint4*>(dst + swz(r, 2 * c)) =
          make_uint4(w[0], w[1], w[2], w[3]);
      *reinterpret_cast<uint4*>(dst + swz(r, 2 * c + 1)) =
          make_uint4(w[4], w[5], w[6], w[7]);
    }
  };
  // q8: the tile's k and v scales, read only for keys that some row of this
  // q tile may attend (0 for the others, whose columns are masked anyway)
  auto load_scales = [&](int k0) {
    if (tid >= 2 * WK) return;
    const int j = tid % WK, col = k0 + j;
    const bool is_v = tid >= WK;
    const bool seen = col < a.Sk && (!a.causal || col <= rlast) &&
                      (a.window <= 0 || q0 - col < a.window);
    float s = 0.f;
    if (seen)
      s = (is_v ? a.v_scale : a.k_scale)[(static_cast<long long>(b) * a.n_sg +
                                           col / a.sg) * a.Hkv + hk];
    (is_v ? sVs : sKs)[j] = s;
  };

  // Software pipeline over the nt tiles (Q K_t and P_{t-1} V_{t-1} on the
  // tensor cores while the softmax of S_t runs), Q in registers as the A
  // operand of Q K^T.  cp.async group g_t = {K_t, V_{t-1}} lands two steps
  // after it is requested.  Step t:
  //   1. wait for g_t; q8: widen it to bf16; fence to the async proxy;
  //      barrier;
  //   2. start S_t = Q K_t; O *= alpha_{t-1} meanwhile; start
  //      O += P_{t-1} V_{t-1};
  //   3. prefetch g_{t+2} = {K_{t+2}, V_{t+1}} into the stages that
  //      S_{t-1} and P_{t-2} V_{t-2} read (both finished in step t - 1);
  //   4. wait for S_t only; softmax -> P_t, alpha_t while P_{t-1} V_{t-1}
  //      runs; wait for it.
  // Step 0 has no P V and a last step nt has only P_{nt-1} V_{nt-1}; both
  // are peeled, so every wait in the loop counts the same groups.  P_t and
  // P_{t-1} live in two register sets that swap roles each step (the loop
  // runs two steps per turn): were they one, P_t would be written while
  // the tensor cores still read P_{t-1}, and ptxas would serialize.
  if (nt > 0) load_kv(k, 0, false);
  cp_commit();
  if (nt > 1) load_kv(k, 1, false);
  if (nt > 0) load_kv(v, 0, true);
  cp_commit();
  // Q's m16n8k16 A fragments, k block kk: rows g (+8), columns 16 kk + 2 t4
  // (+8); rows past Sq are 0
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = row0 + 8 * (r & 1);
      qa[kk][r] = row < a.Sq ? *reinterpret_cast<const uint32_t*>(
                                   q + q_base + static_cast<long long>(row) *
                                   a.q_ss + 16 * kk + 8 * (r >> 1) + 2 * t4)
                             : 0u;
    }

  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};  // l: this thread's columns
  float s[32], alpha[2];
  uint32_t pa[4][4], pb[4][4];  // P as the A operand of the P V product

  // step 1
  auto land = [&](int t) {
    cp_wait<1>();
    if constexpr (Q8) {
      __syncthreads();
      if (t < nt) {
        widen(t & 1, false);
        load_scales(kbeg + t * WK);
      }
      if (t > 0) widen(t & 1, true);
    }
    fence_async_smem();
    __syncthreads();
  };
  auto prefetch = [&](int t) {  // step 3
    if (t + 2 < nt) load_kv(k, t + 2, false);
    if (t + 1 < nt) load_kv(v, t + 1, true);
    cp_commit();
  };
  auto rescale = [&] {
    reg_fence(o);
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] *= alpha[(i >> 1) & 1];
  };
  auto start_s = [&](int t) {  // S_t = Q K_t
#pragma unroll
    for (int j = 0; j < 32; ++j) s[j] = 0.f;
    const uint32_t aK = smem_addr(sK + (t % NS) * TILE);
    reg_fence(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk >> 2) * ATOM + (kk & 3) * 32;
      wgmma_rs_n64_kmajor(s, qa[kk], desc(aK + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
  };
  // O += P_t V_t (V MN-major: 16 keys = 2 KB)
  auto start_pv = [&](int t, const uint32_t(&p)[4][4]) {
    const uint32_t aV = smem_addr(sV + (t % NS) * TILE);
    reg_fence(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dv = desc(aV + kk * 2048, ATOM, 1024);
      if constexpr (DS == 64)
        wgmma_rs_n64(o, p[kk], dv);
      else
        wgmma_rs_n128(o, p[kk], dv);
    }
    wgmma_commit();
  };
  // online softmax of S_t on the accumulator fragment -> P_t in p (as the
  // A operand: key block kk's m16n8k16 fragment is the S accumulators of
  // column blocks 2kk and 2kk + 1) and alpha.  m is kept in the log2
  // domain (scores times sc); a masked score is NEG before the max and
  // its probability 0.
  auto softmax = [&](int t, uint32_t(&p)[4][4]) {
    const int k0 = kbeg + t * WK;
    const bool edge = k0 + WK > a.Sk || (a.causal && k0 + WK - 1 > q0) ||
                      (a.window > 0 && rlast - k0 >= a.window);
    uint32_t okm = 0xffffffffu;
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int c = 8 * (j >> 2) + 2 * t4 + (j & 1), hh = (j >> 1) & 1;
      float x = s[j];
      if constexpr (Q8) x *= sKs[c];
      if (edge) {
        const int row = row0 + 8 * hh, col = k0 + c;
        const bool ok = col < a.Sk && (!a.causal || col <= row) &&
                        (a.window <= 0 || row - col < a.window);
        if (!ok) {
          x = NEG;
          okm &= ~(1u << j);
        }
      }
      s[j] = x;
      mx[hh] = fmaxf(mx[hh], x);
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(FULL, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(FULL, mx[hh], 2));
      const float m_next = fmaxf(m[hh], mx[hh] * sc);
      alpha[hh] = ex2(m[hh] - m_next);
      m[hh] = m_next;
      l[hh] *= alpha[hh];
    }
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int hh = (j >> 1) & 1;
      float p = (okm >> j) & 1u ? ex2(fmaf(s[j], sc, -m[hh])) : 0.f;
      l[hh] += p;
      if constexpr (Q8) p *= sVs[8 * (j >> 2) + 2 * t4 + (j & 1)];
      s[j] = p;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        p[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
  };
  // step t of the loop: P_{t-1} in pv, P_t into pn
  auto step = [&](int t, const uint32_t(&pv)[4][4], uint32_t(&pn)[4][4]) {
    land(t);
    start_s(t);
    rescale();  // by alpha_{t-1}, while S_t runs
    start_pv(t - 1, pv);
    prefetch(t);
    wgmma_wait<1>();
    reg_fence(s);
    softmax(t, pn);
    wgmma_wait<0>();
    reg_fence(o);
  };

  if (nt > 0) {
    land(0);
    start_s(0);
    prefetch(0);
    wgmma_wait<0>();
    reg_fence(s);
    softmax(0, pa);  // O is still 0: no rescale
    int t = 1;
    for (; t + 1 < nt; t += 2) {
      step(t, pa, pb);
      step(t + 1, pb, pa);
    }
    if (t < nt) {
      step(t, pa, pb);
      land(nt);
      rescale();
      start_pv(nt - 1, pb);
    } else {
      land(nt);
      rescale();
      start_pv(nt - 1, pa);
    }
    wgmma_wait<0>();
    reg_fence(o);
  }
  cp_wait<0>();

  T* out = static_cast<T*>(a.out);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(FULL, l[hh], 1);
    l[hh] += __shfl_xor_sync(FULL, l[hh], 2);
    const int row = row0 + 8 * hh;
    if (row < a.Sq) {
      const float inv = l[hh] > 0.f ? 1.f / l[hh] : 0.f;
      T* dst = out + q_base + static_cast<long long>(row) * a.q_ss;
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
        *reinterpret_cast<uint32_t*>(dst + 8 * i + 2 * t4) = pack_bf16(
            o[4 * i + 2 * hh] * inv, o[4 * i + 2 * hh + 1] * inv);
    }
  }
}

template <typename KV, int D, int NWG>
cudaError_t launch_wgmma_nwg(const FlashArgs& a, int B, cudaStream_t stream) {
  constexpr int bytes = wg_smem_bytes<std::is_same<KV, int8_t>::value, D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_kernel<KV, D, NWG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.Hq / NWG, B, (a.Sq + WQ - 1) / WQ);
  flash_wgmma_kernel<KV, D, NWG><<<grid, NWG * WT, bytes, stream>>>(a);
  return cudaGetLastError();
}

// Pair the query heads of a kv group (even group size) when the paired grid
// still fills the card: sharing K/V tiles halves their traffic from L2,
// which bounds long prompts; short prompts keep one head a block, for
// blocks on more SMs.
template <typename KV, int D>
cudaError_t launch_wgmma(const FlashArgs& a, int B, cudaStream_t stream) {
  const long long paired = static_cast<long long>(a.Hq / 2) * B *
                           ((a.Sq + WQ - 1) / WQ);
  if ((a.Hq / a.Hkv) % 2 == 0 && paired >= 132)
    return launch_wgmma_nwg<KV, D, 2>(a, B, stream);
  return launch_wgmma_nwg<KV, D, 1>(a, B, stream);
}

// K/V element type: the query's, or int8 for the q8 variant
template <typename T, bool Q8>
using KVOf = typename std::conditional<Q8, int8_t, T>::type;

template <bool Q8>
int flash(int dtype, int D, const void* q, const void* k, const void* v,
          const void* k_scale, const void* v_scale, void* out, int B, int Hq,
          int Hkv, int Sq, int Sk, int q_sb, int q_ss, int q_sh, int k_sb,
          int k_ss, int k_sh, int causal, int window, int sg, void* stream) {
  if ((D != 64 && D != 80 && D != 128) || (dtype != 0 && dtype != 1) ||
      Hkv < 1 ||
      Hq % Hkv != 0 || (Q8 && (sg < 1 || Sk % sg != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  // the bf16 body moves 16-byte chunks: pointers 16-byte aligned, strides a
  // whole number of chunks (8 bf16 or 16 int8 elements)
  const int kq = Q8 ? 16 : 8;
  if (dtype == 1 &&
      (((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) &
        15) != 0 ||
       (q_sb | q_ss | q_sh) % 8 != 0 || (k_sb | k_ss | k_sh) % kq != 0))
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (Sq == 0 || B == 0) return static_cast<int>(cudaSuccess);
  FlashArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = out;
  a.k_scale = static_cast<const float*>(k_scale);
  a.v_scale = static_cast<const float*>(v_scale);
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.Sq = Sq;
  a.Sk = Sk;
  a.causal = causal;
  a.window = window;
  a.sg = sg;
  a.n_sg = Q8 ? Sk / sg : 0;
  a.q_sb = q_sb;
  a.q_ss = q_ss;
  a.q_sh = q_sh;
  a.k_sb = k_sb;
  a.k_ss = k_ss;
  a.k_sh = k_sh;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using F = float;
  using H = __nv_bfloat16;
  cudaError_t err;
  if (dtype == 0)
    err = D == 64   ? launch<F, KVOf<F, Q8>, 64>(a, B, st)
          : D == 80 ? launch<F, KVOf<F, Q8>, 80>(a, B, st)
                    : launch<F, KVOf<F, Q8>, 128>(a, B, st);
  else
    err = D == 64   ? launch_wgmma<KVOf<H, Q8>, 64>(a, B, st)
          : D == 80 ? launch_wgmma<KVOf<H, Q8>, 80>(a, B, st)
                    : launch_wgmma<KVOf<H, Q8>, 128>(a, B, st);
  return static_cast<int>(err);
}

}  // namespace

// dtype: 0 = float32 (the FMA body), 1 = bfloat16 (the wgmma body); the
// query's and the output's type, K/V share it or are int8 for the q8
// variant.  D must be 64, 80 or 128; the bf16 body also needs 16-byte aligned
// pointers and strides.  Strides are in elements; the output takes the
// query's.  Returns a cudaError_t (0 on success); the Python wrapper
// raises on any other value.
extern "C" int flash_attention_launch(
    int dtype, int D, const void* q, const void* k, const void* v, void* out,
    int B, int Hq, int Hkv, int Sq, int Sk, int q_sb, int q_ss, int q_sh,
    int k_sb, int k_ss, int k_sh, int causal, int window, void* stream) {
  return flash<false>(dtype, D, q, k, v, nullptr, nullptr, out, B, Hq, Hkv,
                      Sq, Sk, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, causal,
                      window, 1, stream);
}

// q8: int8 K/V, float32 scales (B, Sk / sg, Hkv); sg divides Sk.
extern "C" int flash_attention_q8_launch(
    int dtype, int D, const void* q, const void* k, const void* v,
    const void* k_scale, const void* v_scale, void* out, int B, int Hq,
    int Hkv, int Sq, int Sk, int q_sb, int q_ss, int q_sh, int k_sb, int k_ss,
    int k_sh, int causal, int window, int sg, void* stream) {
  return flash<true>(dtype, D, q, k, v, k_scale, v_scale, out, B, Hq, Hkv, Sq,
                     Sk, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, causal, window,
                     sg, stream);
}
