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
// One CUDA kernel serves all six, specialised at compile time by the
// ``Paged`` flag and the K/V element type ``KV`` (the query's type, or
// int8_t for the q8 pool): the dense layouts differ only in strides, the
// paged layout only in how a key's row address and position are found
// (the kernel's ``build``), and the q8 pool only in the dequant of a
// loaded row.
//
// Semantics kept from the TPU kernels: a key is attendable iff its
// position p satisfies p >= 0, p <= q_pos and (window == 0 or
// q_pos - p < window); masked scores go to NEG before the row max and their
// probabilities are zeroed; a row with nothing to attend to (denominator
// 0) is exactly 0.  Dense positions are read from kv_pos (B, S).  Paged
// positions are computed here from the table and q_pos, as the TPU
// kernel's _paged_kpos does: absolute addressing (ring == 0) puts table
// slot j at block j; ring addressing (a windowed table of exactly ring
// slots, src/repro/kernels/paging.py) puts slot j at absolute block
// b = lb - ((lb + ring - j) % ring), lb = q_pos / bs, masked when b < 0.
// Offsets of the current block beyond q_pos are hidden by the causal mask.
// The q8 pool is dequantized as float(int8) * scale[page, h] in float32,
// as the TPU kernels do.
//
// What bounds it on an H100: bytes, and at decode sizes the latency of
// reaching them.  Each step reads every attendable K/V row once
// (2 * rows * Hkv * D elements: 2 or 4 bytes each, 1 byte on the q8 pool
// plus two 4-byte scales per attended page and head) and does 4 * G * D
// flops per row and kv head, far below the ~295 flop/byte ridge, so the
// arithmetic is float32 FMA from shared memory (no tensor cores).  At
// B = 4, S = 512 the bytes take 2.5 us; a body that walks keys one
// dependent load after another takes ~20x that.  The design hides the
// latency instead:
//   * one block per (kv split, group part, kv head, batch), 128 threads,
//     loads each K/V row ONCE for the query heads of its part: a kv head's
//     G query heads are cut into ceil(G / MAX_G) parts of at most MAX_G = 8
//     consecutive heads (one part, the whole group, when G <= 8; ChatGLM3's
//     G = 16 takes two).  Each part's blocks read the kv head's K/V rows
//     themselves, so a K/V row is read once per part: a few hundred KB a
//     step at G 16, where Hkv is 2, against the extra blocks that a grid of
//     only B x Hkv (batch, kv head) pairs needs to fill the card;
//   * every load of a key tile is in flight at once.  The tile's 64 (or
//     32) positions or table entries are read with one coalesced load, the
//     row offsets and the attend mask are built in shared memory, and then
//     every attendable K and V row of the tile is copied into shared
//     memory with 16-byte cp.async.cg (L2 only: each row is read once),
//     the q8 scales of attended pages with 4-byte cp.async beside them,
//     all before any wait.  Masked keys and unmapped entries (-1) are never
//     loaded, nor is the scale of an unattended or unmapped page;
//   * a block that walks several tiles (long caches) double-buffers them:
//     tile t+1's copies and tile t+2's index load are in flight while tile
//     t computes.  A one-tile block asks for one stage of shared memory;
//   * scores and P.V read shared memory only, in float32 FMA.  A score
//     thread takes KPT = 2 keys (1 where the K tile is too small to hold
//     their partial dots) and a 1/NPART slice of D for all G heads, so
//     that each float4 of q (broadcast from shared memory) feeds both
//     keys; K rows sit in a 128-byte XOR swizzle, so the 8 rows a
//     quarter-warp reads at one chunk hit 8 distinct bank groups.  The
//     partial dots then overwrite the K tile.  A P.V thread owns two
//     adjacent output columns and walks a 1/KP share of the tile's keys
//     with independent, unrolled loads (the probabilities key-major, one
//     float4 for four heads; a masked key's V row zero-filled, so no
//     branch); the key shares are summed once, at the end, in the idle
//     ring;
//   * one launch: the kv splits of one (batch, kv head, part) form a
//     thread-block cluster (at most MAX_SPLIT blocks, the portable cluster size).  Each
//     block leaves its softmax state (m, l) and unnormalised output in its
//     own shared memory; after a cluster barrier every block combines a
//     share of the G x D outputs by reading its peers' states through
//     distributed shared memory, and writes them normalised.  No workspace,
//     no second kernel, no host decision on device data: the launch is
//     capture-safe;
//   * the partial-state mode (a launch given st_m, st_l, st_o) skips that
//     normalisation: it writes the combined softmax state of the keys it
//     was given, float32, per (batch, query head): the running max m, the
//     sum l of exp(score - m) and the unnormalised output o (D wide).  A
//     rank that holds a slice of the sequence or of the pages (a mesh
//     whose model axis splits them) launches it on its slice, and the
//     ranks' states are combined across the axis
//     (distribution.placed.combine_softmax).  Keys with nothing to attend
//     give m = NEG, l = 0, o = 0;
//   * occupancy: a stage holds the K and V tiles of TK keys, at most 32 KB
//     (TK = 32 for float32 at D = 128), and the static shared memory is
//     under 8 KB, so a block takes at most ~72 KB and three fit on an SM
//     even with two stages: the 256 blocks (32 clusters) of B = 4,
//     Hkv = 8, 8 splits are resident at once in every instantiation
//     (chip_smoke.py prints the occupancy calls' numbers).
// Plain FMA arithmetic in float32, whatever the input type (bf16 or f32).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cstdint>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr float NEG = -1e30f;
constexpr int NT = 128;  // threads per block
constexpr int NWARP = NT / 32;
constexpr int MAX_G = 8;  // query heads of one block (a part of the group)
constexpr int MAX_GROUP = 16;  // query heads per kv head a launch takes
constexpr int MAX_SPLIT = 8;  // kv splits of one (batch, kv head): a cluster
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// the 16 bytes of a K row chunk as floats
__device__ __forceinline__ void unpack(const uint4& r, float (&f)[4]) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void unpack(const uint4& r, float (&f)[8]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // bf16 -> f32 is the high half of a word
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack(const uint4& r, float (&f)[16]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    f[i] = static_cast<float>(static_cast<int8_t>(w[i / 4] >> (8 * (i % 4))));
}

// two adjacent elements of a V row in shared memory, as floats
__device__ __forceinline__ void load2(const float* p, float& a, float& b) {
  const float2 x = *reinterpret_cast<const float2*>(p);
  a = x.x;
  b = x.y;
}
__device__ __forceinline__ void load2(const __nv_bfloat16* p, float& a,
                                      float& b) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
  a = __uint_as_float(w << 16);
  b = __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ void load2(const int8_t* p, float& a, float& b) {
  const char2 x = *reinterpret_cast<const char2*>(p);
  a = static_cast<float>(x.x);
  b = static_cast<float>(x.y);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared, through L2 only; zero-filled when !valid
// (src is then not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid = true) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
// 4 bytes global -> shared (cp.async.cg takes 16-byte copies only)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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
  // partial-state mode (else null): m, l (B, Hkv, G) and o (B, Hkv, G, D),
  // float32, contiguous; out is then not written
  float* st_m;
  float* st_l;
  float* st_o;
  int B, Hkv, G, S, window, n_split, chunk;
  int n_part;  // parts of the query group: ceil(G / MAX_G)
  int MB, bs, ring;  // paged: table width, page size, ring slots (0: absolute)
  long long q_sb, q_sh, k_sb, k_sh, k_ss;
};

// Compile-time geometry of one instantiation.
template <typename KV, int D>
struct Geom {
  static constexpr int EL = sizeof(KV);
  static constexpr int ROWB = D * EL;  // bytes of a K/V head row
  // keys per tile: a stage (K and V tiles) holds at most 32 KB
  static constexpr int TK = 16384 / ROWB < 64 ? 16384 / ROWB : 64;
  static constexpr int TILEB = TK * ROWB;  // bytes of a K (or V) tile
  static constexpr int STAGEB = 2 * TILEB;
  static constexpr int EPC = 16 / EL;  // elements per 16-byte chunk
  static constexpr int CPR = D / EPC;  // chunks per row
  // keys a score thread takes: 2, so that one q load feeds both, where
  // their partial dots (NT * KPT * MAX_G floats) fit in the K tile
  static constexpr int KPT = TILEB >= NT * 2 * MAX_G * 4 ? 2 : 1;
  static constexpr int NPART = NT * KPT / TK;  // score threads per key
  static constexpr int CPP = CPR / NPART;  // chunks per score thread
  static constexpr int NCP = D / 2;  // P.V threads per key: column pairs
  static constexpr int KP = NT / NCP;  // key partitions in P.V
  static_assert(TK == 32 || TK == 64, "tile of 32 or 64 keys");
  static_assert(CPR >= 4 && CPP >= 1, "rows of at least 64 bytes");
  static_assert(NT * KPT * MAX_G * 4 <= TILEB, "partial dots fit the K tile");
  static_assert(KP * MAX_G * D * 4 <= STAGEB, "P.V sums fit one stage");
};

// Position of chunk c of tile row j in the K tile: a 128-byte XOR swizzle
// (chunk index XOR the row's index among the 8 rows, or 4 two-row lines,
// that share bank groups), so that 8 rows read at one chunk hit 8 distinct
// 16-byte bank groups.
template <int CPR>
__device__ __forceinline__ int swz(int j, int c) {
  if constexpr (CPR >= 8)
    return c ^ (j & 7);
  else
    return c ^ ((j >> 1) & 3);  // 64-byte rows: two rows a 128-byte line
}

template <typename T, typename KV, int D, bool Paged>
__global__ void __launch_bounds__(NT, 3) decode_kernel(DecodeArgs a) {
  using Gm = Geom<KV, D>;
  constexpr bool Q8 = std::is_same<KV, int8_t>::value;
  constexpr int TK = Gm::TK, ROWB = Gm::ROWB, TILEB = Gm::TILEB;
  constexpr int EPC = Gm::EPC, CPR = Gm::CPR, CPP = Gm::CPP, KP = Gm::KP;
  constexpr int NCP = Gm::NCP, KPT = Gm::KPT, KS = TK / KPT;

  extern __shared__ __align__(128) unsigned char ring[];  // stages of K, V
  __shared__ __align__(16) float s_q[MAX_G][D];  // query, pre-scaled
  // probabilities, key-major so one float4 holds four heads' (q8: times
  // V's scale)
  __shared__ __align__(16) float s_p[TK][MAX_G];
  __shared__ int s_row[2][TK];  // element offset of each key's row, -1 masked
  __shared__ float s_ks[Q8 ? 2 : 1][Q8 ? TK : 1];  // q8: each key's scales
  __shared__ float s_vs[Q8 ? 2 : 1][Q8 ? TK : 1];
  __shared__ float s_m[MAX_G], s_l[MAX_G], s_alpha[MAX_G];

  cg::cluster_group cluster = cg::this_cluster();
  // blockIdx.y = h * n_part + part: the part's query heads are g0 .. g0+G-1
  // (one part, the whole group, when G <= MAX_G: no division)
  const int split = blockIdx.x, b = blockIdx.z;
  int h = blockIdx.y, g0 = 0, G = a.G;
  if (a.n_part > 1) {
    h = blockIdx.y / a.n_part;
    g0 = (blockIdx.y - h * a.n_part) * MAX_G;
    G = min(MAX_G, a.G - g0);
  }
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const KV* k = static_cast<const KV*>(a.k);
  const KV* v = static_cast<const KV*>(a.v);
  const int s0 = split * a.chunk;
  const int s1 = min(a.S, s0 + a.chunk);
  const int nt = s1 > s0 ? (s1 - s0 + TK - 1) / TK : 0;

  // thread j < TK: the position (dense) or table entry (paged) of key t0+j
  auto load_idx = [&](int t0) -> int {
    const int s = t0 + tid;
    if (tid >= TK || s >= s1) return -1;
    return Paged ? a.bt[b * a.MB + s / a.bs] : a.kv_pos[b * a.S + s];
  };
  // the first two tiles' indices and q_pos go out together with the query
  const int idx = nt > 0 ? load_idx(s0) : -1;
  int idx_next = nt > 1 ? load_idx(s0 + TK) : -1;
  const int qp = a.q_pos[b];
  {
    const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh + g0 * D;
    const float scale = 1.0f / sqrtf(static_cast<float>(D));
    constexpr int QN = MAX_G * D / NT;
    float qv[QN];
#pragma unroll
    for (int i = 0; i < QN; ++i) {
      const int e = tid + i * NT;
      qv[i] = e < G * D ? to_f(q[e]) * scale : 0.f;
    }
#pragma unroll
    for (int i = 0; i < QN; ++i) (&s_q[0][0])[tid + i * NT] = qv[i];
  }
  if (tid < MAX_G) {
    s_m[tid] = NEG;
    s_l[tid] = 0.f;
  }

  // Row offsets and mask of the tile at t0 into stage st; on the q8 pool
  // the scales of its attended pages start copying.  Returns the number of
  // attendable keys (a block barrier).
  auto build = [&](int t0, int st, int entry) -> int {
    int row = -1;
    if (tid < TK && entry >= 0) {
      const int s = t0 + tid;
      int pos;
      long long off;
      if (Paged) {
        const int j = s / a.bs, r = s - j * a.bs;
        int blk = j;
        if (a.ring > 0) {
          const int lb = qp / a.bs;
          blk = lb - (lb + a.ring - j) % a.ring;
        }
        pos = blk >= 0 ? blk * a.bs + r : -1;
        off = entry * a.k_sb + r * a.k_ss + h * a.k_sh;
      } else {
        pos = entry;
        off = b * a.k_sb + h * a.k_sh + s * a.k_ss;
      }
      if (pos >= 0 && pos <= qp && (a.window <= 0 || qp - pos < a.window))
        row = static_cast<int>(off);
    }
    if (tid < TK) {
      s_row[st][tid] = row;
      if constexpr (Q8) {
        if (row >= 0) {  // entry is the page: its scales, read only here
          cp_async4(smem_addr(&s_ks[st][tid]), a.k_scale + entry * a.Hkv + h);
          cp_async4(smem_addr(&s_vs[st][tid]), a.v_scale + entry * a.Hkv + h);
        }
      }
    }
    return __syncthreads_count(row >= 0);
  };
  // every attendable K and V row of stage st's tile, in 16-byte copies;
  // a masked key's V row is zero-filled (P.V then needs no branch)
  auto copy_tile = [&](int st) {
    unsigned char* kt = ring + st * Gm::STAGEB;
    unsigned char* vt = kt + TILEB;
    for (int ci = tid; ci < TK * CPR; ci += NT) {
      const int j = ci / CPR, c = ci % CPR;
      const int row = s_row[st][j];
      if (row >= 0)
        cp_async16(smem_addr(kt + j * ROWB + swz<CPR>(j, c) * 16),
                   k + row + c * EPC);
      cp_async16(smem_addr(vt + j * ROWB + c * 16),
                 v + (row >= 0 ? row + c * EPC : 0), row >= 0);
    }
  };

  // P.V thread: output columns 2 cp and 2 cp + 1 of each head, over keys
  // kpart, kpart + KP, ...
  float acc[2][MAX_G];
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) acc[0][g] = acc[1][g] = 0.f;
  const int cp = tid % NCP, kpart = tid / NCP;

  auto compute = [&](int st) {
    unsigned char* kt = ring + st * Gm::STAGEB;
    const unsigned char* vt = kt + TILEB;
    // the partial dots (NPART, MAX_G, TK) replace the K tile once it is read
    float* s_dot = reinterpret_cast<float*>(kt);
    {  // partial dots: keys jj and jj + KS, chunks [part * CPP, ...)
       // (one q load feeds both keys)
      const int jj = tid % KS, part = tid / KS;
      float dot[KPT][MAX_G];
#pragma unroll
      for (int u = 0; u < KPT; ++u)
#pragma unroll
        for (int g = 0; g < MAX_G; ++g) dot[u][g] = 0.f;
#pragma unroll
      for (int cc = 0; cc < CPP; ++cc) {
        const int c = part * CPP + cc;
        float kf[KPT][EPC];
#pragma unroll
        for (int u = 0; u < KPT; ++u) {
          const int j = jj + u * KS;
          unpack(*reinterpret_cast<const uint4*>(
                     kt + j * ROWB + swz<CPR>(j, c) * 16), kf[u]);
        }
#pragma unroll
        for (int g = 0; g < MAX_G; ++g) {
          if (g < G) {
#pragma unroll
            for (int e4 = 0; e4 < EPC; e4 += 4) {
              const float4 qq =
                  *reinterpret_cast<const float4*>(&s_q[g][c * EPC + e4]);
#pragma unroll
              for (int u = 0; u < KPT; ++u)
                dot[u][g] += qq.x * kf[u][e4] + qq.y * kf[u][e4 + 1] +
                             qq.z * kf[u][e4 + 2] + qq.w * kf[u][e4 + 3];
            }
          }
        }
      }
      __syncthreads();  // every K row is read
#pragma unroll
      for (int u = 0; u < KPT; ++u)
#pragma unroll
        for (int g = 0; g < MAX_G; ++g)
          if (g < G) s_dot[(part * MAX_G + g) * TK + jj + u * KS] = dot[u][g];
    }
    __syncthreads();

    // online softmax update, one warp per query head
    for (int g = warp; g < G; g += NWARP) {
      constexpr int KL = TK / 32;  // keys per lane
      float sc[KL];
      float mx = NEG;
#pragma unroll
      for (int i = 0; i < KL; ++i) {
        const int j = lane + 32 * i;
        float x = NEG;
        if (s_row[st][j] >= 0) {  // a masked key's row was not loaded
          x = 0.f;
#pragma unroll
          for (int p = 0; p < Gm::NPART; ++p)
            x += s_dot[(p * MAX_G + g) * TK + j];
          if constexpr (Q8) x *= s_ks[st][j];
        }
        sc[i] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
      const float m_prev = s_m[g];
      const float m_next = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < KL; ++i) {
        const int j = lane + 32 * i;
        const float p = s_row[st][j] >= 0 ? expf(sc[i] - m_next) : 0.f;
        sum += p;
        if constexpr (Q8)
          s_p[j][g] = s_row[st][j] >= 0 ? p * s_vs[st][j] : 0.f;
        else
          s_p[j][g] = p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(FULL, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_next);
        s_alpha[g] = alpha;
        s_l[g] = s_l[g] * alpha + sum;
        s_m[g] = m_next;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P.V over this thread's keys: independent
    // loads, unrolled (masked keys: p == 0 and a zero-filled V row)
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) {
      if (g < G) {
        acc[0][g] *= s_alpha[g];
        acc[1][g] *= s_alpha[g];
      }
    }
    const KV* vcol = reinterpret_cast<const KV*>(vt) + 2 * cp;
#pragma unroll 8
    for (int i = 0; i < TK / KP; ++i) {
      const int j = kpart + i * KP;
      float v0, v1;
      load2(vcol + j * D, v0, v1);
#pragma unroll
      for (int g4 = 0; g4 < MAX_G; g4 += 4) {
        if (g4 < G) {
          const float4 p = *reinterpret_cast<const float4*>(&s_p[j][g4]);
          const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            acc[0][g4 + u] += pv[u] * v0;
            acc[1][g4 + u] += pv[u] * v1;
          }
        }
      }
    }
  };

  // the ring: tile t+1 copies and tile t+2's indices load while t computes
  // (tiles 0 and 1 are both in flight before the first wait)
  int n_ok_next = 0;
  if (nt > 0) {
    n_ok_next = build(s0, 0, idx);
    if (n_ok_next) copy_tile(0);
    cp_commit();
  }
  for (int t = 0; t < nt; ++t) {
    const int st = t & 1;
    const int n_ok = n_ok_next;
    if (t + 1 < nt) {
      n_ok_next = build(s0 + (t + 1) * TK, st ^ 1, idx_next);
      if (n_ok_next) copy_tile(st ^ 1);
      cp_commit();
      if (t + 2 < nt) idx_next = load_idx(s0 + (t + 2) * TK);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    if (n_ok) compute(st);  // a tile with nothing to attend changes nothing
    __syncthreads();  // stage st is refilled next turn
  }

  // this block's unnormalised output for the cluster, in the idle ring:
  // the key partitions' sums (KP, MAX_G, D), then their total at g * D + d
  float* s_out = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) {
    if (g < G)
      *reinterpret_cast<float2*>(&s_out[(kpart * MAX_G + g) * D + 2 * cp]) =
          make_float2(acc[0][g], acc[1][g]);
  }
  __syncthreads();
  for (int e = tid; e < G * D; e += NT) {  // e = g * D + d
    float t = 0.f;
#pragma unroll
    for (int p = 0; p < KP; ++p) t += s_out[p * MAX_G * D + e];
    s_out[e] = t;
  }
  cluster.sync();  // every split's (m, l, output) is visible cluster-wide

  // combine: split r of n writes outputs r*NT + tid, stepping n*NT
  const int n = static_cast<int>(cluster.num_blocks());
  T* out = a.st_o != nullptr
               ? nullptr
               : static_cast<T*>(a.out) + b * a.q_sb + h * a.q_sh + g0 * D;
  const long long st = (static_cast<long long>(b) * a.Hkv + h) * a.G + g0;
  for (int e = split * NT + tid; e < G * D; e += n * NT) {
    const int g = e / D;
    float m_r[MAX_SPLIT];
    float M = NEG;
#pragma unroll
    for (int r = 0; r < MAX_SPLIT; ++r) {
      m_r[r] = r < n ? *cluster.map_shared_rank(&s_m[g], r) : NEG;
      M = fmaxf(M, m_r[r]);
    }
    float L = 0.f, o = 0.f;
#pragma unroll
    for (int r = 0; r < MAX_SPLIT; ++r) {
      if (r < n) {
        const float w = expf(m_r[r] - M);
        L += *cluster.map_shared_rank(&s_l[g], r) * w;
        o += *cluster.map_shared_rank(&s_out[e], r) * w;
      }
    }
    if (a.st_o != nullptr) {  // partial-state mode: the state, unnormalised
      a.st_o[st * D + e] = o;
      if (e - g * D == 0) {
        a.st_m[st + g] = M;
        a.st_l[st + g] = L;
      }
    } else {
      out[e] = from_f<T>(o / (L == 0.f ? 1.f : L));
    }
  }
  cluster.sync();  // peers may still read this block's shared memory
}

// one instantiation: output type, K/V element type, head dim, paging
template <typename T_, typename KV_, int D_, bool Paged_>
struct Inst {
  using T = T_;
  using KV = KV_;
  static constexpr int D = D_;
  static constexpr bool Paged = Paged_;
};

template <typename I>
auto kernel_of() {
  return &decode_kernel<typename I::T, typename I::KV, I::D, I::Paged>;
}

// dynamic shared memory: one stage when a split is one tile, else two
template <typename I>
int ring_bytes(int chunk) {
  using Gm = Geom<typename I::KV, I::D>;
  return (chunk > Gm::TK ? 2 : 1) * Gm::STAGEB;
}

template <typename I>
cudaLaunchConfig_t config(const DecodeArgs& a, cudaStream_t stream,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.n_split, a.Hkv * a.n_part, a.B);
  cfg.blockDim = dim3(NT, 1, 1);
  cfg.dynamicSmemBytes = ring_bytes<I>(a.chunk);
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = a.n_split;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename I>
cudaError_t launch(const DecodeArgs& a, cudaStream_t stream) {
  const auto kern = kernel_of<I>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      2 * Geom<typename I::KV, I::D>::STAGEB);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config<I>(a, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, kern, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// K/V element type: the query's, or int8 on the q8 pool
template <typename T, bool Q8>
using KVOf = typename std::conditional<Q8, int8_t, T>::type;

// fn(Inst<...>{}) for the instantiation of (dtype, D, Paged, Q8)
template <bool Paged, bool Q8, typename Fn>
cudaError_t with_inst(int dtype, int D, Fn fn) {
  using F = float;
  using H = __nv_bfloat16;
  if (dtype == 0)
    return D == 64 ? fn(Inst<F, KVOf<F, Q8>, 64, Paged>{})
                   : fn(Inst<F, KVOf<F, Q8>, 128, Paged>{});
  return D == 64 ? fn(Inst<H, KVOf<H, Q8>, 64, Paged>{})
                 : fn(Inst<H, KVOf<H, Q8>, 128, Paged>{});
}

template <bool Paged, bool Q8>
int dispatch(int dtype, int D, const DecodeArgs& a, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(with_inst<Paged, Q8>(
      dtype, D, [&](auto inst) { return launch<decltype(inst)>(a, st); }));
}

bool bad_common(int dtype, int D, int G, int n_split, int chunk) {
  return G < 1 || G > MAX_GROUP || (D != 64 && D != 128) ||
         (dtype != 0 && dtype != 1) || n_split < 1 || n_split > MAX_SPLIT ||
         chunk < 1 || chunk % 64 != 0;
}

// the three state outputs are all set or all null; without them out is set
bool bad_states(const void* out, const void* m, const void* l, const void* o) {
  const int n = (m != nullptr) + (l != nullptr) + (o != nullptr);
  return (n != 0 && n != 3) || (n == 0 && out == nullptr);
}

void set_states(DecodeArgs& a, void* m, void* l, void* o) {
  a.st_m = static_cast<float*>(m);
  a.st_l = static_cast<float*>(l);
  a.st_o = static_cast<float*>(o);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  D must be 64 or 128, G at most 16,
// n_split at most 8 (a cluster), chunk a whole number of 64-key tiles;
// K/V 16-byte aligned.  st_m, st_l and st_o are null (out takes the
// normalised output) or all three set (the partial-state mode: out is not
// written and may be null).  Each launch function returns a cudaError_t (0
// on success); the Python wrapper raises on any other value.

// Dense: position-tagged cache, strides as in DecodeArgs.
extern "C" int decode_attention_launch(
    int dtype, int D, const void* q, const void* k, const void* v,
    const void* kv_pos, const void* q_pos, void* out, int B, int Hkv, int G,
    int S, int q_sb, int q_sh, int k_sb, int k_sh, int k_ss, int window,
    int n_split, int chunk, void* st_m, void* st_l, void* st_o,
    void* stream) {
  if (bad_common(dtype, D, G, n_split, chunk) ||
      bad_states(out, st_m, st_l, st_o))
    return static_cast<int>(cudaErrorInvalidValue);
  DecodeArgs a = {};
  set_states(a, st_m, st_l, st_o);
  a.q = q;
  a.k = k;
  a.v = v;
  a.kv_pos = static_cast<const int*>(kv_pos);
  a.q_pos = static_cast<const int*>(q_pos);
  a.out = out;
  a.B = B;
  a.Hkv = Hkv;
  a.G = G;
  a.n_part = (G + MAX_G - 1) / MAX_G;
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
          const void* block_tables, const void* q_pos, void* out, int B,
          int Hkv, int G, int MB, int bs, int ring, int q_sb, int q_sh,
          int window, int n_split, int chunk, void* st_m, void* st_l,
          void* st_o, void* stream) {
  if (bad_common(dtype, D, G, n_split, chunk) || MB < 1 || bs < 1 ||
      ring < 0 || bad_states(out, st_m, st_l, st_o))
    return static_cast<int>(cudaErrorInvalidValue);
  DecodeArgs a = {};
  set_states(a, st_m, st_l, st_o);
  a.q = q;
  a.k = k_pool;
  a.v = v_pool;
  a.k_scale = static_cast<const float*>(k_scale);
  a.v_scale = static_cast<const float*>(v_scale);
  a.bt = static_cast<const int*>(block_tables);
  a.q_pos = static_cast<const int*>(q_pos);
  a.out = out;
  a.B = B;
  a.Hkv = Hkv;
  a.G = G;
  a.n_part = (G + MAX_G - 1) / MAX_G;
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
    const void* block_tables, const void* q_pos, void* out, int B, int Hkv,
    int G, int MB, int bs, int ring, int q_sb, int q_sh, int window,
    int n_split, int chunk, void* st_m, void* st_l, void* st_o,
    void* stream) {
  return paged<false>(dtype, D, q, k_pool, v_pool, nullptr, nullptr,
                      block_tables, q_pos, out, B, Hkv, G, MB, bs, ring, q_sb,
                      q_sh, window, n_split, chunk, st_m, st_l, st_o, stream);
}

// q8: int8 pools, float32 scales (NB, Hkv); dtype is the query's.
extern "C" int decode_attention_paged_q8_launch(
    int dtype, int D, const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* block_tables,
    const void* q_pos, void* out, int B, int Hkv, int G, int MB, int bs,
    int ring, int q_sb, int q_sh, int window, int n_split, int chunk,
    void* st_m, void* st_l, void* st_o, void* stream) {
  return paged<true>(dtype, D, q, k_pool, v_pool, k_scale, v_scale,
                     block_tables, q_pos, out, B, Hkv, G, MB, bs, ring, q_sb,
                     q_sh, window, n_split, chunk, st_m, st_l, st_o, stream);
}

// Residency of one instantiation (kind 0 dense, 1 paged, 2 paged q8) for a
// launch of n_split-block clusters whose splits are chunk keys long: writes
// the blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor), the
// clusters resident at once on the card (cudaOccupancyMaxActiveClusters)
// and the dynamic shared memory bytes of a block to res[0..2].
extern "C" int decode_attention_occupancy(int dtype, int D, int kind,
                                          int n_split, int chunk, void* res) {
  if (bad_common(dtype, D, 1, n_split, chunk) || kind < 0 || kind > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  int* r = static_cast<int*>(res);
  auto query = [&](auto inst) {
    using I = decltype(inst);
    const auto kern = kernel_of<I>();
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        2 * Geom<typename I::KV, I::D>::STAGEB);
    if (err != cudaSuccess) return err;
    DecodeArgs a = {};
    a.B = 1;
    a.Hkv = 1;
    a.n_part = 1;
    a.n_split = n_split;
    a.chunk = chunk;
    r[2] = ring_bytes<I>(chunk);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&r[0], kern, NT, r[2]);
    if (err != cudaSuccess) return err;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = config<I>(a, nullptr, &attr);
    return cudaOccupancyMaxActiveClusters(&r[1], kern, &cfg);
  };
  cudaError_t err;
  if (kind == 0)
    err = with_inst<false, false>(dtype, D, query);
  else if (kind == 1)
    err = with_inst<true, false>(dtype, D, query);
  else
    err = with_inst<true, true>(dtype, D, query);
  return static_cast<int>(err);
}
