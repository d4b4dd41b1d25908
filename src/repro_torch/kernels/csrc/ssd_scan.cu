// Mamba2 SSD (state-space duality) chunked scan from a zero state: the
// prefill of every ssm / hybrid layer.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py::ssd_scan_pallas
// (body _ssd_kernel).  For each (batch b, head h) it computes, over the
// sequence,
//
//   S_t = exp(a_t) S_{t-1} + dt_t x_t B_tᵀ       (P x N state, S_0 = 0)
//   y_t = S_t C_t
//
// and returns y (B, S, H, P) float32 and the final state (B, H, P, N)
// float32.  Inputs: x (B, S, H, P) and Bm / Cm (B, S, H, N) in float32 or
// bfloat16 (one type), dt and a = dt * A (B, S, H) float32, all addressed
// by strides (the last dim contiguous), so B and C may be broadcast from
// their groups with a zero head stride.  x, B and C rows are read in
// 16-byte pieces: N is a multiple of 8, pointers and strides 16-byte
// aligned (the wrapper checks).  Within a tile of L = 64 rows the kernel
// uses the duality
//
//   y  = (tril(exp(Acum_i - Acum_j)) ∘ (C Bᵀ) ∘ dt_j) X + exp(Acum) ∘ (C Sᵀ)
//   S' = exp(a_sum) S + Xᵀ (B ∘ dt ∘ exp(a_sum - Acum))
//
// with Acum the inclusive cumulative sum of a within the tile.  Every
// decay is exp of a difference that is <= 0 (dt > 0, A < 0), formed per
// pair, never as exp(Acum_i) / exp(Acum_j); the mask is applied before the
// product.  The TPU kernel's chunk is the caller's (a 2,000-token prompt is
// one 2,000 x 2,000 tile in VMEM); here it is 64 rows whatever ``chunk``
// says: only a tiling of the same recurrence, equal up to float32 rounding.
//
// What bounds it on an H100.  bf16 inputs: bytes.  At Hymba-1.5B's shape
// (H 50, P 64, N 16) and 250 tokens x, y, dt, a and B/C of the one group
// are 5.1 MB (1.5 us at 3.35 TB/s) against 0.2 GFLOP (0.2 us at bf16's
// 989 TFLOP/s); at Mamba2-2.7B's (H 80, P 64, N 128) and 512 tokens 18.9 MB
// (5.6 us) against 2.3 GFLOP (2.4 us).  float32 inputs: operations, since
// the products run as FMA at 67 TFLOP/s (Mamba2 at 2048 tokens: 9.4 GFLOP,
// 0.14 ms).  A grid of one block per (b, h) walking the whole sequence
// fills 50 or 80 of 132 SMs and serialises every tile behind the last.
//
// What the design does about it:
//   * the sequence of one (b, h) is cut into n_span spans of whole 64-row
//     tiles (the last one may be ragged), at most MAX_SPAN = 8, the portable
//     cluster size; the spans of one (b, h) are the blocks of one
//     thread-block cluster.  The grid is n_span x H x B blocks: 640 at
//     Mamba2's 512 tokens, 200 at Hymba's 250 (80 and 50 before).
//     ssd_split() picks the spans; kernels/ssd_scan.py::ssd_split mirrors it;
//   * pass (a): block k scans its span from a zero state, keeping only the
//     state: its local end state Sloc_k (in shared memory) and decay sum
//     Asum_k;
//   * combine, between two cluster barriers: the state elements are dealt
//     out over the cluster's blocks; the owner of an element reads it from
//     every block through distributed shared memory and runs the chain
//     Sin_0 = 0, Sin_{j+1} = exp(Asum_j) Sin_j + Sloc_j, writing Sin_j back
//     into block j's state and Sin_{n_span} (the final state) to device
//     memory.  No workspace, no second kernel, one launch per call;
//   * pass (c): block k walks its span again from Sin_k, producing y; each
//     y row is written once.  A span of one tile keeps its tile in shared
//     memory from pass (a); a longer span reads x, B and C again (from L2).
//     Pass (a) reads no C: a one-tile span's C copies while it runs;
//   * bf16: the four products run on tensor cores as mma.sync m16n8k16
//     (bf16 operands, float32 accumulators; mma.sync rather than wgmma: the
//     bound is bytes at every main-path shape and the tiles are small).
//     C Bᵀ takes bf16 operands exactly.  M X, C Sᵀ and Xᵀ W each have one
//     float32 operand (M, the state, W = B ∘ dt ∘ decay), split into a bf16
//     high and low part (hi = bf16(v), lo = bf16(v - hi)), two products
//     summed in float32: ~2^-17 relative against bf16's 2^-9.  The carried
//     state stays float32 in shared memory; only its operand copy is split,
//     as each fragment is read.  Operands come by ldmatrix from rows padded
//     by 16 bytes (conflict-free), tiles by 16-byte cp.async, zero-filled
//     past the span.  A span of several tiles double-buffers X and B, tile
//     t+1 copying while tile t computes; C has one buffer, which M's split
//     parts take over once every product that reads C is done (C Bᵀ,
//     masked, and C Sᵀ wait in registers), and C of tile t+1 copies while
//     tile t updates the state.  So two blocks of 256 threads share an SM
//     at Mamba2's N 128 (81 KB a block for one-tile spans, 108 KB for
//     longer ones);
//   * float32: FMA in float32 (tensor cores would read float32 as TF32), 256
//     threads with 4 x 4 (C Bᵀ), 4 x P/16 (y) and P/16 x 8 (state) register
//     micro-tiles, C Bᵀ and C Sᵀ in one walk over N that reads C and B four
//     columns at a time.  A tile arrives by 16-byte cp.async, every copy in
//     flight at once.  M overwrites C once C is read, the state is held
//     transposed and B's 16-byte pieces in an XOR swizzle, so the column
//     reads are conflict-free without padding and Mamba2's tile takes 113
//     KB: two blocks share an SM.
// chip_smoke.py prints each instantiation's occupancy
// (ssd_scan_occupancy) and asserts one device kernel per call.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cstdint>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int LC = 64;  // rows per tile
constexpr int MAX_N = 128;  // state width
constexpr int MAX_SPAN = 8;  // spans of one (b, h): a cluster
constexpr int NT_BF = 256;  // threads of the bf16 body: 8 warps
constexpr int NT_F32 = 256;  // threads of the float32 body: 16 x 16
constexpr int LDM = LC + 8;  // row stride of M's bf16 parts
constexpr unsigned FULL = 0xffffffffu;

struct SsdArgs {
  const void* x;  // element (b, s, h, p) at b*x_sb + s*x_ss + h*x_sh + p
  const float* dt;  // element (b, s, h) at b*t_sb + s*t_ss + h*t_sh
  const float* a;  // same strides as dt
  const void* bm;  // element (b, s, h, n) at b*b_sb + s*b_ss + h*b_sh + n
  const void* cm;  // same strides as bm
  float* y;  // (B, S, H, P) contiguous
  float* fin;  // (B, H, P, N) contiguous
  int H, S, N, n_span, span;  // span: rows per span, whole tiles
  long long x_sb, x_ss, x_sh, t_sb, t_ss, t_sh, b_sb, b_ss, b_sh;
};

// The spans of a sequence of S rows: at most MAX_SPAN of whole tiles, as
// many as there are tiles up to that cap, none empty.  Returns n_span and
// writes the rows per span.
__host__ int ssd_split(int S, int* span) {
  const int tiles = S > 0 ? (S + LC - 1) / LC : 1;
  const int want = tiles < MAX_SPAN ? tiles : MAX_SPAN;
  const int per = (tiles + want - 1) / want;
  *span = per * LC;
  return (tiles + per - 1) / per;
}

__host__ __device__ constexpr int round16(int n) { return (n + 15) / 16 * 16; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared through L2; zero-filled when !valid (src is
// then not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
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

// four 8 x 8 bf16 matrices from shared memory (lane l gives a row address
// of matrix l / 8); .trans delivers each transposed
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
// d += a b: a 16 x 16 (row), b 16 x 8 (col), bf16, float32 accumulators
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
// (x, y) ~ hi + lo, each a bf16 pair (x in the low half)
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi,
                                       uint32_t& lo) {
  hi = pack_bf16(x, y);
  lo = pack_bf16(x - __uint_as_float(hi << 16),
                 y - __uint_as_float(hi & 0xffff0000u));
}

// Warp 0: the tile's inclusive cumulative sum of a into ac (rows past the
// tile's end hold a = 0, so Acum is flat there; ac may alias a), and, per
// row, e_i = exp(Acum_i) (when e is given) and w_j = dt_j exp(a_sum -
// Acum_j), a_sum = Acum_63.  The other warps return at once.
__device__ __forceinline__ void prep(const float* dt, const float* a,
                                     float* ac, float* e, float* w, int tid) {
  if (tid >= 32) return;
  const float v0 = a[2 * tid], v1 = a[2 * tid + 1];
  float incl = v0 + v1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(FULL, incl, off);
    if (tid >= off) incl += o;
  }
  float excl = __shfl_up_sync(FULL, incl, 1);
  if (tid == 0) excl = 0.f;
  const float c0 = excl + v0, c1 = excl + v0 + v1;
  const float asum = __shfl_sync(FULL, c1, 31);
  const float d0 = dt[2 * tid], d1 = dt[2 * tid + 1];
  ac[2 * tid] = c0;
  ac[2 * tid + 1] = c1;
  if (e != nullptr) {
    e[2 * tid] = expf(c0);
    e[2 * tid + 1] = expf(c1);
  }
  w[2 * tid] = d0 * expf(asum - c0);
  w[2 * tid + 1] = d1 * expf(asum - c1);
}

// The cluster's state passing (see the header).  Every block holds its
// span's local end state as rows x cols floats at state[r * ld + c] (cols
// and ld multiples of 4) and its decay sum in *s_asum; afterwards each
// holds its entering state, and out(r, c, v) has stored the final state's
// elements (r, c..c+3).  The elements go out in 16-byte pieces, neighbouring
// lanes on neighbouring pieces, so each warp's remote access is whole
// 128-byte lines.  Call between two cluster barriers.
template <typename Out>
__device__ __forceinline__ void combine(cg::cluster_group& cluster,
                                        float* state, float* s_asum,
                                        int rows, int cols, int ld, Out out,
                                        int tid, int nthr) {
  const int K = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  float dec[MAX_SPAN];
#pragma unroll
  for (int j = 0; j < MAX_SPAN; ++j)
    dec[j] = j < K ? expf(*cluster.map_shared_rank(s_asum, j)) : 0.f;
  const int c4 = cols / 4;
  for (int q = rank * nthr + tid; q < rows * c4; q += K * nthr) {
    const int r = q / c4, c = (q - r * c4) * 4;
    float4* mine = reinterpret_cast<float4*>(state + r * ld + c);
    float4 loc[MAX_SPAN];  // every load in flight before the chain
#pragma unroll
    for (int j = 0; j < MAX_SPAN; ++j)
      if (j < K) loc[j] = *cluster.map_shared_rank(mine, j);
    float4 sin = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int j = 0; j < MAX_SPAN; ++j) {
      if (j < K) {
        *cluster.map_shared_rank(mine, j) = sin;
        sin.x = sin.x * dec[j] + loc[j].x;
        sin.y = sin.y * dec[j] + loc[j].y;
        sin.z = sin.z * dec[j] + loc[j].z;
        sin.w = sin.w * dec[j] + loc[j].w;
      }
    }
    out(r, c, sin);
  }
}

// ---------------------------------------------------------------------------
// bfloat16 body: mma.sync tiles fed by a cp.async ring
// ---------------------------------------------------------------------------

// Byte offsets of the bf16 body's dynamic shared memory: n_stage stages of
// (X, B bf16 rows padded by 8 elements; dt, a), one C buffer (bf16 rows
// padded by 8) that M's high and low bf16 parts (64 x LDM each) take over
// once C is read, the float32 state (P x (NP + 8)) and the per-row Acum,
// exp(Acum) and W factors.
struct BfLay {
  int ldx, ldb, lds, stage, x, b, dt, a, cm, mlo, s, ac, e, w, bytes;
  __host__ __device__ BfLay(int P, int N, int n_stage) {
    const int np = round16(N);
    ldx = P + 8;
    ldb = np + 8;
    lds = np + 8;
    x = 0;
    b = x + LC * ldx * 2;
    dt = b + LC * ldb * 2;
    a = dt + LC * 4;
    stage = a + LC * 4;
    cm = n_stage * stage;
    mlo = cm + LC * LDM * 2;
    const int c_bytes = LC * ldb * 2, m_bytes = 2 * LC * LDM * 2;
    s = cm + (c_bytes > m_bytes ? c_bytes : m_bytes);
    ac = s + P * lds * 4;
    e = ac + LC * 4;
    w = e + LC * 4;
    bytes = w + LC * 4;
  }
};

template <int P>
__global__ void __launch_bounds__(NT_BF, 2) ssd_bf16_kernel(SsdArgs g) {
  constexpr int NW = NT_BF / 32;
  constexpr int MT = P / 16 < 4 ? P / 16 : 4;  // m-tiles of a state unit
  constexpr int MG = P / 16 / MT;  // state units along P
  constexpr int NYU = P / 16 * 2;  // y units: 16 columns x 32 rows
  constexpr int YU = (NYU + NW - 1) / NW;  // y units per warp
  constexpr int CBU = (10 + NW - 1) / NW;  // C Bᵀ tiles per warp
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float s_asum;
  cg::cluster_group cluster = cg::this_cluster();

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int k = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int N = g.N, NP = round16(N), KS = NP / 16;
  const int s_beg = k * g.span, s_end = min(g.S, s_beg + g.span);
  const int nt = s_end > s_beg ? (s_end - s_beg + LC - 1) / LC : 0;
  // one layout for the whole cluster (peers address each other's state),
  // so the stages follow the span, not this block's share of it
  const int n_stage = g.span > LC ? 2 : 1;
  const BfLay L(P, N, n_stage);
  float* sS = reinterpret_cast<float*>(smem + L.s);
  const float* sAc = reinterpret_cast<const float*>(smem + L.ac);
  const float* sE = reinterpret_cast<const float*>(smem + L.e);
  const float* sW = reinterpret_cast<const float*>(smem + L.w);
  const uint32_t aC = smem_addr(smem + L.cm);  // C, then M's high part
  const uint32_t aMl = smem_addr(smem + L.mlo);
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(g.x);
  const __nv_bfloat16* bm = static_cast<const __nv_bfloat16*>(g.bm);
  const __nv_bfloat16* cm = static_cast<const __nv_bfloat16*>(g.cm);
  const long long x_base = b * g.x_sb + h * g.x_sh;
  const long long t_base = b * g.t_sb + h * g.t_sh;
  const long long b_base = b * g.b_sb + h * g.b_sh;

  auto stage = [&](int i) { return smem + i * L.stage; };
  auto tile_len = [&](int t) { return min(LC, s_end - s_beg - t * LC); };

  // X and B rows of tile t into stage st in 16-byte copies (zero-filled
  // past the span), dt and a in 4-byte copies
  auto load_xb = [&](unsigned char* st, int t) {
    const int s0 = s_beg + t * LC, len = tile_len(t);
    const uint32_t sx = smem_addr(st + L.x), sb = smem_addr(st + L.b);
    constexpr int XQ = P / 8;
    for (int i = tid; i < LC * XQ; i += NT_BF) {
      const int r = i / XQ, q = i % XQ;
      const bool ok = r < len;
      cp_async16(sx + (r * L.ldx + q * 8) * 2,
                 x + (ok ? x_base + (s0 + r) * g.x_ss + q * 8 : 0), ok);
    }
    const int BQ = N / 8;
    for (int i = tid; i < LC * BQ; i += NT_BF) {
      const int r = i / BQ, q = i - r * BQ;
      const bool ok = r < len;
      cp_async16(sb + (r * L.ldb + q * 8) * 2,
                 bm + (ok ? b_base + (s0 + r) * g.b_ss + q * 8 : 0), ok);
    }
    if (tid < LC) {
      float* sdt = reinterpret_cast<float*>(st + L.dt);
      float* sa = reinterpret_cast<float*>(st + L.a);
      if (tid < len) {
        const long long off = t_base + (s0 + tid) * g.t_ss;
        cp_async4(smem_addr(sdt + tid), g.dt + off);
        cp_async4(smem_addr(sa + tid), g.a + off);
      } else {
        sdt[tid] = 0.f;
        sa[tid] = 0.f;
      }
    }
  };
  // C rows of tile t into the C buffer, and zeros in its columns N..NP-1,
  // which the products read and M overwrote
  auto load_c = [&](int t) {
    const int s0 = s_beg + t * LC, len = tile_len(t);
    const int BQ = N / 8;
    for (int i = tid; i < LC * BQ; i += NT_BF) {
      const int r = i / BQ, q = i - r * BQ;
      const bool ok = r < len;
      cp_async16(aC + (r * L.ldb + q * 8) * 2,
                 cm + (ok ? b_base + (s0 + r) * g.b_ss + q * 8 : 0), ok);
    }
    if (NP > N) {
      __nv_bfloat16* sc = reinterpret_cast<__nv_bfloat16*>(smem + L.cm);
      for (int i = tid; i < LC * (NP - N); i += NT_BF)
        sc[(i / (NP - N)) * L.ldb + N + i % (NP - N)] = __float2bfloat16(0.f);
    }
  };
  auto prep_stage = [&](unsigned char* st) {
    prep(reinterpret_cast<const float*>(st + L.dt),
         reinterpret_cast<const float*>(st + L.a),
         reinterpret_cast<float*>(smem + L.ac),
         reinterpret_cast<float*>(smem + L.e),
         reinterpret_cast<float*>(smem + L.w), tid);
  };

  // S' = decay S + Xᵀ W (W = B ∘ w, w from prep), S zero when zero_in.
  // A unit is MT m-tiles (P rows) x 16 state columns; W is read as the
  // B operand from B's rows (ldmatrix.trans), scaled and split per
  // fragment, and Xᵀ as the A operand (ldmatrix.trans of X's rows).
  auto update = [&](unsigned char* st, float decay, bool zero_in) {
    const uint32_t sx = smem_addr(st + L.x), sb = smem_addr(st + L.b);
    for (int u = warp; u < MG * KS; u += NW) {
      const int mg = u / KS, n0 = (u - mg * KS) * 16;
      float acc[MT][2][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt2 = 0; nt2 < 2; ++nt2)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int p = (mg * MT + mt) * 16 + g8 + hf * 8;
            const int n = n0 + nt2 * 8 + 2 * t4;
            float2 v = make_float2(0.f, 0.f);
            if (!zero_in) {
              v = *reinterpret_cast<const float2*>(&sS[p * L.lds + n]);
              v.x *= decay;
              v.y *= decay;
            }
            acc[mt][nt2][2 * hf] = v.x;
            acc[mt][nt2][2 * hf + 1] = v.y;
          }
#pragma unroll
      for (int ks = 0; ks < LC / 16; ++ks) {
        const int k0 = ks * 16;
        uint32_t raw[4];
        ldsm_x4_t(sb + ((k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * L.ldb +
                        n0 + (lane >> 4) * 8) * 2, raw);
        const float w0 = sW[k0 + 2 * t4], w1 = sW[k0 + 2 * t4 + 1];
        const float w2 = sW[k0 + 2 * t4 + 8], w3 = sW[k0 + 2 * t4 + 9];
        uint32_t bh[4], bl[4];  // n-tile 0: [0], [1]; n-tile 1: [2], [3]
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float wl = (i & 1) ? w2 : w0, wh = (i & 1) ? w3 : w1;
          split2(__uint_as_float(raw[i] << 16) * wl,
                 __uint_as_float(raw[i] & 0xffff0000u) * wh, bh[i], bl[i]);
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const int m0 = (mg * MT + mt) * 16;
          uint32_t af[4];
          ldsm_x4_t(sx + ((k0 + (lane & 7) + (lane >> 4) * 8) * L.ldx + m0 +
                          ((lane >> 3) & 1) * 8) * 2, af);
#pragma unroll
          for (int nt2 = 0; nt2 < 2; ++nt2) {
            mma(acc[mt][nt2], af, bh[2 * nt2], bh[2 * nt2 + 1]);
            mma(acc[mt][nt2], af, bl[2 * nt2], bl[2 * nt2 + 1]);
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt2 = 0; nt2 < 2; ++nt2)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int p = (mg * MT + mt) * 16 + g8 + hf * 8;
            const int n = n0 + nt2 * 8 + 2 * t4;
            *reinterpret_cast<float2*>(&sS[p * L.lds + n]) =
                make_float2(acc[mt][nt2][2 * hf], acc[mt][nt2][2 * hf + 1]);
          }
    }
  };

  // The tile's y = exp(Acum) ∘ (C Sᵀ) + M X, written once, with
  // M = tril(exp(Acum_i - Acum_j)) ∘ (C Bᵀ) ∘ dt_j.  Everything that reads
  // C runs first (C Bᵀ, masked, and C Sᵀ held in registers), then M's
  // split parts replace C, then M X.  The 10 16 x 16 C Bᵀ tiles on or
  // below the diagonal are dealt out over the warps (the others are never
  // read); a y unit is 16 columns x 32 rows, so each state fragment is
  // read and split once per unit.
  auto y_tile = [&](unsigned char* st, int t) {
    const int s0 = s_beg + t * LC, len = tile_len(t);
    const uint32_t sb = smem_addr(st + L.b), sx = smem_addr(st + L.x);
    const float* sDt = reinterpret_cast<const float*>(st + L.dt);
    float mv[CBU][2][4];
#pragma unroll
    for (int i = 0; i < CBU; ++i) {
      const int u = warp + i * NW;
      if (u >= 10) continue;
      const int r = u < 1 ? 0 : u < 3 ? 1 : u < 6 ? 2 : 3;
      const int c = u - r * (r + 1) / 2;
      float acc[2][4] = {};
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t af[4], bf[4];
        ldsm_x4(aC + ((r * 16 + (lane & 15)) * L.ldb + ks * 16 +
                      (lane >> 4) * 8) * 2, af);
        ldsm_x4(sb + ((c * 16 + (lane & 7) + (lane >> 4) * 8) * L.ldb +
                      ks * 16 + ((lane >> 3) & 1) * 8) * 2, bf);
        mma(acc[0], af, bf[0], bf[1]);
        mma(acc[1], af, bf[2], bf[3]);
      }
#pragma unroll
      for (int nt2 = 0; nt2 < 2; ++nt2)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i2 = r * 16 + g8 + (q >> 1) * 8;
          const int j = c * 16 + nt2 * 8 + 2 * t4 + (q & 1);
          mv[i][nt2][q] = j <= i2 ? expf(sAc[i2] - sAc[j]) * acc[nt2][q] *
                                        sDt[j] : 0.f;
        }
    }
    float ya[YU][2][2][4] = {};  // [unit][row tile][n-tile][fragment]
#pragma unroll
    for (int i = 0; i < YU; ++i) {
      const int u = warp + i * NW;
      if (u >= NYU) continue;
      const int p0 = (u >> 1) * 16, r0 = (u & 1) * 2;
      for (int ks = 0; ks < KS; ++ks) {
        const int k0 = ks * 16;
        uint32_t bh[4], bl[4];
#pragma unroll
        for (int nt2 = 0; nt2 < 2; ++nt2) {
          const float* row = sS + (p0 + nt2 * 8 + g8) * L.lds + k0 + 2 * t4;
          const float2 v0 = *reinterpret_cast<const float2*>(row);
          const float2 v1 = *reinterpret_cast<const float2*>(row + 8);
          split2(v0.x, v0.y, bh[2 * nt2], bl[2 * nt2]);
          split2(v1.x, v1.y, bh[2 * nt2 + 1], bl[2 * nt2 + 1]);
        }
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          uint32_t af[4];
          ldsm_x4(aC + (((r0 + rr) * 16 + (lane & 15)) * L.ldb + k0 +
                        (lane >> 4) * 8) * 2, af);
#pragma unroll
          for (int nt2 = 0; nt2 < 2; ++nt2) {
            mma(ya[i][rr][nt2], af, bh[2 * nt2], bh[2 * nt2 + 1]);
            mma(ya[i][rr][nt2], af, bl[2 * nt2], bl[2 * nt2 + 1]);
          }
        }
      }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int i0 = (r0 + rr) * 16 + g8;
        const float e0 = sE[i0], e1 = sE[i0 + 8];
#pragma unroll
        for (int nt2 = 0; nt2 < 2; ++nt2) {
          ya[i][rr][nt2][0] *= e0;
          ya[i][rr][nt2][1] *= e0;
          ya[i][rr][nt2][2] *= e1;
          ya[i][rr][nt2][3] *= e1;
        }
      }
    }
    __syncthreads();  // every read of C is done: M takes its place
    {
      __nv_bfloat16* mh = reinterpret_cast<__nv_bfloat16*>(smem + L.cm);
      __nv_bfloat16* ml = reinterpret_cast<__nv_bfloat16*>(smem + L.mlo);
#pragma unroll
      for (int i = 0; i < CBU; ++i) {
        const int u = warp + i * NW;
        if (u >= 10) continue;
        const int r = u < 1 ? 0 : u < 3 ? 1 : u < 6 ? 2 : 3;
        const int c = u - r * (r + 1) / 2;
#pragma unroll
        for (int nt2 = 0; nt2 < 2; ++nt2)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int off = (r * 16 + g8 + hf * 8) * LDM + c * 16 + nt2 * 8 +
                            2 * t4;
            uint32_t hi, lo;
            split2(mv[i][nt2][2 * hf], mv[i][nt2][2 * hf + 1], hi, lo);
            *reinterpret_cast<uint32_t*>(&mh[off]) = hi;
            *reinterpret_cast<uint32_t*>(&ml[off]) = lo;
          }
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < YU; ++i) {
      const int u = warp + i * NW;
      if (u >= NYU) continue;
      const int p0 = (u >> 1) * 16, r0 = (u & 1) * 2;
#pragma unroll
      for (int ks = 0; ks < r0 + 2; ++ks) {  // M is 0 above the diagonal
        uint32_t xb[4];
        ldsm_x4_t(sx + ((ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                            L.ldx + p0 + (lane >> 4) * 8) * 2, xb);
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          if (ks > r0 + rr) continue;
          uint32_t ah[4], al[4];
          const uint32_t off = (((r0 + rr) * 16 + (lane & 15)) * LDM +
                                ks * 16 + (lane >> 4) * 8) * 2;
          ldsm_x4(aC + off, ah);
          ldsm_x4(aMl + off, al);
#pragma unroll
          for (int nt2 = 0; nt2 < 2; ++nt2) {
            mma(ya[i][rr][nt2], ah, xb[2 * nt2], xb[2 * nt2 + 1]);
            mma(ya[i][rr][nt2], al, xb[2 * nt2], xb[2 * nt2 + 1]);
          }
        }
      }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int row = (r0 + rr) * 16 + g8 + hf * 8;
          if (row < len) {
            float* yrow = g.y + ((static_cast<long long>(b) * g.S + s0 + row) *
                                 g.H + h) * P + p0 + 2 * t4;
#pragma unroll
            for (int nt2 = 0; nt2 < 2; ++nt2)
              *reinterpret_cast<float2*>(yrow + nt2 * 8) = make_float2(
                  ya[i][rr][nt2][2 * hf], ya[i][rr][nt2][2 * hf + 1]);
          }
        }
    }
  };

  // B's columns N..NP-1 are read by the products and never loaded
  if (NP > N) {
    const int pad = NP - N;
    for (int i = tid; i < n_stage * LC * pad; i += NT_BF) {
      const int st = i / (LC * pad), r = (i / pad) % LC, c = N + i % pad;
      reinterpret_cast<__nv_bfloat16*>(stage(st) + L.b)[r * L.ldb + c] =
          __float2bfloat16(0.f);
    }
  }
  if (nt == 0)
    for (int i = tid; i < P * L.lds; i += NT_BF) sS[i] = 0.f;

  // pass (a): the span's local end state from a zero state.  It reads no
  // C; a one-tile span's C copies meanwhile, for pass (c).
  float asum = 0.f;
  if (nt > 0) {
    load_xb(stage(0), 0);
    cp_commit();
    if (nt == 1) {
      load_c(0);
      cp_commit();
    }
  }
  for (int t = 0; t < nt; ++t) {
    unsigned char* st = stage(t & 1);
    if (t + 1 < nt) {
      load_xb(stage((t + 1) & 1), t + 1);
      cp_commit();
      cp_wait<1>();
    } else if (nt == 1) {
      cp_wait<1>();  // C may still be on its way
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    prep_stage(st);
    __syncthreads();
    asum += sAc[LC - 1];
    update(st, expf(sAc[LC - 1]), t == 0);
    __syncthreads();
  }
  // pass (c)'s first tile: still in stage 0 (a one-tile span), or copying
  // into the free stage during the combine
  if (nt > 1) {
    load_xb(stage(nt & 1), 0);
    load_c(0);
    cp_commit();
  }
  if (tid == 0) s_asum = asum;
  cluster.sync();
  float* fin = g.fin + (static_cast<long long>(b) * g.H + h) * P * N;
  combine(cluster, sS, &s_asum, P, N, L.lds,
          [&](int p, int n, float4 v) {
            *reinterpret_cast<float4*>(fin + p * N + n) = v;
          }, tid, NT_BF);
  cluster.sync();

  // pass (c): y from the entering state.  Tile t+1's X and B copy while
  // tile t computes, its C while tile t updates the state.
  for (int t = 0; t < nt; ++t) {
    unsigned char* st = stage(nt > 1 ? (nt + t) & 1 : 0);
    if (nt > 1 && t + 1 < nt) {
      load_xb(stage((nt + t + 1) & 1), t + 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    if (nt > 1) {
      prep_stage(st);
      __syncthreads();
    }
    y_tile(st, t);
    if (t + 1 < nt) {
      __syncthreads();  // every read of M and S is done
      load_c(t + 1);
      cp_commit();
      update(st, expf(sAc[LC - 1]), false);
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// float32 body: FMA micro-tiles
// ---------------------------------------------------------------------------

// Float offsets of the float32 body's dynamic shared memory: X (64 x P),
// B (64 x N, 16-byte piece q of row j at q ^ (j & msk)), C and then M
// (64 x N or 64 x 64), the state transposed (N x P), dt, a (then Acum) and
// W factors.
struct F32Lay {
  int x, b, c, s, dt, ac, w, bytes;
  __host__ __device__ F32Lay(int P, int N) {
    x = 0;
    b = x + LC * P;
    c = b + LC * N;
    s = c + (N > LC ? LC * N : LC * LC);
    dt = s + N * P;
    ac = dt + LC;
    w = ac + LC;
    bytes = (w + LC) * 4;
  }
};

template <int P>
__global__ void __launch_bounds__(NT_F32, 2) ssd_f32_kernel(SsdArgs g) {
  constexpr int PC = P / 16;  // y columns / state rows per thread
  extern __shared__ __align__(128) float smf[];
  __shared__ float s_asum;
  cg::cluster_group cluster = cg::this_cluster();

  const int N = g.N, NQ = N / 4;
  const F32Lay L(P, N);
  float* sX = smf + L.x;
  float* sB = smf + L.b;
  float* sC = smf + L.c;  // C, then M (64 x 64)
  float* sS = smf + L.s;  // element (p, n) at n * P + p
  float* sDt = smf + L.dt;
  float* sAc = smf + L.ac;  // a, then Acum
  float* sW = smf + L.w;
  // B's swizzle: 8 neighbouring rows hold a 16-byte piece in 8 bank groups
  const int msk = ((NQ & -NQ) < 8 ? (NQ & -NQ) : 8) - 1;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int k = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int s_beg = k * g.span, s_end = min(g.S, s_beg + g.span);
  const int nt = s_end > s_beg ? (s_end - s_beg + LC - 1) / LC : 0;
  const float* x = static_cast<const float*>(g.x);
  const float* bm = static_cast<const float*>(g.bm);
  const float* cm = static_cast<const float*>(g.cm);
  const long long x_base = b * g.x_sb + h * g.x_sh;
  const long long t_base = b * g.t_sb + h * g.t_sh;
  const long long b_base = b * g.b_sb + h * g.b_sh;
  auto tile_len = [&](int t) { return min(LC, s_end - s_beg - t * LC); };

  // tile t's X, B, dt and a (with_xb) and C (with_c) rows in 16-byte
  // copies (dt and a 4-byte), all in flight at once, zero-filled past the
  // span
  auto load = [&](int t, bool with_xb, bool with_c) {
    const int s0 = s_beg + t * LC, len = tile_len(t);
    for (int i = tid; with_xb && i < LC * (P / 4); i += NT_F32) {
      const int r = i / (P / 4), q = i % (P / 4);
      const bool ok = r < len;
      cp_async16(smem_addr(sX + r * P + 4 * q),
                 x + (ok ? x_base + (s0 + r) * g.x_ss + 4 * q : 0), ok);
    }
    for (int i = tid; i < LC * NQ; i += NT_F32) {
      const int r = i / NQ, q = i - r * NQ;
      const bool ok = r < len;
      const long long off = ok ? b_base + (s0 + r) * g.b_ss + 4 * q : 0;
      if (with_xb)
        cp_async16(smem_addr(sB + r * N + ((q ^ (r & msk)) << 2)), bm + off,
                   ok);
      if (with_c) cp_async16(smem_addr(sC + r * N + 4 * q), cm + off, ok);
    }
    if (with_xb && tid < LC) {
      if (tid < len) {
        const long long off = t_base + (s0 + tid) * g.t_ss;
        cp_async4(smem_addr(sDt + tid), g.dt + off);
        cp_async4(smem_addr(sAc + tid), g.a + off);
      } else {
        sDt[tid] = 0.f;
        sAc[tid] = 0.f;
      }
    }
  };
  auto ready = [&]() {  // the copies are in: Acum and W
    __syncthreads();
    prep(sDt, sAc, sAc, nullptr, sW, tid);
    __syncthreads();
  };

  // S' = decay S + Xᵀ W (S zero when zero_in); state rows p = tx + 16r,
  // columns n = 4 ty + 64 hh + u (u < 4), so each row of W is two 16-byte
  // reads of B
  auto update = [&](int len, float decay, bool zero_in) {
    float acc[PC][2][4];
    bool live[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) live[hh] = 4 * ty + 64 * hh < N;
#pragma unroll
    for (int r = 0; r < PC; ++r)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int u = 0; u < 4; ++u)
          acc[r][hh][u] = live[hh] && !zero_in
                              ? sS[(4 * ty + 64 * hh + u) * P + tx + 16 * r] *
                                    decay
                              : 0.f;
    for (int j = 0; j < len; ++j) {
      const float wj = sW[j];
      float xv[PC];
      float4 wv[2];
#pragma unroll
      for (int r = 0; r < PC; ++r) xv[r] = sX[j * P + tx + 16 * r];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        wv[hh] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (live[hh]) {
          wv[hh] = *reinterpret_cast<const float4*>(
              sB + j * N + (((ty + 16 * hh) ^ (j & msk)) << 2));
          wv[hh].x *= wj;
          wv[hh].y *= wj;
          wv[hh].z *= wj;
          wv[hh].w *= wj;
        }
      }
#pragma unroll
      for (int r = 0; r < PC; ++r)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int u = 0; u < 4; ++u)
            acc[r][hh][u] += xv[r] * (&wv[hh].x)[u];
    }
#pragma unroll
    for (int r = 0; r < PC; ++r)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (live[hh])
            sS[(4 * ty + 64 * hh + u) * P + tx + 16 * r] = acc[r][hh][u];
  };

  // y = exp(Acum) ∘ (C Sᵀ) + M X; rows i = ty + 16r, columns p = tx + 16c
  auto y_tile = [&](int t) {
    const int s0 = s_beg + t * LC, len = tile_len(t);
    float ya[4][PC], cb[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int c = 0; c < PC; ++c) ya[r][c] = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) cb[r][c] = 0.f;
    }
    // C Sᵀ and C Bᵀ share C's reads; C and B four columns a read
    for (int q = 0; q < NQ; ++q) {
      float4 cv[4], bv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        cv[r] = *reinterpret_cast<const float4*>(sC + (ty + 16 * r) * N +
                                                 4 * q);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = tx + 16 * c;
        bv[c] = *reinterpret_cast<const float4*>(sB + j * N +
                                                 ((q ^ (j & msk)) << 2));
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float sv[PC];
#pragma unroll
        for (int c = 0; c < PC; ++c) sv[c] = sS[(4 * q + u) * P + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float cu = (&cv[r].x)[u];
#pragma unroll
          for (int c = 0; c < PC; ++c) ya[r][c] += cu * sv[c];
#pragma unroll
          for (int c = 0; c < 4; ++c) cb[r][c] += cu * (&bv[c].x)[u];
        }
      }
    }
    __syncthreads();  // every read of C is done: M takes its place
    float* sM = sC;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = ty + 16 * r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = tx + 16 * c;
        sM[i * LC + j] =
            j <= i ? expf(sAc[i] - sAc[j]) * cb[r][c] * sDt[j] : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float e = expf(sAc[ty + 16 * r]);
#pragma unroll
      for (int c = 0; c < PC; ++c) ya[r][c] *= e;
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
        for (int c = 0; c < PC; ++c) ya[r][c] += mv[r] * xv[c];
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = ty + 16 * r;
      if (i < len) {
        float* yrow = g.y + ((static_cast<long long>(b) * g.S + s0 + i) *
                             g.H + h) * P;
#pragma unroll
        for (int c = 0; c < PC; ++c) yrow[tx + 16 * c] = ya[r][c];
      }
    }
  };

  if (nt == 0)
    for (int i = tid; i < N * P; i += NT_F32) sS[i] = 0.f;

  // pass (a): no C, but a one-tile span's C copies meanwhile, for pass (c)
  float asum = 0.f;
  for (int t = 0; t < nt; ++t) {
    load(t, true, false);
    cp_commit();
    if (nt == 1) {
      load(t, false, true);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    ready();
    asum += sAc[LC - 1];
    update(tile_len(t), expf(sAc[LC - 1]), t == 0);
    __syncthreads();
  }
  if (tid == 0) s_asum = asum;
  cluster.sync();
  float* fin = g.fin + (static_cast<long long>(b) * g.H + h) * P * N;
  combine(cluster, sS, &s_asum, N, P, P,
          [&](int n, int p, float4 v) {
            fin[p * N + n] = v.x;
            fin[(p + 1) * N + n] = v.y;
            fin[(p + 2) * N + n] = v.z;
            fin[(p + 3) * N + n] = v.w;
          }, tid, NT_F32);
  cluster.sync();

  // pass (c): a one-tile span still holds its tile
  for (int t = 0; t < nt; ++t) {
    if (nt > 1) {
      load(t, true, true);
      cp_commit();
      cp_wait<0>();
      ready();
    } else {
      cp_wait<0>();
      __syncthreads();
    }
    y_tile(t);
    if (t + 1 < nt) update(tile_len(t), expf(sAc[LC - 1]), false);
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename T, int P>
struct Inst {
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr int NT = F32 ? NT_F32 : NT_BF;
  static auto kernel() {
    if constexpr (F32)
      return &ssd_f32_kernel<P>;
    else
      return &ssd_bf16_kernel<P>;
  }
  // dynamic shared memory of a launch whose spans are span rows; max: the
  // largest any launch of this N asks for
  static int bytes(int N, int span) {
    if constexpr (F32)
      return F32Lay(P, N).bytes;
    else
      return BfLay(P, N, span > LC ? 2 : 1).bytes;
  }
  static int max_bytes(int N) { return bytes(N, 2 * LC); }
};

template <typename I>
cudaError_t set_attributes(int N) {
  const auto kern = I::kernel();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, I::max_bytes(N));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <typename I>
cudaLaunchConfig_t config(const SsdArgs& g, int B, cudaStream_t stream,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(g.n_span, g.H, B);
  cfg.blockDim = dim3(I::NT, 1, 1);
  cfg.dynamicSmemBytes = I::bytes(g.N, g.span);
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = g.n_span;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename I>
cudaError_t launch(const SsdArgs& g, int B, cudaStream_t stream) {
  cudaError_t err = set_attributes<I>(g.N);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config<I>(g, B, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, I::kernel(), g);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// fn(Inst<T, P>{}) for the instantiation of (dtype, P)
template <typename Fn>
cudaError_t with_inst(int dtype, int P, Fn fn) {
  using H = __nv_bfloat16;
  if (dtype == 0) {
    switch (P) {
      case 16: return fn(Inst<float, 16>{});
      case 32: return fn(Inst<float, 32>{});
      case 64: return fn(Inst<float, 64>{});
      default: return fn(Inst<float, 128>{});
    }
  }
  switch (P) {
    case 16: return fn(Inst<H, 16>{});
    case 32: return fn(Inst<H, 32>{});
    case 64: return fn(Inst<H, 64>{});
    default: return fn(Inst<H, 128>{});
  }
}

bool bad_shape(int dtype, int P, int N) {
  return (P != 16 && P != 32 && P != 64 && P != 128) || N < 8 || N > MAX_N ||
         N % 8 != 0 || (dtype != 0 && dtype != 1);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, Bm and Cm; dt, a, y and the final
// state are float32).  P must be 16, 32, 64 or 128 and N a multiple of 8 in
// [8, 128]; x, Bm and Cm 16-byte aligned with strides of whole 16 bytes.
// Returns a cudaError_t (0 on success); the Python wrapper raises on any
// other value.
extern "C" int ssd_scan_launch(
    int dtype, int P, const void* x, const void* dt, const void* a,
    const void* bm, const void* cm, void* y, void* fin, int B, int S, int H,
    int N, long long x_sb, long long x_ss, long long x_sh, long long t_sb,
    long long t_ss, long long t_sh, long long b_sb, long long b_ss,
    long long b_sh, void* stream) {
  if (bad_shape(dtype, P, N) || S < 0 || H < 1)
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
  g.n_span = ssd_split(S, &g.span);
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
  return static_cast<int>(with_inst(
      dtype, P, [&](auto inst) { return launch<decltype(inst)>(g, B, st); }));
}

// Residency of the instantiation (dtype, P) for a launch of N state
// columns over S rows: writes the blocks per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), the clusters resident
// at once on the card (cudaOccupancyMaxActiveClusters), the dynamic shared
// memory bytes of a block, and the split (n_span, rows per span) to
// res[0..4].
extern "C" int ssd_scan_occupancy(int dtype, int P, int N, int S, void* res) {
  if (bad_shape(dtype, P, N) || S < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int* r = static_cast<int*>(res);
  SsdArgs g = {};
  g.H = 1;
  g.S = S;
  g.N = N;
  g.n_span = ssd_split(S, &g.span);
  r[3] = g.n_span;
  r[4] = g.span;
  return static_cast<int>(with_inst(dtype, P, [&](auto inst) {
    using I = decltype(inst);
    cudaError_t err = set_attributes<I>(N);
    if (err != cudaSuccess) return err;
    r[2] = I::bytes(N, g.span);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&r[0], I::kernel(),
                                                        I::NT, r[2]);
    if (err != cudaSuccess) return err;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = config<I>(g, 1, nullptr, &attr);
    return cudaOccupancyMaxActiveClusters(&r[1], I::kernel(), &cfg);
  }));
}
