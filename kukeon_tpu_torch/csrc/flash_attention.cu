// Flash-attention forward (causal by position), hand-written for Hopper (sm_90a).
//
// Replaces the Pallas kernel kukeon_tpu/ops/flash_attention.py::_flash_kernel
// (launched by _flash_forward, reached through flash_attention). Same math:
// scores q.k in f32 times 1/sqrt(D); a score is kept where
// kv_pos <= q_pos and set to -1e30 otherwise (not -inf: a row whose first
// tile is fully masked gets p = exp(0) = 1 there, and the first real score
// wipes it with corr = exp(-1e30 - m) = 0; with -inf that row would be
// (-inf) - (-inf) = NaN); an online softmax with f32 running max, sum and
// accumulator; the unnormalised p cast to v's dtype before the value
// product, while the sum adds the f32 p; out = acc / max(l, 1e-30).
// A kv tile is skipped when min(kv_pos of the tile) > max(q_pos of the
// q tile), the JAX kernel's predicate. Positions are per batch row and
// shared by its heads.
//
// Bound. Causal attention does 2*B*H*S^2*D operations (the two products,
// half of the S x S tiles) against 2*(B*S*H*D) + 2*(B*S*KV*D) elements of
// q, k, v and o: at S = 2048, D = 64 that is ~750 operations a byte, so the
// kernel is bound by the tensor cores, not by HBM. The design keeps the
// S x S scores out of device memory and feeds both products to the tensor
// cores:
// - One block of 4 warps per (64-row q tile, head, batch row); each warp
//   owns 16 query rows. Q is staged once through shared memory into
//   mma fragments that stay in registers.
// - The block first lists the kv tiles it must visit (a warp reduces each
//   tile's 64 positions with shuffles): skipped tiles are never loaded,
//   and a tile whose every kv position is <= every q position of the
//   block skips the mask.
// - K, V and kv-position tiles of 64 rows stream into shared memory with
//   cp.async, two stages deep: the next tile loads while this one
//   computes. Rows are padded by 16 bytes so that ldmatrix is free of bank
//   conflicts.
// - S = Q K^T and P V run on mma.sync.m16n8k16 (bf16 in, f32 accumulate),
//   K's and V's B fragments come from ldmatrix (.trans for V), and the f32
//   score fragment is re-packed in registers as the bf16 A operand of P V
//   (no shared-memory round trip).
// - K/V are read at their own head count: query head h reads kv head
//   h / (H / KV), so grouped-query attention needs no expanded copy.
// - Tensors are read through their strides ([B, S, H, D] with D
//   contiguous), so the caller's layout needs no transpose.
// - Q tiles with the most unmasked kv tiles launch first (causal balance).
// Not done yet (later work): wgmma, TMA, warp specialisation, 128-row q
// tiles (each K/V tile is read from shared memory once per 16 query rows).
//
// f32 inputs take a plain-FMA kernel (16-row tiles in shared memory); it
// exists for the f32 models and tests, not for speed.
//
// C interface, loaded with ctypes: kukeon_flash_attention(...) returns
// cudaGetLastError() after the launch (0 = success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;       // the JAX kernel's mask and initial max
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kTile = 64;               // q rows per block, kv rows per tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxS = 1 << 16;          // bounds the kv-tile list in shared memory

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int* q_pos;
  const int* kv_pos;
  int S, H, KV;
  // Element strides (batch, seq, head) of q, k, v, o; D is contiguous.
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh;
  float scale;
};

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a * b: one 16x8x16 bf16 product, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices from shared memory (lanes 8i..8i+7 give the row
// addresses of matrix i).
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const __nv_bfloat16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Four 8x8 bf16 matrices from shared memory, transposed on the way in.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const __nv_bfloat16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows [0, 64) of a [S, D] slab (row stride `ld` elements) -> smem [64][LD],
// asynchronously (cp.async, 16 bytes a thread per copy).
template <int D, int LD>
__device__ __forceinline__ void stage_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           long long ld) {
  constexpr int kChunks = D / 8;        // 16-byte chunks per row
  static_assert(kTile * kChunks % kThreads == 0, "tile chunks split evenly");
#pragma unroll
  for (int it = 0; it < kTile * kChunks / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i / kChunks, c = (i % kChunks) * 8;
    cp_async16(dst + r * LD + c, src + r * ld + c);
  }
}

// min and max of 64 positions, computed by every warp (lane reads 2).
__device__ __forceinline__ void warp_min_max(const int* pos, int lane, int& mn, int& mx) {
  const int a = pos[lane], b = pos[lane + 32];
  mn = min(a, b);
  mx = max(a, b);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    mn = min(mn, __shfl_xor_sync(0xffffffffu, mn, off));
    mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  }
}

template <int D>
__host__ __device__ constexpr int tile_bytes() { return kTile * (D + 8) * 2; }

// Dynamic shared memory of the bf16 kernel: two stages of (K, V, kv
// positions), the q positions, and the list of the kv tiles to visit.
template <int D>
size_t bf16_smem_bytes(int S) {
  return 4 * tile_bytes<D>() + 2 * kTile * 4 + kTile * 4 + (S / kTile) * 4;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_bf16_kernel(const Params p) {
  constexpr int LD = D + 8;             // padded smem row (elements)
  constexpr int KS = D / 16;            // k-steps of Q K^T
  constexpr int DT = D / 8;             // 8-column tiles of the output
  extern __shared__ __align__(16) unsigned char smem[];
  // Stage st: K at smem + st * T, V at smem + (2 + st) * T, T = tile_bytes.
  const auto k_s = [&](int st) {
    return reinterpret_cast<__nv_bfloat16*>(smem + st * tile_bytes<D>());
  };
  const auto v_s = [&](int st) {
    return reinterpret_cast<__nv_bfloat16*>(smem + (2 + st) * tile_bytes<D>());
  };
  int* kv_pos_base = reinterpret_cast<int*>(smem + 4 * tile_bytes<D>());
  const auto kv_pos_s = [&](int st) { return kv_pos_base + st * kTile; };
  int* q_pos_s = kv_pos_base + 2 * kTile;
  int* tiles = q_pos_s + kTile;         // kv tiles to visit; bit 30: no mask needed
  __shared__ int n_tiles;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16 + g;         // this thread's rows: r0 and r0 + 8

  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb +
                            q0 * p.q_ss + h * p.q_sh;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  const int* qpos = p.q_pos + static_cast<long long>(b) * p.S;
  const int* kvpos = p.kv_pos + static_cast<long long>(b) * p.S;
  const int n_kt = p.S / kTile;

  // Q tile -> registers (A fragments), staged through the second K buffer.
  stage_tile<D, LD>(k_s(1), qg, p.q_ss);
  cp_async_commit();
  if (threadIdx.x < kTile) q_pos_s[threadIdx.x] = qpos[q0 + threadIdx.x];
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const __nv_bfloat16* base = k_s(1) + r0 * LD + kk * 16 + 2 * t;
    qf[kk][0] = ld_u32(base);
    qf[kk][1] = ld_u32(base + 8 * LD);
    qf[kk][2] = ld_u32(base + 8);
    qf[kk][3] = ld_u32(base + 8 * LD + 8);
  }
  const int qp0 = q_pos_s[r0], qp1 = q_pos_s[r0 + 8];
  int q_min, q_max;
  warp_min_max(q_pos_s, lane, q_min, q_max);

  // The kv tiles this q tile visits, in order: skipped when every kv
  // position exceeds every q position (the JAX predicate), unmasked when
  // every kv position is <= every q position.
  for (int kt = warp; kt < n_kt; kt += kWarps) {
    int mn, mx;
    warp_min_max(kvpos + kt * kTile, lane, mn, mx);
    if (lane == 0) tiles[kt] = mn > q_max ? -1 : (kt | (mx <= q_min ? 1 << 30 : 0));
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int n = 0;
    for (int kt = 0; kt < n_kt; ++kt) {
      if (tiles[kt] >= 0) tiles[n++] = tiles[kt];
    }
    n_tiles = n;
  }
  __syncthreads();                      // also: every warp has read Q out of k_s(1)
  const int n_visit = n_tiles;

  auto load_stage = [&](int i) {
    const int k0 = (tiles[i] & ~(1 << 30)) * kTile;
    const int st = i & 1;
    stage_tile<D, LD>(k_s(st), kg + k0 * p.k_ss, p.k_ss);
    stage_tile<D, LD>(v_s(st), vg + k0 * p.v_ss, p.v_ss);
    if (threadIdx.x < kTile / 4) {
      cp_async16(kv_pos_s(st) + 4 * threadIdx.x, kvpos + k0 + 4 * threadIdx.x);
    }
    cp_async_commit();
  };

  const float scale = p.scale * kLog2e; // exp(x) = exp2(x * log2 e)
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;

  if (n_visit > 0) load_stage(0);
  for (int i = 0; i < n_visit; ++i) {
    if (i + 1 < n_visit) {
      load_stage(i + 1);                // the next tile streams in during this one
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int st = i & 1;
    const bool visible = (tiles[i] >> 30) & 1;
    const __nv_bfloat16* ks = k_s(st);
    const __nv_bfloat16* vs = v_s(st);
    const int* kps = kv_pos_s(st);

    // s = Q K^T for this warp's 16 rows x 64 kv columns (8 n-tiles).
    // B fragments of K come four 8x8 matrices at a time: rows 8nt..8nt+7,
    // columns 16kk..16kk+31 (k-steps kk and kk+1).
    float s[8][4];
    const __nv_bfloat16* kb = ks + (lane & 7) * LD + (lane >> 3) * 8;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; kk += 2) {
        uint32_t bk[4];
        ldmatrix_x4(bk, kb + nt * 8 * LD + kk * 16);
        mma_bf16(s[nt], qf[kk], bk[0], bk[1]);
        mma_bf16(s[nt], qf[kk + 1], bk[2], bk[3]);
      }
    }

    // Scale and mask (log2 domain), then the tile's row max.
    if (visible) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] *= scale;
    } else {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool keep = kps[nt * 8 + 2 * t + (e & 1)] <= (e < 2 ? qp0 : qp1);
          s[nt][e] = keep ? s[nt][e] * scale : kNegInf;
        }
    }
    float mc0 = kNegInf, mc1 = kNegInf;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      mc0 = fmaxf(mc0, fmaxf(s[nt][0], s[nt][1]));
      mc1 = fmaxf(mc1, fmaxf(s[nt][2], s[nt][3]));
    }
    // The 4 threads of a quad hold one row's 64 columns.
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mc0 = fmaxf(mc0, __shfl_xor_sync(0xffffffffu, mc0, off));
      mc1 = fmaxf(mc1, __shfl_xor_sync(0xffffffffu, mc1, off));
    }
    const float mn0 = fmaxf(m0, mc0), mn1 = fmaxf(m1, mc1);
    const float corr0 = exp2f(m0 - mn0), corr1 = exp2f(m1 - mn1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = exp2f(s[nt][0] - mn0);
      s[nt][1] = exp2f(s[nt][1] - mn0);
      s[nt][2] = exp2f(s[nt][2] - mn1);
      s[nt][3] = exp2f(s[nt][3] - mn1);
      sum0 += s[nt][0] + s[nt][1];
      sum1 += s[nt][2] + s[nt][3];
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
    }
    l0 = l0 * corr0 + sum0;
    l1 = l1 * corr1 + sum1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      acc[dt][0] *= corr0;
      acc[dt][1] *= corr0;
      acc[dt][2] *= corr1;
      acc[dt][3] *= corr1;
    }

    // acc += bf16(p) V: the score fragments of n-tiles 2j, 2j+1 form the A
    // operand of kv rows [16j, 16j+16).
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t a[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                             pack_bf16(s[2 * j][2], s[2 * j][3]),
                             pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                             pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
      const int mi = lane >> 3;         // which of the four 8x8 matrices
      const __nv_bfloat16* vb = vs + (16 * j + (mi & 1) * 8 + (lane & 7)) * LD + (mi >> 1) * 8;
#pragma unroll
      for (int dt = 0; dt < DT; dt += 2) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, vb + dt * 8);
        mma_bf16(acc[dt], a, bv[0], bv[1]);
        mma_bf16(acc[dt + 1], a, bv[2], bv[3]);
      }
    }
    __syncthreads();                    // this stage is refilled two tiles on
  }

  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + (q0 + r0) * p.o_ss +
                      h * p.o_sh + 2 * t;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    *reinterpret_cast<__nv_bfloat162*>(og + dt * 8) =
        __floats2bfloat162_rn(acc[dt][0] / d0, acc[dt][1] / d0);
    *reinterpret_cast<__nv_bfloat162*>(og + 8 * p.o_ss + dt * 8) =
        __floats2bfloat162_rn(acc[dt][2] / d1, acc[dt][3] / d1);
  }
}

// f32: one block of 128 threads per (16-row q tile, head, batch row), kv
// tiles of 16 rows, every product a plain FMA from shared memory.
constexpr int kTile32 = 16;

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const Params p) {
  __shared__ float q_s[kTile32][D];
  __shared__ float k_s[kTile32][D + 1];
  __shared__ float v_s[kTile32][D];
  __shared__ float s_s[kTile32][kTile32];
  __shared__ float acc_s[kTile32][D];
  __shared__ float m_s[kTile32], l_s[kTile32], corr_s[kTile32];
  __shared__ int q_pos_s[kTile32], kv_pos_s[kTile32];

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile32;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const int tid = threadIdx.x;
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + q0 * p.q_ss + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  const int* qpos = p.q_pos + static_cast<long long>(b) * p.S;
  const int* kvpos = p.kv_pos + static_cast<long long>(b) * p.S;

  for (int i = tid; i < kTile32 * D; i += kThreads) {
    const int r = i / D, c = i % D;
    q_s[r][c] = qg[r * p.q_ss + c];
    acc_s[r][c] = 0.f;
  }
  if (tid < kTile32) {
    q_pos_s[tid] = qpos[q0 + tid];
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  __syncthreads();
  int q_max = q_pos_s[0];
  for (int i = 1; i < kTile32; ++i) q_max = max(q_max, q_pos_s[i]);

  for (int k0 = 0; k0 < p.S; k0 += kTile32) {
    if (tid < kTile32) kv_pos_s[tid] = kvpos[k0 + tid];
    __syncthreads();
    int kv_min = kv_pos_s[0];
    for (int i = 1; i < kTile32; ++i) kv_min = min(kv_min, kv_pos_s[i]);
    if (kv_min > q_max) {
      __syncthreads();
      continue;
    }
    for (int i = tid; i < kTile32 * D; i += kThreads) {
      const int r = i / D, c = i % D;
      k_s[r][c] = kg[(k0 + r) * p.k_ss + c];
      v_s[r][c] = vg[(k0 + r) * p.v_ss + c];
    }
    __syncthreads();
    for (int i = tid; i < kTile32 * kTile32; i += kThreads) {
      const int r = i / kTile32, c = i % kTile32;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) dot = fmaf(q_s[r][d], k_s[c][d], dot);
      s_s[r][c] = kv_pos_s[c] <= q_pos_s[r] ? dot * p.scale : kNegInf;
    }
    __syncthreads();
    if (tid < kTile32) {
      float mc = kNegInf;
      for (int c = 0; c < kTile32; ++c) mc = fmaxf(mc, s_s[tid][c]);
      const float mn = fmaxf(m_s[tid], mc);
      float sum = 0.f;
      for (int c = 0; c < kTile32; ++c) {
        const float e = expf(s_s[tid][c] - mn);
        s_s[tid][c] = e;
        sum += e;
      }
      const float corr = expf(m_s[tid] - mn);
      corr_s[tid] = corr;
      l_s[tid] = l_s[tid] * corr + sum;
      m_s[tid] = mn;
    }
    __syncthreads();
    for (int i = tid; i < kTile32 * D; i += kThreads) {
      const int r = i / D, c = i % D;
      float pv = 0.f;
#pragma unroll
      for (int j = 0; j < kTile32; ++j) pv = fmaf(s_s[r][j], v_s[j][c], pv);
      acc_s[r][c] = acc_s[r][c] * corr_s[r] + pv;
    }
    __syncthreads();
  }

  float* og = static_cast<float*>(p.o) + b * p.o_sb + q0 * p.o_ss + h * p.o_sh;
  for (int i = tid; i < kTile32 * D; i += kThreads) {
    const int r = i / D, c = i % D;
    og[r * p.o_ss + c] = acc_s[r][c] / fmaxf(l_s[r], 1e-30f);
  }
}

template <int D>
cudaError_t launch(const Params& p, int B, bool is_bf16, cudaStream_t st) {
  if (is_bf16) {
    const dim3 grid(p.S / kTile, p.H, B);
    // Dynamic shared memory above 48 KB (D = 128, or long S) needs the
    // kernel's limit raised first; raise it once to the most any S takes.
    static const cudaError_t raised = cudaFuncSetAttribute(
        flash_fwd_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bf16_smem_bytes<D>(kMaxS)));
    if (raised != cudaSuccess) return raised;
    flash_fwd_bf16_kernel<D><<<grid, kThreads, bf16_smem_bytes<D>(p.S), st>>>(p);
  } else {
    const dim3 grid(p.S / kTile32, p.H, B);
    flash_fwd_f32_kernel<D><<<grid, kThreads, 0, st>>>(p);
  }
  return cudaSuccess;
}

}  // namespace

// q [B,S,H,D], k and v [B,S,KV,D], o [B,S,H,D], all bf16 (is_bf16) or all
// f32, read and written through `strides`: 12 element strides, (batch, seq,
// head) for q, k, v, o in that order; D is contiguous. q_pos and kv_pos are
// int32 [B,S], contiguous and 16-byte aligned. S a multiple of 64 and at
// most 65536, H a multiple of KV, D in {32, 64, 128}. For bf16 every row
// start must be 16-byte aligned.
extern "C" int kukeon_flash_attention(const void* q, const void* k, const void* v, void* o,
                                      const void* q_pos, const void* kv_pos, int B, int S,
                                      int H, int KV, int D, const long long* strides,
                                      int is_bf16, void* stream) {
  if (B < 1 || S < kTile || S % kTile || S > kMaxS || KV < 1 || H % KV) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.q_pos = static_cast<const int*>(q_pos);
  p.kv_pos = static_cast<const int*>(kv_pos);
  p.S = S;
  p.H = H;
  p.KV = KV;
  p.q_sb = strides[0]; p.q_ss = strides[1]; p.q_sh = strides[2];
  p.k_sb = strides[3]; p.k_ss = strides[4]; p.k_sh = strides[5];
  p.v_sb = strides[6]; p.v_ss = strides[7]; p.v_sh = strides[8];
  p.o_sb = strides[9]; p.o_ss = strides[10]; p.o_sh = strides[11];
  p.scale = 1.0f / sqrtf(static_cast<float>(D));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 32: err = launch<32>(p, B, is_bf16 != 0, st); break;
    case 64: err = launch<64>(p, B, is_bf16 != 0, st); break;
    case 128: err = launch<128>(p, B, is_bf16 != 0, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
