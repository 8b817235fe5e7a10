// Weight-only int8 matmul for decode, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas kernels kukeon_tpu/ops/int8_matmul.py::_kernel
// (h[B,K] @ q[K,N] * s[N]) and ::_kernel_t (h[B,K] @ q[N,K]^T * s[N], the
// tied-embedding LM head), and the MoE expert product
// ::int8_matmul_expert (x[E,C,K] @ q[E,K,N] * s[E,N] -> [E,C,N]), which the
// TPU runs as E launches of _kernel and this file runs as one launch with
// the expert on a grid axis. Same math: every product h*q is exact in f32,
// the sum accumulates in f32, the f32 per-column scale s[n] multiplies the
// sum, and one cast produces the output in h's dtype (bf16, or f32).
//
// Bound. Decode runs B <= 64 rows against weights read once per step, so
// the kernels are bound by bytes, not operations:
//     bytes = K*N (int8 weights) + 4*N (scales) + e*B*K (h) + e*B*N (out),
// e = 2 for bf16; at B = 4 the weights are > 99% of it, and the least time
// is bytes / HBM bandwidth (3.35 TB/s on an H100 SXM). The operations,
// 2*B*K*N, are far below the tensor cores' line at this B.
//
// K1 with bf16 activations (int8_mm_bf16_kernel; every llama3-8b and
// Mixtral trunk decode projection). Three things held the f32-FMA body
// below (still the f32 routes) at 3.6x its bound: the int8
// -> f32 conversion (I2F runs at a quarter rate) plus RB FMAs a weight,
// one 16-byte load in flight per thread, and a second launch that summed
// the K slices' f32 partials. Against pure streaming reads of the same
// tiles, what then remained lay at each block's end, where it streams
// nothing: the sum across its warps (a shared-memory pass that was 16-way
// bank-conflicted) and across the K slices (f32 partials through global
// memory, a fence and an atomic, each a loaded round trip). The design:
// - One block per (128-column tile, K slice, 8-row group of h): every row
//   of q is read as whole 128-byte lines. The K slices of a (tile, row
//   group), at most 8 (k_slice_bf16 in ops/int8_matmul.py: wq/wo 32 tiles
//   x 4 slices, wk/wv 8 x 8, the MLP 112 or 32 tiles x 2 or 7, the head
//   1002 x 2), form one thread block cluster.
// - The weights stream through a 4-stage cp.async ring in shared memory
//   (16 KB stages of 128 k rows x 128 columns, 48 KB in flight per block,
//   two blocks an SM), XOR-swizzled so that the fragment reads are free of
//   bank conflicts. Each stage also brings its 128 k of the rows of h, so
//   a K slice of any length fits.
// - The product runs on mma.sync.m16n8k16 in bf16, as the TPU kernel
//   dequantises to bf16 for its matrix unit: weights are the A operand (16
//   output columns by 16 k), the rows of h the B operand (padded to the
//   mma's 8). int8 is exact in bf16 and every product is exact in the f32
//   accumulator. The conversion costs 2.5 ALU operations a weight (prmt
//   into the f32 0x4B0000xx pattern, one fadd, a prmt that keeps the upper
//   halves), not I2F.
// - One launch, no partials in global memory: each block sums its 8 warps
//   in shared memory in order; after a cluster barrier, each block of the
//   cluster takes a share of the outputs, reads the slices' sums through
//   distributed shared memory in slice order, applies s in f32, casts once
//   and writes out. Every sum has a fixed order, so the output is
//   bit-identical run to run.
// Rows of h past 8 take further 8-row groups on the grid (each re-reads
// the weights; decode runs B = 4).
//
// K1t with bf16 activations (int8_mm_t_bf16_kernel; the tied LM head of
// llama3-1b, K 2048 x N 128256, 263 MB of weights a call) is the same
// design turned to q [N,K], one launch, no workspace:
// - The rows of q are the mma's A operand as they lie (M = output
//   columns, k contiguous) and the rows of h its B operand, so neither is
//   transposed. Within each 64 k, a lane takes 16 consecutive k of two
//   rows of q (one 16-byte read each, enough for 4 mma steps) and the same
//   16 k of a row of h; both operands see one permutation of k, which
//   leaves the sum as it is. The conversion pairs adjacent k of one row.
// - Warp w takes 16 rows of q and every k of a stage, so each output is
//   summed in one warp: the block's end has no sum across warps.
// - The same 4-stage ring (stages of 128 rows of q x 128 k, one 128-byte
//   line a row, and that stage's 128 k of h), and the same cluster sum
//   over at most 8 K slices (k_slice_t_bf16). At 74 registers three
//   blocks fit an SM; the 1B head's 1002 tiles would be 2.5 waves of
//   them, and its 2 slices of 1024 (5.1 waves, a short last one) run 3%
//   faster than no split on an H100 (tools/k1t_sweep.py).
// - The 8-row groups of h are the grid's x, so the groups of one tile run
//   side by side and share its weights through L2.
//
// With f32 activations both layouts keep the first design (the tiny
// models, whose f32 h the bf16 mma would round): one 16-byte __ldg of int8
// weights a thread a k row, f32 FMAs, N tiles x K slices into an f32
// workspace, and reduce_scale_kernel as a second launch that sums the
// slices in a fixed order. Rows of h are taken RB at a time (RB in
// {1,2,4,8}) as a grid axis; the accumulators of all RB rows stay in
// registers. Experts with f32 activations take the same body with the
// grid's z axis expert x row group (GROUPED), every pointer stepping by its
// expert's stride.
//
// Experts with bf16 activations (the Mixtral decode path) take
// int8_mm_expert_bf16_kernel, the design K1's bf16 kernel grew from: the
// same tiles, ring and mma body, with each K slice of x staged once and
// the slices summed by reduce_scale_kernel, a second launch. At C = 4 the
// grouped product streams 470 MB of weights a call. On top of the body it
// skips weights no token needs: a block first
// stages its activation rows (its expert, 8-row group and K slice); when
// every one is exactly 0 (dense dispatch leaves an expert that no token
// chose with zero rows) it loads no weights and writes +0 partials. That
// is the sum the full product gives (+0 products summed into +0; int8
// weights and finite activations make no NaN), so the output is
// bit-identical.
//
// C interface, loaded with ctypes: kukeon_int8_matmul(...) (f32),
// kukeon_int8_matmul_bf16(...), kukeon_int8_matmul_t_bf16(...) and
// kukeon_int8_matmul_expert(...) return cudaGetLastError() after their
// launches (0 = success), or the error of the launch's set-up.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kVec = 16;                 // int8 weights per 16-byte load
constexpr int kNTile = 32 * kVec;        // q[K,N]: 512 columns per block
constexpr int kMaxKs = 512;              // largest K slice staged in shared memory
constexpr int kRowsPerWarpT = 4;         // q[N,K]: output columns per warp
constexpr int kNTileT = kWarps * kRowsPerWarpT;
constexpr int kPadT = kMaxKs + kMaxKs / 4;  // padded h row, conflict-free float4 reads

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// 16 int8 (little-endian bytes of one int4) -> 16 f32, in address order.
__device__ __forceinline__ void unpack16(const int4 v, float w[kVec]) {
  const int words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      w[i * 4 + j] = static_cast<float>(static_cast<int8_t>((words[i] >> (8 * j)) & 0xff));
    }
  }
}

// Stage h[b0 : b0+RB, k0 : k0+ks]; rows past B are zero. The transposed
// kernel pads 4 floats after every 16 so that lane i's float4 reads at
// i*20 words hit distinct banks.
template <int RB, int LD, bool PAD>
__device__ __forceinline__ void stage_h(float (*h_s)[LD], const float* __restrict__ h,
                                        int B, int K, int b0, int k0, int ks) {
  for (int i = threadIdx.x; i < RB * ks; i += kThreads) {
    const int r = i / ks, c = i % ks;
    const int cs = PAD ? c + (c / kVec) * 4 : c;
    h_s[r][cs] = (b0 + r < B) ? h[static_cast<size_t>(b0 + r) * K + k0 + c] : 0.f;
  }
}

// q[K,N]. Block (x, y, z) = (512-column tile, K slice, expert x RB-row
// group). Warp w takes rows k0+w, k0+w+8, ... of the slice; lane l owns
// columns [16l, 16l+16) of the tile. Warps are summed in shared memory in
// order. GROUPED: expert e = z / groups reads h[e] ([B,K]) and q[e]
// ([K,N]) and writes rows e*B.. of each workspace slice, which holds E*B
// rows; otherwise z is the row group alone (E = 1).
template <int RB, bool GROUPED>
__global__ void __launch_bounds__(kThreads)
int8_mm_kernel(const float* __restrict__ h, const int8_t* __restrict__ q,
               float* __restrict__ ws, int B, int K, int N, int ks, int groups, int E) {
  __shared__ float h_s[RB][kMaxKs];
  __shared__ float red[kWarps][kNTile];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int k0 = blockIdx.y * ks;
  const int e = GROUPED ? blockIdx.z / groups : 0;
  const int b0 = (GROUPED ? blockIdx.z % groups : blockIdx.z) * RB;
  const int n0 = blockIdx.x * kNTile + lane * kVec;
  if (GROUPED) {
    h += static_cast<size_t>(e) * B * K;
    q += static_cast<size_t>(e) * K * N;
  }
  const int ws_rows = GROUPED ? E * B : B;

  stage_h<RB, kMaxKs, false>(h_s, h, B, K, b0, k0, ks);
  __syncthreads();

  float acc[RB][kVec];
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int j = 0; j < kVec; ++j) acc[r][j] = 0.f;

  if (n0 < N) {
    const int8_t* qp = q + static_cast<size_t>(k0) * N + n0;
#pragma unroll 4
    for (int kk = warp; kk < ks; kk += kWarps) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(qp + static_cast<size_t>(kk) * N));
      float w[kVec];
      unpack16(v, w);
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const float hv = h_s[r][kk];
#pragma unroll
        for (int j = 0; j < kVec; ++j) acc[r][j] = fmaf(hv, w[j], acc[r][j]);
      }
    }
  }

  const int rows = min(RB, B - b0);
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    if (r < rows) {  // uniform across the block
#pragma unroll
      for (int j = 0; j < kVec; ++j) red[warp][lane * kVec + j] = acc[r][j];
      __syncthreads();
      for (int c = threadIdx.x; c < kNTile; c += kThreads) {
        const int n = blockIdx.x * kNTile + c;
        if (n < N) {
          float sum = 0.f;
#pragma unroll
          for (int w2 = 0; w2 < kWarps; ++w2) sum += red[w2][c];
          ws[(static_cast<size_t>(blockIdx.y) * ws_rows + e * B + b0 + r) * N + n] = sum;
        }
      }
      __syncthreads();
    }
  }
}

// q[N,K]. Block (x, y, z) = (32-row tile of q, K slice, RB-row group of h).
// Warp w owns rows n of q; lane l reads q[n, k0+16l : k0+16l+16] for each
// of its 4 rows (4 loads in flight), then a fixed-order shuffle tree sums
// the lanes.
template <int RB>
__global__ void __launch_bounds__(kThreads)
int8_mm_t_kernel(const float* __restrict__ h, const int8_t* __restrict__ q,
                 float* __restrict__ ws, int B, int K, int N, int ks) {
  __shared__ __align__(16) float h_s[RB][kPadT];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int k0 = blockIdx.y * ks;
  const int b0 = blockIdx.z * RB;
  const int nb = blockIdx.x * kNTileT + warp * kRowsPerWarpT;

  stage_h<RB, kPadT, true>(h_s, h, B, K, b0, k0, ks);
  __syncthreads();

  float acc[kRowsPerWarpT][RB];
#pragma unroll
  for (int i = 0; i < kRowsPerWarpT; ++i)
#pragma unroll
    for (int r = 0; r < RB; ++r) acc[i][r] = 0.f;

  for (int kk = lane * kVec; kk < ks; kk += 32 * kVec) {
    float w[kRowsPerWarpT][kVec];
#pragma unroll
    for (int i = 0; i < kRowsPerWarpT; ++i) {
      int4 v = make_int4(0, 0, 0, 0);
      if (nb + i < N) {
        v = __ldg(reinterpret_cast<const int4*>(
            q + static_cast<size_t>(nb + i) * K + k0 + kk));
      }
      unpack16(v, w[i]);
    }
    const int base = kk + (kk / kVec) * 4;
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      float hv[kVec];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float4 f = *reinterpret_cast<const float4*>(&h_s[r][base + 4 * c]);
        hv[4 * c] = f.x; hv[4 * c + 1] = f.y; hv[4 * c + 2] = f.z; hv[4 * c + 3] = f.w;
      }
#pragma unroll
      for (int i = 0; i < kRowsPerWarpT; ++i)
#pragma unroll
        for (int j = 0; j < kVec; ++j) acc[i][r] = fmaf(hv[j], w[i][j], acc[i][r]);
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarpT; ++i)
#pragma unroll
    for (int r = 0; r < RB; ++r)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[i][r] += __shfl_xor_sync(0xffffffffu, acc[i][r], off);

  if (lane == 0) {
    const int rows = min(RB, B - b0);
#pragma unroll
    for (int i = 0; i < kRowsPerWarpT; ++i) {
      if (nb + i >= N) break;
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        if (r < rows) {
          ws[(static_cast<size_t>(blockIdx.y) * B + b0 + r) * N + nb + i] = acc[i][r];
        }
      }
    }
  }
}

// out[e, b, n] = cast(sum over slices of ws[slice, e*B + b, n], in slice
// order, * s[e, n]); E*B rows in all (GROUPED), else B rows and s[n].
template <typename T, bool GROUPED>
__global__ void reduce_scale_kernel(const float* __restrict__ ws, const float* __restrict__ s,
                                    T* __restrict__ out, int B, int N, int splits, int E) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const size_t per_expert = static_cast<size_t>(B) * N;
  const size_t total = GROUPED ? per_expert * E : per_expert;
  if (idx >= total) return;
  float acc = 0.f;
  for (int sp = 0; sp < splits; ++sp) acc += ws[sp * total + idx];
  const size_t col = GROUPED ? (idx / per_expert) * N + idx % N : idx % N;
  out[idx] = from_f32<T>(acc * s[col]);
}

// ---- the grouped bf16 expert kernel -------------------------------------

constexpr int kEThreads = 256;
constexpr int kENTile = 128;               // output columns per block
constexpr int kEKStage = 128;              // k rows per ring stage
constexpr int kEStages = 4;
constexpr int kEStageBytes = kEKStage * kENTile;
constexpr int kERows = 8;                  // activation rows per block (the mma's n)
constexpr int kEMaxKs = 2048;

size_t expert_smem_bytes(int ks) {
  return static_cast<size_t>(kEStages) * kEStageBytes + kERows * (ks + 8) * 2;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(r) : "r"(a), "r"(b), "r"(sel));
  return r;
}

// Byte `i` of two words of int8 weights, each flipped to excess-128 (x ^
// 0x80) -> one bf16 pair (lo from a, hi from b), exactly: the byte u goes
// into the f32 0x4B0000uu = 2^23 + u, less 2^23 + 128 gives the int8 value,
// whose f32 has zeros in its low 16 bits, so the upper half is its bf16.
__device__ __forceinline__ uint32_t i8x2_to_bf16x2(uint32_t a, uint32_t b, uint32_t i) {
  const float fa = __uint_as_float(prmt(a, 0x4B000000u, 0x7540u | i)) - 8388736.f;
  const float fb = __uint_as_float(prmt(b, 0x4B000000u, 0x7540u | i)) - 8388736.f;
  return prmt(__float_as_uint(fa), __float_as_uint(fb), 0x7632u);
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

// x [E,C,K] bf16 @ q [E,K,N] int8 -> f32 partials. Block (x, y, z) =
// (128-column tile, K slice, expert x 8-row group). A ring stage holds 128
// k rows x 128 columns, row r's 16-byte chunk ch at chunk ch ^ 2((r/2)%4).
// Warp w takes k rows [16w, 16w+16) of every stage. Lane (g, t) reads
// chunk g of rows 2t, 2t+1, 2t+8, 2t+9: columns 16g..16g+15, which feed
// the A rows g and g+8 of 8 mma tiles (tile j: columns 16g+2j, 16g+2j+1).
__global__ void __launch_bounds__(kEThreads, 2)
int8_mm_expert_bf16_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
                           float* __restrict__ ws, int C, int K, int N, int ks, int groups,
                           int E) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;
  __nv_bfloat16* x_s = reinterpret_cast<__nv_bfloat16*>(smem + kEStages * kEStageBytes);
  const int xld = ks + 8;                  // padded: the B fragment reads miss no bank twice
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * kENTile;
  const int k0 = blockIdx.y * ks;
  const int e = blockIdx.z / groups;
  const int c0 = (blockIdx.z % groups) * kERows;
  const int rows = min(kERows, C - c0);
  x += (static_cast<size_t>(e) * C + c0) * K + k0;
  q += static_cast<size_t>(e) * K * N + static_cast<size_t>(k0) * N + n0;
  float* wsp = ws + (static_cast<size_t>(blockIdx.y) * E * C + static_cast<size_t>(e) * C + c0) * N + n0;

  // Stage the activation rows (rows past C are zero) and look for a
  // nonzero one; the sign bit does not count (-0 is zero).
  bool nonzero = false;
  const int chunks = ks / 8;
  for (int i = threadIdx.x; i < kERows * chunks; i += kEThreads) {
    const int r = i / chunks, cc = i % chunks;
    int4 v = make_int4(0, 0, 0, 0);
    if (r < rows) v = __ldg(reinterpret_cast<const int4*>(x + static_cast<size_t>(r) * K + cc * 8));
    nonzero |= ((v.x | v.y | v.z | v.w) & 0x7FFF7FFF) != 0;
    *reinterpret_cast<int4*>(x_s + r * xld + cc * 8) = v;
  }
  if (!__syncthreads_or(nonzero)) {
    // No token was dispatched to these rows: every product is +0, and so is
    // the sum. No weight is read.
    for (int i = threadIdx.x; i < rows * kENTile; i += kEThreads) {
      wsp[static_cast<size_t>(i / kENTile) * N + i % kENTile] = 0.f;
    }
    return;
  }

  const int n_stages = ks / kEKStage;
  const auto load_stage = [&](int i) {
    unsigned char* dst = ring + (i % kEStages) * kEStageBytes;
    const int8_t* src = q + static_cast<size_t>(i) * kEKStage * N;
#pragma unroll
    for (int it = 0; it < kEStageBytes / 16 / kEThreads; ++it) {
      const int idx = threadIdx.x + it * kEThreads;
      const int r = idx >> 3, ch = idx & 7;
      cp_async16(dst + r * kENTile + ((ch ^ (((r >> 1) & 3) << 1)) << 4),
                 src + static_cast<size_t>(r) * N + ch * 16);
    }
  };
#pragma unroll
  for (int i = 0; i < kEStages - 1; ++i) {
    if (i < n_stages) load_stage(i);
    cp_async_commit();
  }

  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[j][v] = 0.f;

  const int rb = warp * 16;
  const int rr[4] = {rb + 2 * t, rb + 2 * t + 1, rb + 2 * t + 8, rb + 2 * t + 9};
  for (int i = 0; i < n_stages; ++i) {
    cp_async_wait<kEStages - 2>();
    __syncthreads();                     // stage i landed; stage i - 1 is free
    if (i + kEStages - 1 < n_stages) load_stage(i + kEStages - 1);
    cp_async_commit();
    const unsigned char* st = ring + (i % kEStages) * kEStageBytes;
    uint32_t w[4][4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const uint4 v = *reinterpret_cast<const uint4*>(
          st + rr[m] * kENTile + ((g ^ (((rr[m] >> 1) & 3) << 1)) << 4));
      w[m][0] = v.x ^ 0x80808080u;
      w[m][1] = v.y ^ 0x80808080u;
      w[m][2] = v.z ^ 0x80808080u;
      w[m][3] = v.w ^ 0x80808080u;
    }
    const __nv_bfloat16* xb = x_s + g * xld + i * kEKStage + rb + 2 * t;
    const uint32_t b0 = *reinterpret_cast<const uint32_t*>(xb);
    const uint32_t b1 = *reinterpret_cast<const uint32_t*>(xb + 8);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t byte = 2 * (j & 1);
      const uint32_t a[4] = {i8x2_to_bf16x2(w[0][j >> 1], w[1][j >> 1], byte),
                             i8x2_to_bf16x2(w[0][j >> 1], w[1][j >> 1], byte + 1),
                             i8x2_to_bf16x2(w[2][j >> 1], w[3][j >> 1], byte),
                             i8x2_to_bf16x2(w[2][j >> 1], w[3][j >> 1], byte + 1)};
      mma_bf16(acc[j], a, b0, b1);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // Sum the warps in order: red[warp][row][column] over the ring.
  float* red = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = 16 * g + 2 * j;
    red[(warp * kERows + 2 * t) * kENTile + n] = acc[j][0];
    red[(warp * kERows + 2 * t + 1) * kENTile + n] = acc[j][1];
    red[(warp * kERows + 2 * t) * kENTile + n + 1] = acc[j][2];
    red[(warp * kERows + 2 * t + 1) * kENTile + n + 1] = acc[j][3];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rows * kENTile; i += kEThreads) {
    const int r = i / kENTile, n = i % kENTile;
    float sum = 0.f;
#pragma unroll
    for (int w2 = 0; w2 < kEThreads / 32; ++w2) sum += red[(w2 * kERows + r) * kENTile + n];
    wsp[static_cast<size_t>(r) * N + n] = sum;
  }
}

cudaError_t launch_expert_bf16(const void* x, const void* q, const void* s, void* out, void* ws,
                               int E, int C, int K, int N, int ks, cudaStream_t st) {
  static const cudaError_t raised = cudaFuncSetAttribute(
      int8_mm_expert_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(expert_smem_bytes(kEMaxKs)));
  if (raised != cudaSuccess) return raised;
  const int groups = (C + kERows - 1) / kERows;
  const dim3 grid(N / kENTile, K / ks, E * groups);
  int8_mm_expert_bf16_kernel<<<grid, kEThreads, expert_smem_bytes(ks), st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
      static_cast<float*>(ws), C, K, N, ks, groups, E);
  const size_t total = static_cast<size_t>(E) * C * N;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  reduce_scale_kernel<__nv_bfloat16, true><<<blocks, threads, 0, st>>>(
      static_cast<const float*>(ws), static_cast<const float*>(s),
      static_cast<__nv_bfloat16*>(out), C, N, K / ks, E);
  return cudaSuccess;
}

// ---- K1, bf16 activations: one launch, the K slices summed in a cluster ---

constexpr int kBThreads = 256;
constexpr int kBNTile = 128;               // output columns per block
constexpr int kBKStage = 128;              // k rows per ring stage
constexpr int kBStages = 4;
constexpr int kBRows = 8;                  // rows of h per block (the mma's n)
constexpr int kBHld = kBKStage + 8;        // padded h row: the B fragment reads miss no bank twice
constexpr int kBWBytes = kBKStage * kBNTile;                 // a stage's weights, 16 KB
constexpr int kBStageBytes = kBWBytes + kBRows * kBHld * 2;  // and its rows of h
constexpr int kBSmemBytes = kBStages * kBStageBytes;
constexpr int kBMaxSplits = 8;             // K slices in a cluster: the portable cluster size
constexpr int kBRedLd = kBNTile + 4;       // padded row of the warps' sums

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// The float at `p` in this block's shared memory, read from the block of
// cluster rank `rank` (the same offset in its shared memory).
__device__ __forceinline__ float ld_cluster(const float* p, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote) : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))),
                 "r"(rank));
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(remote) : "memory");
  return v;
}

// Rows of h past `rows` are zero in every stage of the ring: no stage
// load writes them. The main loop's first barrier publishes them.
__device__ __forceinline__ void zero_h_padding(unsigned char* smem, int rows) {
  for (int i = threadIdx.x; i < kBStages * kBRows * (kBKStage / 8); i += kBThreads) {
    const int st = i / (kBRows * (kBKStage / 8)), r = i / (kBKStage / 8) % kBRows;
    const int c = i % (kBKStage / 8);
    if (r >= rows) {
      *reinterpret_cast<int4*>(smem + st * kBStageBytes + kBWBytes + (r * kBHld + c * 8) * 2) =
          make_int4(0, 0, 0, 0);
    }
  }
}

// Stage i's 128 k of the `rows` rows of h (row stride K from hs), behind
// the stage's weights at dst.
__device__ __forceinline__ void load_h_stage(unsigned char* dst, const __nv_bfloat16* hs, int K,
                                             int rows, int i) {
  if (threadIdx.x < rows * (kBKStage / 8)) {
    const int r = threadIdx.x / (kBKStage / 8), c = threadIdx.x % (kBKStage / 8);
    cp_async16(dst + kBWBytes + (r * kBHld + c * 8) * 2,
               hs + static_cast<size_t>(r) * K + i * kBKStage + c * 8);
  }
}

// The end of a cluster of K slices: each block finishes its share of the
// outputs. It sums the slices' part[row][column] (rows ld floats apart)
// in slice order through distributed shared memory, scales and casts
// once. The second barrier keeps every block's shared memory alive until
// the others have read it.
__device__ __forceinline__ void cluster_finish(const float* part, int ld, int rows,
                                               const float* __restrict__ s,
                                               __nv_bfloat16* __restrict__ out, int b0, int n0,
                                               int N) {
  cluster_sync();
  const int splits = gridDim.y;
  for (int i = threadIdx.x + static_cast<int>(cluster_rank()) * kBThreads; i < rows * kBNTile;
       i += kBThreads * splits) {
    const int r = i / kBNTile, n = i % kBNTile;
    float sum = 0.f;
#pragma unroll 4
    for (int sp = 0; sp < splits; ++sp) sum += ld_cluster(part + r * ld + n, sp);
    out[static_cast<size_t>(b0 + r) * N + n0 + n] = __float2bfloat16_rn(sum * __ldg(s + n0 + n));
  }
  cluster_sync();
}

// h [B,K] bf16 @ q [K,N] int8 * s [N] -> out [B,N] bf16. Block (x, y, z) =
// (128-column tile, K slice, 8-row group); the K/ks slices of a (tile, row
// group) form one cluster, rank = slice. A ring stage holds 128 k rows x
// 128 columns of q, row r's 16-byte chunk ch at chunk ch ^ 2((r/2)%4), then
// the stage's 128 k of each row of h (rows past B are zero). Warp w takes
// k rows [16w, 16w+16) of every stage. Lane (g, t) reads chunk g of rows
// 2t, 2t+1, 2t+8, 2t+9: columns 16g..16g+15, which feed the A rows g and
// g+8 of 8 mma tiles (tile j: columns 16g+2j, 16g+2j+1).
__global__ void __launch_bounds__(kBThreads, 2)
int8_mm_bf16_kernel(const __nv_bfloat16* __restrict__ h, const int8_t* __restrict__ q,
                    const float* __restrict__ s, __nv_bfloat16* __restrict__ out, int B, int K,
                    int N, int ks) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * kBNTile;
  const int k0 = blockIdx.y * ks;
  const int b0 = blockIdx.z * kBRows;
  const int rows = min(kBRows, B - b0);
  const int8_t* qs = q + static_cast<size_t>(k0) * N + n0;
  const __nv_bfloat16* hs = h + static_cast<size_t>(b0) * K + k0;

  zero_h_padding(smem, rows);

  const int n_stages = ks / kBKStage;
  const auto load_stage = [&](int i) {
    unsigned char* dst = smem + (i % kBStages) * kBStageBytes;
    const int8_t* src = qs + static_cast<size_t>(i) * kBKStage * N;
#pragma unroll
    for (int it = 0; it < kBWBytes / 16 / kBThreads; ++it) {
      const int idx = threadIdx.x + it * kBThreads;
      const int r = idx >> 3, ch = idx & 7;
      cp_async16(dst + r * kBNTile + ((ch ^ (((r >> 1) & 3) << 1)) << 4),
                 src + static_cast<size_t>(r) * N + ch * 16);
    }
    load_h_stage(dst, hs, K, rows, i);
  };
#pragma unroll
  for (int i = 0; i < kBStages - 1; ++i) {
    if (i < n_stages) load_stage(i);
    cp_async_commit();
  }

  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[j][v] = 0.f;

  const int rb = warp * 16;
  const int rr[4] = {rb + 2 * t, rb + 2 * t + 1, rb + 2 * t + 8, rb + 2 * t + 9};
  for (int i = 0; i < n_stages; ++i) {
    cp_async_wait<kBStages - 2>();
    __syncthreads();                     // stage i landed; stage i - 1 is free
    if (i + kBStages - 1 < n_stages) load_stage(i + kBStages - 1);
    cp_async_commit();
    const unsigned char* st = smem + (i % kBStages) * kBStageBytes;
    uint32_t w[4][4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const uint4 v = *reinterpret_cast<const uint4*>(
          st + rr[m] * kBNTile + ((g ^ (((rr[m] >> 1) & 3) << 1)) << 4));
      w[m][0] = v.x ^ 0x80808080u;
      w[m][1] = v.y ^ 0x80808080u;
      w[m][2] = v.z ^ 0x80808080u;
      w[m][3] = v.w ^ 0x80808080u;
    }
    const __nv_bfloat16* hb =
        reinterpret_cast<const __nv_bfloat16*>(st + kBWBytes) + g * kBHld + rb + 2 * t;
    const uint32_t b0r = *reinterpret_cast<const uint32_t*>(hb);
    const uint32_t b1r = *reinterpret_cast<const uint32_t*>(hb + 8);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t byte = 2 * (j & 1);
      const uint32_t a[4] = {i8x2_to_bf16x2(w[0][j >> 1], w[1][j >> 1], byte),
                             i8x2_to_bf16x2(w[0][j >> 1], w[1][j >> 1], byte + 1),
                             i8x2_to_bf16x2(w[2][j >> 1], w[3][j >> 1], byte),
                             i8x2_to_bf16x2(w[2][j >> 1], w[3][j >> 1], byte + 1)};
      mma_bf16(acc[j], a, b0r, b1r);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // Sum the warps in order through red[warp][row][column] over the ring
  // into this slice's part[row][column]. A lane holds columns 16g..16g+15
  // of rows 2t and 2t+1: four float4 stores a row, rows padded to kBRedLd
  // floats so that a quarter-warp's stores meet at most two to a bank.
  float* red = reinterpret_cast<float*>(smem);
  float* part = red + (kBThreads / 32) * kBRows * kBRedLd;
  float* mine = red + (warp * kBRows + 2 * t) * kBRedLd + 16 * g;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    *reinterpret_cast<float4*>(mine + 4 * c) =
        make_float4(acc[2 * c][0], acc[2 * c][2], acc[2 * c + 1][0], acc[2 * c + 1][2]);
    *reinterpret_cast<float4*>(mine + kBRedLd + 4 * c) =
        make_float4(acc[2 * c][1], acc[2 * c][3], acc[2 * c + 1][1], acc[2 * c + 1][3]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rows * kBNTile; i += kBThreads) {
    const int r = i / kBNTile, n = i % kBNTile;
    float sum = 0.f;
#pragma unroll
    for (int w2 = 0; w2 < kBThreads / 32; ++w2) sum += red[(w2 * kBRows + r) * kBRedLd + n];
    part[i] = sum;
  }
  cluster_finish(part, kBNTile, rows, s, out, b0, n0, N);
}

// ---- K1t, bf16 activations: q [N,K] as the mma's A operand, one launch ----

// Byte `i` and byte `i + 1` of a word of int8 weights, flipped to
// excess-128 -> one bf16 pair (lo from byte i), exactly, as
// i8x2_to_bf16x2 does for one byte of two words.
__device__ __forceinline__ uint32_t i8pair_to_bf16x2(uint32_t w, uint32_t i) {
  const float lo = __uint_as_float(prmt(w, 0x4B000000u, 0x7540u | i)) - 8388736.f;
  const float hi = __uint_as_float(prmt(w, 0x4B000000u, 0x7540u | (i + 1))) - 8388736.f;
  return prmt(__float_as_uint(lo), __float_as_uint(hi), 0x7632u);
}

// h [B,K] bf16 @ q [N,K]^T int8 * s [N] -> out [B,N] bf16. Block (x, y, z)
// = (8-row group, K slice, 128-row tile of q): the row groups of a tile
// are neighbours on the grid, so they meet its weights in L2. The K/ks
// slices of a (row group, tile) form one cluster, rank = slice. A ring
// stage holds the stage's 128 k of the tile's 128 rows of q, one 128-byte
// line a row, row r's 16-byte chunk ch at chunk ch ^ 4(r%2), then the
// stage's 128 k of each row of h (rows past B are zero), as in
// int8_mm_bf16_kernel. The rows of q are the mma's A operand as they lie
// (M = output columns, k contiguous) and the rows of h its B operand.
// Warp w takes rows [16w, 16w+16) of the tile and every k of a stage, so
// each output is summed in one warp. In each 64 k of a stage, lane (g, t)
// takes k [16t, 16t+16): chunk t of the group in rows g and g+8 of its
// warp's 16 (one 16-byte read each) and the same 16 k of row g of h. Mma
// step j of the group takes the lane's k 4j..4j+3 in the places of the
// mma's k 2t, 2t+1, 2t+8, 2t+9: one permutation of k for both operands,
// so the sum is unchanged.
__global__ void __launch_bounds__(kBThreads, 2)
int8_mm_t_bf16_kernel(const __nv_bfloat16* __restrict__ h, const int8_t* __restrict__ q,
                      const float* __restrict__ s, __nv_bfloat16* __restrict__ out, int B,
                      int K, int N, int ks) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int b0 = blockIdx.x * kBRows;
  const int k0 = blockIdx.y * ks;
  const int n0 = blockIdx.z * kBNTile;
  const int rows = min(kBRows, B - b0);
  const int8_t* qs = q + static_cast<size_t>(n0) * K + k0;
  const __nv_bfloat16* hs = h + static_cast<size_t>(b0) * K + k0;

  zero_h_padding(smem, rows);

  const int n_stages = ks / kBKStage;
  const auto load_stage = [&](int i) {
    unsigned char* dst = smem + (i % kBStages) * kBStageBytes;
    const int8_t* src = qs + i * kBKStage;
#pragma unroll
    for (int it = 0; it < kBWBytes / 16 / kBThreads; ++it) {
      const int idx = threadIdx.x + it * kBThreads;
      const int r = idx >> 3, ch = idx & 7;
      cp_async16(dst + r * kBKStage + ((ch ^ ((r & 1) << 2)) << 4),
                 src + static_cast<size_t>(r) * K + ch * 16);
    }
    load_h_stage(dst, hs, K, rows, i);
  };
#pragma unroll
  for (int i = 0; i < kBStages - 1; ++i) {
    if (i < n_stages) load_stage(i);
    cp_async_commit();
  }

  // One accumulator for each 64 k of a stage: two independent mma chains.
  float acc[2][4];
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[c][v] = 0.f;

  const int r0 = warp * 16 + g;            // and r0 + 8, of the same parity
  const int swz = (g & 1) << 2;
  for (int i = 0; i < n_stages; ++i) {
    cp_async_wait<kBStages - 2>();
    __syncthreads();                     // stage i landed; stage i - 1 is free
    if (i + kBStages - 1 < n_stages) load_stage(i + kBStages - 1);
    cp_async_commit();
    const unsigned char* st = smem + (i % kBStages) * kBStageBytes;
    const __nv_bfloat16* hrow = reinterpret_cast<const __nv_bfloat16*>(st + kBWBytes) + g * kBHld;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int ch = ((4 * c + t) ^ swz) << 4;
      const uint4 lo = *reinterpret_cast<const uint4*>(st + r0 * kBKStage + ch);
      const uint4 hi = *reinterpret_cast<const uint4*>(st + (r0 + 8) * kBKStage + ch);
      const uint4 h0 = *reinterpret_cast<const uint4*>(hrow + 64 * c + 16 * t);
      const uint4 h1 = *reinterpret_cast<const uint4*>(hrow + 64 * c + 16 * t + 8);
      const uint32_t wl[4] = {lo.x ^ 0x80808080u, lo.y ^ 0x80808080u, lo.z ^ 0x80808080u,
                              lo.w ^ 0x80808080u};
      const uint32_t wh[4] = {hi.x ^ 0x80808080u, hi.y ^ 0x80808080u, hi.z ^ 0x80808080u,
                              hi.w ^ 0x80808080u};
      const uint32_t hv[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t a[4] = {i8pair_to_bf16x2(wl[j], 0), i8pair_to_bf16x2(wh[j], 0),
                               i8pair_to_bf16x2(wl[j], 2), i8pair_to_bf16x2(wh[j], 2)};
        mma_bf16(acc[c], a, hv[2 * j], hv[2 * j + 1]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // This slice's sums, part[row of h][column], over the ring: a lane holds
  // columns 16w+g and 16w+g+8 of rows 2t and 2t+1; rows padded to kBRedLd
  // floats, so that a warp's stores meet no bank twice.
  float* part = reinterpret_cast<float*>(smem);
  float* mine = part + 2 * t * kBRedLd + warp * 16 + g;
  mine[0] = acc[0][0] + acc[1][0];
  mine[kBRedLd] = acc[0][1] + acc[1][1];
  mine[8] = acc[0][2] + acc[1][2];
  mine[kBRedLd + 8] = acc[0][3] + acc[1][3];
  cluster_finish(part, kBRedLd, rows, s, out, b0, n0, N);
}

// Both bf16 cluster kernels: (h, q, s, out, B, K, N, ks).
using Bf16Kernel = decltype(&int8_mm_bf16_kernel);

// Lets a bf16 cluster kernel take its kBSmemBytes of dynamic shared memory.
cudaError_t allow_smem(Bf16Kernel kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBSmemBytes);
}

// One launch of a bf16 kernel whose K slices (grid y) form a cluster.
cudaError_t launch_cluster(Bf16Kernel kernel, dim3 grid, const void* h, const void* q,
                           const void* s, void* out, int B, int K, int N, int ks,
                           cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kBThreads);
  cfg.dynamicSmemBytes = kBSmemBytes;
  cfg.stream = st;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = grid.y;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<const __nv_bfloat16*>(h),
                            static_cast<const int8_t*>(q), static_cast<const float*>(s),
                            static_cast<__nv_bfloat16*>(out), B, K, N, ks);
}

template <int RB>
void launch_mm(const float* h, const int8_t* q, float* ws, int E, int B, int K, int N, int ks,
               bool transpose, cudaStream_t st) {
  const int splits = K / ks;
  const int groups = (B + RB - 1) / RB;
  if (transpose) {
    const dim3 grid((N + kNTileT - 1) / kNTileT, splits, groups);
    int8_mm_t_kernel<RB><<<grid, kThreads, 0, st>>>(h, q, ws, B, K, N, ks);
  } else {
    const dim3 grid((N + kNTile - 1) / kNTile, splits, groups * E);
    if (E > 1) {
      int8_mm_kernel<RB, true><<<grid, kThreads, 0, st>>>(h, q, ws, B, K, N, ks, groups, E);
    } else {
      int8_mm_kernel<RB, false><<<grid, kThreads, 0, st>>>(h, q, ws, B, K, N, ks, groups, 1);
    }
  }
}

// E stacks of f32 h [B,K] @ q [K,N] (transpose only with E = 1).
void launch_all(const void* hv, const void* qv, const void* s, void* out, void* wsv, int E,
                int B, int K, int N, int ks, bool transpose, cudaStream_t st) {
  const float* h = static_cast<const float*>(hv);
  const int8_t* q = static_cast<const int8_t*>(qv);
  float* ws = static_cast<float*>(wsv);
  if (B == 1) {
    launch_mm<1>(h, q, ws, E, B, K, N, ks, transpose, st);
  } else if (B == 2) {
    launch_mm<2>(h, q, ws, E, B, K, N, ks, transpose, st);
  } else if (B <= 4) {
    launch_mm<4>(h, q, ws, E, B, K, N, ks, transpose, st);
  } else {
    launch_mm<8>(h, q, ws, E, B, K, N, ks, transpose, st);
  }
  const size_t total = static_cast<size_t>(E) * B * N;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  if (E > 1) {
    reduce_scale_kernel<float, true><<<blocks, threads, 0, st>>>(
        ws, static_cast<const float*>(s), static_cast<float*>(out), B, N, K / ks, E);
  } else {
    reduce_scale_kernel<float, false><<<blocks, threads, 0, st>>>(
        ws, static_cast<const float*>(s), static_cast<float*>(out), B, N, K / ks, 1);
  }
}

bool bad_dims(int B, int K, int N, int ks) {
  return B < 1 || B > 64 || K % 128 || N % 128 || ks < 16 || ks > kMaxKs || ks % 16 ||
         K % ks;
}

// What both bf16 cluster kernels take: 1 <= B <= 64, K and N multiples of
// 128, ks a multiple of 128 that divides K into at most 8 slices, h and q
// 16-byte aligned.
bool bad_bf16_dims(const void* h, const void* q, int B, int K, int N, int ks) {
  return B < 1 || B > 64 || K % 128 || N % 128 || ks < kBKStage || ks % kBKStage || K % ks ||
         K / ks > kBMaxSplits || reinterpret_cast<uintptr_t>(h) % 16 ||
         reinterpret_cast<uintptr_t>(q) % 16;
}

}  // namespace

// h f32 [B,K], q int8 [K,N] or [N,K] (transpose), s f32 [N], out f32 [B,N],
// ws f32 [K/ks, B, N]. K and N multiples of 128 (so of 16), ks divides K and
// is at most 512, 1 <= B <= 64. bf16 h takes kukeon_int8_matmul_bf16 or
// kukeon_int8_matmul_t_bf16.
extern "C" int kukeon_int8_matmul(const void* h, const void* q, const void* s, void* out,
                                  void* ws, int B, int K, int N, int ks, int transpose,
                                  void* stream) {
  if (bad_dims(B, K, N, ks)) return static_cast<int>(cudaErrorInvalidValue);
  launch_all(h, q, s, out, ws, 1, B, K, N, ks, transpose != 0,
             static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// h [B,K] bf16 @ q int8 [K,N] * s f32 [N] -> out [B,N] bf16 in one launch
// (bad_bf16_dims says what it takes).
extern "C" int kukeon_int8_matmul_bf16(const void* h, const void* q, const void* s, void* out,
                                       int B, int K, int N, int ks, void* stream) {
  if (bad_bf16_dims(h, q, B, K, N, ks)) return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t raised = allow_smem(int8_mm_bf16_kernel);
  if (raised != cudaSuccess) return static_cast<int>(raised);
  const cudaError_t err = launch_cluster(
      int8_mm_bf16_kernel, dim3(N / kBNTile, K / ks, (B + kBRows - 1) / kBRows), h, q, s, out,
      B, K, N, ks, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// h [B,K] bf16 @ q int8 [N,K]^T * s f32 [N] -> out [B,N] bf16 in one launch
// (the tied LM head): what kukeon_int8_matmul_bf16 takes, with N/128 at
// most 65535 (the grid's z).
extern "C" int kukeon_int8_matmul_t_bf16(const void* h, const void* q, const void* s,
                                         void* out, int B, int K, int N, int ks,
                                         void* stream) {
  if (bad_bf16_dims(h, q, B, K, N, ks) || N / kBNTile > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static const cudaError_t raised = allow_smem(int8_mm_t_bf16_kernel);
  if (raised != cudaSuccess) return static_cast<int>(raised);
  const cudaError_t err = launch_cluster(
      int8_mm_t_bf16_kernel, dim3((B + kBRows - 1) / kBRows, K / ks, N / kBNTile), h, q, s,
      out, B, K, N, ks, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// x [E,C,K] (bf16 when is_bf16, else f32), q int8 [E,K,N], s f32 [E,N],
// out [E,C,N] in x's dtype, ws f32 [K/ks, E*C, N]; 1 <= E <= 1024. f32:
// the same limits as kukeon_int8_matmul with C in B's place. bf16: 1 <= C
// <= 64, K and N multiples of 128, ks a multiple of 128 that divides K, at
// most 2048; x, q 16-byte aligned.
extern "C" int kukeon_int8_matmul_expert(const void* x, const void* q, const void* s,
                                         void* out, void* ws, int E, int C, int K, int N,
                                         int ks, int is_bf16, void* stream) {
  if (E < 1 || E > 1024) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (C < 1 || C > 64 || K % 128 || N % kENTile || ks < kEKStage || ks > kEMaxKs ||
        ks % kEKStage || K % ks) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const cudaError_t err = launch_expert_bf16(x, q, s, out, ws, E, C, K, N, ks, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  } else {
    if (bad_dims(C, K, N, ks)) return static_cast<int>(cudaErrorInvalidValue);
    launch_all(x, q, s, out, ws, E, C, K, N, ks, false, st);
  }
  return static_cast<int>(cudaGetLastError());
}
