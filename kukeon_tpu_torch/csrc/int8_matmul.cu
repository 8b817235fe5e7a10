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
// the kernel is bound by bytes, not operations:
//     bytes = K*N (int8 weights) + 4*N (scales) + e*B*K (h) + e*B*N (out),
// e = 2 for bf16; at B = 4 the weights are > 99% of it, and the least time
// is bytes / HBM bandwidth (3.35 TB/s on an H100 SXM). The operations,
// 2*B*K*N, are far below the tensor cores' line at this B.
//
// Design against that bound:
// - Each thread reads 16 contiguous int8 weights with one 16-byte load
//   (along N for q[K,N], along K for q[N,K]); a warp's loads cover 512
//   contiguous bytes, so every weight byte crosses HBM once, coalesced.
// - The weights are converted to f32 in registers; no bf16 copy of the
//   weights exists anywhere.
// - The TPU kernel walks N tiles in order on one core. Hopper needs enough
//   independent blocks for 132 SMs (wk/wv have N = 1024: 2 column tiles),
//   so the grid splits N tiles *and* K slices. The K slice of h is staged
//   in shared memory once per block.
// - Each K slice writes f32 partial sums to a workspace; a second small
//   kernel sums the slices in a fixed order, applies s and casts. No
//   atomics: results are bit-reproducible run to run.
// - Rows of h are taken RB at a time (RB in {1,2,4,8}) as a grid axis, so
//   B needs no padding; the accumulators of all RB rows stay in registers.
// - Experts with f32 activations (kukeon_int8_matmul_expert; the f32
//   models and tests, not speed): K1's body with the grid's z axis expert x
//   row group, every pointer stepping by its expert's stride, so all E
//   weight stacks stream in one launch and the reduce is one launch too.
//   The workspace is [K/ks, E*C, N]: expert e's rows sit at e*C.., so the
//   reduce is K1's with a per-expert scale row. The expert arithmetic is a
//   template branch (GROUPED), so K1's instantiations compile to the code
//   they had before the grouped form existed.
// - Experts with bf16 activations (the Mixtral decode path) take their own
//   kernel, int8_mm_expert_bf16_kernel, the same workspace and reduce.
//   At C = 4 the grouped product streams 470 MB of weights a call, and
//   three things kept K1's body at 2.3x its bound: weights no token needs
//   (dense dispatch leaves an expert that no token chose with activation
//   rows that are exactly 0), the int8 -> f32 conversion (I2F runs at a
//   quarter rate, about as fast as the bytes arrive) plus 4 FMAs a weight,
//   and one 16-byte load in flight per thread. The bf16 design:
//   * Zero-expert skip: a block first stages its activation rows (its
//     expert, 8-row group and K slice); when every one is exactly 0 it
//     loads no weights and writes +0 partials. That is the sum the full
//     product gives (+0 products summed into +0; int8 weights and finite
//     activations make no NaN), so the output is bit-identical.
//   * The weights stream through a 4-stage cp.async ring in shared memory
//     (16 KB stages of 128 k rows x 128 columns, 48 KB in flight per
//     block, two blocks an SM), XOR-swizzled so that the fragment reads
//     are free of bank conflicts.
//   * The product runs on mma.sync.m16n8k16 in bf16, as the TPU kernel
//     dequantises to bf16 for its matrix unit: weights are the A operand
//     (16 output columns by 16 k), the activation rows the B operand (C
//     padded to the mma's 8). int8 is exact in bf16 and every product is
//     exact in the f32 accumulator. The conversion costs 2.5 ALU
//     operations a weight (prmt into the f32 0x4B0000xx pattern, one
//     fadd, a prmt that keeps the upper halves), not I2F.
//   * Each warp sums one 16-row k step of every stage; the 8 warps are
//     summed in shared memory in order, the K slices by the reduce kernel
//     in order, as K1: no atomics, bit-reproducible.
//
// C interface, loaded with ctypes: kukeon_int8_matmul(...) and
// kukeon_int8_matmul_expert(...) return cudaGetLastError() after both
// launches (0 = success), or the error of the launch's set-up.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kVec = 16;                 // int8 weights per 16-byte load
constexpr int kNTile = 32 * kVec;        // q[K,N]: 512 columns per block
constexpr int kMaxKs = 512;              // largest K slice staged in shared memory
constexpr int kRowsPerWarpT = 4;         // q[N,K]: output columns per warp
constexpr int kNTileT = kWarps * kRowsPerWarpT;
constexpr int kPadT = kMaxKs + kMaxKs / 4;  // padded h row, conflict-free float4 reads

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

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

// Stage h[b0 : b0+RB, k0 : k0+ks] as f32; rows past B are zero. The
// transposed kernel pads 4 floats after every 16 so that lane i's float4
// reads at i*20 words hit distinct banks.
template <typename T, int RB, int LD, bool PAD>
__device__ __forceinline__ void stage_h(float (*h_s)[LD], const T* __restrict__ h,
                                        int B, int K, int b0, int k0, int ks) {
  for (int i = threadIdx.x; i < RB * ks; i += kThreads) {
    const int r = i / ks, c = i % ks;
    const int cs = PAD ? c + (c / kVec) * 4 : c;
    h_s[r][cs] = (b0 + r < B) ? to_f32(h[static_cast<size_t>(b0 + r) * K + k0 + c]) : 0.f;
  }
}

// q[K,N]. Block (x, y, z) = (512-column tile, K slice, expert x RB-row
// group). Warp w takes rows k0+w, k0+w+8, ... of the slice; lane l owns
// columns [16l, 16l+16) of the tile. Warps are summed in shared memory in
// order. GROUPED: expert e = z / groups reads h[e] ([B,K]) and q[e]
// ([K,N]) and writes rows e*B.. of each workspace slice, which holds E*B
// rows; otherwise z is the row group alone (E = 1).
template <typename T, int RB, bool GROUPED>
__global__ void __launch_bounds__(kThreads)
int8_mm_kernel(const T* __restrict__ h, const int8_t* __restrict__ q,
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

  stage_h<T, RB, kMaxKs, false>(h_s, h, B, K, b0, k0, ks);
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
template <typename T, int RB>
__global__ void __launch_bounds__(kThreads)
int8_mm_t_kernel(const T* __restrict__ h, const int8_t* __restrict__ q,
                 float* __restrict__ ws, int B, int K, int N, int ks) {
  __shared__ __align__(16) float h_s[RB][kPadT];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int k0 = blockIdx.y * ks;
  const int b0 = blockIdx.z * RB;
  const int nb = blockIdx.x * kNTileT + warp * kRowsPerWarpT;

  stage_h<T, RB, kPadT, true>(h_s, h, B, K, b0, k0, ks);
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

template <typename T, int RB>
cudaError_t launch_mm(const void* h, const void* q, void* ws, int E, int B, int K, int N, int ks,
                      bool transpose, cudaStream_t st) {
  const int splits = K / ks;
  const int groups = (B + RB - 1) / RB;
  if (transpose) {
    const dim3 grid((N + kNTileT - 1) / kNTileT, splits, groups);
    int8_mm_t_kernel<T, RB><<<grid, kThreads, 0, st>>>(
        static_cast<const T*>(h), static_cast<const int8_t*>(q), static_cast<float*>(ws),
        B, K, N, ks);
  } else if (E > 1) {
    // Experts take K1's body only with f32 activations; bf16 ones have
    // int8_mm_expert_bf16_kernel, so no bf16 instantiation is built here,
    // and a bf16 call refuses rather than leave the workspace unwritten.
    if constexpr (std::is_same_v<T, float>) {
      const dim3 grid((N + kNTile - 1) / kNTile, splits, groups * E);
      int8_mm_kernel<T, RB, true><<<grid, kThreads, 0, st>>>(
          static_cast<const T*>(h), static_cast<const int8_t*>(q), static_cast<float*>(ws),
          B, K, N, ks, groups, E);
    } else {
      return cudaErrorInvalidValue;
    }
  } else {
    const dim3 grid((N + kNTile - 1) / kNTile, splits, groups);
    int8_mm_kernel<T, RB, false><<<grid, kThreads, 0, st>>>(
        static_cast<const T*>(h), static_cast<const int8_t*>(q), static_cast<float*>(ws),
        B, K, N, ks, groups, 1);
  }
  return cudaSuccess;
}

// E stacks of h [B,K] @ q [K,N] (transpose only with E = 1).
template <typename T>
cudaError_t launch_all(const void* h, const void* q, const void* s, void* out, void* ws,
                       int E, int B, int K, int N, int ks, bool transpose, cudaStream_t st) {
  cudaError_t err;
  if (B == 1) {
    err = launch_mm<T, 1>(h, q, ws, E, B, K, N, ks, transpose, st);
  } else if (B == 2) {
    err = launch_mm<T, 2>(h, q, ws, E, B, K, N, ks, transpose, st);
  } else if (B <= 4) {
    err = launch_mm<T, 4>(h, q, ws, E, B, K, N, ks, transpose, st);
  } else {
    err = launch_mm<T, 8>(h, q, ws, E, B, K, N, ks, transpose, st);
  }
  if (err != cudaSuccess) return err;
  const size_t total = static_cast<size_t>(E) * B * N;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  if (E > 1) {
    reduce_scale_kernel<T, true><<<blocks, threads, 0, st>>>(
        static_cast<const float*>(ws), static_cast<const float*>(s), static_cast<T*>(out),
        B, N, K / ks, E);
  } else {
    reduce_scale_kernel<T, false><<<blocks, threads, 0, st>>>(
        static_cast<const float*>(ws), static_cast<const float*>(s), static_cast<T*>(out),
        B, N, K / ks, 1);
  }
  return cudaSuccess;
}

bool bad_dims(int B, int K, int N, int ks) {
  return B < 1 || B > 64 || K % 128 || N % 128 || ks < 16 || ks > kMaxKs || ks % 16 ||
         K % ks;
}

}  // namespace

// h [B,K] (bf16 when is_bf16, else f32), q int8 [K,N] or [N,K] (transpose),
// s f32 [N], out [B,N] in h's dtype, ws f32 [K/ks, B, N]. K and N multiples
// of 128 (so of 16), ks divides K and is at most 512, 1 <= B <= 64.
extern "C" int kukeon_int8_matmul(const void* h, const void* q, const void* s, void* out,
                                  void* ws, int B, int K, int N, int ks, int transpose,
                                  int is_bf16, void* stream) {
  if (bad_dims(B, K, N, ks)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_all<__nv_bfloat16>(h, q, s, out, ws, 1, B, K, N, ks, transpose != 0, st)
              : launch_all<float>(h, q, s, out, ws, 1, B, K, N, ks, transpose != 0, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// x [E,C,K] (bf16 when is_bf16, else f32), q int8 [E,K,N], s f32 [E,N],
// out [E,C,N] in x's dtype, ws f32 [K/ks, E*C, N]; 1 <= E <= 1024. f32:
// the same limits as above with C in B's place. bf16: 1 <= C <= 64, K and
// N multiples of 128, ks a multiple of 128 that divides K, at most 2048;
// x, q 16-byte aligned.
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
    const cudaError_t err = launch_all<float>(x, q, s, out, ws, E, C, K, N, ks, false, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
