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
// - Experts (kukeon_int8_matmul_expert): the grid's z axis is expert x
//   row group, and every pointer steps by its expert's stride, so all E
//   weight stacks stream in one launch (at decode, E*K*N bytes: 470 MB for
//   a Mixtral-8x7B w_gate) and the reduce is one launch too. The workspace
//   is [K/ks, E*C, N]: expert e's rows sit at e*C.., so the reduce is K1's
//   with a per-expert scale row. The expert arithmetic is a template
//   branch (GROUPED), so K1's instantiations compile to the code they had
//   before the grouped form existed.
//
// C interface, loaded with ctypes: kukeon_int8_matmul(...) and
// kukeon_int8_matmul_expert(...) return cudaGetLastError() after both
// launches (0 = success).

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

template <typename T, int RB>
void launch_mm(const void* h, const void* q, void* ws, int E, int B, int K, int N, int ks,
               bool transpose, cudaStream_t st) {
  const int splits = K / ks;
  const int groups = (B + RB - 1) / RB;
  if (transpose) {
    const dim3 grid((N + kNTileT - 1) / kNTileT, splits, groups);
    int8_mm_t_kernel<T, RB><<<grid, kThreads, 0, st>>>(
        static_cast<const T*>(h), static_cast<const int8_t*>(q), static_cast<float*>(ws),
        B, K, N, ks);
  } else if (E > 1) {
    const dim3 grid((N + kNTile - 1) / kNTile, splits, groups * E);
    int8_mm_kernel<T, RB, true><<<grid, kThreads, 0, st>>>(
        static_cast<const T*>(h), static_cast<const int8_t*>(q), static_cast<float*>(ws),
        B, K, N, ks, groups, E);
  } else {
    const dim3 grid((N + kNTile - 1) / kNTile, splits, groups);
    int8_mm_kernel<T, RB, false><<<grid, kThreads, 0, st>>>(
        static_cast<const T*>(h), static_cast<const int8_t*>(q), static_cast<float*>(ws),
        B, K, N, ks, groups, 1);
  }
}

// E stacks of h [B,K] @ q [K,N] (transpose only with E = 1).
template <typename T>
void launch_all(const void* h, const void* q, const void* s, void* out, void* ws,
                int E, int B, int K, int N, int ks, bool transpose, cudaStream_t st) {
  if (B == 1) {
    launch_mm<T, 1>(h, q, ws, E, B, K, N, ks, transpose, st);
  } else if (B == 2) {
    launch_mm<T, 2>(h, q, ws, E, B, K, N, ks, transpose, st);
  } else if (B <= 4) {
    launch_mm<T, 4>(h, q, ws, E, B, K, N, ks, transpose, st);
  } else {
    launch_mm<T, 8>(h, q, ws, E, B, K, N, ks, transpose, st);
  }
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
  if (is_bf16) {
    launch_all<__nv_bfloat16>(h, q, s, out, ws, 1, B, K, N, ks, transpose != 0, st);
  } else {
    launch_all<float>(h, q, s, out, ws, 1, B, K, N, ks, transpose != 0, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// x [E,C,K] (bf16 when is_bf16, else f32), q int8 [E,K,N], s f32 [E,N],
// out [E,C,N] in x's dtype, ws f32 [K/ks, E*C, N]. The same limits as above
// with C in B's place; 1 <= E <= 1024.
extern "C" int kukeon_int8_matmul_expert(const void* x, const void* q, const void* s,
                                         void* out, void* ws, int E, int C, int K, int N,
                                         int ks, int is_bf16, void* stream) {
  if (E < 1 || E > 1024 || bad_dims(C, K, N, ks)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    launch_all<__nv_bfloat16>(x, q, s, out, ws, E, C, K, N, ks, false, st);
  } else {
    launch_all<float>(x, q, s, out, ws, E, C, K, N, ks, false, st);
  }
  return static_cast<int>(cudaGetLastError());
}
