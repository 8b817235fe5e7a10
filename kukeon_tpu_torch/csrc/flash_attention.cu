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
// kernel is bound by the tensor cores (989 TFLOP/s bf16 on an H100 SXM),
// not by HBM. What keeps a kernel from that rate on Hopper: the legacy
// mma.sync path, shared-memory traffic when small warp tiles each re-read
// the K and V tiles, the softmax's exp2 (16 a clock per SM on the MUFU:
// at D 64 as long as the two products of the same tile) in series with the
// products, and a block's start and end (listing tiles, first loads,
// stores) when one block fills an SM. The bf16 design:
// - Persistent: one block an SM walks work tiles (128-row q tile, head,
//   batch row), heaviest q tiles first, round robin over the blocks.
// - Three warpgroups. Warpgroup 0 is the producer: it gives registers back
//   (setmaxnreg) and one warp lists each work tile's kv tiles and issues
//   every TMA load: the Q tile into one of two buffers, K and V tiles of
//   128 kv rows into a ring of NS stages (3 at D <= 64, 2 at D = 128), with
//   full/empty mbarriers. So the next work tile's list and loads run while
//   the consumers finish this one. Warpgroups 1 and 2 consume, 64 q rows
//   each.
// - S = Q K^T on wgmma.m64n128k16 with Q and K read from shared memory as
//   TMA wrote them (128-byte swizzle, 64-byte at D = 32); each K/V tile is
//   read once per 64 q rows, straight from shared memory into the tensor
//   cores.
// - O += P V on wgmma with P from registers: the f32 score accumulator is
//   re-packed as the bf16 A operand, so P never touches shared memory; V is
//   the MN-major B operand (transposed by the instruction), so no
//   transposed copy of V exists.
// - The softmax runs in registers in the log2 domain: one FFMA (scale times
//   log2 e folded in) and one ex2.approx an element. The two consumers take
//   turns on the tensor cores (named barriers 1 and 2): one issues its S
//   product of tile i and its P V of tile i-1 while the other runs its
//   softmax; within a consumer the softmax of tile i also overlaps its own
//   P V of tile i-1.
// - Tensor maps are built per call on the host, in the launch, over the
//   caller's strides ([B, S, H, D] as a 4-D map, D innermost, 64-row
//   boxes), passed as
//   __grid_constant__ CUtensorMap. cuTensorMapEncodeTiled is reached
//   through cudaGetDriverEntryPoint, so the library links no -lcuda.
// - A ragged last tile needs no padding: TMA zero-fills rows past S, kv
//   rows past S are masked, q rows past S are not stored.
// - The kv tiles a work tile visits follow the JAX predicate above, from
//   the min and max position of every 64-row chunk (a first small launch,
//   chunk_minmax_kernel); a tile whose every kv position is <= every q
//   position of the work tile, and that lies inside S, skips the mask.
//   Each block keeps two lists (this work tile's and the next one's): in
//   shared memory up to 512 kv tiles (S 65536), past that in its own part
//   of a global int32 workspace that the wrapper allocates, so S is bounded
//   only by int32 arithmetic (2^30).
// - K/V are read at their own head count: query head h reads kv head
//   h / (H / KV), so grouped-query attention needs no expanded copy.
//
// f32 inputs take a plain-FMA kernel (16-row tiles in shared memory); it
// exists for the f32 models and tests, not for speed.
//
// C interface, loaded with ctypes: kukeon_flash_attention(...) returns
// cudaGetLastError() after the launch (0 = success), or the error of the
// tensor-map encoding or of the launch's set-up.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;       // the JAX kernel's mask and initial max
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBN = 128;                // kv rows per tile
constexpr int kBox = 64;                // rows of a TMA box, of a consumer's q slice, of a
                                        // position chunk
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;   // the f32 kernel's block
constexpr int kMaxS = 1 << 30;          // rows, tile counts and positions stay in int32
constexpr int kSmemTiles = 512;         // kv-tile lists up to S 65536 live in shared memory
constexpr int kPosMin = -2147483647 - 1;
constexpr int kPosMax = 2147483647;

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
  const int4* minmax;   // bf16: [B, n_c] (kv min, kv max, q min, q max) of 64-row chunks
  int* tile_list;       // bf16, n_kt > kSmemTiles: [grid][2][n_kt], the blocks' kv-tile lists
};

// ---- bf16 kernel: shared-memory plan --------------------------------------

template <int D>
struct Plan {
  // Consumer warpgroups, 64 q rows each.
  static constexpr int NC = 2;
  static constexpr int BM = kBox * NC;                // q rows per work tile
  static constexpr int THREADS = 128 * (NC + 1);
  // setmaxnreg split of the block's launch-time registers (65536 / THREADS
  // = 168 a thread): the producer gives back, the consumers take.
  static constexpr int PRODUCER_REGS = 40;
  static constexpr int CONSUMER_REGS = 232;
  static constexpr int SW = D < 64 ? D : 64;          // columns per swizzle row
  static constexpr int RB = SW * 2;                   // bytes per swizzle row
  static constexpr int NCB = D / SW;                  // column blocks (2 at D = 128)
  static constexpr int NS = D == 128 ? 2 : 3;         // K/V ring stages
  static constexpr uint64_t LAYOUT = RB == 128 ? 1 : 2;   // wgmma: 128B / 64B swizzle
  static constexpr int Q_BYTES = BM * D * 2;          // one Q tile (two buffers)
  static constexpr int T_BYTES = kBN * D * 2;         // one K or V tile
  static constexpr int BAR_OFF = 2 * Q_BYTES + 2 * NS * T_BYTES;
  // full[NS], empty[NS], q_full[2], q_empty[2]; then n_visit[2]
  static constexpr int NV_OFF = BAR_OFF + 8 * (2 * NS + 4);
  static constexpr int LIST_OFF = NV_OFF + 8;         // tiles[2][list_tiles]
  static size_t smem_bytes(int list_tiles) {
    return 1024 + LIST_OFF + 8 * list_tiles;   // 1024: alignment slack
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar), "r"(parity) : "memory");
}

// One TMA tile load of a 4-D map, coordinates innermost first.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
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
// Pin registers that an asynchronous wgmma reads or writes: the compiler
// may not move their uses across this point or reuse them before it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle layout in bits 62-63.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

// d[64] (+)= A[64x16] (smem) * B[16x128] (smem); scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[16] += A[64x16] (registers, bf16x2) * B[16x32] (smem, MN-major).
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[32] += A[64x16] (registers, bf16x2) * B[16x64] (smem, MN-major).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64] += A[64x16] (registers, bf16x2) * B[16x128] (smem, MN-major).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&d)[D / 2], const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void wgmma_pv<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  wgmma_rs_n32(d, a, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  wgmma_rs_n64(d, a, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  wgmma_rs_n128(d, a, db);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// S = Q K^T for one consumer's 64 rows and one 128-row kv tile: D/16
// k-steps, Q and K K-major in swizzled shared memory (a k-step advances the
// start address by 32 bytes inside the swizzle row).
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[kBN / 2], uint32_t q_base, uint32_t k_base) {
  using P = Plan<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t blk = kk * 16 / P::SW, within = (kk * 16 % P::SW) * 2;
    const uint64_t da = make_desc(q_base + blk * P::BM * P::RB + within, 16, 8 * P::RB, P::LAYOUT);
    const uint64_t db = make_desc(k_base + blk * kBN * P::RB + within, 16, 8 * P::RB, P::LAYOUT);
    wgmma_ss_n128(s, da, db, kk > 0 ? 1 : 0);
  }
}

// O += P V: 8 k-steps of 16 kv rows; V MN-major (column blocks LBO apart,
// 8-row groups SBO apart).
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], const uint32_t (&pf)[kBN / 16][4],
                                         uint32_t v_base) {
  using P = Plan<D>;
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
    const uint64_t db = make_desc(v_base + kk * 16 * P::RB, kBN * P::RB, 8 * P::RB, P::LAYOUT);
    wgmma_pv<D>(o, pf[kk], db);
  }
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One tile's online-softmax step on the raw scores s (this thread holds
// rows r, elements 0 and 1 of each n-tile, and r + 8, elements 2 and 3;
// columns 8j + 2t and 8j + 2t + 1 of n-tile j): mask, update the running
// max m (log2 domain, scale sl2 = log2(e) / sqrt(D) folded in), and turn s
// into the unnormalised p = exp2(s * sl2 - m) in place, one FFMA and one
// MUFU.EX2 an element. A masked score is set to -1e30 / sl2, which scales
// to the JAX kernel's -1e30.
__device__ __forceinline__ void softmax_tile(float (&s)[kBN / 2], bool visible, int k0,
                                             const int* kvpos, int S, int qp0, int qp1,
                                             float sl2, int t, float& m0, float& m1,
                                             float& corr0, float& corr1, float& sum0,
                                             float& sum1) {
  if (!visible) {
    const float masked = kNegInf / sl2;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int col = k0 + 8 * j + 2 * t;
      const int kp0 = col < S ? __ldg(kvpos + col) : kPosMax;
      const int kp1 = col + 1 < S ? __ldg(kvpos + col + 1) : kPosMax;
      if (kp0 > qp0) s[4 * j + 0] = masked;
      if (kp1 > qp0) s[4 * j + 1] = masked;
      if (kp0 > qp1) s[4 * j + 2] = masked;
      if (kp1 > qp1) s[4 * j + 3] = masked;
    }
  }
  float mx0[4], mx1[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    mx0[j] = fmaxf(s[4 * j], s[4 * j + 1]);
    mx1[j] = fmaxf(s[4 * j + 2], s[4 * j + 3]);
  }
#pragma unroll
  for (int j = 4; j < kBN / 8; ++j) {
    mx0[j % 4] = fmaxf(mx0[j % 4], fmaxf(s[4 * j], s[4 * j + 1]));
    mx1[j % 4] = fmaxf(mx1[j % 4], fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  float mc0 = fmaxf(fmaxf(mx0[0], mx0[1]), fmaxf(mx0[2], mx0[3]));
  float mc1 = fmaxf(fmaxf(mx1[0], mx1[1]), fmaxf(mx1[2], mx1[3]));
  // The 4 threads of a quad hold one row's 128 columns.
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    mc0 = fmaxf(mc0, __shfl_xor_sync(0xffffffffu, mc0, off));
    mc1 = fmaxf(mc1, __shfl_xor_sync(0xffffffffu, mc1, off));
  }
  const float mn0 = fmaxf(m0, mc0 * sl2), mn1 = fmaxf(m1, mc1 * sl2);
  corr0 = fast_exp2(m0 - mn0);
  corr1 = fast_exp2(m1 - mn1);
  m0 = mn0;
  m1 = mn1;
  float sm0[4] = {0.f, 0.f, 0.f, 0.f}, sm1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    s[4 * j + 0] = fast_exp2(fmaf(s[4 * j + 0], sl2, -mn0));
    s[4 * j + 1] = fast_exp2(fmaf(s[4 * j + 1], sl2, -mn0));
    s[4 * j + 2] = fast_exp2(fmaf(s[4 * j + 2], sl2, -mn1));
    s[4 * j + 3] = fast_exp2(fmaf(s[4 * j + 3], sl2, -mn1));
    sm0[j % 4] += s[4 * j + 0] + s[4 * j + 1];
    sm1[j % 4] += s[4 * j + 2] + s[4 * j + 3];
  }
  sum0 = (sm0[0] + sm0[1]) + (sm0[2] + sm0[3]);
  sum1 = (sm1[0] + sm1[1]) + (sm1[2] + sm1[3]);
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
  }
}

// After the previous P V has landed: rescale O, add the tile's row sums,
// and pack p as bf16 A fragments (n-tiles 2kk, 2kk+1 form k-step kk).
template <int D>
__device__ __forceinline__ void rescale_and_pack(float (&o)[D / 2], uint32_t (&pf)[kBN / 16][4],
                                                 const float (&s)[kBN / 2], float corr0,
                                                 float corr1, float sum0, float sum1, float& l0,
                                                 float& l1) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    o[4 * j + 0] *= corr0;
    o[4 * j + 1] *= corr0;
    o[4 * j + 2] *= corr1;
    o[4 * j + 3] *= corr1;
  }
  l0 = l0 * corr0 + sum0;
  l1 = l1 * corr1 + sum1;
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
    pf[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
    pf[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    pf[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    pf[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// min and max of the q and kv positions of every 64-row chunk, rows past S
// left out: out[b * n_c + c] = (kv min, kv max, q min, q max). One warp per
// (chunk, batch row).
__global__ void __launch_bounds__(32)
chunk_minmax_kernel(const int* __restrict__ q_pos, const int* __restrict__ kv_pos,
                    int4* __restrict__ out, int S, int n_c) {
  int4 v = make_int4(kPosMax, kPosMin, kPosMax, kPosMin);
#pragma unroll
  for (int i = 0; i < kBox / 32; ++i) {
    const int r = blockIdx.x * kBox + threadIdx.x + 32 * i;
    if (r < S) {
      const long long at = static_cast<long long>(blockIdx.y) * S + r;
      const int kp = kv_pos[at], qp = q_pos[at];
      v.x = min(v.x, kp);
      v.y = max(v.y, kp);
      v.z = min(v.z, qp);
      v.w = max(v.w, qp);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v.x = min(v.x, __shfl_xor_sync(0xffffffffu, v.x, off));
    v.y = max(v.y, __shfl_xor_sync(0xffffffffu, v.y, off));
    v.z = min(v.z, __shfl_xor_sync(0xffffffffu, v.z, off));
    v.w = max(v.w, __shfl_xor_sync(0xffffffffu, v.w, off));
  }
  if (threadIdx.x == 0) out[static_cast<long long>(blockIdx.y) * n_c + blockIdx.x] = v;
}

// Work tile w (heaviest q tiles first) -> q tile, head, batch row.
__device__ __forceinline__ void work_tile(int w, int n_qt, int H, int B, int& qt, int& h,
                                          int& b) {
  qt = n_qt - 1 - w / (H * B);
  h = w % H;
  b = (w / H) % B;
}

// Persistent: one block an SM walks work tiles blockIdx.x, + gridDim.x, ...
// GLOBAL_LIST: the kv-tile lists live in p.tile_list, not in shared memory.
template <int D, bool GLOBAL_LIST>
__global__ void __launch_bounds__(Plan<D>::THREADS, 1)
flash_fwd_bf16_kernel(const Params p, int B, const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v) {
  using P = Plan<D>;
  constexpr int NC = P::NC;
  extern __shared__ unsigned char smem_raw[];
  // Swizzled TMA tiles want 1024-byte aligned addresses.
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  const auto q_s = [&](int qb) { return base + qb * P::Q_BYTES; };
  const auto k_s = [&](int st) { return base + 2 * P::Q_BYTES + st * P::T_BYTES; };
  const auto v_s = [&](int st) { return base + 2 * P::Q_BYTES + (P::NS + st) * P::T_BYTES; };
  const auto full_bar = [&](int st) { return base + P::BAR_OFF + 8 * st; };
  const auto empty_bar = [&](int st) { return base + P::BAR_OFF + 8 * (P::NS + st); };
  const auto q_full = [&](int qb) { return base + P::BAR_OFF + 8 * (2 * P::NS + qb); };
  const auto q_empty = [&](int qb) { return base + P::BAR_OFF + 8 * (2 * P::NS + 2 + qb); };
  volatile int* n_visit = reinterpret_cast<volatile int*>(smem + P::NV_OFF);
  const int S = p.S;
  const int n_kt = (S + kBN - 1) / kBN, n_qt = (S + P::BM - 1) / P::BM;
  const int n_c = (S + kBox - 1) / kBox;
  // [2][n_kt]; bit 30: no mask.
  int* const tiles = GLOBAL_LIST ? p.tile_list + static_cast<long long>(blockIdx.x) * 2 * n_kt
                                 : reinterpret_cast<int*>(smem + P::LIST_OFF);
  const int T = n_qt * p.H * B;                    // work tiles
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int st = 0; st < P::NS; ++st) {
      mbar_init(full_bar(st), 1);
      mbar_init(empty_bar(st), 128 * NC);   // every consumer thread releases
    }
    for (int qb = 0; qb < 2; ++qb) {
      mbar_init(q_full(qb), 1);
      mbar_init(q_empty(qb), 128 * NC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // Producer warpgroup: warp 0 lists each work tile's kv tiles and issues
    // every TMA load; its other warps have nothing to do.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(P::PRODUCER_REGS));
    if (threadIdx.x < 32) {
      int it = 0;                                  // ring slots filled so far
      for (int j = 0, w = blockIdx.x; w < T; ++j, w += gridDim.x) {
        int qt, h, b;
        work_tile(w, n_qt, p.H, B, qt, h, b);
        const int qb = j & 1, kvh = h / (p.H / p.KV);
        if (j >= 2) mbar_wait(q_empty(qb), ((j >> 1) & 1) ^ 1);
        // The kv tiles to visit, in order: skipped when every kv position
        // exceeds every q position of the q tile (the JAX predicate),
        // unmasked when every kv position is <= every q position and the
        // tile lies inside S.
        const int4* mm = p.minmax + static_cast<long long>(b) * n_c;
        int q_min = kPosMax, q_max = kPosMin;
        for (int ci = qt * NC; ci < min(n_c, qt * NC + NC); ++ci) {
          q_min = min(q_min, mm[ci].z);
          q_max = max(q_max, mm[ci].w);
        }
        int* list = tiles + qb * n_kt;
        int n = 0;
        for (int k0 = 0; k0 < n_kt; k0 += 32) {
          const int kt = k0 + lane;
          bool vis = false;
          int entry = 0;
          if (kt < n_kt) {
            int4 kmm = mm[2 * kt];
            if (2 * kt + 1 < n_c) {
              const int4 hi = mm[2 * kt + 1];
              kmm.x = min(kmm.x, hi.x);
              kmm.y = max(kmm.y, hi.y);
            }
            vis = kmm.x <= q_max;
            entry = kt | (kmm.y <= q_min && (kt + 1) * kBN <= S ? 1 << 30 : 0);
          }
          const unsigned ball = __ballot_sync(0xffffffffu, vis);
          if (vis) list[n + __popc(ball & ((1u << lane) - 1))] = entry;
          n += __popc(ball);
        }
        if (lane == 0) n_visit[qb] = n;
        __threadfence_block();
        __syncwarp();
        if (lane == 0) {                           // publishes the list with Q
          mbar_expect_tx(q_full(qb), P::Q_BYTES);
          for (int cb = 0; cb < P::NCB; ++cb) {
            for (int r = 0; r < NC; ++r) {
              tma_load_4d(q_s(qb) + (cb * P::BM + r * kBox) * P::RB, &tm_q, q_full(qb),
                          cb * P::SW, h, qt * P::BM + r * kBox, b);
            }
          }
          for (int i = 0; i < n; ++i, ++it) {
            const int st = it % P::NS;
            if (it >= P::NS) mbar_wait(empty_bar(st), ((it / P::NS) & 1) ^ 1);
            const int k0 = (list[i] & ~(1 << 30)) * kBN;
            mbar_expect_tx(full_bar(st), 2 * P::T_BYTES);
            for (int cb = 0; cb < P::NCB; ++cb) {
              for (int r = 0; r < kBN / kBox; ++r) {
                const uint32_t off = (cb * kBN + r * kBox) * P::RB;
                tma_load_4d(k_s(st) + off, &tm_k, full_bar(st), cb * P::SW, kvh,
                            k0 + r * kBox, b);
                tma_load_4d(v_s(st) + off, &tm_v, full_bar(st), cb * P::SW, kvh,
                            k0 + r * kBox, b);
              }
            }
          }
        }
        it = __shfl_sync(0xffffffffu, it, 0);
      }
    }
  } else {
    // Consumer warpgroups 1..NC: 64 q rows each of every work tile.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(P::CONSUMER_REGS));
    const int c = threadIdx.x / 128 - 1;
    const int w4 = (threadIdx.x % 128) / 32, g = lane >> 2, t = lane & 3;
    const float sl2 = p.scale * kLog2e;    // exp(x) = exp2(x * log2 e)
    // Turns on the tensor cores, round robin: consumer c waits on named
    // barrier 1 + c and hands over on the next one's; consumer 0 goes first.
    const int my_turn = 1 + c, next_turn = 1 + (c + 1) % NC;
    if (c == NC - 1) named_arrive(1);
    int it = 0;
    for (int j = 0, w = blockIdx.x; w < T; ++j, w += gridDim.x) {
      int qt, h, b;
      work_tile(w, n_qt, p.H, B, qt, h, b);
      const int qb = j & 1;
      const int row0 = qt * P::BM + c * kBox + w4 * 16 + g, row1 = row0 + 8;
      const int* qpos = p.q_pos + static_cast<long long>(b) * S;
      const int* kvpos = p.kv_pos + static_cast<long long>(b) * S;
      const int qp0 = row0 < S ? qpos[row0] : kPosMin;
      const int qp1 = row1 < S ? qpos[row1] : kPosMin;
      const uint32_t q_mine = q_s(qb) + c * kBox * P::RB;
      const int* list = tiles + qb * n_kt;
      mbar_wait(q_full(qb), (j >> 1) & 1);
      const int n = n_visit[qb];

      float o[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
      float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
      if (n > 0) {
        float s[kBN / 2];
#pragma unroll
        for (int i = 0; i < kBN / 2; ++i) s[i] = 0.f;
        uint32_t pf[kBN / 16][4];
        float corr0, corr1, sum0, sum1;

        int st = it % P::NS;
        mbar_wait(full_bar(st), (it / P::NS) & 1);
        named_sync(my_turn);
        fence_regs(s);
        wgmma_fence();
        issue_qk<D>(s, q_mine, k_s(st));
        wgmma_commit();
        named_arrive(next_turn);
        wgmma_wait<0>();
        fence_regs(s);
        softmax_tile(s, (list[0] >> 30) & 1, (list[0] & ~(1 << 30)) * kBN, kvpos, S, qp0, qp1,
                     sl2, t, m0, m1, corr0, corr1, sum0, sum1);
        rescale_and_pack<D>(o, pf, s, corr0, corr1, sum0, sum1, l0, l1);

        for (int i = 1; i < n; ++i) {
          const int prev = st;
          st = (it + i) % P::NS;
          mbar_wait(full_bar(st), ((it + i) / P::NS) & 1);
          named_sync(my_turn);
          fence_regs(o);
          fence_regs(pf);
          wgmma_fence();
          issue_qk<D>(s, q_mine, k_s(st));          // S of tile i
          wgmma_commit();
          issue_pv<D>(o, pf, v_s(prev));             // P V of tile i - 1
          wgmma_commit();
          named_arrive(next_turn);
          wgmma_wait<1>();                           // S has landed
          fence_regs(s);
          softmax_tile(s, (list[i] >> 30) & 1, (list[i] & ~(1 << 30)) * kBN, kvpos, S, qp0,
                       qp1, sl2, t, m0, m1, corr0, corr1, sum0, sum1);
          wgmma_wait<0>();                           // P V has landed
          fence_regs(o);
          fence_regs(pf);
          mbar_arrive(empty_bar(prev));
          rescale_and_pack<D>(o, pf, s, corr0, corr1, sum0, sum1, l0, l1);
        }
        named_sync(my_turn);
        fence_regs(o);
        fence_regs(pf);
        wgmma_fence();
        issue_pv<D>(o, pf, v_s(st));
        wgmma_commit();
        named_arrive(next_turn);
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(pf);
        mbar_arrive(empty_bar(st));
        it += n;
      }
      mbar_arrive(q_empty(qb));

      const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
      __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh + 2 * t;
      if (row0 < S) {
#pragma unroll
        for (int jj = 0; jj < D / 8; ++jj) {
          *reinterpret_cast<__nv_bfloat162*>(og + row0 * p.o_ss + 8 * jj) =
              __floats2bfloat162_rn(o[4 * jj] / d0, o[4 * jj + 1] / d0);
        }
      }
      if (row1 < S) {
#pragma unroll
        for (int jj = 0; jj < D / 8; ++jj) {
          *reinterpret_cast<__nv_bfloat162*>(og + row1 * p.o_ss + 8 * jj) =
              __floats2bfloat162_rn(o[4 * jj + 2] / d1, o[4 * jj + 3] / d1);
        }
      }
    }
    if (c == 0) named_sync(1);                       // the last hand-over to consumer 0
  }
}

// f32: one block of 128 threads per (16-row q tile, head, batch row), kv
// tiles of 16 rows, every product a plain FMA from shared memory. Rows past
// S read as zero, their kv positions as the largest int (masked), and are
// not stored.
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

  const int S = p.S;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile32;
  const int q_rows = min(kTile32, S - q0);
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const int tid = threadIdx.x;
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + q0 * p.q_ss + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  const int* qpos = p.q_pos + static_cast<long long>(b) * S;
  const int* kvpos = p.kv_pos + static_cast<long long>(b) * S;

  for (int i = tid; i < kTile32 * D; i += kThreads) {
    const int r = i / D, c = i % D;
    q_s[r][c] = r < q_rows ? qg[r * p.q_ss + c] : 0.f;
    acc_s[r][c] = 0.f;
  }
  if (tid < kTile32) {
    q_pos_s[tid] = tid < q_rows ? qpos[q0 + tid] : kPosMin;
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  __syncthreads();
  int q_max = q_pos_s[0];
  for (int i = 1; i < q_rows; ++i) q_max = max(q_max, q_pos_s[i]);

  for (int k0 = 0; k0 < S; k0 += kTile32) {
    const int kv_rows = min(kTile32, S - k0);
    if (tid < kTile32) kv_pos_s[tid] = tid < kv_rows ? kvpos[k0 + tid] : kPosMax;
    __syncthreads();
    int kv_min = kv_pos_s[0];
    for (int i = 1; i < kv_rows; ++i) kv_min = min(kv_min, kv_pos_s[i]);
    if (kv_min > q_max) {
      __syncthreads();
      continue;
    }
    for (int i = tid; i < kTile32 * D; i += kThreads) {
      const int r = i / D, c = i % D;
      k_s[r][c] = r < kv_rows ? kg[(k0 + r) * p.k_ss + c] : 0.f;
      v_s[r][c] = r < kv_rows ? vg[(k0 + r) * p.v_ss + c] : 0.f;
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
  for (int i = tid; i < q_rows * D; i += kThreads) {
    const int r = i / D, c = i % D;
    og[r * p.o_ss + c] = acc_s[r][c] / fmaxf(l_s[r], 1e-30f);
  }
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (no -lcuda).
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* f = nullptr;
#if CUDART_VERSION >= 12050
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault,
                                         &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess) {
      f = nullptr;
    }
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault) != cudaSuccess) {
      f = nullptr;
    }
#endif
    return reinterpret_cast<EncodeTiledFn>(f);
  }();
  return fn;
}

// A bf16 [B, S, X, D] operand (X heads) with element strides sb, ss, sh and
// a contiguous D as a 4-D tensor map, innermost first: dims (D, X, S, B);
// a box of P::SW columns (one swizzle row: 128 bytes, 64 at D 32; D 128
// takes two boxes a row block), one head, 64 rows and one batch row. TMA
// takes only byte strides that are multiples of 16; the wrapper checks them.
template <int D>
cudaError_t encode_map(CUtensorMap* map, const void* ptr, int X, int S, int B, long long sb,
                       long long ss, long long sh) {
  using P = Plan<D>;
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(X),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {P::SW, 1, kBox, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        P::RB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D, bool GLOBAL_LIST>
cudaError_t launch_bf16(const Params& p, int B, long long tile_list_len, cudaStream_t st) {
  using P = Plan<D>;
  static int sms = 0;
  static const cudaError_t ready = [] {
    // Dynamic shared memory above 48 KB needs the kernel's limit raised
    // first; raise it once to the most any S takes.
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_bf16_kernel<D, GLOBAL_LIST>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(P::smem_bytes(GLOBAL_LIST ? 0 : kSmemTiles)));
    if (e != cudaSuccess) return e;
    // setmaxnreg moves registers between the warpgroups of the block's
    // launch-time allocation: a kernel compiled to fewer registers than the
    // split needs would wait forever in setmaxnreg.inc, so it never runs.
    cudaFuncAttributes a;
    e = cudaFuncGetAttributes(&a, flash_fwd_bf16_kernel<D, GLOBAL_LIST>);
    if (e != cudaSuccess) return e;
    if (a.numRegs * P::THREADS < P::PRODUCER_REGS * 128 + P::CONSUMER_REGS * 128 * P::NC) {
      return cudaErrorInvalidConfiguration;
    }
    int dev = 0;
    e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    return cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }();
  if (ready != cudaSuccess) return ready;
  const long long work = static_cast<long long>((p.S + P::BM - 1) / P::BM) * p.H * B;
  const int grid = static_cast<int>(work < sms ? work : sms);
  const int n_kt = (p.S + kBN - 1) / kBN;
  if (GLOBAL_LIST && (p.tile_list == nullptr || tile_list_len < 2LL * grid * n_kt)) {
    return cudaErrorInvalidValue;
  }
  CUtensorMap maps[3];
  cudaError_t e = encode_map<D>(&maps[0], p.q, p.H, p.S, B, p.q_sb, p.q_ss, p.q_sh);
  if (e == cudaSuccess) e = encode_map<D>(&maps[1], p.k, p.KV, p.S, B, p.k_sb, p.k_ss, p.k_sh);
  if (e == cudaSuccess) e = encode_map<D>(&maps[2], p.v, p.KV, p.S, B, p.v_sb, p.v_ss, p.v_sh);
  if (e != cudaSuccess) return e;
  const int n_c = (p.S + kBox - 1) / kBox;
  chunk_minmax_kernel<<<dim3(n_c, B), 32, 0, st>>>(p.q_pos, p.kv_pos,
                                                   const_cast<int4*>(p.minmax), p.S, n_c);
  flash_fwd_bf16_kernel<D, GLOBAL_LIST><<<grid, P::THREADS,
                                         P::smem_bytes(GLOBAL_LIST ? 0 : n_kt), st>>>(
      p, B, maps[0], maps[1], maps[2]);
  return cudaSuccess;
}

template <int D>
cudaError_t launch(const Params& p, int B, bool is_bf16, long long tile_list_len,
                   cudaStream_t st) {
  if (is_bf16) {
    return (p.S + kBN - 1) / kBN > kSmemTiles ? launch_bf16<D, true>(p, B, tile_list_len, st)
                                              : launch_bf16<D, false>(p, B, tile_list_len, st);
  }
  const dim3 grid((p.S + kTile32 - 1) / kTile32, p.H, B);
  flash_fwd_f32_kernel<D><<<grid, kThreads, 0, st>>>(p);
  return cudaSuccess;
}

}  // namespace

// q [B,S,H,D], k and v [B,S,KV,D], o [B,S,H,D], all bf16 (is_bf16) or all
// f32, read and written through `strides`: 12 element strides, (batch, seq,
// head) for q, k, v, o in that order; D is contiguous. q_pos and kv_pos are
// int32 [B,S], contiguous. 1 <= S <= 2^30, H a multiple of KV, D in {32,
// 64, 128}. For bf16, q, k and v are read through tensor maps built here
// from these strides, so every stride but D's and every base address is a
// multiple of 16 bytes, and `minmax` is an int32 workspace of B *
// ceil(S / 64) * 4 (16-byte aligned), unused for f32. Past S 65536 (more
// than 512 kv tiles of 128 rows) the bf16 kernel keeps its kv-tile lists
// in `tile_list`, an int32 workspace of tile_list_len >= 2 * ceil(S / 128)
// for each SM; it is not read otherwise and may be null.
extern "C" int kukeon_flash_attention(const void* q, const void* k, const void* v, void* o,
                                      const void* q_pos, const void* kv_pos, void* minmax,
                                      void* tile_list, long long tile_list_len, int B, int S,
                                      int H, int KV, int D, const long long* strides,
                                      int is_bf16, void* stream) {
  if (B < 1 || S < 1 || S > kMaxS || KV < 1 || H % KV) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.q_pos = static_cast<const int*>(q_pos);
  p.kv_pos = static_cast<const int*>(kv_pos);
  p.minmax = static_cast<const int4*>(minmax);
  p.tile_list = static_cast<int*>(tile_list);
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
    case 32: err = launch<32>(p, B, is_bf16 != 0, tile_list_len, st); break;
    case 64: err = launch<64>(p, B, is_bf16 != 0, tile_list_len, st); break;
    case 128: err = launch<128>(p, B, is_bf16 != 0, tile_list_len, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
