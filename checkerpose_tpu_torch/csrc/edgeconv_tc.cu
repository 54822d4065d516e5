// Fused inference EdgeConv with BatchNorm folded, bf16, on Hopper's tensor
// cores (sm_90a).
//
//   out[b, n, c] = max_k leaky(scale[c] * (y[b, knn[n, k], c] + z[b, n, c]) + bias[c])
//   y = x @ W1,  z = x @ (W2 - W1),  bf16 x bf16 products summed in f32
//
// Replaces: checkerpose_tpu/ops/pallas_edgeconv.py::edgeconv_fused_pallas
// (the Pallas TPU kernel, pl.pallas_call at :79), like its sibling
// edgeconv.cu, which keeps serving f32 inputs and the shapes this kernel
// does not take.
//
// Bound on an H100 SXM (B=512, N=512, K=20, C=C'=256, bf16): x read once and
// out written once are 268 MB, 80 us at 3.35 TB/s; the two projections are
// 68.7 GFLOP, 69 us at the bf16 tensor-core rate. So the function is bound
// by bytes. This design cannot reach that bound: it gathers y from shared
// memory in f32 (rounding y to bf16 would cancel badly in s * (y + z) + b),
// and B*N*K*C' four-byte reads at 128 bytes a clock on each of 132 SMs take
// about 0.18 ms a launch, a little over twice the byte bound; and the four
// blocks of a batch row each copy x twice from L2, 1.07 GB a launch, which
// alone takes about 0.2 ms.
//
// Design. One block owns one batch row b and a chunk of 64 output channels;
// the blocks of one batch row are neighbours in the grid, so their x tiles
// meet in L2. Its 13 warps have three roles and never meet after the set-up:
//  * The copy warp (one thread of it) asks the TMA for x tiles of 64 nodes x
//    64 input channels (8 KB, 128-byte swizzle, zeros past N and C) into a
//    ring of 3 to 8 stages, whatever the shared memory leaves, and for the W
//    chunk of the pass. An mbarrier per stage counts the bytes that land
//    (full), another the readers that are done (empty), so copies run as far
//    ahead of the products as the ring is deep.
//  * Warpgroup 0 issues the products: wgmma.mma_async m64n64k16 (f32 <- bf16
//    x bf16), both operands in shared memory, K-major, so neither needs a
//    transpose flag: W comes packed on the host side as transposed 64 x 64
//    tiles (ops/edgeconv.py::pack_edgeconv_weights). One product group stays
//    in flight while the next is issued. Pass 0 walks x once and leaves
//    y[:, chunk] for all N nodes in shared memory (f32). Pass 1 walks x again
//    for z, 64 nodes at a time, and hands each z tile over in shared memory.
//  * Warpgroups 1 and 2 take the max over the K neighbours of a z tile's
//    nodes while warpgroup 0 already multiplies the next tile: half a warp
//    takes a node and a lane four channels, so a neighbour costs one 16-byte
//    read from a 256-byte y row (free of bank conflicts), one address and
//    four maxima. Two named barriers pass the z tile back and forth.
//  z for all N in f32 would need as much shared memory again as y, and does
//  not fit beside it at a 64-channel chunk; a 32-channel chunk that kept both
//  would read x as often (8 blocks x 1 pass against 4 blocks x 2 passes) with
//  half the bytes per gather instruction, so x is walked twice. The W chunk
//  of a pass (W1, then W2-W1) is resident for the pass: 32 KB at C=256.
//  * leaky(s * (v + z) + b) is monotone in v, rising for s >= 0 and falling
//    for s < 0. y and z are stored multiplied by sign(s), so the max over k
//    is always a max, and the epilogue uses |s|: |s| * (max_k(sg*y) + sg*z)
//    + b equals s * (max_k or min_k of y + z) + b exactly.
//  * knn is read through the read-only cache (it is 40 KB, the same for
//    every block, and does not fit in shared memory beside y), a node's list
//    ahead of its turn.
// Shared memory at N=512, C=256: 1 KB alignment slack, W 32 KB, y 128 KB,
// z tile 18 KB, barriers 256 B, 5 ring stages 40 KB = 224,512 of the 232,448
// bytes a block may use: one block per SM.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int MMA_THREADS = 128;          // warpgroup 0: the products
constexpr int GATHER_WARPS = 8;           // warpgroups 1 and 2: max over neighbours
constexpr int Z_THREADS = MMA_THREADS + 32 * GATHER_WARPS;   // who meets at a z tile
constexpr int THREADS = Z_THREADS + 32;   // and one warp that issues the copies
constexpr int TILE = 64;                  // rows, k-columns, channels of a tile
constexpr int TILE_BYTES = TILE * TILE * 2;
constexpr int ALIGN = 1024;               // swizzle atoms repeat every 1024 bytes
constexpr int ZS_STRIDE = TILE + 8;       // f32 row of the z tile, padded: the
                                          // accumulator stores miss each other's banks
constexpr int NODES_PER_SLOT = TILE / (2 * GATHER_WARPS);   // nodes of a tile per half warp
constexpr int MIN_STAGES = 3;
constexpr int MAX_STAGES = 8;
constexpr int BAR_BYTES = 256;            // the mbarriers below, rounded up
constexpr int MAX_SMEM = 232448;

// mbarriers, behind the z tile: a full and an empty one per ring stage, and
// a pair for the W chunk
struct Barriers {
  uint64_t full[MAX_STAGES];              // the copy of a stage has landed (transaction bytes)
  uint64_t empty[MAX_STAGES];             // warpgroup 0 is done reading a stage
  uint64_t w_full, w_empty;
};
static_assert(sizeof(Barriers) <= BAR_BYTES, "BAR_BYTES");

// named barriers (0 is __syncthreads)
constexpr int BAR_Z_FULL = 1;             // warpgroup 0 arrives, the gather warps wait
constexpr int BAR_Z_EMPTY = 2;            // the gather warps arrive, warpgroup 0 waits

// -DEDGECONV_TC_SYNC_COPIES builds the kernel with a ring of one stage: each
// x tile is copied, waited for and multiplied before the next copy starts.
// Its output is the same; chip_smoke.py --steps times it beside the kernel
// to show what the asynchronous copies buy. The port never loads it.
#ifdef EDGECONV_TC_SYNC_COPIES
constexpr bool SYNC_COPIES = true;
#else
constexpr bool SYNC_COPIES = false;
#endif

__host__ __device__ constexpr int ceil_div(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(arrivals)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// one arrival, and `bytes` of copies that must land before the phase ends
__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// wait for the phase of this parity to end; a wait that never ends (a lost
// copy or arrival) traps, so a fault shows as a launch error, not a hang
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  for (int spin = 0; spin < (1 << 26); ++spin) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
  }
  __trap();
}

// TMA: one thread asks for a 64 x 64 bf16 box (128-byte swizzle, zeros past
// the tensor's edge); its bytes are counted on `bar`
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor: K-major, 128-byte swizzle, 8-row groups
// 1024 bytes apart; the leading offset is not used by swizzled K-major tiles
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
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

// d (64 x 64, f32) = A (64 x 16, bf16) @ B (16 x 64, bf16) + (accumulate ? d : 0),
// both operands in shared memory
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t a, uint64_t b,
                                                int accumulate) {
  // operands after the descriptors: scale-d (predicate: accumulate), scale-a,
  // scale-b (+1), trans-a, trans-b (0: both K-major)
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// The copy warp's one thread: the W chunk of each pass, then every x tile of
// the pass, each as soon as its ring stage is free.
__device__ __forceinline__ void produce(const CUtensorMap* tmap_x, const CUtensorMap* tmap_w,
                                        Barriers* bars, uint32_t w_s, uint32_t ring, int N, int C,
                                        int b, int chunk, int chunks, int stages) {
  const int KS = ceil_div(C, TILE), T = ceil_div(N, TILE);
  int stage = 0, phase = 0;
  for (int pass = 0; pass < 2; ++pass) {
    // pass 1 overwrites W1 once every product of pass 0 is complete; a fresh
    // barrier lets the wait on the phase before its first one through
    mbar_wait(&bars->w_empty, (pass & 1) ^ 1);
    mbar_expect(&bars->w_full, KS * TILE_BYTES);
    for (int ks = 0; ks < KS; ++ks)
      tma_load_2d(w_s + ks * TILE_BYTES, tmap_w, 0, ((pass * chunks + chunk) * KS + ks) * TILE,
                  &bars->w_full);
    for (int tile = 0; tile < T; ++tile) {
      for (int ks = 0; ks < KS; ++ks) {
        mbar_wait(&bars->empty[stage], phase ^ 1);
        mbar_expect(&bars->full[stage], TILE_BYTES);
        tma_load_3d(ring + stage * TILE_BYTES, tmap_x, ks * TILE, tile * TILE, b,
                    &bars->full[stage]);
        if (++stage == stages) { stage = 0; phase ^= 1; }
      }
    }
  }
}

// Warpgroup 0: both passes over x. Pass 0 leaves sign(s) * y for every node
// in `ys`; pass 1 hands sign(s) * z to the gather warps tile by tile in `zs`.
__device__ __forceinline__ void project(const float* scale, Barriers* bars, uint32_t w_s,
                                        uint32_t ring, float* ys, float* zs, int N, int C, int Cp,
                                        int c0, int stages, int tid) {
  const int lane = tid & 31, warp = tid >> 5;
  const int KS = ceil_div(C, TILE), T = ceil_div(N, TILE);
  // sign(scale) at this thread's accumulator columns 8j + 2(lane & 3) + {0, 1}
  float sg[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int cc = c0 + 8 * (i >> 1) + 2 * (lane & 3) + (i & 1);
    sg[i] = (cc < Cp && scale[cc] < 0.f) ? -1.f : 1.f;
  }
  float acc[32];
  int stage = 0, phase = 0;

  for (int pass = 0; pass < 2; ++pass) {
    mbar_wait(&bars->w_full, pass & 1);
    for (int tile = 0; tile < T; ++tile) {
      int unreleased = -1;                // a stage whose product may still be running
      for (int ks = 0; ks < KS; ++ks) {
        mbar_wait(&bars->full[stage], phase);
        const uint32_t a_s = ring + stage * TILE_BYTES;
        const uint32_t b_s = w_s + ks * TILE_BYTES;
        const int ksteps = min(TILE / 16, ceil_div(C - ks * TILE, 16));
        wgmma_fence();
        for (int kk = 0; kk < ksteps; ++kk)
          wgmma_m64n64k16(acc, wgmma_desc(a_s + kk * 32), wgmma_desc(b_s + kk * 32),
                          (ks | kk) != 0);
        wgmma_commit();
        // one product group stays in flight under the next wait; a stage goes
        // back to the copy warp once the product that read it is complete
        if (ks < KS - 1 && !SYNC_COPIES) wgmma_wait<1>(); else wgmma_wait<0>();
        // (a warp's wait covers its own rows of the product: a lane per warp arrives)
        if (unreleased >= 0 && lane == 0) mbar_arrive(&bars->empty[unreleased]);
        unreleased = stage;
        if (ks == KS - 1 || SYNC_COPIES) {
          if (lane == 0) mbar_arrive(&bars->empty[stage]);
          unreleased = -1;
        }
        if (++stage == stages) { stage = 0; phase ^= 1; }
      }
      // accumulators -> y (all nodes, rows of 64 floats) or the z tile
      if (pass == 1 && tile > 0) bar_sync(BAR_Z_EMPTY, Z_THREADS);   // the last z tile is read
      float* dst = pass == 0 ? ys + (size_t)tile * TILE * TILE : zs;
      const int stride = pass == 0 ? TILE : ZS_STRIDE;
      const int r0 = 16 * warp + (lane >> 2);
      const int col = 2 * (lane & 3);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        *reinterpret_cast<float2*>(dst + r0 * stride + 8 * j + col) =
            make_float2(acc[4 * j] * sg[2 * j], acc[4 * j + 1] * sg[2 * j + 1]);
        *reinterpret_cast<float2*>(dst + (r0 + 8) * stride + 8 * j + col) =
            make_float2(acc[4 * j + 2] * sg[2 * j], acc[4 * j + 3] * sg[2 * j + 1]);
      }
      if (pass == 1) bar_arrive(BAR_Z_FULL, Z_THREADS);              // y and this z tile stand
    }
    if (lane == 0) mbar_arrive(&bars->w_empty);   // every product of the pass has read W
  }
}

__device__ __forceinline__ void max4(float4& m, const float4 v) {
  m.x = fmaxf(m.x, v.x);
  m.y = fmaxf(m.y, v.y);
  m.z = fmaxf(m.z, v.z);
  m.w = fmaxf(m.w, v.w);
}

// knn[n, 4g .. 4g+3]; slots past K repeat neighbour 0, which changes no max
__device__ __forceinline__ int4 load_idx4(const int* row, int g, int K) {
  const int k = 4 * g;
  return make_int4(__ldg(row + (k < K ? k : 0)), __ldg(row + (k + 1 < K ? k + 1 : 0)),
                   __ldg(row + (k + 2 < K ? k + 2 : 0)), __ldg(row + (k + 3 < K ? k + 3 : 0)));
}

// Warpgroups 1..: for each z tile, half a warp takes a node and a lane four
// channels: one 16-byte read per neighbour from the node's 256-byte y row (a
// warp reads two rows, 4 wavefronts, no bank conflict), so the index and
// address work is shared by four maxima.
//
// KG > 0 is the straight-line form for K = 4 * KG with knn on a 16-byte
// line: a node's neighbour list sits in KG int4 registers, fetched while the
// node before it is worked on, and the 4 * KG reads of y carry no branch, so
// the compiler keeps many in flight; it is built for K = 20 (KG = 5), the
// flagship graph, only. KG = 0 is the loop for any other K.
template <int KG>
__device__ __forceinline__ void gather(const int* __restrict__ knn, const float* scale,
                                       const float* bias, __nv_bfloat16* outb, const float* ys,
                                       const float* zs, int N, int Cp, int K, int c0,
                                       float slope, int gw, int lane) {
  constexpr int G = KG > 0 ? KG : 1;
  const int T = ceil_div(N, TILE);
  const int hl = lane & 15;
  const int slot = 2 * gw + (lane >> 4);            // this half warp, of 2 * GATHER_WARPS
  const int ce = c0 + 4 * hl;                       // this lane's four channels
  float sa[4], bb[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    sa[i] = ce + i < Cp ? fabsf(scale[ce + i]) : 0.f;
    bb[i] = ce + i < Cp ? bias[ce + i] : 0.f;
  }
  const float4* yrow = reinterpret_cast<const float4*>(ys) + hl;
  const bool vec_out = (Cp & 3) == 0 && ce + 3 < Cp;

  // rows past N read node 0's list and store nothing
  auto row_of = [&](int n) { return knn + (size_t)(n < N ? n : 0) * K; };
  auto load_idx = [&](int4 (&idx)[G], int n) {
    if (KG > 0) {
      const int4* row = reinterpret_cast<const int4*>(row_of(n));
#pragma unroll
      for (int g = 0; g < KG; ++g) idx[g] = __ldg(row + g);
    }
  };
  int4 idx[G], idx_next[G];
  load_idx(idx_next, slot);

  for (int tile = 0; tile < T; ++tile) {
    bar_sync(BAR_Z_FULL, Z_THREADS);
#pragma unroll
    for (int i = 0; i < NODES_PER_SLOT; ++i) {
      const int r = slot + 2 * GATHER_WARPS * i;
      const int n = tile * TILE + r;
      float4 m = make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
      if (KG > 0) {
#pragma unroll
        for (int g = 0; g < KG; ++g) idx[g] = idx_next[g];
        // the next node of this half warp: in this tile, or the first of the next
        load_idx(idx_next, i + 1 < NODES_PER_SLOT ? n + 2 * GATHER_WARPS : (tile + 1) * TILE + slot);
#pragma unroll
        for (int g = 0; g < KG; ++g) {
          max4(m, yrow[idx[g].x * (TILE / 4)]);
          max4(m, yrow[idx[g].y * (TILE / 4)]);
          max4(m, yrow[idx[g].z * (TILE / 4)]);
          max4(m, yrow[idx[g].w * (TILE / 4)]);
        }
      } else {
        const int* row = row_of(n);
        for (int g = 0; 4 * g < K; ++g) {
          const int4 j = load_idx4(row, g, K);
          max4(m, yrow[j.x * (TILE / 4)]);
          max4(m, yrow[j.y * (TILE / 4)]);
          max4(m, yrow[j.z * (TILE / 4)]);
          max4(m, yrow[j.w * (TILE / 4)]);
        }
      }

      const float4 z = *reinterpret_cast<const float4*>(zs + r * ZS_STRIDE + 4 * hl);
      float v[4] = {sa[0] * (m.x + z.x) + bb[0], sa[1] * (m.y + z.y) + bb[1],
                    sa[2] * (m.z + z.z) + bb[2], sa[3] * (m.w + z.w) + bb[3]};
#pragma unroll
      for (int c = 0; c < 4; ++c) v[c] = v[c] >= 0.f ? v[c] : v[c] * slope;
      if (n < N) {
        __nv_bfloat16* o = outb + (size_t)n * Cp + ce;
        if (vec_out) {
          const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
          const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
          *reinterpret_cast<uint2*>(o) = make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                                                    *reinterpret_cast<const uint32_t*>(&hi));
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (ce + c < Cp) o[c] = __float2bfloat16(v[c]);
        }
      }
    }
    if (tile + 1 < T) bar_arrive(BAR_Z_EMPTY, Z_THREADS);
  }
}

__global__ void __launch_bounds__(THREADS, 1)
edgeconv_tc_kernel(const __grid_constant__ CUtensorMap tmap_x,
                   const __grid_constant__ CUtensorMap tmap_w, const int* __restrict__ knn,
                   const float* __restrict__ scale, const float* __restrict__ bias,
                   __nv_bfloat16* __restrict__ out, int N, int C, int Cp, int K, float slope,
                   int stages, int chunks) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t w_s = (raw + ALIGN - 1) & ~static_cast<uint32_t>(ALIGN - 1);
  const uint32_t ring = w_s + ceil_div(C, TILE) * TILE_BYTES;
  float* ys = reinterpret_cast<float*>(smem_raw + (ring - raw) + stages * TILE_BYTES);
  float* zs = ys + (size_t)ceil_div(N, TILE) * TILE * TILE;
  Barriers* bars = reinterpret_cast<Barriers*>(zs + TILE * ZS_STRIDE);

  const int chunk = blockIdx.x % chunks;
  const int b = blockIdx.x / chunks;
  const int c0 = chunk * TILE;
  const int tid = threadIdx.x;
  // from a shuffle, so the compiler sees one value per warp: the roles
  // below never meet again, and wgmma sits in one of them
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&bars->full[s], 1);
      mbar_init(&bars->empty[s], MMA_THREADS / 32);
    }
    mbar_init(&bars->w_full, 1);
    mbar_init(&bars->w_empty, MMA_THREADS / 32);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp < MMA_THREADS / 32) {
    project(scale, bars, w_s, ring, ys, zs, N, C, Cp, c0, SYNC_COPIES ? 1 : stages, tid);
  } else if (warp < Z_THREADS / 32) {
    const int gw = warp - MMA_THREADS / 32, lane = tid & 31;
    __nv_bfloat16* outb = out + (size_t)b * N * Cp;
    const bool lines = (reinterpret_cast<uintptr_t>(knn) & 15) == 0;
    if (K == 20 && lines)            // the flagship graph
      gather<5>(knn, scale, bias, outb, ys, zs, N, Cp, K, c0, slope, gw, lane);
    else
      gather<0>(knn, scale, bias, outb, ys, zs, N, Cp, K, c0, slope, gw, lane);
  } else if (tid == Z_THREADS) {
    produce(&tmap_x, &tmap_w, bars, w_s, ring, N, C, b, chunk, chunks,
            SYNC_COPIES ? 1 : stages);
  }
}

int stages_for(int N, int C) {
  const long fixed = ALIGN + (long)ceil_div(C, TILE) * TILE_BYTES +
                     (long)ceil_div(N, TILE) * TILE * TILE * 4 + TILE * ZS_STRIDE * 4 + BAR_BYTES;
  const long s = (MAX_SMEM - fixed) / TILE_BYTES;
  return (int)(s < 0 ? 0 : (s > MAX_STAGES ? MAX_STAGES : s));
}

size_t smem_bytes(int N, int C) {
  const int s = stages_for(N, C);
  if (s < MIN_STAGES) return 0;
  return ALIGN + (size_t)(ceil_div(C, TILE) + s) * TILE_BYTES +
         (size_t)ceil_div(N, TILE) * TILE * TILE * 4 + TILE * ZS_STRIDE * 4 + BAR_BYTES;
}

// cuTensorMapEncodeTiled lives in libcuda, which every CUDA process has
// loaded: looked up there by name, so this library links against nothing
// but cudart
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_LAZY);
    if (lib != nullptr) fn = reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// a bf16 tensor of `rank` dims (innermost first) cut into 64 x 64 (x 1) boxes
// with the 128-byte swizzle; what a box holds past the edge reads as zero
bool make_map(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  cuuint64_t strides[2] = {dims[0] * 2, dims[0] * dims[1] * 2};   // bytes, dims 1 and 2
  const cuuint32_t box[3] = {TILE, TILE, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

}  // namespace

extern "C" {

// Ring stages at (N, C); below 3 the kernel does not take the shape.
int edgeconv_tc_stages(int N, int C) { return stages_for(N, C); }

// Dynamic shared memory of one block, or 0 where the shape does not fit.
size_t edgeconv_tc_smem_bytes(int N, int C) { return smem_bytes(N, C); }

// x (B, N, C) bf16 with C % 8 == 0 on a 16-byte line; knn (N, K) int32 with
// entries in [0, N); wpack bf16 (2, ceil(Cp/64), ceil(C/64), 64, 64): the
// transposed zero-padded tiles of W1 and W2-W1; scale, bias (Cp,) f32; out
// (B, N, Cp) bf16. All contiguous. Returns the CUDA error code (0 = ok).
int edgeconv_tc_launch(const void* x, const int* knn, const void* wpack, const float* scale,
                       const float* bias, void* out, int B, int N, int C, int Cp, int K,
                       float slope, void* stream) {
  const size_t smem = (N > 0 && C > 0) ? smem_bytes(N, C) : 0;
  if (smem == 0 || B <= 0 || Cp <= 0 || K <= 0 || C % 8 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int chunks = ceil_div(Cp, TILE);
  if ((long)B * chunks > 2147483647L) return (int)cudaErrorInvalidValue;
  // the maps hold x's and wpack's addresses, so they are made per launch
  CUtensorMap tmap_x, tmap_w;
  const cuuint64_t x_dims[3] = {(cuuint64_t)C, (cuuint64_t)N, (cuuint64_t)B};
  const cuuint64_t w_dims[2] = {TILE, (cuuint64_t)2 * chunks * ceil_div(C, TILE) * TILE};
  if (!make_map(&tmap_x, x, 3, x_dims) || !make_map(&tmap_w, wpack, 2, w_dims))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      edgeconv_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  edgeconv_tc_kernel<<<B * chunks, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      tmap_x, tmap_w, knn, scale, bias, static_cast<__nv_bfloat16*>(out), N, C, Cp, K, slope,
      stages_for(N, C), chunks);
  return (int)cudaGetLastError();
}

}  // extern "C"
