// Fused inference EdgeConv with BatchNorm folded, exact f32 on the CUDA cores
// of Hopper (sm_90a).
//
//   out[b, n, c] = max_k leaky(scale[c] * (y[b, knn[n, k], c] + z[b, n, c]) + bias[c])
//   y = x @ W1,  z = x @ (W2 - W1),  f32 products summed in f32 (no TF32)
//
// Replaces: checkerpose_tpu/ops/pallas_edgeconv.py::edgeconv_fused_pallas
// (the Pallas TPU kernel, pl.pallas_call at :79) for f32 inputs, and for the
// bf16 shapes its sibling edgeconv_tc.cu does not take (C % 8 != 0, x off a
// 16-byte line, a y chunk too large for its ring); bf16 is widened to f32 on
// the way into shared memory and the output rounded back. It is the port's
// f32 reference, so the products stay on the FMA units: TF32 (and 3xTF32)
// would round the operands.
//
// Bound on an H100 SXM (B=512, N=512, K=20, f32): the two per-node
// projections are 4*B*N*C*C' operations, 68.7 GFLOP at C=C'=256 (1.026 ms at
// 67 TFLOP/s of f32 FMA) and 4.3 GFLOP at C=C'=64 (0.064 ms); x read once and
// out written once are 537 MB (0.160 ms) and 134 MB (0.040 ms). So the
// kernel is bound by operations at both widths.
//
// Design. One block of 256 threads owns one batch row b and a chunk of CB
// output channels (64, or 32 where a 64-channel y chunk does not fit); the
// chunks of one row are neighbours in the grid (blockIdx.x), so their reads
// of x meet in L2. The block walks x twice, 256 nodes at a time: pass 0
// leaves y[:, chunk] * sign(scale) for all N nodes in shared memory, pass 1
// computes a z tile in registers and takes the max over the K neighbours
// straight from them. Every thread owns 8 nodes x CB/8 channels of a tile.
// Against the first version's five limits:
//  1. Register tiling. A thread holds 64 accumulators (8 nodes x 8 channels;
//     32 at CB = 32). Four k at a time it reads each of its 8 nodes' x with
//     one 16-byte load and W with 2 x 4 (1 x 4 at CB = 32): 64 FMAs per four
//     16-byte shared loads (32 per three), where the first version did 16 per
//     five. x rows are node-major, TK f32 a row, their 16-byte chunks
//     permuted by the TMA's swizzle, so the four rows a warp reads at once
//     miss each other's banks; a warp's W load is 128 contiguous bytes.
//  2. Asynchronous copies. The tiles arrive through a ring of 2 stages, one
//     step ahead of the products: for f32 with C and C' multiples of 4 and
//     x, W on 16-byte lines (the main path), one thread asks the TMA for a
//     256-node x TK-channel x box (swizzled) and a TK x CB W box, counted on
//     the stage's mbarrier, zeros past N, C and C'. TK = 32 input channels
//     a stage (16 past N = 1231) keeps the steps, and their barrier and
//     waits, few: 2,048 FMAs a thread a step at CB = 64. The rest (C % 4 !=
//     0, views off a 16-byte line, bf16) is copied element by element into
//     the same layout: 4-byte cp.async for f32, loads widened by the threads
//     for bf16 (the scalar load path). One __syncthreads a step frees the
//     stage the next copy overwrites. (Transposing 4-byte
//     cp.async copies into a k-major tile, and 16-byte ones, both cost the
//     launch more than the TMA does: the SM issues and lands every piece.)
//  3. Shared memory. The knn table stays out of it: neighbours come through
//     the read-only cache (__ldg), as edgeconv_tc.cu reads them. At N=512 a
//     block takes 214,080 bytes (below), so one block of 8 warps runs on an
//     SM. The chunk and the stage depth follow N: (CB, TK) = (64, 32) up
//     to N = 583, (32, 32) up to 1231, (32, 16) up to 1519, which covers
//     every N the first version took (1477 at K = 1); small batches take
//     (32, 32) in place of (64, 32) (point 5).
//  4. Passes over x. A 64-channel chunk halves the blocks of a batch row:
//     at C'=256 four blocks walk x_b twice, 8 walks against the first
//     version's 16.
//  5. Small batches. The grid is (ceil(C'/CB), B). Where 64-channel chunks
//     would give fewer blocks than the card has SMs, B * ceil(C'/64) < 132,
//     the launch takes 32-channel chunks: at B=64, C'=64 that is 128 blocks
//     where 64 would leave half the card idle. At the main path's B=512 the
//     grid holds 512 or 2048 blocks.
//  The max over k takes all 8 of a thread's nodes at once (8 independent
//  chains of an index load and two 16-byte row loads): a quarter warp reads
//  one neighbour's 128 contiguous bytes of y, free of bank conflicts.
//  leaky(s * (v + z) + b) is monotone in v (rising for s >= 0, falling for
//  s < 0, slope >= 0), and y and z are stored times sign(s), so the max over
//  k is always a max and the epilogue, |s| * (max_k(sg*y) + sg*z) + b, runs
//  once per output; its multiply and add round separately, as the plain
//  version's do.
// Shared memory at N=512, K=20, CB=64, TK=32: 1,024 bytes of alignment
// slack, 2 stages x (x box 256 x 32 f32 + W box 32 x 64 f32) = 81,920, y
// chunk 512 x 64 f32 = 131,072, mbarriers 64: 214,080 of the 232,448 bytes
// a block may use, whatever K.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TX = 8;                  // threads across a chunk's channels
constexpr int TY = THREADS / TX;       // threads across a tile's nodes
constexpr int TN = 8 * TY;             // nodes per tile: 256, 8 a thread
constexpr int STAGES = 2;
constexpr int ALIGN = 1024;            // slack to put the ring on a 1024-byte line
constexpr int BAR_BYTES = 64;          // one mbarrier a stage, rounded up
constexpr int MAX_SMEM = 232448;

// A ring stage: an x box of TN nodes x tk input channels, a W box of tk x cb.
__host__ __device__ constexpr size_t stage_floats(int cb, int tk) { return (size_t)tk * (TN + cb); }

size_t smem_for(int N, int cb, int tk) {
  return ALIGN + sizeof(float) * (STAGES * stage_floats(cb, tk) + (size_t)N * cb) + BAR_BYTES;
}

// A block's output channels and input channels a stage, the first of (64,
// 32), (32, 32), (32, 16) whose y chunk fits beside the ring: N <= 583,
// 1231, 1519.
struct Config {
  int cb, tk;
};
constexpr Config CONFIGS[3] = {{64, 32}, {32, 32}, {32, 16}};
Config config_for(int N) {
  for (const Config& c : CONFIGS)
    if (smem_for(N, c.cb, c.tk) <= (size_t)MAX_SMEM) return c;
  return CONFIGS[2];
}

// The config a launch takes: N's, but 32 output channels a block where
// 64-channel chunks would give fewer blocks than the card has SMs (a small
// batch: B = 64 at C' = 64 gives 128 blocks instead of 64 on 132 SMs).
Config launch_config_for(int B, int N, int Cp) {
  Config c = config_for(N);
  int dev = 0, sms = 0;
  if (c.cb == 64 && cudaGetDevice(&dev) == cudaSuccess &&
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) == cudaSuccess &&
      (long)B * ((Cp + 63) / 64) < sms)
    c = CONFIGS[1];
  return c;
}

// Where x[node n, k] of a tile lies in its stage: node-major rows of TK f32
// whose 16-byte chunks are permuted as the TMA's swizzle of the row's width
// lays them (128 bytes: chunk c of row n at c ^ (n & 7); 64 bytes: at
// c ^ ((n >> 1) & 3)), so the four rows a warp reads at once fall in four
// distinct groups of banks.
template <int TK>
__device__ __forceinline__ int x_at(int n, int k) {
  constexpr int R = TK / 4;            // 16-byte chunks a row
  return n * TK + ((((k >> 2) ^ ((n * R) >> 3)) & (R - 1)) << 2) + (k & 3);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(arrivals)
               : "memory");
}
// one arrival, and `bytes` of copies that must land before the phase ends
__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// wait for the phase of this parity to end; a wait that never ends (a lost
// copy) traps, so a fault shows as a launch error, not a hang
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

// TMA: one thread asks for a box of a tensor map (zeros past its edge); the
// bytes are counted on `bar`
__device__ __forceinline__ void tma_load_3d(float* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma_load_2d(float* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void copy_elem(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void copy_elem(float* dst, const __nv_bfloat16* src, bool valid) {
  *dst = valid ? __bfloat162float(*src) : 0.f;
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(STAGES - 2) : "memory");
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<unsigned*>(&lo);
  u.y = *reinterpret_cast<unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// Node of a thread's row r in a tile (a warp's four ty are consecutive
// nodes), and channel of its column q in a chunk (two groups of 4, so a
// quarter warp's 16-byte loads of W and y are 128 contiguous bytes).
__device__ __forceinline__ int node_of(int ty, int r) { return r * TY + ty; }
__device__ __forceinline__ int chan_of(int tx, int q) { return (q / 4) * 32 + tx * 4 + q % 4; }

struct Shape {
  int N, C, Cp, K, ktiles, tiles;  // tiles: of TN nodes; ktiles: of a stage's input channels
};

// A ring step's place: k-tile, node tile, pass (0: y, 1: z).
struct Cursor {
  int kt = 0, tile = 0, pass = 0;
  __device__ __forceinline__ void next(const Shape& sh) {
    if (++kt == sh.ktiles) {
      kt = 0;
      if (++tile == sh.tiles) {
        tile = 0;
        ++pass;
      }
    }
  }
};

struct Maps {
  CUtensorMap x, w1, w2m1;
};

// The copies of step `at` (x rows of its node tile, that pass's W rows) into
// `stage`. TMA: thread 0 asks for an x box of 256 nodes x TK channels and a
// W box of TK x CB, counted on the stage's mbarrier. Else every thread
// copies elements (4-byte cp.async for f32, loads widened by the thread for
// bf16) and commits a group, even past the last step, so the wait in the
// loop counts the same everywhere.
template <typename T, int CB, int TK, bool TMA>
__device__ __forceinline__ void issue_step(const Cursor& at, const Shape& sh, const Maps& maps,
                                           const T* __restrict__ xb, const T* __restrict__ w1,
                                           const T* __restrict__ w2m1, int b, int c0,
                                           float* stage, uint64_t* full) {
  const int k0 = at.kt * TK, n0 = at.tile * TN;
  float* xs = stage;
  float* ws = stage + TN * TK;
  if constexpr (TMA) {
    if (at.pass < 2 && threadIdx.x == 0) {
      mbar_expect(full, (int)(sizeof(float) * stage_floats(CB, TK)));
      tma_load_3d(xs, &maps.x, k0, n0, b, full);
      tma_load_2d(ws, at.pass ? &maps.w2m1 : &maps.w1, c0, k0, full);
    }
  } else {
    if (at.pass < 2) {
      const int tid = threadIdx.x;
      const T* w = at.pass ? w2m1 : w1;
      // x: a warp copies 32 / TK rows of TK elements an instruction
#pragma unroll 8
      for (int i = 0; i < TN * TK / THREADS; ++i) {
        const int e = i * THREADS + tid;
        const int n = e / TK, k = e % TK;
        const bool ok = n0 + n < sh.N && k0 + k < sh.C;
        copy_elem(xs + x_at<TK>(n, k), ok ? xb + (size_t)(n0 + n) * sh.C + k0 + k : xb, ok);
      }
#pragma unroll
      for (int i = 0; i < TK * CB / THREADS; ++i) {
        const int e = i * THREADS + tid;
        const int k = e / CB, c = e % CB;
        const bool ok = k0 + k < sh.C && c0 + c < sh.Cp;
        copy_elem(ws + k * CB + c, ok ? w + (size_t)(k0 + k) * sh.Cp + c0 + c : w, ok);
      }
    }
    cp_async_commit();
  }
}

// acc[r][q] += sum_k x[node r, k] * w[k, chan q] over one stage's TK k, in
// order of k. Four k at a time: one 16-byte load gives a node's four x, so a
// thread reads its 8 nodes with 8 loads and its channels with 4 x NQ / 4 for
// 4 x 8 x NQ FMAs.
template <int CB, int TK>
__device__ __forceinline__ void multiply_stage(const float* __restrict__ xs,
                                               const float* __restrict__ ws,
                                               float (&acc)[8][CB / 8], int tx, int ty) {
  constexpr int NQ = CB / 8;
#pragma unroll
  for (int k4 = 0; k4 < TK; k4 += 4) {
    float a[8][4];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float4 v = *reinterpret_cast<const float4*>(xs + x_at<TK>(node_of(ty, r), k4));
      a[r][0] = v.x;
      a[r][1] = v.y;
      a[r][2] = v.z;
      a[r][3] = v.w;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float w[NQ];
#pragma unroll
      for (int g = 0; g < NQ / 4; ++g) {
        const float4 v = *reinterpret_cast<const float4*>(ws + (k4 + j) * CB + g * 32 + tx * 4);
        w[g * 4 + 0] = v.x;
        w[g * 4 + 1] = v.y;
        w[g * 4 + 2] = v.z;
        w[g * 4 + 3] = v.w;
      }
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int q = 0; q < NQ; ++q) acc[r][q] = fmaf(a[r][j], w[q], acc[r][q]);
    }
  }
}

__device__ __forceinline__ float sign_of(float s) { return s >= 0.f ? 1.f : -1.f; }

// Pass 0's epilogue: y * sign(scale) of the tile's nodes into the y chunk.
template <int CB>
__device__ __forceinline__ void keep_y(const float (&acc)[8][CB / 8], float* ys, int n0,
                                       const Shape& sh, const float* __restrict__ scale,
                                       int c0, int tx, int ty) {
  constexpr int NQ = CB / 8;
  float sg[NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const int c = c0 + chan_of(tx, q);
    sg[q] = c < sh.Cp ? sign_of(__ldg(scale + c)) : 1.f;
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int n = n0 + node_of(ty, r);
    if (n < sh.N) {
#pragma unroll
      for (int g = 0; g < NQ / 4; ++g) {
        const float v[4] = {sg[g * 4] * acc[r][g * 4], sg[g * 4 + 1] * acc[r][g * 4 + 1],
                            sg[g * 4 + 2] * acc[r][g * 4 + 2], sg[g * 4 + 3] * acc[r][g * 4 + 3]};
        store4(ys + n * CB + g * 32 + tx * 4, v);
      }
    }
  }
}

// One output row: |s| * (m + sg * z) + b, leaky, into out.
template <typename T, int NQ>
__device__ __forceinline__ void write_out(const float (&m)[NQ], const float (&z)[NQ],
                                          const float (&sg)[NQ], const float (&as)[NQ],
                                          const float (&bb)[NQ], float slope, T* o, int c0,
                                          int Cp, int tx) {
#pragma unroll
  for (int g = 0; g < NQ / 4; ++g) {
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = g * 4 + i;
      const float e = __fadd_rn(__fmul_rn(as[q], __fadd_rn(m[q], sg[q] * z[q])), bb[q]);
      v[i] = e >= 0.f ? e : __fmul_rn(e, slope);
    }
    const int c = chan_of(tx, g * 4);
    if (Cp % 4 == 0 && c0 + c < Cp) {
      store4(o + c, v);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (c0 + c + i < Cp) store(o + c + i, v[i]);
    }
  }
}

// m = max(m, y row j) over the thread's channels of the chunk.
template <int CB>
__device__ __forceinline__ void take_row(float (&m)[CB / 8], const float* ys, int j, int tx) {
  const float* row = ys + j * CB + tx * 4;
#pragma unroll
  for (int g = 0; g < CB / 32; ++g) {
    const float4 v = *reinterpret_cast<const float4*>(row + g * 32);
    m[g * 4 + 0] = fmaxf(m[g * 4 + 0], v.x);
    m[g * 4 + 1] = fmaxf(m[g * 4 + 1], v.y);
    m[g * 4 + 2] = fmaxf(m[g * 4 + 2], v.z);
    m[g * 4 + 3] = fmaxf(m[g * 4 + 3], v.w);
  }
}

// Pass 1's epilogue: the max over the K neighbours' y rows for all 8 of the
// thread's nodes at once (8 independent chains of index load, then row
// loads; four indices a 16-byte load where the rows of knn allow), then the
// outputs. A node past N reads node n0's list and writes nothing.
template <typename T, int CB>
__device__ __forceinline__ void gather_out(const float (&acc)[8][CB / 8], const float* ys,
                                           int n0, const Shape& sh,
                                           const int* __restrict__ knn,
                                           const float* __restrict__ scale,
                                           const float* __restrict__ bias, float slope,
                                           T* __restrict__ outb, int c0, int tx, int ty) {
  constexpr int NQ = CB / 8;
  const int* nb[8];
  float m[8][NQ];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int n = n0 + node_of(ty, r);
    nb[r] = knn + (size_t)(n < sh.N ? n : n0) * sh.K;
#pragma unroll
    for (int q = 0; q < NQ; ++q) m[r][q] = -INFINITY;
  }
  int k = 0;
  if (sh.K % 4 == 0 && reinterpret_cast<uintptr_t>(knn) % 16 == 0) {
    for (; k < sh.K; k += 4) {
      int4 j[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) j[r] = __ldg(reinterpret_cast<const int4*>(nb[r] + k));
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        take_row<CB>(m[r], ys, j[r].x, tx);
        take_row<CB>(m[r], ys, j[r].y, tx);
        take_row<CB>(m[r], ys, j[r].z, tx);
        take_row<CB>(m[r], ys, j[r].w, tx);
      }
    }
  }
  for (; k < sh.K; ++k) {
    int j[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) j[r] = __ldg(nb[r] + k);
#pragma unroll
    for (int r = 0; r < 8; ++r) take_row<CB>(m[r], ys, j[r], tx);
  }
  float sg[NQ], as[NQ], bb[NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const int c = c0 + chan_of(tx, q);
    const float s = c < sh.Cp ? __ldg(scale + c) : 0.f;
    sg[q] = sign_of(s);
    as[q] = fabsf(s);
    bb[q] = c < sh.Cp ? __ldg(bias + c) : 0.f;
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int n = n0 + node_of(ty, r);
    if (n < sh.N)
      write_out<T, NQ>(m[r], acc[r], sg, as, bb, slope, outb + (size_t)n * sh.Cp + c0, c0,
                       sh.Cp, tx);
  }
}

template <typename T, int CB, int TK, bool TMA>
__global__ void __launch_bounds__(THREADS, 1)
edgeconv_fma_kernel(const __grid_constant__ Maps maps, const T* __restrict__ x,
                    const int* __restrict__ knn, const T* __restrict__ w1,
                    const T* __restrict__ w2m1, const float* __restrict__ scale,
                    const float* __restrict__ bias, T* __restrict__ out, int N, int C, int Cp,
                    int K, float slope) {
  extern __shared__ uint8_t smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_raw + ((ALIGN - smem_u32(smem_raw) % ALIGN) % ALIGN));
  float* ys = ring + STAGES * stage_floats(CB, TK);    // N x CB
  uint64_t* full = reinterpret_cast<uint64_t*>(ys + (size_t)N * CB);

  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int c0 = blockIdx.x * CB;
  const int b = blockIdx.y;
  const T* xb = x + (size_t)b * N * C;
  T* outb = out + (size_t)b * N * Cp;
  const Shape sh{N, C, Cp, K, (C + TK - 1) / TK, (N + TN - 1) / TN};
  const int steps = 2 * sh.tiles * sh.ktiles;

  if (TMA && threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  Cursor load, use;                    // the step copied next, the step multiplied next
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    issue_step<T, CB, TK, TMA>(load, sh, maps, xb, w1, w2m1, b, c0,
                               ring + s * stage_floats(CB, TK), &full[s]);
    load.next(sh);
  }

  float acc[8][CB / 8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int q = 0; q < CB / 8; ++q) acc[r][q] = 0.f;

  for (int s = 0; s < steps; ++s) {
    // step s has landed, and everyone is done with step s - 1, whose stage
    // the next copies overwrite
    const int st = s % STAGES;
    if constexpr (TMA)
      mbar_wait(&full[st], (s / STAGES) & 1);
    else
      cp_async_wait_ring();
    __syncthreads();
    const int next = (s + STAGES - 1) % STAGES;
    issue_step<T, CB, TK, TMA>(load, sh, maps, xb, w1, w2m1, b, c0,
                               ring + next * stage_floats(CB, TK), &full[next]);
    load.next(sh);
    const float* xs = ring + st * stage_floats(CB, TK);
    multiply_stage<CB, TK>(xs, xs + TN * TK, acc, tx, ty);
    if (use.kt == sh.ktiles - 1) {
      // the tile is done; pass 1 starts at least one barrier after the last
      // y store, so every y row is in place before the first gather
      const int n0 = use.tile * TN;
      if (use.pass == 0)
        keep_y<CB>(acc, ys, n0, sh, scale, c0, tx, ty);
      else
        gather_out<T, CB>(acc, ys, n0, sh, knn, scale, bias, slope, outb, c0, tx, ty);
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int q = 0; q < CB / 8; ++q) acc[r][q] = 0.f;
    }
    use.next(sh);
  }
}

template <typename T, int CB, int TK, bool TMA>
int launch_config(const Maps& maps, const void* x, const int* knn, const void* w1,
                  const void* w2m1, const float* scale, const float* bias, void* out, int B,
                  int N, int C, int Cp, int K, float slope, cudaStream_t stream) {
  const size_t smem = smem_for(N, CB, TK);
  cudaError_t err = cudaFuncSetAttribute(edgeconv_fma_kernel<T, CB, TK, TMA>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Cp + CB - 1) / CB, B);
  edgeconv_fma_kernel<T, CB, TK, TMA><<<grid, THREADS, smem, stream>>>(
      maps, static_cast<const T*>(x), knn, static_cast<const T*>(w1),
      static_cast<const T*>(w2m1), scale, bias, static_cast<T*>(out), N, C, Cp, K, slope);
  return (int)cudaGetLastError();
}

template <typename T, bool TMA>
int launch(const Maps& maps, const void* x, const int* knn, const void* w1, const void* w2m1,
           const float* scale, const float* bias, void* out, int B, int N, int C, int Cp,
           int K, float slope, cudaStream_t stream) {
  const Config c = launch_config_for(B, N, Cp);
  if (c.cb == 64)
    return launch_config<T, 64, 32, TMA>(maps, x, knn, w1, w2m1, scale, bias, out, B, N, C, Cp,
                                         K, slope, stream);
  if (c.tk == 32)
    return launch_config<T, 32, 32, TMA>(maps, x, knn, w1, w2m1, scale, bias, out, B, N, C, Cp,
                                         K, slope, stream);
  return launch_config<T, 32, 16, TMA>(maps, x, knn, w1, w2m1, scale, bias, out, B, N, C, Cp,
                                       K, slope, stream);
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

// An f32 tensor of `rank` dims (innermost first, rows of 16-byte multiples)
// cut into `box`es; what a box holds past the edge reads as zero.
bool make_map(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
              const cuuint32_t* box, CUtensorMapSwizzle swizzle) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t strides[2] = {dims[0] * 4, dims[0] * dims[1] * 4};   // bytes, dims 1, 2
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank, const_cast<void*>(base), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

bool on_line(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

// Dynamic shared memory of one block at the chunk N takes (the ring, the y
// chunk and the ring's mbarriers; K does not enter: knn stays in device
// memory). The wrapper refuses an N above the 227 KB a block can use.
size_t edgeconv_fused_smem_bytes(int N, int K) {
  (void)K;
  const Config c = config_for(N);
  return smem_for(N, c.cb, c.tk);
}

size_t edgeconv_fused_max_smem_bytes() { return MAX_SMEM; }

// x (B, N, C) and w1, w2m1 (C, Cp) are bf16 when is_bf16 else f32 (x 4-byte
// aligned when f32); knn (N, K) int32 with entries in [0, N); scale, bias
// (Cp,) f32; out (B, N, Cp) of x's type, on a 16-byte line. All contiguous.
// f32 with C and Cp multiples of 4 and x, w1, w2m1 on 16-byte lines is
// copied by the TMA, the rest element by element. Returns the CUDA error
// code of the launch (0 = ok).
int edgeconv_fused_launch(int is_bf16, const void* x, const int* knn,
                          const void* w1, const void* w2m1, const float* scale,
                          const float* bias, void* out, int B, int N, int C,
                          int Cp, int K, float slope, void* stream) {
  if (B > 65535 || B <= 0 || N <= 0 || C <= 0 || Cp <= 0 || K <= 0 ||
      edgeconv_fused_smem_bytes(N, K) > (size_t)MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Maps maps = {};
  if (is_bf16)
    return launch<__nv_bfloat16, false>(maps, x, knn, w1, w2m1, scale, bias, out, B, N, C, Cp,
                                        K, slope, s);
  if (C % 4 != 0 || Cp % 4 != 0 || !on_line(x) || !on_line(w1) || !on_line(w2m1))
    return launch<float, false>(maps, x, knn, w1, w2m1, scale, bias, out, B, N, C, Cp, K,
                                slope, s);
  // the maps hold x's and W's addresses, so they are made per launch
  const Config c = launch_config_for(B, N, Cp);
  const cuuint64_t x_dims[3] = {(cuuint64_t)C, (cuuint64_t)N, (cuuint64_t)B};
  const cuuint32_t x_box[3] = {(cuuint32_t)c.tk, TN, 1};
  const cuuint64_t w_dims[2] = {(cuuint64_t)Cp, (cuuint64_t)C};
  const cuuint32_t w_box[2] = {(cuuint32_t)c.cb, (cuuint32_t)c.tk};
  // an x row of the box is the swizzle's width: 128 bytes at tk = 32, 64 at 16
  const CUtensorMapSwizzle sw = c.tk == 32 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  if (!make_map(&maps.x, x, 3, x_dims, x_box, sw) ||
      !make_map(&maps.w1, w1, 2, w_dims, w_box, CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !make_map(&maps.w2m1, w2m1, 2, w_dims, w_box, CU_TENSOR_MAP_SWIZZLE_NONE))
    return (int)cudaErrorInvalidValue;
  return launch<float, true>(maps, x, knn, w1, w2m1, scale, bias, out, B, N, C, Cp, K, slope, s);
}

}  // extern "C"
