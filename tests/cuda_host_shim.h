// The subset of CUDA that csrc/ransac.cu uses, on the host, so that the
// kernel's arithmetic and control flow can be compiled with g++ and run on the
// CPU in the tests (tests/test_torch_solver_kernel.py). One std::thread per
// CUDA thread; the blocks of a launch run one after another, so a __shared__
// variable becomes a static shared by the block's threads.
//
//   shim_launch(blocks, threads, dynamic_smem_bytes, [&] { kernel(args...); });
//
// __syncthreads is a barrier of the block's threads, __shfl_down_sync an
// exchange through a buffer of the calling warp (every lane of the warp must
// call it, as on the card). A barrier that waits 60 s (a thread of the block
// or warp never reached it: a hang on the card) aborts the process. No FMA
// contraction, no fast math: the host's f32.
#pragma once

#include <algorithm>
#include <chrono>
#include <cmath>
#include <condition_variable>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

using std::isfinite;
using std::isnan;
using std::min;

#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(n)
#define __restrict__ __restrict
#define __shared__ static

class ShimBarrier {
 public:
  explicit ShimBarrier(int n) : n_(n) {}
  void arrive_and_wait() {
    std::unique_lock<std::mutex> lk(m_);
    const long gen = gen_;
    if (++count_ == n_) {
      count_ = 0;
      ++gen_;
      cv_.notify_all();
      return;
    }
    if (!cv_.wait_for(lk, std::chrono::seconds(60), [&] { return gen_ != gen; })) {
      std::fprintf(stderr, "cuda_host_shim: a barrier waited 60 s for %d threads\n", n_);
      std::abort();
    }
  }

 private:
  std::mutex m_;
  std::condition_variable cv_;
  const int n_;
  int count_ = 0;
  long gen_ = 0;
};

struct ShimDim {
  unsigned x;
};
inline thread_local ShimDim threadIdx, blockIdx;

struct ShimBlock {
  std::unique_ptr<ShimBarrier> block;
  std::vector<std::unique_ptr<ShimBarrier>> warp;
  std::vector<float> lanes;                // 32 a warp
  std::vector<float> smem;
};
inline ShimBlock* shim_block = nullptr;

inline float* shim_dynamic_smem() { return shim_block->smem.data(); }

inline void __syncthreads() { shim_block->block->arrive_and_wait(); }

inline float __shfl_down_sync(unsigned, float v, int offset) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  float* buf = shim_block->lanes.data() + 32 * w;
  buf[lane] = v;
  shim_block->warp[w]->arrive_and_wait();
  const float r = lane + offset < 32 ? buf[lane + offset] : v;
  shim_block->warp[w]->arrive_and_wait();
  return r;
}

inline float __int_as_float(int i) {
  float f;
  std::memcpy(&f, &i, sizeof f);
  return f;
}

template <class F>
void shim_launch(int blocks, int threads, size_t smem_bytes, F&& body) {
  for (int b = 0; b < blocks; ++b) {
    ShimBlock blk;
    blk.block = std::make_unique<ShimBarrier>(threads);
    for (int w = 0; w < threads / 32; ++w)
      blk.warp.push_back(std::make_unique<ShimBarrier>(32));
    blk.lanes.resize(threads);
    blk.smem.resize(smem_bytes / sizeof(float) + 1);
    shim_block = &blk;
    std::vector<std::thread> ts;
    for (int t = 0; t < threads; ++t)
      ts.emplace_back([&body, t, b] {
        threadIdx.x = t;
        blockIdx.x = b;
        body();
      });
    for (auto& th : ts) th.join();
    shim_block = nullptr;
  }
}
