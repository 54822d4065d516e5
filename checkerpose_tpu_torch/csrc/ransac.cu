// RANSAC-EPnP on the CUDA cores of Hopper (sm_90a), in two launches:
//
//   ransac_hypotheses  one block per row: each hypothesis's EPnP, its score
//                      over the row's N points, the best by argmax
//   ransac_refine      one block per row: IRLS rounds of weighted
//                      Gauss-Newton, the reseed EPnP, the final inlier mask
//
// The function is solver/ransac.py::ransac_pnp after the sampling (which
// stays in PyTorch, so both routes draw the same index sets), with every
// count the caller passes and the eager chain's constants, all in f32
// (solver/epnp.py says what each step computes; this file follows it line by
// line). It replaces no TPU kernel: the JAX package's solver is XLA. It
// replaces the eager chain on the card, which kept (B, H, N) intermediates in
// device memory, allocated workspace in every batched Cholesky and drained
// the stream on every `eigh`'s host check.
//
// Bound on an H100 SXM, for the largest call the port makes (1,536 rows,
// 128 hypotheses, 512 points, reseed on): scoring is 1536 * 128 * 512 point
// reprojections, ~2.5 GFLOP (37 us at 67 TFLOP/s of f32), and the inputs and
// outputs are ~30 MB (9 us at 3.35 TB/s). Neither bounds it: the work is
// chains of small dependent steps (Cholesky, Jacobi sweeps, Gauss-Newton
// rounds, each a reduction over the row's points), so the kernel is bound by
// latency, and its design keeps every chain on chip:
//  - A row's points, validity and weights live in shared memory; p3d and K
//    batches of stride 0 are read in place.
//  - A hypothesis is solved by one thread in registers: the 4x4 sums of the
//    EPnP normal matrix (40 of them), its 12x12 Cholesky packed (78
//    floats), Horn's 4x4 by shifted power iteration. A warp scores one
//    hypothesis at a time over the N points; the (B, H, N) errors are never
//    written.
//  - The refine's sums over points (the Gauss-Newton normal equations, the
//    candidates' costs, the EPnP sums) are block reductions in a fixed order,
//    so a run repeats bit for bit. The small dense steps after a reduction
//    (the 6x6 solve, the candidates) run on every thread from the same sums;
//    the symmetric eigendecompositions (3x3 covariance, 12x12 normal matrix,
//    Horn's 4x4) run on one thread by cyclic Jacobi and are broadcast.
//  - Nothing synchronises with the host and nothing allocates: the wrapper
//    hands over its outputs, and the two launches go on the caller's stream.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;              // a block: one row
constexpr int WARPS = THREADS / 32;
constexpr int MAX_N = 4096;               // points of a row (shared memory)
constexpr int MAX_S = 16;                 // points of a hypothesis
constexpr int CAND = 4;                   // Gauss-Newton candidates scored per pass
constexpr int RED = 40;                   // the widest block reduction (floats)
constexpr int BCAST = 32;                 // the widest broadcast (floats)
constexpr int MAX_SWEEPS = 50;            // Jacobi sweeps at most (Numerical Recipes' cap)
constexpr float EPS = 1e-9f;              // solver/epnp.py's _EPS
constexpr float DAMPING = 1e-5f;          // refine_pose_gn's damping

struct Cam {
  float fx, fy, cx, cy;
};

struct Pose {
  float R[9];                             // row-major
  float t[3];
};

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fffffff); }

// torch.clamp_min: NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }

// torch.sign: -1, 0 or 1, and 0 for NaN
__device__ __forceinline__ float sign_f(float x) {
  return (float)((x > 0.f) - (x < 0.f));
}

__device__ __forceinline__ float sigmoid_f(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ Cam load_cam(const float* K) {
  return Cam{K[0], K[4], K[2], K[5]};
}

// solver/epnp.py::reproj_errors for one point
__device__ __forceinline__ float reproj_err(const Pose& P, const float X[3], float u0, float v0,
                                            const Cam& k) {
  const float pcx = P.R[0] * X[0] + P.R[1] * X[1] + P.R[2] * X[2] + P.t[0];
  const float pcy = P.R[3] * X[0] + P.R[4] * X[1] + P.R[5] * X[2] + P.t[1];
  const float z = clamp_min(P.R[6] * X[0] + P.R[7] * X[1] + P.R[8] * X[2] + P.t[2], 1e-6f);
  const float du = k.fx * pcx / z + k.cx - u0;
  const float dv = k.fy * pcy / z + k.cy - v0;
  return sqrtf(du * du + dv * dv);
}

// ---------------------------------------------------------------- reductions

// Sum of each of v's M entries over the block; every thread gets the same
// sums (lane 0 of each warp writes, all threads add the warps in order).
template <int M>
__device__ void block_sum(float (&v)[M], float* red) {
  static_assert(M <= RED, "reduction wider than its scratch");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < M; ++i) {
    float x = v[i];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
    if (lane == 0) red[warp * M + i] = x;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < M; ++i) {
    float s = red[i];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) s += red[w * M + i];
    v[i] = s;
  }
  __syncthreads();
}

// ---------------------------------------------------------------- small dense algebra

// Packed lower triangle of an n x n matrix: (i, j), j <= i, at i(i+1)/2 + j.
__host__ __device__ constexpr int tri(int i, int j) { return i * (i + 1) / 2 + j; }

// Cholesky in place on a packed lower triangle; a matrix that is not positive
// definite (or not finite) leaves every entry NaN, as solver/epnp.py's
// _cho_factor does after cholesky_ex.
template <int n>
__device__ __forceinline__ void cholesky(float (&L)[n * (n + 1) / 2]) {
  bool ok = true;
#pragma unroll
  for (int j = 0; j < n; ++j) {
    float d = L[tri(j, j)];
#pragma unroll
    for (int k = 0; k < j; ++k) d -= L[tri(j, k)] * L[tri(j, k)];
    ok = ok && d > 0.f;
    d = sqrtf(d);
    L[tri(j, j)] = d;
#pragma unroll
    for (int i = j + 1; i < n; ++i) {
      float s = L[tri(i, j)];
#pragma unroll
      for (int k = 0; k < j; ++k) s -= L[tri(i, k)] * L[tri(j, k)];
      L[tri(i, j)] = s / d;
    }
  }
  if (!ok) {
#pragma unroll
    for (int i = 0; i < n * (n + 1) / 2; ++i) L[i] = nan_f();
  }
}

// x <- (L L^T)^-1 x (torch.cholesky_solve)
template <int n>
__device__ __forceinline__ void cho_solve(const float (&L)[n * (n + 1) / 2], float (&x)[n]) {
#pragma unroll
  for (int i = 0; i < n; ++i) {
    float s = x[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s -= L[tri(i, k)] * x[k];
    x[i] = s / L[tri(i, i)];
  }
#pragma unroll
  for (int i = n - 1; i >= 0; --i) {
    float s = x[i];
#pragma unroll
    for (int k = i + 1; k < n; ++k) s -= L[tri(k, i)] * x[k];
    x[i] = s / L[tri(i, i)];
  }
}

template <int n>
__device__ __forceinline__ void normalize(float (&v)[n]) {
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < n; ++i) ss += v[i] * v[i];
  const float d = sqrtf(ss) + EPS;
#pragma unroll
  for (int i = 0; i < n; ++i) v[i] = v[i] / d;
}

// Symmetric eigendecomposition by cyclic Jacobi (Numerical Recipes' jacobi:
// threshold rotations for the first sweeps, negligible entries set to zero),
// eigenvalues ascending and eigenvectors as V's columns, like
// torch.linalg.eigh; a non-finite A gives NaN everywhere (solver/epnp.py's
// _eigh). A is destroyed.
template <int n>
__device__ void eigh(float (&A)[n][n], float (&vals)[n], float (&V)[n][n]) {
  bool finite = true;
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < n; ++j) finite = finite && isfinite(A[i][j]);
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < n; ++j) V[i][j] = finite ? (i == j ? 1.f : 0.f) : nan_f();
  if (!finite) {
    for (int i = 0; i < n; ++i) vals[i] = nan_f();
    return;
  }
  for (int sweep = 0; sweep < MAX_SWEEPS; ++sweep) {
    float off = 0.f;
    for (int p = 0; p < n - 1; ++p)
      for (int q = p + 1; q < n; ++q) off += fabsf(A[p][q]);
    if (off == 0.f) break;
    const float thresh = sweep < 3 ? 0.2f * off / (n * n) : 0.f;
    for (int p = 0; p < n - 1; ++p) {
      for (int q = p + 1; q < n; ++q) {
        const float apq = A[p][q], app = A[p][p], aqq = A[q][q];
        const float g = 100.f * fabsf(apq);
        if (sweep > 3 && fabsf(app) + g == fabsf(app) && fabsf(aqq) + g == fabsf(aqq)) {
          A[p][q] = A[q][p] = 0.f;
          continue;
        }
        if (fabsf(apq) <= thresh) continue;
        const float h = aqq - app;
        float t;
        if (fabsf(h) + g == fabsf(h)) {
          t = apq / h;
        } else {
          const float theta = 0.5f * h / apq;
          t = 1.f / (fabsf(theta) + sqrtf(1.f + theta * theta));
          if (theta < 0.f) t = -t;
        }
        const float c = 1.f / sqrtf(1.f + t * t), s = t * c;
        for (int r = 0; r < n; ++r) {
          if (r == p || r == q) continue;
          const float arp = A[r][p], arq = A[r][q];
          A[r][p] = A[p][r] = c * arp - s * arq;
          A[r][q] = A[q][r] = s * arp + c * arq;
        }
        A[p][p] = app - t * apq;
        A[q][q] = aqq + t * apq;
        A[p][q] = A[q][p] = 0.f;
        for (int r = 0; r < n; ++r) {
          const float vrp = V[r][p], vrq = V[r][q];
          V[r][p] = c * vrp - s * vrq;
          V[r][q] = s * vrp + c * vrq;
        }
      }
    }
  }
  for (int i = 0; i < n; ++i) vals[i] = A[i][i];
  for (int i = 0; i < n - 1; ++i) {       // ascending, columns with their values
    int m = i;
    for (int j = i + 1; j < n; ++j)
      if (vals[j] < vals[m]) m = j;
    if (m == i) continue;
    const float tv = vals[i];
    vals[i] = vals[m];
    vals[m] = tv;
    for (int r = 0; r < n; ++r) {
      const float tr = V[r][i];
      V[r][i] = V[r][m];
      V[r][m] = tr;
    }
  }
}

// solver/epnp.py::_inv3: adjugate over det + sign(det + EPS) * EPS
__device__ __forceinline__ void inv3(const float A[9], float out[9]) {
  const float a = A[0], b = A[1], c = A[2], d = A[3], e = A[4], f = A[5];
  const float g = A[6], h = A[7], i = A[8];
  const float A11 = e * i - f * h, A12 = c * h - b * i, A13 = b * f - c * e;
  const float A21 = f * g - d * i, A22 = a * i - c * g, A23 = c * d - a * f;
  const float A31 = d * h - e * g, A32 = b * g - a * h, A33 = a * e - b * d;
  const float det = a * A11 + b * A21 + c * A31;
  const float den = det + sign_f(det + EPS) * EPS;
  out[0] = A11 / den; out[1] = A12 / den; out[2] = A13 / den;
  out[3] = A21 / den; out[4] = A22 / den; out[5] = A23 / den;
  out[6] = A31 / den; out[7] = A32 / den; out[8] = A33 / den;
}

// solver/epnp.py::_horn_matrix
__device__ __forceinline__ void horn(const float S[9], float (&N)[4][4]) {
  const float Sxx = S[0], Sxy = S[1], Sxz = S[2];
  const float Syx = S[3], Syy = S[4], Syz = S[5];
  const float Szx = S[6], Szy = S[7], Szz = S[8];
  N[0][0] = Sxx + Syy + Szz; N[0][1] = Syz - Szy; N[0][2] = Szx - Sxz; N[0][3] = Sxy - Syx;
  N[1][0] = Syz - Szy; N[1][1] = Sxx - Syy - Szz; N[1][2] = Sxy + Syx; N[1][3] = Szx + Sxz;
  N[2][0] = Szx - Sxz; N[2][1] = Sxy + Syx; N[2][2] = -Sxx + Syy - Szz; N[2][3] = Syz + Szy;
  N[3][0] = Sxy - Syx; N[3][1] = Szx + Sxz; N[3][2] = Syz + Szy; N[3][3] = -Sxx - Syy + Szz;
}

// solver/epnp.py::_dominant_quat: 12 shifted power iterations
__device__ __forceinline__ void dominant_quat(const float (&N)[4][4], float (&v)[4]) {
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) ss += N[i][j] * N[i][j];
  const float s = sqrtf(ss) + EPS;
  float M[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) M[i][j] = N[i][j] + (i == j ? s : 0.f);
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = 0.5f;
#pragma unroll
  for (int it = 0; it < 12; ++it) {
    float w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = M[i][0] * v[0] + M[i][1] * v[1] + M[i][2] * v[2] + M[i][3] * v[3];
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = w[i];
    normalize<4>(v);
  }
}

// The eigenvector of N's largest eigenvalue (eigh(N)[1][:, -1])
__device__ __forceinline__ void top_quat(const float (&N)[4][4], float (&q)[4]) {
  float A[4][4], vals[4], V[4][4];
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) A[i][j] = N[i][j];
  eigh<4>(A, vals, V);
  for (int i = 0; i < 4; ++i) q[i] = V[i][3];
}

// solver/epnp.py::quat_to_rot
__device__ __forceinline__ void quat_to_rot(const float (&qin)[4], float R[9]) {
  float q[4] = {qin[0], qin[1], qin[2], qin[3]};
  normalize<4>(q);
  const float w = q[0], x = q[1], y = q[2], z = q[3];
  R[0] = 1 - 2 * (y * y + z * z); R[1] = 2 * (x * y - w * z); R[2] = 2 * (x * z + w * y);
  R[3] = 2 * (x * y + w * z); R[4] = 1 - 2 * (x * x + z * z); R[5] = 2 * (y * z - w * x);
  R[6] = 2 * (x * z - w * y); R[7] = 2 * (y * z + w * x); R[8] = 1 - 2 * (x * x + y * y);
}

// solver/epnp.py::project_so3: the nearest rotation through Horn's form of M^T
__device__ __forceinline__ void project_so3(const float M[9], float R[9]) {
  const float S[9] = {M[0], M[3], M[6], M[1], M[4], M[7], M[2], M[5], M[8]};
  float N[4][4], q[4];
  horn(S, N);
  top_quat(N, q);
  quat_to_rot(q, R);
}

// solver/epnp.py::rodrigues, then R <- rodrigues(w) @ R
__device__ __forceinline__ void rotate_by(const float w[3], const float R[9], float out[9]) {
  const float theta = sqrtf(w[0] * w[0] + w[1] * w[1] + w[2] * w[2] + EPS);
  const float k0 = w[0] / theta, k1 = w[1] / theta, k2 = w[2] / theta;
  const float Kx[9] = {0.f, -k2, k1, k2, 0.f, -k0, -k1, k0, 0.f};
  const float s = sinf(theta), c1 = 1.f - cosf(theta);
  float Rr[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float kk = Kx[i * 3 + 0] * Kx[0 * 3 + j] + Kx[i * 3 + 1] * Kx[1 * 3 + j] +
                       Kx[i * 3 + 2] * Kx[2 * 3 + j];
      Rr[i * 3 + j] = (i == j ? 1.f : 0.f) + s * Kx[i * 3 + j] + c1 * kk;
    }
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      out[i * 3 + j] = Rr[i * 3 + 0] * R[0 * 3 + j] + Rr[i * 3 + 1] * R[1 * 3 + j] +
                       Rr[i * 3 + 2] * R[2 * 3 + j];
}

// ---------------------------------------------------------------- EPnP

// The points of one EPnP solve. Sample: the S points one hypothesis drew,
// walked by its own thread; their weights are the points' validity. Row:
// all N points of a row with the refine's weights, walked by the whole
// block, every sum reduced across it.
struct Sample {
  static constexpr bool kBlock = false;
  const float *p3, *p2, *val;
  const int* idx;
  int S, N;
  __device__ int first() const { return 0; }
  __device__ int end() const { return S; }
  __device__ int step() const { return 1; }
  __device__ void at(int i, float X[3], float uv[2], float& w) const {
    const int j = idx[i];
    if (j < 0 || j >= N) {                 // an index off the row: a NaN point
      X[0] = X[1] = X[2] = uv[0] = uv[1] = w = nan_f();
      return;
    }
    X[0] = p3[3 * j]; X[1] = p3[3 * j + 1]; X[2] = p3[3 * j + 2];
    uv[0] = p2[2 * j]; uv[1] = p2[2 * j + 1];
    w = val[j];
  }
};

struct Row {
  static constexpr bool kBlock = true;
  const float *p3, *p2, *w;
  int N;
  __device__ int first() const { return threadIdx.x; }
  __device__ int end() const { return N; }
  __device__ int step() const { return THREADS; }
  __device__ void at(int i, float X[3], float uv[2], float& wi) const {
    X[0] = p3[3 * i]; X[1] = p3[3 * i + 1]; X[2] = p3[3 * i + 2];
    uv[0] = p2[2 * i]; uv[1] = p2[2 * i + 1];
    wi = w[i];
  }
};

template <class P, int M>
__device__ __forceinline__ void reduce(float (&v)[M], float* red) {
  if constexpr (P::kBlock) block_sum<M>(v, red);
}

// Run f(out) once: inline for a thread's own solve, on thread 0 and
// broadcast through shared memory for a block's.
template <class P, int M, class F>
__device__ __forceinline__ void serial(float (&out)[M], float* bc, F&& f) {
  static_assert(M <= BCAST, "broadcast wider than its scratch");
  if constexpr (!P::kBlock) {
    f(out);
  } else {
    if (threadIdx.x == 0) {
      f(out);
      for (int i = 0; i < M; ++i) bc[i] = out[i];
    }
    __syncthreads();
    for (int i = 0; i < M; ++i) out[i] = bc[i];
    __syncthreads();
  }
}

// Barycentric coordinates of X - c0 in the control simplex: Xc @ inv(A)^T,
// with alpha_0 = 1 - the rest.
__device__ __forceinline__ void alphas_of(const float X[3], const float c0[3], const float invA[9],
                                          float a[4]) {
  const float x0 = X[0] - c0[0], x1 = X[1] - c0[1], x2 = X[2] - c0[2];
  a[1] = x0 * invA[0] + x1 * invA[1] + x2 * invA[2];
  a[2] = x0 * invA[3] + x1 * invA[4] + x2 * invA[5];
  a[3] = x0 * invA[6] + x1 * invA[7] + x2 * invA[8];
  a[0] = 1.f - (a[1] + a[2] + a[3]);
}

// ctrl (4 x 3: c0 then c0 + each axis) and inv(A), A = (ctrl[1:] - ctrl[0])^T
// + 1e-9 I, into o[0:12] and o[12:21].
__device__ __forceinline__ void control_simplex(const float c0[3], const float axes[3][3],
                                                float (&o)[21]) {
  o[0] = c0[0]; o[1] = c0[1]; o[2] = c0[2];
  for (int j = 0; j < 3; ++j)
    for (int k = 0; k < 3; ++k) o[3 + 3 * j + k] = c0[k] + axes[j][k];
  float A[9];
  for (int k = 0; k < 3; ++k)
    for (int j = 0; j < 3; ++j)
      A[3 * k + j] = (o[3 + 3 * j + k] - o[k]) + (k == j ? 1e-9f : 0.f);
  inv3(A, o + 12);
}

// solver/epnp.py::epnp with use_eigh = kEigh, over the points of P; K's
// intrinsics in k. red and bc are the block's scratch (unused by a Sample).
template <bool kEigh, class P>
__device__ Pose epnp(const P& pts, const Cam& k, float* red, float* bc) {
  float X[3], uv[2], w, a[4];
  // weighted centroid
  float s0[4] = {0.f, 0.f, 0.f, 0.f};
  for (int i = pts.first(); i < pts.end(); i += pts.step()) {
    pts.at(i, X, uv, w);
    s0[0] += X[0] * w; s0[1] += X[1] * w; s0[2] += X[2] * w; s0[3] += w;
  }
  reduce<P>(s0, red);
  const float wsum = s0[3] + EPS;
  const float c0[3] = {s0[0] / wsum, s0[1] / wsum, s0[2] / wsum};

  // control simplex: the covariance's principal axes, or axis-aligned
  float cs[21];
  if constexpr (kEigh) {
    float cv[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int i = pts.first(); i < pts.end(); i += pts.step()) {
      pts.at(i, X, uv, w);
      const float x0 = X[0] - c0[0], x1 = X[1] - c0[1], x2 = X[2] - c0[2];
      cv[0] += x0 * w * x0; cv[1] += x0 * w * x1; cv[2] += x0 * w * x2;
      cv[3] += x1 * w * x1; cv[4] += x1 * w * x2; cv[5] += x2 * w * x2;
    }
    reduce<P>(cv, red);
    serial<P>(cs, bc, [&](float (&o)[21]) {
      float C[3][3] = {{cv[0] / wsum, cv[1] / wsum, cv[2] / wsum},
                       {cv[1] / wsum, cv[3] / wsum, cv[4] / wsum},
                       {cv[2] / wsum, cv[4] / wsum, cv[5] / wsum}};
      float ev[3], V[3][3], axes[3][3];
      eigh<3>(C, ev, V);
      for (int j = 0; j < 3; ++j) {
        const float s = sqrtf(clamp_min(ev[j], 1e-6f));
        for (int kk = 0; kk < 3; ++kk) axes[j][kk] = V[kk][j] * s;
      }
      control_simplex(c0, axes, o);
    });
  } else {
    float sq[1] = {0.f};
    for (int i = pts.first(); i < pts.end(); i += pts.step()) {
      pts.at(i, X, uv, w);
      const float x0 = X[0] - c0[0], x1 = X[1] - c0[1], x2 = X[2] - c0[2];
      sq[0] += x0 * x0 * w + x1 * x1 * w + x2 * x2 * w;
    }
    reduce<P>(sq, red);
    const float s = sqrtf(clamp_min(sq[0] / (3.f * wsum), 1e-6f));
    float axes[3][3];
    for (int j = 0; j < 3; ++j)
      for (int kk = 0; kk < 3; ++kk) axes[j][kk] = (j == kk ? 1.f : 0.f) * s;
    control_simplex(c0, axes, cs);
  }
  const float* ctrl = cs;
  const float* invA = cs + 12;

  // M^T M from the 4x4 sums of w a_j a_k times 1, x, y and x^2 + y^2
  // (MtM[3j:3j+3, 3k:3k+3] = sum_i w_i a_ij a_ik [[1,0,-x],[0,1,-y],[-x,-y,x^2+y^2]])
  float m[40];
#pragma unroll
  for (int i = 0; i < 40; ++i) m[i] = 0.f;
  for (int i = pts.first(); i < pts.end(); i += pts.step()) {
    pts.at(i, X, uv, w);
    alphas_of(X, c0, invA, a);
    const float x = (uv[0] - k.cx) / k.fx, y = (uv[1] - k.cy) / k.fy;
    const float r2 = x * x + y * y;
    int p = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int kk = j; kk < 4; ++kk, ++p) {
        const float q = a[j] * w * a[kk];
        m[4 * p] += q; m[4 * p + 1] += q * x; m[4 * p + 2] += q * y; m[4 * p + 3] += q * r2;
      }
  }
  reduce<P>(m, red);

  // null space by inverse iteration on the regularised MtM, then the scale
  // that matches the control points' distances: bv = beta * v (4 x 3)
  float bv[12];
  serial<P>(bv, bc, [&](float (&o)[12]) {
    float L[78];
#pragma unroll
    for (int r = 0; r < 12; ++r)
#pragma unroll
      for (int c = 0; c <= r; ++c) {
        const int j = r / 3, kk = c / 3, ra = r % 3, cb = c % 3;
        const int lo = j < kk ? j : kk, hi = j < kk ? kk : j;
        const int p = lo * 4 - lo * (lo - 1) / 2 + (hi - lo);   // pair (lo, hi) in m
        float e;
        if (ra < 2 && cb < 2) e = ra == cb ? m[4 * p] : 0.f;
        else if (ra == 2 && cb == 2) e = m[4 * p + 3];
        else e = -m[4 * p + 1 + (ra < 2 ? ra : cb)];
        L[tri(r, c)] = e;
      }
    float v[12];
    if constexpr (kEigh) {
      float A[12][12], vals[12], V[12][12];
      for (int r = 0; r < 12; ++r)
        for (int c = 0; c <= r; ++c) A[r][c] = A[c][r] = L[tri(r, c)];
      eigh<12>(A, vals, V);
      for (int r = 0; r < 12; ++r) v[r] = V[r][0];
    }
#pragma unroll
    for (int r = 0; r < 12; ++r) L[tri(r, r)] += 1e-6f;
    cholesky<12>(L);
    if constexpr (kEigh) {
      cho_solve<12>(L, v);
    } else {
#pragma unroll
      for (int r = 0; r < 12; ++r) v[r] = 0.28867513459481287f;   // 12 ** -0.5
#pragma unroll
      for (int it = 0; it < 2; ++it) {
        cho_solve<12>(L, v);
        normalize<12>(v);
      }
      cho_solve<12>(L, v);
    }
    normalize<12>(v);
    const int IU[6] = {0, 0, 0, 1, 1, 2}, IV[6] = {1, 2, 3, 2, 3, 3};
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int p = 0; p < 6; ++p) {
      float dc = 0.f, dw = 0.f;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float ec = v[3 * IU[p] + c] - v[3 * IV[p] + c];
        const float ew = ctrl[3 * IU[p] + c] - ctrl[3 * IV[p] + c];
        dc += ec * ec;
        dw += ew * ew;
      }
      dc = sqrtf(dc);
      dw = sqrtf(dw);
      num += dc * dw;
      den += dc * dc;
    }
    const float beta = num / (den + EPS);
#pragma unroll
    for (int r = 0; r < 12; ++r) o[r] = beta * v[r];
  });

  // camera-frame points pc = alphas @ bv, turned to positive mean depth
  float zs[1] = {0.f};
  for (int i = pts.first(); i < pts.end(); i += pts.step()) {
    pts.at(i, X, uv, w);
    alphas_of(X, c0, invA, a);
    zs[0] += (a[0] * bv[2] + a[1] * bv[5] + a[2] * bv[8] + a[3] * bv[11]) * w;
  }
  reduce<P>(zs, red);
  const float sg = sign_f(zs[0] / wsum + EPS);

  // weighted Kabsch (Horn) from the model points to pc; its centroid of the
  // model points is c0 (the same sums)
  float cy[3] = {0.f, 0.f, 0.f};
  for (int i = pts.first(); i < pts.end(); i += pts.step()) {
    pts.at(i, X, uv, w);
    alphas_of(X, c0, invA, a);
#pragma unroll
    for (int c = 0; c < 3; ++c)
      cy[c] += (a[0] * bv[c] + a[1] * bv[3 + c] + a[2] * bv[6 + c] + a[3] * bv[9 + c]) * sg * w;
  }
  reduce<P>(cy, red);
#pragma unroll
  for (int c = 0; c < 3; ++c) cy[c] = cy[c] / wsum;
  float S[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) S[i] = 0.f;
  for (int i = pts.first(); i < pts.end(); i += pts.step()) {
    pts.at(i, X, uv, w);
    alphas_of(X, c0, invA, a);
    float Yc[3];
#pragma unroll
    for (int c = 0; c < 3; ++c)
      Yc[c] = (a[0] * bv[c] + a[1] * bv[3 + c] + a[2] * bv[6 + c] + a[3] * bv[9 + c]) * sg - cy[c];
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c) S[3 * r + c] += (X[r] - c0[r]) * w * Yc[c];
  }
  reduce<P>(S, red);
  float out[12];
  serial<P>(out, bc, [&](float (&o)[12]) {
    float N[4][4], q[4];
    horn(S, N);
    if constexpr (kEigh) top_quat(N, q);
    else dominant_quat(N, q);
    quat_to_rot(q, o);
#pragma unroll
    for (int r = 0; r < 3; ++r)
      o[9 + r] = cy[r] - (o[3 * r] * c0[0] + o[3 * r + 1] * c0[1] + o[3 * r + 2] * c0[2]);
  });
  Pose pose;
#pragma unroll
  for (int i = 0; i < 9; ++i) pose.R[i] = out[i];
#pragma unroll
  for (int i = 0; i < 3; ++i) pose.t[i] = out[9 + i];
  return pose;
}

// ---------------------------------------------------------------- launch 1

struct Best {                             // torch.argmax: the first NaN, else the first maximum
  float score;
  int h;
};

__device__ __forceinline__ bool takes_max(const Best& b, float s) {
  if (b.h < 0) return true;
  if (isnan(b.score)) return false;
  return isnan(s) || s > b.score;
}

// One block per row: hypotheses THREADS at a time, one a thread; each scored
// over the row's points by a warp; the running best kept by thread 0.
__global__ void __launch_bounds__(THREADS)
ransac_hypotheses(const float* __restrict__ p3d, long long p3d_bs, const float* __restrict__ p2d,
                  const float* __restrict__ valid, const float* __restrict__ Kmat, long long K_bs,
                  const long long* __restrict__ hyp, int N, int H, int S, float thresh,
                  float soft_sigma, float* __restrict__ pose_out, int* __restrict__ best_out) {
  extern __shared__ float smem[];
  float* p3 = smem;                        // N x 3
  float* p2 = p3 + 3 * N;                  // N x 2
  float* val = p2 + 2 * N;                 // N
  float* hpose = val + N;                  // THREADS x 12
  float* score = hpose + THREADS * 12;     // THREADS
  int* hidx = reinterpret_cast<int*>(score + THREADS);   // THREADS x S
  __shared__ float best_pose[12];
  __shared__ Best best;

  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* gp3 = p3d + b * p3d_bs;
  for (int i = tid; i < 3 * N; i += THREADS) p3[i] = gp3[i];
  for (int i = tid; i < 2 * N; i += THREADS) p2[i] = p2d[(long long)b * 2 * N + i];
  for (int i = tid; i < N; i += THREADS) val[i] = valid[(long long)b * N + i];
  if (tid == 0) best = Best{0.f, -1};
  const Cam k = load_cam(Kmat + b * K_bs);
  __syncthreads();

  for (int h0 = 0; h0 < H; h0 += THREADS) {
    const int nh = min(THREADS, H - h0);
    if (tid < nh) {
      const long long* src = hyp + ((long long)b * H + h0 + tid) * S;
      int* idx = hidx + tid * S;
      for (int s = 0; s < S; ++s) {
        const long long j = src[s];
        idx[s] = (j < 0 || j >= N) ? -1 : (int)j;
      }
      const Pose P = epnp<false>(Sample{p3, p2, val, idx, S, N}, k, nullptr, nullptr);
#pragma unroll
      for (int i = 0; i < 9; ++i) hpose[tid * 12 + i] = P.R[i];
#pragma unroll
      for (int i = 0; i < 3; ++i) hpose[tid * 12 + 9 + i] = P.t[i];
    }
    __syncthreads();
    for (int j = warp; j < nh; j += WARPS) {
      Pose P;
#pragma unroll
      for (int i = 0; i < 9; ++i) P.R[i] = hpose[j * 12 + i];
#pragma unroll
      for (int i = 0; i < 3; ++i) P.t[i] = hpose[j * 12 + 9 + i];
      float acc = 0.f;
      for (int n = lane; n < N; n += 32) {
        const float X[3] = {p3[3 * n], p3[3 * n + 1], p3[3 * n + 2]};
        const float e = reproj_err(P, X, p2[2 * n], p2[2 * n + 1], k);
        acc += (soft_sigma > 0.f ? sigmoid_f((thresh - e) / soft_sigma)
                                 : (e < thresh ? 1.f : 0.f)) * val[n];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
      if (lane == 0) score[j] = acc;
    }
    __syncthreads();
    if (tid == 0) {
      for (int j = 0; j < nh; ++j) {
        if (!takes_max(best, score[j])) continue;
        best = Best{score[j], h0 + j};
        for (int i = 0; i < 12; ++i) best_pose[i] = hpose[j * 12 + i];
      }
    }
    __syncthreads();
  }
  if (tid < 12) pose_out[(long long)b * 12 + tid] = best_pose[tid];
  if (tid == 0) best_out[b] = best.h;
}

// ---------------------------------------------------------------- launch 2

struct Params {
  float thresh, soft_sigma, coherence, radius2;
  int iters, n_backtrack, irls_rounds, reseed;
};

struct RowData {
  const float *p3, *p2, *val;
  float *w, *sv, *lg, *deg;                // weights; coherence: sigmoid, logit, degree
  int N;
  Cam k;
};

__device__ __forceinline__ void point(const RowData& d, int i, float X[3]) {
  X[0] = d.p3[3 * i]; X[1] = d.p3[3 * i + 1]; X[2] = d.p3[3 * i + 2];
}

// ransac_pnp's inlier_w into d.w: hard or soft inliers, the neighbours'
// consensus when coherence > 0, and the validity where fewer than 4 weigh in.
__device__ void inlier_weights(const RowData& d, const Pose& P, const Params& pr, float* red) {
  const bool coh = pr.coherence > 0.f;
  const float sig = pr.soft_sigma > 0.f ? pr.soft_sigma : 0.25f;
  for (int i = threadIdx.x; i < d.N; i += THREADS) {
    float X[3];
    point(d, i, X);
    const float e = reproj_err(P, X, d.p2[2 * i], d.p2[2 * i + 1], d.k);
    if (coh) {
      const float lg = (pr.thresh - e) / sig;
      d.lg[i] = lg;
      d.sv[i] = sigmoid_f(lg) * d.val[i];
    } else {
      d.w[i] = (pr.soft_sigma > 0.f ? sigmoid_f((pr.thresh - e) / pr.soft_sigma)
                                    : (e < pr.thresh ? 1.f : 0.f)) * d.val[i];
    }
  }
  if (coh) {
    __syncthreads();
    const float kappa = 10.f * pr.coherence;
    for (int i = threadIdx.x; i < d.N; i += THREADS) {
      const float xi = d.p2[2 * i], yi = d.p2[2 * i + 1], vi = d.val[i];
      float s = 0.f;
      for (int j = 0; j < d.N; ++j) {
        const float dx = xi - d.p2[2 * j], dy = yi - d.p2[2 * j + 1];
        const float d2 = dx * dx + dy * dy;
        if (d2 < pr.radius2 && d2 > 0.f) s += vi * d.val[j] * d.sv[j];
      }
      const float consensus = s / clamp_min(d.deg[i], 1.f);
      d.w[i] = sigmoid_f(d.lg[i] + kappa * (2.f * consensus - 1.f)) * vi;
    }
  }
  float ws[1] = {0.f};
  for (int i = threadIdx.x; i < d.N; i += THREADS) ws[0] += d.w[i];
  block_sum<1>(ws, red);
  if (!(ws[0] >= 4.f))
    for (int i = threadIdx.x; i < d.N; i += THREADS) d.w[i] = d.val[i];
  __syncthreads();
}

// ransac_pnp's werr for two poses: sum(e w) / (sum(w) + 1e-9) each
__device__ void werr2(const RowData& d, const Pose& A, const Pose& B, float& ea, float& eb,
                      float* red) {
  float s[3] = {0.f, 0.f, 0.f};
  for (int i = threadIdx.x; i < d.N; i += THREADS) {
    float X[3];
    point(d, i, X);
    const float u = d.p2[2 * i], v = d.p2[2 * i + 1], w = d.w[i];
    s[0] += reproj_err(A, X, u, v, d.k) * w;
    s[1] += reproj_err(B, X, u, v, d.k) * w;
    s[2] += w;
  }
  block_sum<3>(s, red);
  ea = s[0] / (s[2] + 1e-9f);
  eb = s[1] / (s[2] + 1e-9f);
}

// solver/epnp.py::refine_pose_gn with d.w as the weights
__device__ Pose refine_gn(const RowData& d, Pose P, const Params& pr, float* red, float* bc) {
  float pb[4] = {0.f, 0.f, 0.f, 0.f};
  for (int i = threadIdx.x; i < d.N; i += THREADS) {
    const float w = d.w[i];
    pb[0] += d.p3[3 * i] * w; pb[1] += d.p3[3 * i + 1] * w; pb[2] += d.p3[3 * i + 2] * w;
    pb[3] += w;
  }
  block_sum<4>(pb, red);
  const float den = pb[3] + EPS;
  const float pbar[3] = {pb[0] / den, pb[1] / den, pb[2] / den};
#pragma unroll
  for (int r = 0; r < 3; ++r)
    P.t[r] = P.t[r] + (P.R[3 * r] * pbar[0] + P.R[3 * r + 1] * pbar[1] + P.R[3 * r + 2] * pbar[2]);

  const Cam& k = d.k;
  const int nc = pr.n_backtrack + 1;      // the scaled steps, then no step
  for (int it = 0; it < pr.iters; ++it) {
    // normal equations: 21 entries of H (lower) and g
    float acc[27];
#pragma unroll
    for (int i = 0; i < 27; ++i) acc[i] = 0.f;
    for (int i = threadIdx.x; i < d.N; i += THREADS) {
      const float X[3] = {d.p3[3 * i] - pbar[0], d.p3[3 * i + 1] - pbar[1],
                          d.p3[3 * i + 2] - pbar[2]};
      const float w = d.w[i];
      float pc[3];
#pragma unroll
      for (int r = 0; r < 3; ++r)
        pc[r] = P.R[3 * r] * X[0] + P.R[3 * r + 1] * X[1] + P.R[3 * r + 2] * X[2] + P.t[r];
      const float z = clamp_min(pc[2], 1e-6f);
      const float r0 = k.fx * pc[0] / z + k.cx - d.p2[2 * i];
      const float r1 = k.fy * pc[1] / z + k.cy - d.p2[2 * i + 1];
      const float j00 = k.fx / z, j02 = -k.fx * pc[0] / (z * z);
      const float j11 = k.fy / z, j12 = -k.fy * pc[1] / (z * z);
      const float a0 = pc[0] - P.t[0], a1 = pc[1] - P.t[1], a2 = pc[2] - P.t[2];
      // J = [-(J_pc @ skew(a)) | J_pc], two rows of six
      const float J0[6] = {j02 * a1, j00 * a2 - j02 * a0, -j00 * a1, j00, 0.f, j02};
      const float J1[6] = {j12 * a1 - j11 * a2, -j12 * a0, j11 * a0, 0.f, j11, j12};
#pragma unroll
      for (int r = 0; r < 6; ++r) {
#pragma unroll
        for (int c = 0; c <= r; ++c) acc[tri(r, c)] += J0[r] * w * J0[c] + J1[r] * w * J1[c];
        acc[21 + r] += J0[r] * w * r0 + J1[r] * w * r1;
      }
    }
    block_sum<27>(acc, red);
    // H + damping diag(H) + 1e-9 I; delta = -H^-1 g (every thread, same sums)
    float L[21], delta[6];
#pragma unroll
    for (int i = 0; i < 21; ++i) L[i] = acc[i];
#pragma unroll
    for (int r = 0; r < 6; ++r) {
      L[tri(r, r)] = L[tri(r, r)] + DAMPING * acc[tri(r, r)] + 1e-9f;
      delta[r] = acc[21 + r];
    }
    cholesky<6>(L);
    cho_solve<6>(L, delta);
#pragma unroll
    for (int r = 0; r < 6; ++r) delta[r] = -delta[r];

    // candidates in order, the cheapest kept (torch.argmin: the first NaN,
    // else the first minimum), CAND of them scored per pass
    Pose chosen = P;
    float best = 0.f;
    bool have = false;
    for (int c0 = 0; c0 < nc; c0 += CAND) {
      Pose cand[CAND];
#pragma unroll
      for (int q = 0; q < CAND; ++q) {
        const int c = c0 + q;
        if (c < pr.n_backtrack) {
          const float s = ldexpf(1.f, -c);
          const float wv[3] = {delta[0] * s, delta[1] * s, delta[2] * s};
          rotate_by(wv, P.R, cand[q].R);
#pragma unroll
          for (int r = 0; r < 3; ++r) cand[q].t[r] = P.t[r] + delta[3 + r] * s;
        } else {
          cand[q] = P;
        }
      }
      float cost[CAND];
#pragma unroll
      for (int q = 0; q < CAND; ++q) cost[q] = 0.f;
      for (int i = threadIdx.x; i < d.N; i += THREADS) {
        const float X[3] = {d.p3[3 * i] - pbar[0], d.p3[3 * i + 1] - pbar[1],
                            d.p3[3 * i + 2] - pbar[2]};
        const float u = d.p2[2 * i], v = d.p2[2 * i + 1], w = d.w[i];
#pragma unroll
        for (int q = 0; q < CAND; ++q) {
          if (c0 + q >= nc) continue;
          const float e = reproj_err(cand[q], X, u, v, k);
          cost[q] += e * e * w;
        }
      }
      block_sum<CAND>(cost, red);
#pragma unroll
      for (int q = 0; q < CAND; ++q) {
        if (c0 + q >= nc) continue;
        const bool take = !have || (!isnan(best) && (isnan(cost[q]) || cost[q] < best));
        if (take) {
          chosen = cand[q];
          best = cost[q];
          have = true;
        }
      }
    }
    P = chosen;
  }
  float out[9];
  serial<Row>(out, bc, [&](float (&o)[9]) { project_so3(P.R, o); });
#pragma unroll
  for (int i = 0; i < 9; ++i) P.R[i] = out[i];
#pragma unroll
  for (int r = 0; r < 3; ++r)
    P.t[r] = P.t[r] - (P.R[3 * r] * pbar[0] + P.R[3 * r + 1] * pbar[1] + P.R[3 * r + 2] * pbar[2]);
  return P;
}

// The answer of a row: inliers of (R, t), their count, success, and the
// identity where the solve failed.
__device__ void write_answer(const RowData& d, const Pose& P, bool success, float thresh,
                             float* R_out, float* t_out, float* inl_out, float* num_out,
                             unsigned char* ok_out, float* red) {
  float cnt[1] = {0.f};
  for (int i = threadIdx.x; i < d.N; i += THREADS) {
    float X[3];
    point(d, i, X);
    const float e = reproj_err(P, X, d.p2[2 * i], d.p2[2 * i + 1], d.k);
    const float in = (e < thresh ? 1.f : 0.f) * d.val[i];
    inl_out[i] = in;
    cnt[0] += in;
  }
  block_sum<1>(cnt, red);
  if (threadIdx.x < 9)
    R_out[threadIdx.x] = success ? P.R[threadIdx.x] : (threadIdx.x % 4 == 0 ? 1.f : 0.f);
  if (threadIdx.x < 3) t_out[threadIdx.x] = success ? P.t[threadIdx.x] : 0.f;
  if (threadIdx.x == 0) {
    *num_out = cnt[0];
    *ok_out = success ? 1 : 0;
  }
}

__device__ __forceinline__ bool finite_pose(const Pose& P) {
  bool f = true;
#pragma unroll
  for (int i = 0; i < 9; ++i) f = f && isfinite(P.R[i]);
#pragma unroll
  for (int i = 0; i < 3; ++i) f = f && isfinite(P.t[i]);
  return f;
}

__device__ __forceinline__ Pose choose(bool first, const Pose& A, const Pose& B) {
  return first ? A : B;
}

// One block per row: ransac_pnp after the best hypothesis.
__global__ void __launch_bounds__(THREADS)
ransac_refine(const float* __restrict__ p3d, long long p3d_bs, const float* __restrict__ p2d,
              const float* __restrict__ valid, const float* __restrict__ Kmat, long long K_bs,
              const float* __restrict__ pose0, int N, Params pr, float* __restrict__ R_out,
              float* __restrict__ t_out, float* __restrict__ inl_out,
              float* __restrict__ num_out, unsigned char* __restrict__ ok_out) {
  extern __shared__ float smem[];
  __shared__ float red[WARPS * RED];
  __shared__ float bc[BCAST];
  const bool coh = pr.coherence > 0.f;
  RowData d;
  d.p3 = smem;
  d.p2 = smem + 3 * N;
  d.val = smem + 5 * N;
  d.w = smem + 6 * N;
  d.sv = coh ? smem + 7 * N : nullptr;
  d.lg = coh ? smem + 8 * N : nullptr;
  d.deg = coh ? smem + 9 * N : nullptr;
  d.N = N;

  const int b = blockIdx.x, tid = threadIdx.x;
  {
    float* p3 = smem;
    float* p2 = smem + 3 * N;
    float* val = smem + 5 * N;
    const float* gp3 = p3d + b * p3d_bs;
    for (int i = tid; i < 3 * N; i += THREADS) p3[i] = gp3[i];
    for (int i = tid; i < 2 * N; i += THREADS) p2[i] = p2d[(long long)b * 2 * N + i];
    for (int i = tid; i < N; i += THREADS) val[i] = valid[(long long)b * N + i];
  }
  d.k = load_cam(Kmat + b * K_bs);
  Pose P0;
#pragma unroll
  for (int i = 0; i < 9; ++i) P0.R[i] = pose0[(long long)b * 12 + i];
#pragma unroll
  for (int i = 0; i < 3; ++i) P0.t[i] = pose0[(long long)b * 12 + 9 + i];
  __syncthreads();

  float nv[1] = {0.f};
  for (int i = tid; i < N; i += THREADS) nv[0] += d.val[i];
  block_sum<1>(nv, red);
  const bool enough = nv[0] >= 4.f;
  float* R_row = R_out + (long long)b * 9;
  float* t_row = t_out + (long long)b * 3;
  float* inl_row = inl_out + (long long)b * N;

  if (pr.irls_rounds <= 0) {
    write_answer(d, P0, enough, pr.thresh, R_row, t_row, inl_row, num_out + b, ok_out + b, red);
    return;
  }
  if (coh) {                              // each point's weighted count of 2D neighbours
    for (int i = tid; i < N; i += THREADS) {
      const float xi = d.p2[2 * i], yi = d.p2[2 * i + 1], vi = d.val[i];
      float s = 0.f;
      for (int j = 0; j < N; ++j) {
        const float dx = xi - d.p2[2 * j], dy = yi - d.p2[2 * j + 1];
        const float d2 = dx * dx + dy * dy;
        if (d2 < pr.radius2 && d2 > 0.f) s += vi * d.val[j];
      }
      d.deg[i] = s;
    }
    __syncthreads();
  }

  inlier_weights(d, P0, pr, red);
  Pose Pc = refine_gn(d, P0, pr, red, bc);
  if (pr.reseed) {
    Pose P2 = epnp<true>(Row{d.p3, d.p2, d.w, N}, d.k, red, bc);
    P2 = refine_gn(d, P2, pr, red, bc);
    float e2, ec;
    werr2(d, P2, Pc, e2, ec, red);
    Pc = choose(e2 < ec, P2, Pc);
  }
  float ec, e0;
  werr2(d, Pc, P0, ec, e0, red);
  Pose Pf = choose(ec < e0, Pc, P0);
  for (int r = 1; r < pr.irls_rounds; ++r) {
    inlier_weights(d, Pf, pr, red);
    Pc = refine_gn(d, Pf, pr, red, bc);
    float ef;
    werr2(d, Pc, Pf, ec, ef, red);
    Pf = choose(ec < ef, Pc, Pf);
  }
  write_answer(d, Pf, enough && finite_pose(Pf), pr.thresh, R_row, t_row, inl_row, num_out + b,
               ok_out + b, red);
}

size_t hypotheses_smem(int N, int S) {
  return sizeof(float) * (6 * (size_t)N + THREADS * 13) + sizeof(int) * THREADS * (size_t)S;
}

size_t refine_smem(int N, int coherence) {
  return sizeof(float) * (coherence ? 10 : 7) * (size_t)N;
}

}  // namespace

extern "C" {

int ransac_max_n() { return MAX_N; }
int ransac_max_sample() { return MAX_S; }
size_t ransac_hypotheses_smem_bytes(int N, int S) { return hypotheses_smem(N, S); }
size_t ransac_refine_smem_bytes(int N, int coherence) { return refine_smem(N, coherence); }

// p3d (B, N, 3) with rows p3d_bs floats apart (0: one set for every row),
// each row contiguous; p2d (B, N, 2), valid (B, N) contiguous; K (B, 3, 3)
// with rows K_bs floats apart, each contiguous; hyp (B, H, S) int64. Writes
// the best hypothesis's pose (B, 12: R row-major, then t) and its index
// (B,). Returns the CUDA error code of the launch (0 = ok).
int ransac_hypotheses_launch(const float* p3d, long long p3d_bs, const float* p2d,
                             const float* valid, const float* K, long long K_bs,
                             const long long* hyp, int B, int N, int H, int S, float thresh,
                             float soft_sigma, float* pose, int* best, void* stream) {
  if (B <= 0 || N <= 0 || N > MAX_N || H <= 0 || S <= 0 || S > MAX_S)
    return (int)cudaErrorInvalidValue;
  const size_t smem = hypotheses_smem(N, S);
  cudaError_t err = cudaFuncSetAttribute(ransac_hypotheses,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ransac_hypotheses<<<B, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      p3d, p3d_bs, p2d, valid, K, K_bs, hyp, N, H, S, thresh, soft_sigma, pose, best);
  return (int)cudaGetLastError();
}

// The same rows, pose0 (B, 12) from ransac_hypotheses_launch. Writes R (B,
// 3, 3), t (B, 3), inliers (B, N), num_inliers (B,) and success (B,) as
// bytes 0 / 1.
int ransac_refine_launch(const float* p3d, long long p3d_bs, const float* p2d, const float* valid,
                         const float* K, long long K_bs, const float* pose0, int B, int N,
                         float thresh, float soft_sigma, float coherence, float radius2,
                         int iters, int n_backtrack, int irls_rounds, int reseed, float* R,
                         float* t, float* inliers, float* num_inliers, unsigned char* success,
                         void* stream) {
  if (B <= 0 || N <= 0 || N > MAX_N || iters < 0 || n_backtrack < 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = refine_smem(N, coherence > 0.f);
  cudaError_t err = cudaFuncSetAttribute(ransac_refine,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const Params pr{thresh, soft_sigma, coherence, radius2, iters, n_backtrack, irls_rounds, reseed};
  ransac_refine<<<B, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      p3d, p3d_bs, p2d, valid, K, K_bs, pose0, N, pr, R, t, inliers, num_inliers, success);
  return (int)cudaGetLastError();
}

}  // extern "C"
