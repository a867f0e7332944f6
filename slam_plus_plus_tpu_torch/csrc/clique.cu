// The sparse-reduced Schur's clique path (kernels K3a and K3b).
//
// Replaces no Pallas kernel: in the JAX package this path is library code
// (slam_plus_plus_tpu/linalg/schur.py, the clique einsum and segment sums),
// and in the port it was a chain of torch calls (linalg/schur.py:
// _sparse_w_rhs, _sparse_sc, _sparse_back_substitute) that copied C^-1 and
// eta per slot, ran cuBLAS's batched GEMM on 2.6 M tiny blocks, built a
// [25,000, M, M, 36] clique tensor per chunk and summed with index_add_.
//
// The clique path: every landmark l has M observation slots, slot m at pl
// block l*M + m (U_m, Bp x 3, the H_pl block of camera rows[l, m]).
//
// K3a, forward elimination, per landmark:
//   C^-1   = the closed-form 3 x 3 inverse of ll[l] (planar.binv's B = 3)
//   W_m    = U_m C^-1                              (m < M)
//   rhs_p[rows[l, m]]  -= W_m eta_l
//   SC[fill_dst[l, t]] -= W_a U_b^T, transposed when rows[l, a] > rows[l, b]
// over the M (M + 1) / 2 pairs t = (a <= b) in np.triu_indices order; C^-1
// is written once, [Nl, 9], for K3b.  Nothing per slot (W, the pair
// products) reaches device memory.
//
// K3b, back-substitution, per landmark:
//   dx_l = C^-1 (eta_l - sum_m U_m^T dx_p[rows[l, m]])
//
// The reduction.  The host plan (ops/clique.py::build_clique_plan) orders
// the landmarks by their camera tuple, which fixes their SC destinations and
// transposes: in ring871 every landmark with the same first camera shares
// its 5-camera tuple (871 tuples of ~605 landmarks).  A CTA takes per_cta
// landmarks of that order; a piece is a run of one tuple inside one CTA.
// The CTA sums each piece's T pair blocks and M rhs vectors on chip and
// writes them once (the partials).  A second kernel sums the partials of
// each SC block and camera in plan order and subtracts them from the pp
// blocks and eta_p.  Every sum has a fixed order, so a call repeats to the
// bit; there are no atomics.
//
// A K3a CTA first copies its part of the order and the pieces into shared
// memory, then walks its landmarks in tiles of TL with two input buffers:
// the next tile's copies (cp.async) fly while this tile's W and pair
// products are computed.
//
// Layout of the accumulation.  Thread (t, g) of a CTA owns pair t's whole
// Bp x Bp block in registers and adds landmarks g, g + G, ... of each run;
// at a piece's end the G lanes of the pair (neighbours in one warp) reduce
// by a fixed xor butterfly.  G = 16, 8 or 4 so that G T <= 256 threads.
// Each landmark's U and W rows sit in shared memory padded to 4 elements,
// one 16-byte load a row (two in float64), with a landmark stride that is an
// odd multiple of 16 bytes so that 8 lanes reading 8 landmarks hit 8
// distinct bank groups.
//
// Bound.  At ring871 (Nl = 527,480, M = 5, float32) K3a must read U (190
// MB), ll, eta and the camera ids and write C^-1: ~0.23 GB, ~70 us at 3.35
// TB/s; its arithmetic is ~2.1 GFLOP (the pair products 1.7), ~31 us at 67
// TFLOP/s.  K3b reads the same U, C^-1, eta and ids: ~0.22 GB.  Both are
// bound by memory; the design reads each value once, coalesced (a warp
// copies one landmark's 360-byte slot run with cp.async), and keeps every
// intermediate on chip.  On an H100 K3b runs at ~75% of its bytes' time;
// K3a at ~16% (0.37 ms): its pair block takes 128 registers a thread, so
// two CTAs share an SM, and each 32-landmark tile pays two CTA barriers and
// the W pass's dependent chains.  Overlapping the next tile's copies with
// this one's work is worth 0.52 -> 0.37 ms; capping the registers for three
// CTAs an SM spills (0.52 ms).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBl = 3;             // landmark block
constexpr int kRow = 4;            // a block row, padded, in shared memory
constexpr int kFwdThreads = 256;   // the most threads of a K3a CTA
constexpr int kBackThreads = 128;  // landmarks (threads) of a K3b CTA
constexpr int kSumThreads = 256;

__host__ __device__ inline long long round_up(long long n, long long k) {
  return (n + k - 1) / k * k;
}

// Shared memory of one K3a CTA: two buffers of TL landmarks' inputs (the
// next tile's copies fly while this one is computed), one of their W rows
// and W eta, in elements of T from its start; then the ints at byte offset
// `ints`: the two buffers' camera ids [TL * M], and the CTA's permutation
// and pieces [per_cta + 4 each, room for the 16-byte shift, rounded to 16
// bytes].
struct FwdLayout {
  int ls;                 // landmark stride of the U and W rows (elements)
  long long buf;          // one input buffer (elements): U, ll, eta
  long long ll, eta;      // offsets of ll and eta inside a buffer
  long long w, wr;        // offsets of the W rows and of W eta
  long long ints;         // byte offset of the ints
  long long bytes;
};

template <typename T>
__host__ __device__ inline FwdLayout fwd_layout(int TL, int M, int BP, int per_cta) {
  const int v16 = 16 / (int)sizeof(T);
  FwdLayout L;
  L.ls = M * BP * kRow;
  if (((L.ls * (int)sizeof(T) / 16) & 1) == 0) L.ls += v16;   // an odd multiple of 16 bytes
  L.ll = (long long)TL * L.ls;
  L.eta = L.ll + (long long)TL * 12;
  L.buf = L.eta + (long long)TL * 4;
  L.w = 2 * L.buf;
  L.wr = L.w + (long long)TL * L.ls;
  L.ints = (L.wr + round_up((long long)TL * M * BP, v16)) * (long long)sizeof(T);
  L.bytes = L.ints + 4LL * (round_up(2LL * TL * M, 4) + 2 * round_up(per_cta + 4, 4));
  return L;
}

// lanes per pair: G T <= kFwdThreads (T <= 64)
__host__ __device__ inline int fwd_group(int T) { return T <= 16 ? 16 : T <= 32 ? 8 : 4; }

template <int N>
__device__ __forceinline__ void cp_async(void* s, const void* g) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(s);
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a), "l"(g) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(a), "l"(g), "n"(N)
                 : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// offset of p within its 16-byte line, in elements
template <typename E>
__device__ __forceinline__ int shift_of(const E* p) {
  return (int)((reinterpret_cast<uintptr_t>(p) & 15) / sizeof(E));
}

// Asynchronous copy of g[0, n) to s + shift_of(g), s 16-byte aligned, by the
// lanes [0, nlanes) of the caller, the body in 16-byte copies.
template <typename E>
__device__ void copy_async(E* s, const E* g, long long n, int lane, int nlanes) {
  constexpr int V = 16 / sizeof(E);
  s += shift_of(g);
  const long long head = min((long long)((V - shift_of(g)) % V), n);
  const long long nvec = (n - head) / V;
  for (long long k = lane; k < head; k += nlanes) cp_async<sizeof(E)>(s + k, g + k);
  for (long long v = lane; v < nvec; v += nlanes)
    cp_async<16>(s + head + v * V, g + head + v * V);
  for (long long k = head + nvec * V + lane; k < n; k += nlanes)
    cp_async<sizeof(E)>(s + k, g + k);
}

// the first three elements of a 16-byte aligned padded row
__device__ __forceinline__ void row3(const float* p, float& x, float& y, float& z) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x = v.x; y = v.y; z = v.z;
}
__device__ __forceinline__ void row3(const double* p, double& x, double& y, double& z) {
  const double2 v = *reinterpret_cast<const double2*>(p);
  x = v.x; y = v.y; z = p[2];
}

// C^-1 of a row-major 3 x 3 block by the adjugate, as planar.binv (B = 3)
template <typename T>
__device__ __forceinline__ void inv3(const T* a, T* c) {
  const T a11 = a[0], a12 = a[1], a13 = a[2], a21 = a[3], a22 = a[4], a23 = a[5],
          a31 = a[6], a32 = a[7], a33 = a[8];
  c[0] = a22 * a33 - a23 * a32;
  c[1] = a13 * a32 - a12 * a33;
  c[2] = a12 * a23 - a13 * a22;
  c[3] = a23 * a31 - a21 * a33;
  c[4] = a11 * a33 - a13 * a31;
  c[5] = a13 * a21 - a11 * a23;
  c[6] = a21 * a32 - a22 * a31;
  c[7] = a12 * a31 - a11 * a32;
  c[8] = a11 * a22 - a12 * a21;
  const T inv_det = T(1) / (a11 * c[0] + a12 * c[3] + a13 * c[6]);
#pragma unroll
  for (int k = 0; k < 9; ++k) c[k] *= inv_det;
}

// The end of the run of piece p that starts at r0 (pieces rise along the
// order), by every thread of the CTA alike.
__device__ __forceinline__ int run_end(const int* Ps, int r0, int tl, int p, int lane) {
  for (int c = r0 & ~31; c < tl; c += 32) {
    const int lt = c + lane;
    const unsigned m = __ballot_sync(0xffffffffu, lt > r0 && lt < tl && Ps[lt] != p);
    if (m) return c + __ffs(m) - 1;
  }
  return tl;
}

// One warp copies each landmark of a tile (lt = warp, warp + nwarps, ...)
// into buffer b: its slot run in one coalesced sweep, row by padded row, its
// ll, eta and camera ids.  The same warp computes its W (no CTA barrier).
template <typename T, int BP>
__device__ __forceinline__ void load_tile(const T* __restrict__ u, const T* __restrict__ ll,
                                          const T* __restrict__ eta,
                                          const int* __restrict__ rows, const int* orig,
                                          T* Bs, int* Rs, const FwdLayout& L, int tl, int M,
                                          int warp, int lane, int nwarps) {
  const int nu = M * BP * kBl;
  for (int lt = warp; lt < tl; lt += nwarps) {
    const long long o = orig[lt];
    const T* ug = u + o * nu;
    T* us = Bs + lt * L.ls;
    for (int r = lane; r < nu; r += 32) {
      const int mi = r / kBl;
      cp_async<sizeof(T)>(us + mi * kRow + (r - kBl * mi), ug + r);
    }
    if (lane < 9)
      cp_async<sizeof(T)>(Bs + L.ll + lt * 12 + lane, ll + o * 9 + lane);
    else if (lane < 12)
      cp_async<sizeof(T)>(Bs + L.eta + lt * 4 + lane - 9, eta + o * 3 + lane - 9);
    else if (lane < 12 + M)
      cp_async<4>(Rs + lt * M + lane - 12, rows + o * M + lane - 12);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <typename T, int BP>
__global__ void __launch_bounds__(kFwdThreads)
clique_fwd_kernel(const T* __restrict__ u, const T* __restrict__ ll,
                  const T* __restrict__ eta, const int* __restrict__ perm,
                  const int* __restrict__ piece, const int* __restrict__ rows,
                  T* __restrict__ cinv, T* __restrict__ part_sc, T* __restrict__ part_rhs,
                  int Nl, int M, int per_cta, int TL) {
  extern __shared__ __align__(16) unsigned char smem[];
  const FwdLayout L = fwd_layout<T>(TL, M, BP, per_cta);
  T* S = reinterpret_cast<T*>(smem);
  T* Ws = S + L.w;
  T* WRs = S + L.wr;
  int* Rs0 = reinterpret_cast<int*>(smem + L.ints);
  int* Perm = Rs0 + round_up(2LL * TL * M, 4);
  int* Piece = Perm + round_up(per_cta + 4, 4);

  const int nT = M * (M + 1) / 2, G = fwd_group(nT);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  const int mbp = M * BP;
  const long long c0 = (long long)blockIdx.x * per_cta;
  const int nc = (int)min((long long)per_cta, Nl - c0);
  const int ntiles = (nc + TL - 1) / TL;

  // the CTA's order and pieces, then the first tile's inputs
  copy_async(Perm, perm + c0, nc, threadIdx.x, blockDim.x);
  copy_async(Piece, piece + c0, nc, threadIdx.x, blockDim.x);
  cp_async_wait_all();
  __syncthreads();
  const int* Os = Perm + shift_of(perm + c0);
  const int* Ps = Piece + shift_of(piece + c0);
  load_tile<T, BP>(u, ll, eta, rows, Os, S, Rs0, L, min(TL, nc), M, warp, lane, nwarps);

  // this thread's pair t = (a, b), np.triu_indices order, and its lane g
  const int t = threadIdx.x / G, g = threadIdx.x % G;
  const bool active = t < nT;
  int a = 0, b = 0;
  if (active) {
    int r = t;
    while (r >= M - a) { r -= M - a; ++a; }
    b = a + r;
  }
  T acc[BP * BP], racc[BP];
#pragma unroll
  for (int e = 0; e < BP * BP; ++e) acc[e] = T(0);
#pragma unroll
  for (int i = 0; i < BP; ++i) racc[i] = T(0);

  for (int k = 0; k < ntiles; ++k) {
    const int base = k * TL;
    const int tl = min(TL, nc - base);
    T* Us = S + (k & 1) * L.buf;
    int* Rs = Rs0 + (k & 1) * TL * M;
    const int* Pt = Ps + base;

    // 1. the next tile's copies go out; this tile's are waited for
    if (k + 1 < ntiles) {
      load_tile<T, BP>(u, ll, eta, rows, Os + base + TL, S + ((k + 1) & 1) * L.buf,
                       Rs0 + ((k + 1) & 1) * TL * M, L, min(TL, nc - base - TL), M, warp,
                       lane, nwarps);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncwarp();

    // 2. C^-1, W = U C^-1 and W eta, by the warp that loaded the landmark
    for (int lt = warp; lt < tl; lt += nwarps) {
      T ci[9];
      inv3(Us + L.ll + lt * 12, ci);
#pragma unroll
      for (int q = 0; q < 9; ++q)
        if (lane == q) cinv[(long long)Os[base + lt] * 9 + q] = ci[q];
      const T* el = Us + L.eta + lt * 4;
      const T e0 = el[0], e1 = el[1], e2 = el[2];
      for (int r = lane; r < mbp; r += 32) {
        T x, y, z;
        row3(Us + lt * L.ls + r * kRow, x, y, z);
        const T w0 = x * ci[0] + y * ci[3] + z * ci[6];
        const T w1 = x * ci[1] + y * ci[4] + z * ci[7];
        const T w2 = x * ci[2] + y * ci[5] + z * ci[8];
        T* wr = Ws + lt * L.ls + r * kRow;
        wr[0] = w0;
        wr[1] = w1;
        wr[2] = w2;
        wr[3] = T(0);
        WRs[lt * mbp + r] = w0 * e0 + w1 * e1 + w2 * e2;
      }
    }
    __syncthreads();

    // 3. the pair products, summed per piece on chip
    int r0 = 0;
    while (r0 < tl) {
      const int p = Pt[r0];
      const int r1 = run_end(Pt, r0, tl, p, lane);
      if (active) {
        for (int lt = r0 + g; lt < r1; lt += G) {
          const T* wa = Ws + lt * L.ls + a * BP * kRow;
          const T* ub = Us + lt * L.ls + b * BP * kRow;
          T w[BP][kBl];
#pragma unroll
          for (int i = 0; i < BP; ++i) row3(wa + i * kRow, w[i][0], w[i][1], w[i][2]);
#pragma unroll
          for (int j = 0; j < BP; ++j) {
            T x, y, z;
            row3(ub + j * kRow, x, y, z);
#pragma unroll
            for (int i = 0; i < BP; ++i)
              acc[i * BP + j] += w[i][0] * x + w[i][1] * y + w[i][2] * z;
          }
          if (a == b) {
#pragma unroll
            for (int i = 0; i < BP; ++i) racc[i] += WRs[lt * mbp + a * BP + i];
          }
        }
      }
      // a piece ends at a change of piece or at the end of the CTA's order
      const bool ends = r1 < tl || base + tl >= nc || Pt[tl] != p;
      if (ends) {   // the piece's partials: a fixed butterfly over the G lanes
        for (int off = G >> 1; off; off >>= 1) {
#pragma unroll
          for (int e = 0; e < BP * BP; ++e) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], off);
#pragma unroll
          for (int i = 0; i < BP; ++i) racc[i] += __shfl_xor_sync(0xffffffffu, racc[i], off);
        }
        if (active) {
          const bool flip = Rs[r0 * M + a] > Rs[r0 * M + b];
          T* dst = part_sc + ((long long)p * nT + t) * (BP * BP);
#pragma unroll
          for (int e = 0; e < BP * BP; ++e)
            if (e % G == g) dst[flip ? (e % BP) * BP + e / BP : e] = acc[e];
          if (a == b) {
#pragma unroll
            for (int i = 0; i < BP; ++i)
              if (i % G == g) part_rhs[((long long)p * M + a) * BP + i] = racc[i];
          }
        }
#pragma unroll
        for (int e = 0; e < BP * BP; ++e) acc[e] = T(0);
#pragma unroll
        for (int i = 0; i < BP; ++i) racc[i] = T(0);
      }
      r0 = r1;
    }
    __syncthreads();   // the copies of tile k + 2 go into this tile's buffer
  }
}

// SC = pp - the sum of each block's partials, rhs = eta_p - each camera's,
// one thread an output element, the partials in plan order.
template <typename T, int BP>
__global__ void __launch_bounds__(kSumThreads)
clique_sum_kernel(const T* __restrict__ part_sc, const T* __restrict__ part_rhs,
                  const int* __restrict__ sc_src, const int* __restrict__ sc_off,
                  const int* __restrict__ rhs_src, const int* __restrict__ rhs_off,
                  const T* __restrict__ pp, const int* __restrict__ pp_of_sc,
                  const T* __restrict__ eta_p, T* __restrict__ sc, T* __restrict__ rhs,
                  int Ksc, int Np) {
  constexpr int B2 = BP * BP;
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nsc = (long long)Ksc * B2;
  if (q < nsc) {
    const int s = (int)(q / B2), e = (int)(q % B2);
    T sum = T(0);
    for (int k = sc_off[s]; k < sc_off[s + 1]; ++k) sum += part_sc[(long long)sc_src[k] * B2 + e];
    const int i = pp_of_sc[s];
    sc[q] = (i >= 0 ? pp[(long long)i * B2 + e] : T(0)) - sum;
  } else if (q < nsc + (long long)Np * BP) {
    const long long r = q - nsc;
    const int c = (int)(r / BP), i = (int)(r % BP);
    T sum = T(0);
    for (int k = rhs_off[c]; k < rhs_off[c + 1]; ++k) sum += part_rhs[(long long)rhs_src[k] * BP + i];
    rhs[r] = eta_p[r] - sum;
  }
}

template <typename T, int BP>
__global__ void __launch_bounds__(kBackThreads)
clique_back_kernel(const T* __restrict__ u, const T* __restrict__ cinv,
                   const T* __restrict__ eta, const int* __restrict__ rows,
                   const T* __restrict__ dxp, T* __restrict__ dxl, int Nl, int M) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* Us = reinterpret_cast<T*>(smem);
  const int nu = M * BP * kBl;
  const long long l0 = (long long)blockIdx.x * kBackThreads;
  const int nl = (int)min((long long)kBackThreads, Nl - l0);
  const T* ug = u + l0 * nu;
  copy_async(Us, ug, (long long)nl * nu, threadIdx.x, blockDim.x);   // one contiguous range
  cp_async_wait_all();
  __syncthreads();
  const int lt = threadIdx.x;
  if (lt >= nl) return;
  const long long l = l0 + lt;
  const T* us = Us + shift_of(ug) + lt * nu;
  T s0 = T(0), s1 = T(0), s2 = T(0);
  for (int m = 0; m < M; ++m) {   // U_m^T dx_p[rows[l, m]], then the sum over m
    const T* d = dxp + (long long)rows[l * M + m] * BP;
    const T* um = us + m * BP * kBl;
    T p0 = T(0), p1 = T(0), p2 = T(0);
#pragma unroll
    for (int i = 0; i < BP; ++i) {
      const T di = d[i];
      p0 += um[i * kBl] * di;
      p1 += um[i * kBl + 1] * di;
      p2 += um[i * kBl + 2] * di;
    }
    s0 += p0;
    s1 += p1;
    s2 += p2;
  }
  const T r0 = eta[l * 3] - s0, r1 = eta[l * 3 + 1] - s1, r2 = eta[l * 3 + 2] - s2;
  const T* c = cinv + l * 9;
  dxl[l * 3] = c[0] * r0 + c[1] * r1 + c[2] * r2;
  dxl[l * 3 + 1] = c[3] * r0 + c[4] * r1 + c[5] * r2;
  dxl[l * 3 + 2] = c[6] * r0 + c[7] * r1 + c[8] * r2;
}

template <typename K>
int opt_in(K kernel, long long bytes, long long& opted) {
  if (bytes <= opted) return (int)cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) opted = bytes;
  return (int)err;
}

constexpr int kBp = 6;   // the camera block the kernels are built for

template <typename T>
int forward(const void* u, const void* ll, const void* eta, const void* perm,
            const void* piece, const void* rows, void* cinv, void* part_sc, void* part_rhs,
            const void* sc_src, const void* sc_off, const void* rhs_src, const void* rhs_off,
            const void* pp, const void* pp_of_sc, const void* eta_p, void* sc, void* rhs,
            int Nl, int M, int Bp, int per_cta, int TL, int Ksc, int Np, void* stream) {
  if (Bp != kBp || M < 1 || M > 10 || TL < 1 || per_cta < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (Nl > 0) {
    const long long bytes = fwd_layout<T>(TL, M, kBp, per_cta).bytes;
    static long long opted = 48 << 10;
    const int err = opt_in(clique_fwd_kernel<T, kBp>, bytes, opted);
    if (err != (int)cudaSuccess) return err;
    const int nT = M * (M + 1) / 2;
    const int threads = (int)round_up((long long)fwd_group(nT) * nT, 32);
    const long long blocks = (Nl + (long long)per_cta - 1) / per_cta;
    clique_fwd_kernel<T, kBp><<<(unsigned)blocks, threads, (size_t)bytes, s>>>(
        (const T*)u, (const T*)ll, (const T*)eta, (const int*)perm, (const int*)piece,
        (const int*)rows, (T*)cinv, (T*)part_sc, (T*)part_rhs, Nl, M, per_cta, TL);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const long long n = (long long)Ksc * kBp * kBp + (long long)Np * kBp;
  if (n > 0)
    clique_sum_kernel<T, kBp><<<(unsigned)((n + kSumThreads - 1) / kSumThreads), kSumThreads,
                                0, s>>>(
        (const T*)part_sc, (const T*)part_rhs, (const int*)sc_src, (const int*)sc_off,
        (const int*)rhs_src, (const int*)rhs_off, (const T*)pp, (const int*)pp_of_sc,
        (const T*)eta_p, (T*)sc, (T*)rhs, Ksc, Np);
  return (int)cudaGetLastError();
}

template <typename T>
int back(const void* u, const void* cinv, const void* eta, const void* rows, const void* dxp,
         void* dxl, int Nl, int M, int Bp, void* stream) {
  if (Bp != kBp || M < 1 || M > 10) return (int)cudaErrorInvalidValue;
  if (Nl <= 0) return (int)cudaSuccess;
  const long long bytes = ((long long)kBackThreads * M * kBp * kBl + 16 / sizeof(T)) * sizeof(T);
  static long long opted = 48 << 10;
  const int err = opt_in(clique_back_kernel<T, kBp>, bytes, opted);
  if (err != (int)cudaSuccess) return err;
  const long long blocks = (Nl + kBackThreads - 1) / kBackThreads;
  clique_back_kernel<T, kBp><<<(unsigned)blocks, kBackThreads, (size_t)bytes,
                               (cudaStream_t)stream>>>(
      (const T*)u, (const T*)cinv, (const T*)eta, (const int*)rows, (const T*)dxp, (T*)dxl,
      Nl, M);
  return (int)cudaGetLastError();
}

}  // namespace

#define SLAMPP_CLIQUE(SUFFIX, T)                                                              \
  extern "C" int slampp_clique_forward_##SUFFIX(                                              \
      const void* u, const void* ll, const void* eta, const void* perm, const void* piece,    \
      const void* rows, void* cinv, void* part_sc, void* part_rhs, const void* sc_src,        \
      const void* sc_off, const void* rhs_src, const void* rhs_off, const void* pp,           \
      const void* pp_of_sc, const void* eta_p, void* sc, void* rhs, int Nl, int M, int Bp,    \
      int per_cta, int TL, int Ksc, int Np, void* stream) {                                   \
    return forward<T>(u, ll, eta, perm, piece, rows, cinv, part_sc, part_rhs, sc_src, sc_off, \
                      rhs_src, rhs_off, pp, pp_of_sc, eta_p, sc, rhs, Nl, M, Bp, per_cta, TL, \
                      Ksc, Np, stream);                                                       \
  }                                                                                           \
  extern "C" int slampp_clique_back_##SUFFIX(const void* u, const void* cinv,                 \
                                             const void* eta, const void* rows,               \
                                             const void* dxp, void* dxl, int Nl, int M,       \
                                             int Bp, void* stream) {                          \
    return back<T>(u, cinv, eta, rows, dxp, dxl, Nl, M, Bp, stream);                          \
  }

SLAMPP_CLIQUE(f32, float)
SLAMPP_CLIQUE(f64, double)
