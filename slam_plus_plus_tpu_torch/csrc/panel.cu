// Dense Schur panels from the uniform per-landmark layout (kernel K2).
//
// Replaces: slam_plus_plus_tpu/ops/pallas_panel.py::build_panels (the Pallas
// kernel _panel_kernel, pallas_call at pallas_panel.py:89).
//
// For landmark l with M observation slots (camera rows[l, m], block
// u4[l, m] of Bl x Bp, the transposed H_pl block):
//   Ut[l*Bl + i, c*Bp + j] = sum_m [rows[l, m] == c] u4[l, m, i, j]
//   Wt[l*Bl + k, c*Bp + j] = sum_i cinv[l, k*Bl + i] * Ut[l*Bl + i, c*Bp + j]
// summed in order m = 0..M-1 and i = 0..Bl-1, each product and each sum
// rounded on its own (no FMA), as the plain version in ops/panel.py and the
// Pallas kernel compute them.  Wt_l = C_l^-1 Ut_l with cinv read row-major.
// Both panels are [Nl*Bl, n_cams*Bp].
//
// Bound: device memory.  At the bench shape (Nl = 8000, M = 76, Bl = 3,
// Bp = 6, 100 cameras) the function reads u4 (43.8 MB in float32), rows
// (2.4 MB) and cinv (0.3 MB) and writes two 57.6 MB panels: 161.7 MB in
// float32 and 321 MB in float64, 0.048 and 0.096 ms at 3.35 TB/s.  Its
// arithmetic is the 86 MFLOP of C^-1 Ut, about 0.5 flop per byte, so tensor
// cores would have nothing to do (and a 3 x 3 times 3 x 600 product per
// landmark is no MMA tile): the design only moves bytes well.
//
// Design.  A CTA owns TL landmarks and one window of Wcams cameras, columns
// [cam0*Bp, (cam0 + wc)*Bp); ops/panel.py::panel_tiling picks TL and Wcams so
// that the CTA's shared memory (layout() below) fits its budget.  The CTA
//   1. copies its landmarks' u4 blocks, camera ids and C^-1 rows into shared
//      memory with cp.async: 16-byte copies, and 4- or 8-byte ones for the
//      unaligned head and tail of a range.  A landmark's M*Bl*Bp values are
//      dense in device memory in either order of the two block axes, so u4
//      is read through its strides and the solver's transposed view of its
//      [Nl, M, Bp, Bl] blocks needs no copy;
//   2. zeroes its Ut strip [TL*Bl rows, window] in shared memory meanwhile;
//   3. accumulates: one thread owns each (landmark, i, j) and adds its slots
//      in order m = 0..M-1 into the strip.  No two threads share an address,
//      so there are no atomics, and a repeated (landmark, camera) pair -- the
//      uniform layout's dummy slots repeat the camera of edge 0 with a zero
//      block -- is summed in slot order.  A slot whose camera lies outside
//      the window, or outside [0, n_cams), is skipped;
//   4. writes each row of its window once, zeros included: Ut from the
//      strip, and Wt computed on the way out from the finished Ut rows.  A
//      warp writes one row with 16-byte stores.  Each strip row starts at the
//      same offset modulo 16 bytes as its row in device memory, so the
//      vectors are aligned on both sides for any n_cams.  When one window
//      holds the whole row, a tile's Bl*TL rows are one contiguous range.
//
// Against the first version of this kernel, which accumulated in device
// memory: (a) the wrapper no longer zeroes the two panels (torch.empty;
// every output byte is written here once); (b) no read-modify-write of device
// memory -- the 76 dependent updates per thread now hit shared memory;
// (c) stores are 16-byte vectors along whole rows instead of 4-byte pieces on
// rows 2,400 bytes apart; (d) u4 is read through its strides, so the solver
// dropped its 43.8 MB transposed copy; (e) Wt combines finished Ut rows in
// the plain version's order instead of summing per slot.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // ops/panel.py PANEL_THREADS

__host__ __device__ inline long long round_up(long long n, long long k) {
  return (n + k - 1) / k * k;
}

// Shared memory of one CTA, in elements of T from its start, then the int
// camera ids at byte offset `rows`.  Mirrored by ops/panel.py::panel_smem_bytes.
struct Layout {
  long long row;    // strip row stride (elements, a multiple of 16 bytes)
  long long slot;   // one landmark's u4 slot (elements, a multiple of 16 bytes)
  long long u, c;   // offsets of the u4 slots and of C^-1 (elements)
  long long rows;   // offset of the camera ids (bytes)
  long long bytes;  // total
};

template <typename T>
__host__ __device__ inline Layout layout(int TL, int Wcams, int M, int Bl, int Bp) {
  const long long V = 16 / sizeof(T);   // elements per 16 bytes
  Layout s;
  s.row = round_up((long long)Wcams * Bp, V) + V;   // + V: room for the shift
  s.slot = round_up((long long)M * Bl * Bp, V) + V;
  s.u = (long long)TL * Bl * s.row;
  s.c = s.u + TL * s.slot;
  s.rows = (s.c + round_up((long long)TL * Bl * Bl, V) + V) * (long long)sizeof(T);
  s.bytes = s.rows + 4 * (round_up((long long)TL * M, 4) + 4);
  return s;
}

template <typename T> struct Vec16;
template <> struct Vec16<float> { using type = float4; };
template <> struct Vec16<double> { using type = double2; };

template <typename T> union Pack {
  typename Vec16<T>::type v;
  T e[16 / sizeof(T)];
};

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

template <int N>
__device__ __forceinline__ void cp_async(void* s, const void* g) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(s);
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a), "l"(g) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(a), "l"(g), "n"(N)
                 : "memory");
}

// offset of p within its 16-byte line, in elements
template <typename E>
__device__ __forceinline__ int shift_of(const E* p) {
  return (int)((reinterpret_cast<uintptr_t>(p) & 15) / sizeof(E));
}

// Asynchronous copy of g[0, n) to s + shift_of(g), s 16-byte aligned, by the
// lanes [0, nlanes) of the caller; source and destination then agree modulo
// 16 bytes, so the body goes in 16-byte copies.
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
panel_kernel(const T* __restrict__ u4, const int* __restrict__ rows,
             const T* __restrict__ cinv, T* __restrict__ ut, T* __restrict__ wt,
             int Nl, int M, int Bl, int Bp, int n_cams, long long sl, int sm, int si,
             int sj, int TL, int Wcams) {
  constexpr int V = 16 / sizeof(T);
  using VT = typename Vec16<T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout<T>(TL, Wcams, M, Bl, Bp);
  T* strip = reinterpret_cast<T*>(smem);
  T* us = strip + L.u;
  T* cs = strip + L.c;
  int* rs = reinterpret_cast<int*>(smem + L.rows);

  // blocks run over (tile, window), the window fastest, so the windows of a
  // tile run together and share its u4 blocks in L2
  const int n_win = (n_cams + Wcams - 1) / Wcams;
  const int win = (int)(blockIdx.x % n_win);
  const long long l0 = (long long)(blockIdx.x / n_win) * TL;
  const int tl = (int)min((long long)TL, Nl - l0);
  const int cam0 = win * Wcams;
  const int wc = min(Wcams, n_cams - cam0);
  const int wcols = wc * Bp;
  const long long ncols = (long long)n_cams * Bp;
  const long long col0 = (long long)cam0 * Bp;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  const int* rows_g = rows + l0 * M;
  const T* cinv_g = cinv + l0 * Bl * Bl;

  // 1. loads, one warp per landmark block
  for (int lt = warp; lt < tl; lt += nwarps)
    copy_async(us + lt * L.slot, u4 + (l0 + lt) * sl, (long long)M * Bl * Bp, lane, 32);
  copy_async(rs, rows_g, (long long)tl * M, threadIdx.x, blockDim.x);
  copy_async(cs, cinv_g, (long long)tl * Bl * Bl, threadIdx.x, blockDim.x);
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  // 2. zero the strip while the copies fly
  Pack<T> zero;
#pragma unroll
  for (int e = 0; e < V; ++e) zero.e[e] = T(0);
  VT* sv = reinterpret_cast<VT*>(strip);
  for (long long k = threadIdx.x; k < tl * Bl * L.row / V; k += blockDim.x) sv[k] = zero.v;
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  // 3. accumulate: thread q owns (landmark lt, panel row i, camera dim j)
  const int* rsl = rs + shift_of(rows_g);
  for (int q = threadIdx.x; q < tl * Bl * Bp; q += blockDim.x) {
    const int j = q % Bp, li = q / Bp, i = li % Bl, lt = li / Bl;
    const T* u = us + lt * L.slot + shift_of(u4 + (l0 + lt) * sl) + i * si + j * sj;
    const int* r = rsl + lt * M;
    T* acc = strip + li * L.row + (int)(((l0 * Bl + li) * ncols + col0) % V) + j;
    int m = 0;
    for (; m + 4 <= M; m += 4) {   // loads of 4 slots ahead of their updates
      unsigned c[4];
      T v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        c[k] = (unsigned)r[m + k] - (unsigned)cam0;
        v[k] = u[(m + k) * sm];
      }
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (c[k] < (unsigned)wc) acc[c[k] * Bp] += v[k];
    }
    for (; m < M; ++m) {
      const unsigned c = (unsigned)r[m] - (unsigned)cam0;
      if (c < (unsigned)wc) acc[c * Bp] += u[m * sm];
    }
  }
  __syncthreads();

  // 4. write the window's Ut and Wt rows, one warp per row
  const int nrows = tl * Bl;
  const int step = (int)(ncols % V);   // shift change from one row to the next
  const T* csl = cs + shift_of(cinv_g);
  for (int rr = warp; rr < 2 * nrows; rr += nwarps) {
    const bool is_w = rr >= nrows;
    const int li = is_w ? rr - nrows : rr;
    const long long gidx = (l0 * Bl + li) * ncols + col0;
    const int sh = (int)(gidx % V);
    const int head = min((V - sh) % V, wcols);
    const int nvec = (wcols - head) / V;
    T* g = (is_w ? wt : ut) + gidx;
    if (!is_w) {
      const T* s = strip + li * L.row + sh;
      for (int k = lane; k < head; k += 32) g[k] = s[k];
      for (int v = lane; v < nvec; v += 32)
        reinterpret_cast<VT*>(g + head)[v] = reinterpret_cast<const VT*>(s + head)[v];
      for (int k = head + nvec * V + lane; k < wcols; k += 32) g[k] = s[k];
      continue;
    }
    // Wt row (lt, k) = sum_i cinv[l, k*Bl + i] * Ut row (lt, i), in order
    const int lt = li / Bl, k = li % Bl;
    const T* crow = csl + li * Bl;
    const T* s0 = strip + (long long)lt * Bl * L.row;   // strip row (lt, 0)
    const int sh0 = ((sh - k * step) % V + V) % V;        // its shift
    auto wt_at = [&](int col) {
      T w = T(0);
      for (int i = 0; i < Bl; ++i) {
        const T p = mul_rn(crow[i], s0[i * L.row + (sh0 + i * step) % V + col]);
        w = i ? add_rn(w, p) : p;
      }
      return w;
    };
    for (int c = lane; c < head; c += 32) g[c] = wt_at(c);
    for (int v = lane; v < nvec; v += 32) {
      const int col = head + v * V;
      Pack<T> w;
      if (step == 0) {   // every strip row has the same shift: vector loads
        for (int i = 0; i < Bl; ++i) {
          Pack<T> x;
          x.v = *reinterpret_cast<const VT*>(s0 + i * L.row + sh + col);
          const T ci = crow[i];
#pragma unroll
          for (int e = 0; e < V; ++e) {
            const T p = mul_rn(ci, x.e[e]);
            w.e[e] = i ? add_rn(w.e[e], p) : p;
          }
        }
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) w.e[e] = wt_at(col + e);
      }
      reinterpret_cast<VT*>(g + head)[v] = w.v;
    }
    for (int c = head + nvec * V + lane; c < wcols; c += 32) g[c] = wt_at(c);
  }
}

template <typename T>
int launch(const void* u4, const void* rows, const void* cinv, void* ut, void* wt,
           int Nl, int M, int Bl, int Bp, int n_cams, long long sl, int sm, int si,
           int sj, int TL, int Wcams, void* stream) {
  if (Nl <= 0 || n_cams <= 0 || Bl <= 0 || Bp <= 0) return (int)cudaSuccess;
  if (M < 0 || TL < 1 || Wcams < 1 || (((uintptr_t)ut | (uintptr_t)wt) & 15))
    return (int)cudaErrorInvalidValue;
  const long long bytes = layout<T>(TL, Wcams, M, Bl, Bp).bytes;
  static long long opted = 48 << 10;   // dynamic shared memory without opting in
  if (bytes > opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        panel_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    opted = bytes;
  }
  const long long blocks = (long long)((Nl + TL - 1) / TL) * ((n_cams + Wcams - 1) / Wcams);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  panel_kernel<T><<<(unsigned)blocks, kThreads, (size_t)bytes, (cudaStream_t)stream>>>(
      (const T*)u4, (const int*)rows, (const T*)cinv, (T*)ut, (T*)wt, Nl, M, Bl, Bp,
      n_cams, sl, sm, si, sj, TL, Wcams);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int slampp_panels_f32(const void* u4, const void* rows, const void* cinv,
                                 void* ut, void* wt, int Nl, int M, int Bl, int Bp,
                                 int n_cams, long long sl, int sm, int si, int sj,
                                 int TL, int Wcams, void* stream) {
  return launch<float>(u4, rows, cinv, ut, wt, Nl, M, Bl, Bp, n_cams, sl, sm, si, sj,
                       TL, Wcams, stream);
}

extern "C" int slampp_panels_f64(const void* u4, const void* rows, const void* cinv,
                                 void* ut, void* wt, int Nl, int M, int Bl, int Bp,
                                 int n_cams, long long sl, int sm, int si, int sj,
                                 int TL, int Wcams, void* stream) {
  return launch<double>(u4, rows, cinv, ut, wt, Nl, M, Bl, Bp, n_cams, sl, sm, si, sj,
                        TL, Wcams, stream);
}
