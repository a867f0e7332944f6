// Dense Schur panels from the uniform per-landmark layout.
//
// Replaces: slam_plus_plus_tpu/ops/pallas_panel.py::build_panels (the Pallas
// kernel _panel_kernel, pallas_call at pallas_panel.py:89).
//
// For landmark l with M observation slots (camera rows[l, m], block
// u4[l, m] of Bl x Bp, the transposed H_pl block):
//   Ut[l*Bl + i, c*Bp + j] = sum_m [rows[l, m] == c] u4[l, m, i, j]
//   Wt[l*Bl + k, c*Bp + j] = sum_i cinv[l, k*Bl + i] * Ut[l*Bl + i, c*Bp + j]
// i.e. Wt_l = C_l^-1 Ut_l with cinv read row-major (the Pallas kernel's
// formula; linalg/schur.py of the JAX package indexes C^-1 transposed, which
// agrees because C^-1 is symmetric).  Both panels are [Nl*Bl, n_cams*Bp].
//
// The uniform layout's dummy slots are not conflict-free: a landmark's padding
// repeats the camera of edge 0 with a zero block, so a landmark that really
// sees that camera has two slots on one (landmark, camera) block.  The kernel
// therefore accumulates into zeroed panels instead of storing blocks.  One
// thread owns panel row (l, r) at the columns c*Bp + j of one camera dim j,
// for Ut and Wt alike, and loops over m: no two threads share an address, so
// there are no atomics and the sum over duplicate slots is exact in order.
// Camera ids outside [0, n_cams) are skipped (the caller validates them on
// the host).
//
// Bound: device memory and latency.  Per observation slot a thread reads one
// camera id and Bl values and read-modify-writes one Ut and one Wt element;
// at the bench shape (Nl = 8000, M = 76, Bl = 3, Bp = 6, 100 cameras) that is
// 144,000 threads x 76 slots over two 57.6 MB float32 panels (57% of whose
// blocks are filled there).  The writes of one slot are scattered over rows
// of the panel; a later design can stage a landmark's rows in shared memory
// or fuse the panels into the SC product.

#include <cuda_runtime.h>

namespace {

template <typename T>
__global__ void panel_kernel(const T* __restrict__ u4, const int* __restrict__ rows,
                             const T* __restrict__ cinv, T* __restrict__ ut,
                             T* __restrict__ wt, int Nl, int M, int Bl, int Bp,
                             int n_cams) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)Nl * Bl * Bp) return;
  const int j = (int)(t % Bp);
  const long long lr = t / Bp;          // panel row l*Bl + r
  const int r = (int)(lr % Bl);
  const long long l = lr / Bl;
  const long long ncols = (long long)n_cams * Bp;
  T* ut_row = ut + lr * ncols + j;
  T* wt_row = wt + lr * ncols + j;
  const T* c = cinv + l * Bl * Bl + (long long)r * Bl;   // row r of C_l^-1
  for (int m = 0; m < M; ++m) {
    const int cam = rows[l * M + m];
    if (cam < 0 || cam >= n_cams) continue;
    const T* u = u4 + ((l * M + m) * Bl) * Bp + j;      // u4[l, m, 0, j]
    T wv = T(0);
    for (int i = 0; i < Bl; ++i) wv += c[i] * u[i * Bp];
    ut_row[(long long)cam * Bp] += u[r * Bp];
    wt_row[(long long)cam * Bp] += wv;
  }
}

template <typename T>
int launch(const void* u4, const void* rows, const void* cinv, void* ut,
           void* wt, int Nl, int M, int Bl, int Bp, int n_cams, void* stream) {
  const long long total = (long long)Nl * Bl * Bp;
  if (total > 0 && M > 0) {
    const int threads = 256;
    const unsigned blocks = (unsigned)((total + threads - 1) / threads);
    panel_kernel<T><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const T*)u4, (const int*)rows, (const T*)cinv, (T*)ut, (T*)wt, Nl, M,
        Bl, Bp, n_cams);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int slampp_panels_f32(const void* u4, const void* rows,
                                 const void* cinv, void* ut, void* wt, int Nl,
                                 int M, int Bl, int Bp, int n_cams,
                                 void* stream) {
  return launch<float>(u4, rows, cinv, ut, wt, Nl, M, Bl, Bp, n_cams, stream);
}

extern "C" int slampp_panels_f64(const void* u4, const void* rows,
                                 const void* cinv, void* ut, void* wt, int Nl,
                                 int M, int Bl, int Bp, int n_cams,
                                 void* stream) {
  return launch<double>(u4, rows, cinv, ut, wt, Nl, M, Bl, Bp, n_cams, stream);
}
