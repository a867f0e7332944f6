// P2C (mono reprojection) edge terms: residual, analytic Jacobians and every
// per-edge gradient/Hessian block product, one thread per observation.
//
// Replaces: slam_plus_plus_tpu/ops/pallas_p2c.py::p2c_edge_terms (the Pallas
// kernel _p2c_kernel, pallas_call at pallas_p2c.py:185).
//
// Layout: every array is [d, E] (row r of edge e at r*E + e), as in the
// Pallas kernel.  That layout is already structure-of-arrays, so neighbouring
// threads read and write neighbouring addresses; no padding to a tile is
// needed, the tail is masked.
//
// Bound: device memory.  Per edge the kernel reads 20 values (cam 11, point 3,
// z 2, info 4) and writes 74 (chi2 1, hdiag 1, g_cam 6, g_pt 3, H_cc 36,
// H_cp 18, H_pp 9): at the bench shape (E = 608,000 slots) about 229 MB per
// float32 call, against ~200 flops per edge.  The design keeps every
// intermediate in registers and touches device memory once per value.
// J_pt equals the translation columns of J_cam, so H_cp and H_pp are copies of
// sub-blocks of H_cc, computed once.
//
// Guards kept from the Pallas kernel: the Rodrigues Taylor branch for
// theta^2 < 1e-12 and the |p_cz| > 1e-12 guard on the camera-frame depth.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float k_sin(float x) { return sinf(x); }
__device__ __forceinline__ double k_sin(double x) { return sin(x); }
__device__ __forceinline__ float k_cos(float x) { return cosf(x); }
__device__ __forceinline__ double k_cos(double x) { return cos(x); }
__device__ __forceinline__ float k_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double k_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float k_abs(float x) { return fabsf(x); }
__device__ __forceinline__ double k_abs(double x) { return fabs(x); }

// maximum that propagates NaN from either side, like torch.maximum
template <typename T>
__device__ __forceinline__ T k_max(T a, T b) { return (a > b || a != a) ? a : b; }

// output rows of the single [74, E] output buffer
constexpr int kChi2 = 0, kHdiag = 1, kGcam = 2, kGpt = 8, kHcc = 11,
              kHcp = 47, kHpp = 65;

template <typename T>
__global__ void p2c_kernel(const T* __restrict__ cam, const T* __restrict__ pt,
                           const T* __restrict__ z, const T* __restrict__ info,
                           T* __restrict__ out, long long E) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  const T tx = cam[0 * E + e], ty = cam[1 * E + e], tz = cam[2 * E + e];
  const T ax = cam[3 * E + e], ay = cam[4 * E + e], az = cam[5 * E + e];
  const T fx = cam[6 * E + e], fy = cam[7 * E + e];
  const T cx = cam[8 * E + e], cy = cam[9 * E + e];
  const T dd = cam[10 * E + e];
  const T px = pt[0 * E + e], py = pt[1 * E + e], pz = pt[2 * E + e];
  const T z0 = z[0 * E + e], z1 = z[1 * E + e];
  const T i00 = info[0 * E + e], i01 = info[1 * E + e];
  const T i10 = info[2 * E + e], i11 = info[3 * E + e];

  // Rodrigues rotation from axis-angle (Taylor-guarded)
  const T th2 = ax * ax + ay * ay + az * az;
  const bool small = th2 < T(1e-12);
  const T th = k_sqrt(th2);
  const T A = small ? T(1) - th2 / T(6) : k_sin(th) / th;
  const T B = small ? T(0.5) - th2 / T(24) : (T(1) - k_cos(th)) / th2;
  const T r00 = T(1) - B * (ay * ay + az * az);
  const T r01 = B * ax * ay - A * az;
  const T r02 = B * ax * az + A * ay;
  const T r10 = B * ax * ay + A * az;
  const T r11 = T(1) - B * (ax * ax + az * az);
  const T r12 = B * ay * az - A * ax;
  const T r20 = B * ax * az - A * ay;
  const T r21 = B * ay * az + A * ax;
  const T r22 = T(1) - B * (ax * ax + ay * ay);

  // p_cam = R p + t
  const T pcx = r00 * px + r01 * py + r02 * pz + tx;
  const T pcy = r10 * px + r11 * py + r12 * pz + ty;
  const T pcz = r20 * px + r21 * py + r22 * pz + tz;
  const T iz = T(1) / (k_abs(pcz) > T(1e-12) ? pcz : T(1));

  const T du = fx * pcx * iz;
  const T dv = fy * pcy * iz;
  const T k = dd / (T(0.5) * (fx + fy));
  const T w = T(1) + k * (du * du + dv * dv);
  const T e0 = z0 - (cx + w * du);
  const T e1 = z1 - (cy + w * dv);
  out[kChi2 * E + e] = e0 * (i00 * e0 + i01 * e1) + e1 * (i10 * e0 + i11 * e1);

  // dh/dp_cam = Mdist (2x2) @ Ppin (2x3)
  const T m00 = w + T(2) * k * du * du;
  const T m01 = T(2) * k * du * dv;
  const T m11 = w + T(2) * k * dv * dv;
  const T p00 = fx * iz;
  const T p02 = -fx * pcx * iz * iz;
  const T p11 = fy * iz;
  const T p12 = -fy * pcy * iz * iz;
  const T d00 = m00 * p00, d01 = m01 * p11, d02 = m00 * p02 + m01 * p12;
  const T d10 = m01 * p00, d11 = m11 * p11, d12 = m01 * p02 + m11 * p12;

  // J = dr/d(delta) = -dh/d(delta), columns (a, b) = rows 0 and 1.
  // Translation (and point) columns: -Dh R[:, c].  Rotation columns:
  // Dh R [p]x[:, c], with [p]x columns (0, pz, -py), (-pz, 0, px), (py, -px, 0).
  const T rc[3][3] = {{r00, r10, r20}, {r01, r11, r21}, {r02, r12, r22}};
  const T pxc[3][3] = {{T(0), pz, -py}, {-pz, T(0), px}, {py, -px, T(0)}};
  T ja[6], jb[6];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    ja[c] = -(d00 * rc[c][0] + d01 * rc[c][1] + d02 * rc[c][2]);
    jb[c] = -(d10 * rc[c][0] + d11 * rc[c][1] + d12 * rc[c][2]);
    const T vx = pxc[c][0], vy = pxc[c][1], vz = pxc[c][2];
    const T rx = r00 * vx + r01 * vy + r02 * vz;
    const T ry = r10 * vx + r11 * vy + r12 * vz;
    const T rz = r20 * vx + r21 * vy + r22 * vz;
    ja[3 + c] = d00 * rx + d01 * ry + d02 * rz;
    jb[3 + c] = d10 * rx + d11 * ry + d12 * rz;
  }

  // g = -J^T (info e)
  const T se0 = i00 * e0 + i01 * e1;
  const T se1 = i10 * e0 + i11 * e1;
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    const T g = -(ja[c] * se0 + jb[c] * se1);
    out[(kGcam + c) * E + e] = g;
    if (c < 3) out[(kGpt + c) * E + e] = g;
  }

  // H_cc[c1, c2] = J_c1^T info J_c2; H_cp and H_pp are its first 3 columns
  // and its top-left 3x3 block
  T hdiag = T(0);
#pragma unroll
  for (int c1 = 0; c1 < 6; ++c1) {
    const T wa = i00 * ja[c1] + i10 * jb[c1];
    const T wb = i01 * ja[c1] + i11 * jb[c1];
#pragma unroll
    for (int c2 = 0; c2 < 6; ++c2) {
      const T h = wa * ja[c2] + wb * jb[c2];
      out[(kHcc + c1 * 6 + c2) * E + e] = h;
      if (c2 < 3) out[(kHcp + c1 * 3 + c2) * E + e] = h;
      if (c1 < 3 && c2 < 3) out[(kHpp + c1 * 3 + c2) * E + e] = h;
      if (c1 == c2) hdiag = (c1 == 0) ? h : k_max(hdiag, h);
    }
  }
  out[kHdiag * E + e] = hdiag;
}

template <typename T>
int launch(const void* cam, const void* pt, const void* z, const void* info,
           void* out, long long E, void* stream) {
  if (E > 0) {
    const int threads = 256;
    const unsigned blocks = (unsigned)((E + threads - 1) / threads);
    p2c_kernel<T><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const T*)cam, (const T*)pt, (const T*)z, (const T*)info, (T*)out, E);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int slampp_p2c_f32(const void* cam, const void* pt, const void* z,
                              const void* info, void* out, long long E,
                              void* stream) {
  return launch<float>(cam, pt, z, info, out, E, stream);
}

extern "C" int slampp_p2c_f64(const void* cam, const void* pt, const void* z,
                              const void* info, void* out, long long E,
                              void* stream) {
  return launch<double>(cam, pt, z, info, out, E, stream);
}
