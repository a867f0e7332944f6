"""P2C (mono reprojection) edge terms — kernel K1 and its plain version.

Port of slam_plus_plus_tpu/ops/pallas_p2c.py: per observation, the residual,
the analytic Jacobians and every gradient/Hessian block product in one pass.
The layout is the JAX package's ``[d, E]`` (edge index on the last axis).
On a CUDA tensor :func:`p2c_edge_terms` launches the hand-written kernel in
``csrc/p2c.cu``; on a CPU tensor it runs :func:`p2c_edge_terms_plain`, the
same closed-form math in torch.
"""

from __future__ import annotations

import torch

from slam_plus_plus_tpu_torch.ops import _build

#: output rows, in order: chi2, hdiag, g_cam, g_pt, hcc, hcp, hpp
OUT_ROWS = (1, 1, 6, 3, 36, 18, 9)


def p2c_edge_terms_plain(cam_t, pt_t, z_t, info_t):
    """The Pallas kernel's math on [d, E] tensors; same signature and
    results as :func:`p2c_edge_terms`."""
    tx, ty, tz, ax, ay, az, fx, fy, cx, cy, dd = cam_t.unbind(0)
    px, py, pz = pt_t.unbind(0)
    z0, z1 = z_t.unbind(0)
    i00, i01, i10, i11 = info_t.unbind(0)

    # Rodrigues rotation from axis-angle (Taylor-guarded)
    th2 = ax * ax + ay * ay + az * az
    th = torch.sqrt(th2)
    small = th2 < 1e-12
    one = torch.ones_like(th)
    A = torch.where(small, 1.0 - th2 / 6.0, torch.sin(th) / torch.where(small, one, th))
    B = torch.where(small, 0.5 - th2 / 24.0,
                    (1.0 - torch.cos(th)) / torch.where(small, one, th2))
    r00 = 1.0 - B * (ay * ay + az * az)
    r01 = B * ax * ay - A * az
    r02 = B * ax * az + A * ay
    r10 = B * ax * ay + A * az
    r11 = 1.0 - B * (ax * ax + az * az)
    r12 = B * ay * az - A * ax
    r20 = B * ax * az - A * ay
    r21 = B * ay * az + A * ax
    r22 = 1.0 - B * (ax * ax + ay * ay)

    # p_cam = R p + t
    pcx = r00 * px + r01 * py + r02 * pz + tx
    pcy = r10 * px + r11 * py + r12 * pz + ty
    pcz = r20 * px + r21 * py + r22 * pz + tz
    iz = 1.0 / torch.where(torch.abs(pcz) > 1e-12, pcz, one)

    du = fx * pcx * iz
    dv = fy * pcy * iz
    k = dd / (0.5 * (fx + fy))
    w = 1.0 + k * (du * du + dv * dv)
    e0 = z0 - (cx + w * du)
    e1 = z1 - (cy + w * dv)
    chi2 = e0 * (i00 * e0 + i01 * e1) + e1 * (i10 * e0 + i11 * e1)

    # dh/dp_cam = Mdist (2x2) @ Ppin (2x3)
    m00 = w + 2.0 * k * du * du
    m01 = 2.0 * k * du * dv
    m11 = w + 2.0 * k * dv * dv
    p00 = fx * iz
    p02 = -fx * pcx * iz * iz
    p11 = fy * iz
    p12 = -fy * pcy * iz * iz
    d00, d01, d02 = m00 * p00, m01 * p11, m00 * p02 + m01 * p12
    d10, d11, d12 = m01 * p00, m11 * p11, m01 * p02 + m11 * p12

    # J = -dh/d(delta): translation (= point) columns -Dh R[:, c]; rotation
    # columns Dh R [p]x[:, c]
    zero = 0.0 * px
    rcols = ((r00, r10, r20), (r01, r11, r21), (r02, r12, r22))
    pxcols = ((zero, pz, -py), (-pz, zero, px), (py, -px, zero))
    ja, jb = [None] * 6, [None] * 6
    for c in range(3):
        a, b, cc = rcols[c]
        ja[c] = -(d00 * a + d01 * b + d02 * cc)
        jb[c] = -(d10 * a + d11 * b + d12 * cc)
        vx, vy, vz = pxcols[c]
        rx = r00 * vx + r01 * vy + r02 * vz
        ry = r10 * vx + r11 * vy + r12 * vz
        rz = r20 * vx + r21 * vy + r22 * vz
        ja[3 + c] = d00 * rx + d01 * ry + d02 * rz
        jb[3 + c] = d10 * rx + d11 * ry + d12 * rz

    se0 = i00 * e0 + i01 * e1
    se1 = i10 * e0 + i11 * e1
    g = torch.stack([-(ja[c] * se0 + jb[c] * se1) for c in range(6)])

    # H_cc[c1, c2] = J_c1^T info J_c2; J_pt is J_cam's first 3 columns, so
    # H_cp and H_pp are sub-blocks of H_cc
    wa = [i00 * ja[c] + i10 * jb[c] for c in range(6)]
    wb = [i01 * ja[c] + i11 * jb[c] for c in range(6)]
    hcc = torch.stack([wa[c1] * ja[c2] + wb[c1] * jb[c2]
                       for c1 in range(6) for c2 in range(6)])
    h3 = hcc.view(6, 6, -1)
    hcp = h3[:, :3].reshape(18, -1)
    hpp = h3[:3, :3].reshape(9, -1)
    hdiag = torch.amax(torch.diagonal(h3, dim1=0, dim2=1), dim=-1)
    return (chi2[None], hdiag[None], g, g[:3], hcc, hcp, hpp)


def p2c_edge_terms(cam_t, pt_t, z_t, info_t):
    """Inputs transposed [d, E]: cam [11, E], point [3, E], z [2, E],
    info [4, E] (row-major 2x2), one dtype, one device.

    Returns (chi2 [1,E], hdiag [1,E], g_cam [6,E], g_pt [3,E], hcc [36,E],
    hcp [18,E], hpp [9,E]).  CPU tensors run the plain version; CUDA tensors
    launch the kernel or raise."""
    E = cam_t.shape[-1]
    args = (cam_t, pt_t, z_t, info_t)
    for x, d in zip(args, (11, 3, 2, 4)):
        if x.shape != (d, E):
            raise ValueError(f"p2c_edge_terms: expected [{d}, {E}], got {tuple(x.shape)}")
        if x.dtype != cam_t.dtype or x.device != cam_t.device:
            raise ValueError("p2c_edge_terms: inputs differ in dtype or device")
    if cam_t.device.type == "cpu":
        return p2c_edge_terms_plain(*args)
    if cam_t.device.type != "cuda":
        raise ValueError(f"p2c_edge_terms: unsupported device {cam_t.device}")
    if cam_t.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"p2c_edge_terms: unsupported dtype {cam_t.dtype}")
    lib = _build.load_library()
    args = tuple(x.contiguous() for x in args)
    out = torch.empty((sum(OUT_ROWS), E), dtype=cam_t.dtype, device=cam_t.device)
    if E:
        fn = lib.slampp_p2c_f32 if cam_t.dtype == torch.float32 else lib.slampp_p2c_f64
        _build.check(fn(*(x.data_ptr() for x in args), out.data_ptr(), E,
                        _build.stream_of(out)), "p2c_edge_terms")
        p2c_edge_terms.launches += 1
    return tuple(out.split(OUT_ROWS))


p2c_edge_terms.launches = 0
