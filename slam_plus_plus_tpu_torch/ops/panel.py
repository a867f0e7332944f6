"""Dense Schur panels from the uniform per-landmark layout — kernel K2 and
its plain version.

Port of slam_plus_plus_tpu/ops/pallas_panel.py::build_panels, same signature
and panel layout:

    Ut[l*Bl + i, c*Bp + j] = sum_m [rows[l, m] == c] u4[l, m, i, j]
    Wt[l*Bl + k, :]        = sum_i cinv[l, k*Bl + i] * Ut[l*Bl + i, :]

(Wt_l = C_l^-1 Ut_l, cinv row-major).  Slots may repeat a (landmark, camera)
pair — the uniform layout's dummy slots reuse edge 0's camera with a zero
block — so both versions accumulate.  On a CUDA tensor :func:`build_panels`
launches ``csrc/panel.cu``; on a CPU tensor it runs
:func:`build_panels_plain`.
"""

from __future__ import annotations

import torch

from slam_plus_plus_tpu_torch.ops import _build


def build_panels_plain(u4, rows, cinv, Bl: int, Bp: int, n_cams: int):
    """index_put_ accumulation into zeroed panels plus the C^-1
    recombination; same results as :func:`build_panels`."""
    Nl, M = rows.shape
    U = torch.zeros((Nl, n_cams, Bl, Bp), dtype=u4.dtype, device=u4.device)
    lm = torch.arange(Nl, device=u4.device).repeat_interleave(M)
    U.index_put_((lm, rows.reshape(-1).long()), u4.reshape(Nl * M, Bl, Bp),
                 accumulate=True)
    Ut = U.permute(0, 2, 1, 3).reshape(Nl, Bl, n_cams * Bp)
    # Wt rows summed over i in order, as the Pallas kernel does, so that
    # near-singular pivots round the same way
    c = cinv.reshape(Nl, Bl, Bl, 1)
    Wt = c[:, :, 0] * Ut[:, 0:1]
    for i in range(1, Bl):
        Wt = Wt + c[:, :, i] * Ut[:, i:i + 1]
    return Ut.reshape(Nl * Bl, -1), Wt.reshape(Nl * Bl, -1)


def build_panels(u4, rows, cinv, Bl: int, Bp: int, n_cams: int):
    """u4 [Nl, M, Bl, Bp] (block transposes), rows [Nl, M] int32 camera ids
    in [0, n_cams), cinv [Nl, Bl*Bl].  Returns (Ut, Wt), each
    [Nl*Bl, n_cams*Bp].  CPU tensors run the plain version; CUDA tensors
    launch the kernel or raise."""
    Nl, M = rows.shape
    if u4.shape != (Nl, M, Bl, Bp) or cinv.shape != (Nl, Bl * Bl):
        raise ValueError(f"build_panels: shapes u4 {tuple(u4.shape)}, rows "
                         f"{tuple(rows.shape)}, cinv {tuple(cinv.shape)} disagree")
    if cinv.dtype != u4.dtype or rows.dtype != torch.int32:
        raise ValueError("build_panels: u4/cinv must share a float dtype and "
                         "rows must be int32")
    if not (u4.device == rows.device == cinv.device):
        raise ValueError("build_panels: inputs on different devices")
    if u4.device.type == "cpu":
        return build_panels_plain(u4, rows, cinv, Bl, Bp, n_cams)
    if u4.device.type != "cuda":
        raise ValueError(f"build_panels: unsupported device {u4.device}")
    if u4.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"build_panels: unsupported dtype {u4.dtype}")
    lib = _build.load_library()
    u4, rows, cinv = u4.contiguous(), rows.contiguous(), cinv.contiguous()
    shape = (Nl * Bl, n_cams * Bp)
    Ut = torch.zeros(shape, dtype=u4.dtype, device=u4.device)
    Wt = torch.zeros(shape, dtype=u4.dtype, device=u4.device)
    if Nl and M:
        fn = lib.slampp_panels_f32 if u4.dtype == torch.float32 else lib.slampp_panels_f64
        _build.check(fn(u4.data_ptr(), rows.data_ptr(), cinv.data_ptr(),
                        Ut.data_ptr(), Wt.data_ptr(), Nl, M, Bl, Bp, n_cams,
                        _build.stream_of(Ut)), "build_panels")
        build_panels.launches += 1
    return Ut, Wt


build_panels.launches = 0
