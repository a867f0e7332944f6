"""Dense Schur panels from the uniform per-landmark layout — kernel K2 and
its plain version.

Port of slam_plus_plus_tpu/ops/pallas_panel.py::build_panels, same signature
and panel layout:

    Ut[l*Bl + i, c*Bp + j] = sum_m [rows[l, m] == c] u4[l, m, i, j]
    Wt[l*Bl + k, :]        = sum_i cinv[l, k*Bl + i] * Ut[l*Bl + i, :]

(Wt_l = C_l^-1 Ut_l, cinv row-major).  Slots may repeat a (landmark, camera)
pair — the uniform layout's dummy slots reuse edge 0's camera with a zero
block — so both versions accumulate.  On a CUDA tensor :func:`build_panels`
launches ``csrc/panel.cu`` with the tiling of :func:`panel_tiling`; on a CPU
tensor it runs :func:`build_panels_plain`.
"""

from __future__ import annotations

import functools

import torch

from slam_plus_plus_tpu_torch.ops import _build

#: threads of one CTA of the kernel (csrc/panel.cu kThreads)
PANEL_THREADS = 256
#: shared memory a CTA may use: four CTAs then share an SM's 228 KB (1 KB of
#: it is reserved per CTA), so one CTA's stores overlap another's loads
PANEL_SMEM_BUDGET = 56 * 1024
#: the most dynamic shared memory a CTA can opt into on Hopper
SMEM_MAX = 232448


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


def _round_up(n: int, k: int) -> int:
    return -(-n // k) * k


def panel_smem_bytes(TL: int, Wcams: int, M: int, Bl: int, Bp: int, itemsize: int) -> int:
    """Shared memory of one CTA holding TL landmarks and a window of Wcams
    cameras (csrc/panel.cu layout()): the Ut strip, the u4 slots and C^-1,
    each row or range padded by 16 bytes so that it can take the alignment
    of its source, then the int camera ids."""
    V = 16 // itemsize
    elems = (TL * Bl * (_round_up(Wcams * Bp, V) + V) + TL * (_round_up(M * Bl * Bp, V) + V)
             + _round_up(TL * Bl * Bl, V) + V)
    return elems * itemsize + 4 * (_round_up(TL * M, 4) + 4)


@functools.cache
def panel_tiling(Nl: int, M: int, Bl: int, Bp: int, n_cams: int, itemsize: int):
    """(TL, Wcams): landmarks per CTA and cameras per column window.

    The most landmarks (at most one accumulating thread per (landmark, i, j))
    whose whole panel rows fit PANEL_SMEM_BUDGET bytes of shared memory;
    else one landmark and as few windows as fit, of even width (the widest
    windows read each landmark's blocks the fewest times).  Only when not
    even one landmark's slots fit does it go past the budget, up to
    SMEM_MAX; beyond that it raises."""
    tl_max = max(1, min(PANEL_THREADS // max(Bl * Bp, 1), Nl))

    def fits(tl, w, cap):
        return panel_smem_bytes(tl, w, M, Bl, Bp, itemsize) <= cap

    for cap in (PANEL_SMEM_BUDGET, SMEM_MAX):
        for tl in range(tl_max, 0, -1):
            if fits(tl, n_cams, cap):
                return tl, n_cams
        lo, hi = 0, n_cams              # widest window: fits(1, lo) holds or lo == 0
        while lo < hi:
            mid = (lo + hi + 1) // 2
            lo, hi = (mid, hi) if fits(1, mid, cap) else (lo, mid - 1)
        if lo:                          # the same count of windows, evened out
            n_win = -(-n_cams // lo)
            return 1, -(-n_cams // n_win)
    raise ValueError(f"build_panels: {M} slots of {Bl}x{Bp} blocks do not fit in "
                     f"{SMEM_MAX} bytes of shared memory")


def panel_windows(n_cams: int, Wcams: int):
    """The column windows [cam0, cam0 + wc) of the kernel's grid, in order."""
    return [(c, min(Wcams, n_cams - c)) for c in range(0, n_cams, Wcams)]


def _landmark_blocks_dense(u4) -> bool:
    """Whether each landmark's M*Bl*Bp values fill one dense range, in any
    order of the axes m, i, j (the kernel copies that range as it lies)."""
    expect = 1
    for s, n in sorted((s, n) for s, n in zip(u4.stride()[1:], u4.shape[1:]) if n > 1):
        if s != expect:
            return False
        expect *= n
    return True


def build_panels(u4, rows, cinv, Bl: int, Bp: int, n_cams: int):
    """u4 [Nl, M, Bl, Bp] (block transposes; any strides, read in place when
    each landmark's blocks are dense, as in the solver's transposed view),
    rows [Nl, M] int32 camera ids in [0, n_cams), cinv [Nl, Bl*Bl].  Returns
    (Ut, Wt), each [Nl*Bl, n_cams*Bp].  CPU tensors run the plain version;
    CUDA tensors launch the kernel or raise."""
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
    if not _landmark_blocks_dense(u4):
        u4 = u4.contiguous()
    rows, cinv = rows.contiguous(), cinv.contiguous()
    shape = (Nl * Bl, n_cams * Bp)
    # every element is written by the kernel: no zero fill
    Ut = torch.empty(shape, dtype=u4.dtype, device=u4.device)
    Wt = torch.empty(shape, dtype=u4.dtype, device=u4.device)
    if Nl and n_cams:
        TL, Wcams = panel_tiling(Nl, M, Bl, Bp, n_cams, u4.element_size())
        fn = lib.slampp_panels_f32 if u4.dtype == torch.float32 else lib.slampp_panels_f64
        _build.check(fn(u4.data_ptr(), rows.data_ptr(), cinv.data_ptr(),
                        Ut.data_ptr(), Wt.data_ptr(), Nl, M, Bl, Bp, n_cams,
                        *u4.stride(), TL, Wcams, _build.stream_of(Ut)),
                     "build_panels")
        build_panels.launches += 1
    return Ut, Wt


build_panels.launches = 0
