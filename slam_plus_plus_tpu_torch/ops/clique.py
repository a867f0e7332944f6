"""The sparse-reduced Schur's clique path — kernels K3a and K3b, their plain
versions and their host plan.

On the clique path (``SchurSolver.clique``: one uniform channel, every
landmark of degree M, its blocks l*M + m in landmark order) the Schur
elimination is, per landmark l with C = ll[l] and U_m = H_pl[l*M + m]:

    c_inv                 = C^-1                         [Nl, 9]
    rhs_p                 = eta_p - sum_{l, m} U_m C^-1 eta_l      (into rows[l, m])
    SC[fill_dst[l, t]]    = pp - sum_l W_a U_b^T, W = U C^-1, (a <= b) = t,
                            transposed where rows[l, a] > rows[l, b]
    dx_l                  = C^-1 (eta_l - sum_m U_m^T dx_p[rows[l, m]])

:func:`clique_forward` (K3a, ``csrc/clique.cu``) computes the first three in
one pass over the landmarks and a fixed-order sum of per-CTA partials;
:func:`clique_back` (K3b) the last.  CPU tensors run the plain versions,
which follow the kernels' order of summation up to the partials (pieces);
CUDA tensors launch the kernels or raise.  :func:`build_clique_plan` makes
the host plan both share: the landmarks ordered by camera tuple, each
sorted position's piece, and the partials' segments in plan order.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from slam_plus_plus_tpu_torch.ops import _build, planar

#: landmarks of one K3a CTA (csrc/clique.cu); a piece never spans two
CLIQUE_LANDMARKS_PER_CTA = 512
#: landmarks a K3a CTA holds in shared memory at once
CLIQUE_TILE = 32
#: the block shapes the kernels are built for (camera Bp, landmark Bl) and
#: the largest degree (M (M + 1) / 2 pairs of up to 4 lanes in 256 threads)
KERNEL_BP, KERNEL_BL, KERNEL_MAX_M = 6, 3, 10
#: sorted positions a chunk of the plain forward version holds at once
PLAIN_CHUNK = 25000


def supported(M: int, Bp: int, Bl: int) -> bool:
    """Whether K3 takes a clique of degree M with Bp x Bl blocks."""
    return Bp == KERNEL_BP and Bl == KERNEL_BL and 1 <= M <= KERNEL_MAX_M


@dataclass
class CliquePlan:
    """The host plan of the clique path, its arrays on the solver's device
    (int32).  ``perm``: the landmarks ordered by camera tuple; ``piece``:
    each sorted position's piece (a run of one tuple inside one CTA of
    ``per_cta`` positions); ``rows`` [Nl, M]: each slot's camera;
    ``sc_src`` / ``sc_off``: the pieces' pair blocks (piece * T + t) by SC
    block, in plan order; ``rhs_src`` / ``rhs_off``: their rhs vectors
    (piece * M + m) by camera; ``pp_to_sc`` / ``pp_of_sc``: each pp block's
    SC block and each SC block's pp block (-1: none)."""

    M: int
    Np: int
    Ksc: int
    n_pieces: int
    per_cta: int
    perm: torch.Tensor
    piece: torch.Tensor
    rows: torch.Tensor
    sc_src: torch.Tensor
    sc_off: torch.Tensor
    rhs_src: torch.Tensor
    rhs_off: torch.Tensor
    pp_to_sc: torch.Tensor
    pp_of_sc: torch.Tensor

    @property
    def T(self) -> int:
        return self.M * (self.M + 1) // 2

    @property
    def n_partials(self) -> int:
        """Partial SC blocks a forward call writes (against Nl x T pair
        products)."""
        return self.n_pieces * self.T


def tuple_order(rows: np.ndarray) -> np.ndarray:
    """Stable order of the rows of rows [N, M] (camera ids in [0, n))
    lexicographically: one int64 key where the tuple fits, else lexsort."""
    N, M = rows.shape
    n = int(rows.max()) + 1 if rows.size else 1
    if M * max(n - 1, 1).bit_length() <= 62:
        key = np.zeros(N, dtype=np.int64)
        for m in range(M):
            key = key * n + rows[:, m]
        return np.argsort(key, kind="stable")
    return np.lexsort(rows.T[::-1])


def _segments(keys: np.ndarray, n: int):
    """(sources in key order, stable; [n + 1] offsets) of keys in [0, n)."""
    src = np.argsort(keys, kind="stable")
    off = np.concatenate([[0], np.cumsum(np.bincount(keys, minlength=n))])
    return src, off


def build_clique_plan(rows, fill_dst, pp_to_sc, Ksc: int, Np: int, device,
                      per_cta: int = CLIQUE_LANDMARKS_PER_CTA) -> CliquePlan:
    """The plan of a clique: rows [Nl, M] camera ids, fill_dst [Nl * T] the
    SC block of each landmark's pairs (landmark-major, np.triu_indices
    order), pp_to_sc [Kpp].  Equal camera tuples give equal destinations
    and transposes (the diagonal pairs name every camera), so landmarks
    ordered by tuple run in groups; a piece is a group's run inside a
    CTA."""
    rows = np.asarray(rows, dtype=np.int64)
    Nl, M = rows.shape
    T = M * (M + 1) // 2
    perm = tuple_order(rows)
    rs = rows[perm]
    start = np.ones(Nl, dtype=bool)
    start[1:] = np.any(rs[1:] != rs[:-1], axis=1) | (np.arange(1, Nl) % per_cta == 0)
    piece = np.cumsum(start) - 1
    first = perm[start]                       # a landmark of each piece
    P = len(first)
    dst = np.asarray(fill_dst, dtype=np.int64).reshape(Nl, T)[first].reshape(-1)
    sc_src, sc_off = _segments(dst, Ksc)
    rhs_src, rhs_off = _segments(rows[first].reshape(-1), Np)
    pp_to_sc = np.asarray(pp_to_sc, dtype=np.int64)
    pp_of_sc = np.full(Ksc, -1, dtype=np.int64)
    pp_of_sc[pp_to_sc] = np.arange(len(pp_to_sc))

    def t(x):
        return torch.as_tensor(np.asarray(x, dtype=np.int32), device=device)

    return CliquePlan(M=M, Np=Np, Ksc=Ksc, n_pieces=P, per_cta=per_cta, perm=t(perm),
                      piece=t(piece), rows=t(rows), sc_src=t(sc_src), sc_off=t(sc_off),
                      rhs_src=t(rhs_src), rhs_off=t(rhs_off), pp_to_sc=t(pp_to_sc),
                      pp_of_sc=t(pp_of_sc))


def _segment_sum(values, src, off):
    """sums [n, ...] of values[src] in the segments off, each from zero in
    order (the sum kernel's order)."""
    return torch.segment_reduce(values.index_select(0, src.long()), "sum",
                                offsets=off.long(), axis=0, unsafe=True)


def clique_forward_plain(ll, eta_l, u, eta_p, pp_blocks, plan: CliquePlan):
    """(c_inv, sc, rhs): the kernel's arithmetic in torch — each piece's
    pair blocks and rhs vectors summed in sorted order, then the partials
    of each SC block and camera in plan order."""
    Nl, M, T = ll.shape[0], plan.M, plan.T
    Bp, Bl = eta_p.shape[1], eta_l.shape[1]
    c_inv = planar.binv(ll, Bl)
    ii, jj = np.triu_indices(M)
    ii, jj = torch.as_tensor(ii, device=u.device), torch.as_tensor(jj, device=u.device)
    U4 = u.reshape(Nl, M, Bp, Bl)
    rows = plan.rows.long()
    part_sc = u.new_zeros((plan.n_partials, Bp * Bp))
    part_rhs = u.new_zeros((plan.n_pieces * M, Bp))
    ar_t = torch.arange(T, device=u.device)
    ar_m = torch.arange(M, device=u.device)
    for s0 in range(0, Nl, PLAIN_CHUNK):
        ls = plan.perm[s0:s0 + PLAIN_CHUNK].long()
        pc = plan.piece[s0:s0 + PLAIN_CHUNK].long()
        Ul = U4[ls]
        W = Ul @ c_inv[ls].reshape(-1, 1, Bl, Bl)                  # [c, M, Bp, Bl]
        wr = (W @ eta_l[ls].reshape(-1, 1, Bl, 1)).squeeze(-1)     # [c, M, Bp]
        pr = W[:, ii] @ Ul[:, jj].transpose(-1, -2)                # [c, T, Bp, Bp]
        rl = rows[ls]
        flip = (rl[:, ii] > rl[:, jj])[..., None, None]
        pr = torch.where(flip, pr.transpose(-1, -2), pr)
        part_sc.index_add_(0, (pc[:, None] * T + ar_t).reshape(-1), pr.reshape(-1, Bp * Bp))
        part_rhs.index_add_(0, (pc[:, None] * M + ar_m).reshape(-1), wr.reshape(-1, Bp))
    sc = u.new_zeros((plan.Ksc, Bp * Bp))
    sc[plan.pp_to_sc.long()] = pp_blocks
    sc = sc - _segment_sum(part_sc, plan.sc_src, plan.sc_off)
    rhs = eta_p - _segment_sum(part_rhs, plan.rhs_src, plan.rhs_off)
    return c_inv, sc, rhs


def clique_back_plain(c_inv, u, eta_l, dx_p, plan: CliquePlan):
    """dx_l = C^-1 (eta_l - sum_m U_m^T dx_p[rows[l, m]]), the sum over the
    slots in order."""
    Nl, Bp, Bl = eta_l.shape[0], dx_p.shape[1], eta_l.shape[1]
    ut_dx = planar.bmv_At(u, dx_p[plan.rows.reshape(-1).long()], Bp, Bl)
    return planar.bmv(c_inv, eta_l - ut_dx.reshape(Nl, plan.M, Bl).sum(1), Bl, Bl)


def _launches(name, plan, tensors, Bp, Bl) -> bool:
    """Whether a call launches its kernel (CUDA tensors) or runs its plain
    version (CPU tensors); raises on anything K3 does not take."""
    dev, dt = tensors[0].device, tensors[0].dtype
    if any(x.device != dev or x.dtype != dt for x in tensors) or plan.perm.device != dev:
        raise ValueError(f"{name}: inputs and plan must share one device and float dtype")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda" or dt not in (torch.float32, torch.float64):
        raise ValueError(f"{name}: unsupported device {dev} or dtype {dt}")
    if not supported(plan.M, Bp, Bl):
        raise ValueError(f"{name}: K3 takes {KERNEL_BP}x{KERNEL_BL} blocks and degrees up to "
                         f"{KERNEL_MAX_M}, not {Bp}x{Bl} at degree {plan.M}")
    return True


def clique_forward(ll, eta_l, u, eta_p, pp_blocks, plan: CliquePlan):
    """ll [Nl, 9], eta_l [Nl, 3], u [Nl*M, Bp*3] (the H_pl blocks), eta_p
    [Np, Bp], pp_blocks [Kpp, Bp*Bp] -> (c_inv [Nl, 9], sc [Ksc, Bp*Bp],
    rhs [Np, Bp]).  CPU tensors run the plain version; CUDA tensors launch
    K3a (the pass over the landmarks, then the partials' sum) or raise."""
    Nl, Bp, Bl = ll.shape[0], eta_p.shape[1], eta_l.shape[1]
    if u.shape != (Nl * plan.M, Bp * Bl) or ll.shape != (Nl, Bl * Bl) or \
            eta_p.shape[0] != plan.Np or pp_blocks.shape[1:] != (Bp * Bp,):
        raise ValueError(f"clique_forward: shapes ll {tuple(ll.shape)}, u {tuple(u.shape)}, "
                         f"eta_p {tuple(eta_p.shape)}, pp {tuple(pp_blocks.shape)} disagree")
    if not _launches("clique_forward", plan, (ll, eta_l, u, eta_p, pp_blocks), Bp, Bl):
        return clique_forward_plain(ll, eta_l, u, eta_p, pp_blocks, plan)
    lib = _build.load_library()
    ll, eta_l, u = ll.contiguous(), eta_l.contiguous(), u.contiguous()
    eta_p, pp_blocks = eta_p.contiguous(), pp_blocks.contiguous()

    def empty(*shape):
        return torch.empty(shape, dtype=u.dtype, device=u.device)

    # every element is written once by the kernels: no zero fill
    c_inv, sc, rhs = empty(Nl, Bl * Bl), empty(plan.Ksc, Bp * Bp), empty(plan.Np, Bp)
    part_sc, part_rhs = empty(plan.n_partials, Bp * Bp), empty(plan.n_pieces * plan.M, Bp)
    fn = lib.slampp_clique_forward_f32 if u.dtype == torch.float32 else \
        lib.slampp_clique_forward_f64
    _build.check(fn(u.data_ptr(), ll.data_ptr(), eta_l.data_ptr(), plan.perm.data_ptr(),
                    plan.piece.data_ptr(), plan.rows.data_ptr(), c_inv.data_ptr(),
                    part_sc.data_ptr(), part_rhs.data_ptr(), plan.sc_src.data_ptr(),
                    plan.sc_off.data_ptr(), plan.rhs_src.data_ptr(), plan.rhs_off.data_ptr(),
                    pp_blocks.data_ptr(), plan.pp_of_sc.data_ptr(), eta_p.data_ptr(),
                    sc.data_ptr(), rhs.data_ptr(), Nl, plan.M, Bp, plan.per_cta, CLIQUE_TILE,
                    plan.Ksc, plan.Np, _build.stream_of(u)),
                 "clique_forward")
    clique_forward.launches += 1
    return c_inv, sc, rhs


def clique_back(c_inv, u, eta_l, dx_p, plan: CliquePlan):
    """c_inv [Nl, 9] (:func:`clique_forward`'s), u [Nl*M, Bp*3], eta_l
    [Nl, 3], dx_p [Np, Bp] -> dx_l [Nl, 3].  CPU tensors run the plain
    version; CUDA tensors launch K3b or raise."""
    Nl, Bp, Bl = eta_l.shape[0], dx_p.shape[1], eta_l.shape[1]
    if u.shape != (Nl * plan.M, Bp * Bl) or c_inv.shape != (Nl, Bl * Bl) or \
            dx_p.shape[0] != plan.Np:
        raise ValueError(f"clique_back: shapes c_inv {tuple(c_inv.shape)}, u "
                         f"{tuple(u.shape)}, dx_p {tuple(dx_p.shape)} disagree")
    if not _launches("clique_back", plan, (c_inv, u, eta_l, dx_p), Bp, Bl):
        return clique_back_plain(c_inv, u, eta_l, dx_p, plan)
    lib = _build.load_library()
    c_inv, u, eta_l, dx_p = c_inv.contiguous(), u.contiguous(), eta_l.contiguous(), \
        dx_p.contiguous()
    dx_l = torch.empty_like(eta_l)
    fn = lib.slampp_clique_back_f32 if u.dtype == torch.float32 else lib.slampp_clique_back_f64
    _build.check(fn(u.data_ptr(), c_inv.data_ptr(), eta_l.data_ptr(), plan.rows.data_ptr(),
                    dx_p.data_ptr(), dx_l.data_ptr(), Nl, plan.M, Bp, _build.stream_of(u)),
                 "clique_back")
    clique_back.launches += 1
    return dx_l


clique_forward.launches = 0
clique_back.launches = 0
