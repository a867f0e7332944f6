"""FLOP accounting for the solver pipeline.

Port of slam_plus_plus_tpu/utils/flops.py (reference
include/sparse_flops/Instrument.h:40,131, cts.hpp: a FLOP-counting
instrumented scalar): analytic per-stage formulas from the Assembler's
plans, and ``torch_cost``, PyTorch's own count of one call of a function
(``torch.utils.flop_counter.FlopCounterMode``) in place of the JAX
package's XLA cost analysis.  That counter sees aten's matrix products
only: the hand-written kernels (K1, K2) are opaque to it, so their work
stays in the analytic counts.
"""

from __future__ import annotations

from typing import Dict

from slam_plus_plus_tpu_torch.models.types import EDGE_TYPES


def assembly_flops(asm) -> Dict[str, float]:
    """Per-iteration lambda/eta assembly FLOPs from the structure."""
    total = 0.0
    detail = {}
    for plan in asm.plans:
        E = plan.E
        m = EDGE_TYPES[plan.name].residual_dim
        per_edge = 0.0
        for k, t in enumerate(plan.slot_types):
            B = asm.Bp if plan.slot_class[k] == "p" else asm.Bl
            per_edge += 2.0 * m * m * B      # J^T info
            per_edge += 2.0 * m * B          # g = J^T (info r)
        n_pairs = len(plan.pp_contribs) + len(plan.pl_contribs) + \
            sum(1 for c in plan.slot_class if c == "l")
        per_edge += n_pairs * 2.0 * asm.Bp * m * asm.Bp  # H products (upper bound)
        detail[plan.name] = E * per_edge
        total += E * per_edge
    detail["total"] = total
    return detail


def schur_flops(asm) -> Dict[str, float]:
    """Schur elimination FLOPs: C^-1, W, panel GEMMs, reduced Cholesky."""
    Np, Bp, Nl, Bl, Kpl = asm.Np, asm.Bp, asm.Nl, asm.Bl, asm.Kpl
    nred = Np * Bp
    d = {
        "c_inv": Nl * (Bl ** 3) * 2.0,
        "w": Kpl * 2.0 * Bp * Bl * Bl,
        "sc_gemm": 2.0 * nred * nred * Nl * Bl,
        "chol": nred ** 3 / 3.0,
        "backsub": Kpl * 4.0 * Bp * Bl + Nl * 2.0 * Bl * Bl,
    }
    d["total"] = sum(d.values())
    return d


def torch_cost(fn, *args) -> Dict[str, float]:
    """PyTorch's FLOP count of one call fn(*args): {"flops": ...}."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return {"flops": float(counter.get_total_flops())}
