"""Schur-ordering analysis of a dataset's block structure.

    python -m slam_plus_plus_tpu_torch.app.schur_orderings input.g2o
        [--max-degree N] [--bottom N] [--device cuda|cpu]

Port of scripts/schur_orderings.py (which imports JAX and stays the JAX
package's), the analogue of the reference's slam_schur_orderings research
binary (reference src/slam_schur_orderings/Main.cpp:759,2139,2524).  It
prints, for the dataset's block structure (the Assembler's pattern on
``--device``):

  * the nested MIS-Schur elimination, the port's own ordering
    (linalg/block_cholesky.py ``SymbolicPlan``): per level the vertices,
    the eliminated set, the pairs, the fill products and the eliminated
    share; the dense bottom; a flop model of the levels and the bottom
    against one dense factorization;
  * the nested BFS-bisection Schur analysis (linalg/nested_schur.py);

the same lines as the JAX script, from the same host plans.
"""

from __future__ import annotations

import argparse
import sys


def report(asm, path: str, max_degree: int = 16, bottom: int = 64) -> None:
    """Print the analysis of asm's block structure."""
    from slam_plus_plus_tpu_torch.linalg.block_cholesky import SymbolicPlan
    from slam_plus_plus_tpu_torch.linalg.nested_schur import nested_schur_analysis

    print(f"dataset: {path}")
    print(f"block structure: Np={asm.Np} (Bp={asm.Bp}) Nl={asm.Nl} "
          f"(Bl={asm.Bl}) Kpp={asm.Kpp} Kpl={asm.Kpl}")

    # the MIS-Schur elimination levels (the factorization's own ordering)
    plan = SymbolicPlan(asm.pp_rows, asm.pp_cols, asm.Np, asm.Bp, bottom=bottom,
                        max_degree=max_degree)
    print("\nMIS-Schur elimination levels (n, |MIS|, pairs, fill products, MIS frac):")
    total_fill = 0
    for li, lv in enumerate(plan.levels):
        total_fill += len(lv.pa)
        print(f"  L{li:2d}: n={lv.n:7d} elim={lv.n_elim:7d} K={lv.K:8d} "
              f"prods={len(lv.pa):8d} frac={lv.n_elim / max(lv.n, 1):.2f}")
    nb = plan.n_bottom
    print(f"  bottom: {nb} blocks ({nb * asm.Bp} dims dense) after {len(plan.levels)} "
          f"levels; total fill products {total_fill}")

    # flop model: the batched level work against one dense factorization
    B = asm.Bp
    level_flops = sum(lv.n_elim * B ** 3 + len(lv.u_src) * 2 * B ** 3 +
                      len(lv.pa) * 2 * B ** 3 for lv in plan.levels)
    dense_flops = (asm.Np * B) ** 3 / 3
    bottom_flops = (nb * B) ** 3 / 3
    print(f"  flops: levels {level_flops / 1e9:.3f} GF + bottom {bottom_flops / 1e9:.3f} GF  "
          f"(one dense factorization: {dense_flops / 1e9:.3f} GF, "
          f"x{dense_flops / max(level_flops + bottom_flops, 1):.1f})")

    # the nested BFS Schur partitions (the reference tool's experiment)
    print("\nnested BFS-bisection Schur analysis:")
    for row in nested_schur_analysis(asm):
        print(f"  {row}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="slam_plus_plus_tpu_torch.app.schur_orderings")
    p.add_argument("input")
    p.add_argument("--max-degree", type=int, default=16)
    p.add_argument("--bottom", type=int, default=64)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: --device cuda, but torch sees no CUDA device; run on a GPU or "
              "pass --device cpu", file=sys.stderr)
        return 2
    from slam_plus_plus_tpu_torch.assembly.assembler import Assembler
    from slam_plus_plus_tpu_torch.io.parser import parse_g2o

    report(Assembler(parse_g2o(args.input), device=args.device), args.input,
           args.max_degree, args.bottom)
    return 0


if __name__ == "__main__":
    sys.exit(main())
