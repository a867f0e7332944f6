"""The arithmetic of a reference run: its dtype, and whether the operands
of every matrix product are rounded to TF32 first.

TF32 keeps float32's exponent and 10 of its 23 mantissa bits; a float32
product with TF32 allowed rounds both operands so and sums in float32.
Rounding here, on any device, makes the TF32 control the same on the CPU
and on the card, whatever product kernel the library picks.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x (float32) rounded to the nearest TF32 value, ties to even."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


@dataclass(frozen=True)
class Precision:
    name: str               # "float64", "float32" or "tf32"

    @property
    def dtype(self) -> torch.dtype:
        return torch.float64 if self.name == "float64" else torch.float32

    def mm(self, eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """einsum(eq, a, b), a matrix product in this precision."""
        if self.name == "tf32":
            a, b = round_tf32(a), round_tf32(b)
        return torch.einsum(eq, a, b)


FLOAT64 = Precision("float64")
FLOAT32 = Precision("float32")
TF32 = Precision("tf32")
PRECISIONS = {p.name: p for p in (FLOAT64, FLOAT32, TF32)}
