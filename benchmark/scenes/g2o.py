"""Vectorised g2o text: one token, integer id columns and fixed-point value
columns per line, formatted by digit arithmetic on whole columns.

Every value is written with FRAC digits after the point, so the number a
reader parses from the text is ``sign * q / 10**FRAC`` for the integer
``q = rint(|x| * 10**FRAC)``, correctly rounded by the reader as by numpy's
division.  ``as_read`` gives those numbers, so that a plain reference can be
handed exactly what the program's parser reads, without parsing the file.
"""

from __future__ import annotations

import numpy as np

#: digits after the decimal point
FRAC = 10
#: lines formatted per block (bounds the transient digit arrays)
BLOCK = 1 << 19


def as_read(x) -> np.ndarray:
    """The float64 values a reader parses from x written with FRAC digits."""
    x = np.asarray(x, dtype=np.float64)
    q = np.rint(np.abs(x) * 10.0 ** FRAC)
    return np.where(x < 0, -1.0, 1.0) * (q / 10.0 ** FRAC)


def _digits(q: np.ndarray, width: int) -> np.ndarray:
    """[n, width] decimal digits of the non-negative int64 q, most significant
    first."""
    pows = 10 ** np.arange(width - 1, -1, -1, dtype=np.int64)
    return (q[:, None] // pows[None, :]) % 10


def _int_cols(v: np.ndarray) -> np.ndarray:
    """Right-aligned decimal text of non-negative integers, [n, w] uint8,
    led by one space."""
    v = np.asarray(v, dtype=np.int64)
    if len(v) and v.min() < 0:
        raise ValueError("negative id")
    width = max(1, len(str(int(v.max())))) if len(v) else 1
    d = _digits(v, width)
    lead = np.cumsum(d != 0, axis=1) == 0
    lead[:, -1] = False
    out = np.where(lead, ord(" "), d + ord("0")).astype(np.uint8)
    return np.concatenate([np.full((len(v), 1), ord(" "), np.uint8), out], axis=1)


def _float_cols(x: np.ndarray) -> np.ndarray:
    """Fixed-point text of x with FRAC decimals, [n, w] uint8, led by one
    space and a sign column ('-' or '0')."""
    x = np.asarray(x, dtype=np.float64)
    if not np.isfinite(x).all():
        raise ValueError("non-finite value in a scene")
    q = np.rint(np.abs(x) * 10.0 ** FRAC).astype(np.int64)
    width = max(FRAC + 1, len(str(int(q.max())))) if len(q) else FRAC + 1
    d = (_digits(q, width) + ord("0")).astype(np.uint8)
    n = len(x)
    sign = np.where((x < 0) & (q > 0), ord("-"), ord("0")).astype(np.uint8)[:, None]
    return np.concatenate([np.full((n, 1), ord(" "), np.uint8), sign,
                           d[:, :width - FRAC], np.full((n, 1), ord("."), np.uint8),
                           d[:, width - FRAC:]], axis=1)


def write_lines(f, token: str, ints, floats, tail: str = "") -> None:
    """Write one line per row to the binary file f: ``token``, the integer
    columns ints [n, a], the value columns floats [n, b] and a constant
    tail."""
    ints = np.asarray(ints, dtype=np.int64).reshape(len(ints), -1)
    floats = np.asarray(floats, dtype=np.float64).reshape(len(floats), -1)
    head = np.frombuffer(token.encode(), np.uint8)
    end = np.frombuffer((tail + "\n").encode(), np.uint8)
    for lo in range(0, len(ints), BLOCK):
        hi = min(lo + BLOCK, len(ints))
        n = hi - lo
        cols = [np.broadcast_to(head, (n, len(head)))]
        cols += [_int_cols(ints[lo:hi, k]) for k in range(ints.shape[1])]
        cols += [_float_cols(floats[lo:hi, k]) for k in range(floats.shape[1])]
        cols.append(np.broadcast_to(end, (n, len(end))))
        f.write(np.ascontiguousarray(np.concatenate(cols, axis=1)).tobytes())
