"""Segmented sums in a fixed order: the port's deterministic ``index_add_``.

On the card, ``index_add_`` with repeated destinations adds by atomics, in
the order they land, and that order changes from run to run.  In float64
the difference is a few ulps per sum, but the incremental engine's push
decisions and the block Cholesky's deep levels turn it into a different
answer: trees10k-incr ``-nsp 1 -fL`` read 409.12 / 410.32 / 420.73 in
three card runs, and two w100k factors gave solves 4e-4 apart.  The JAX
package and the reference binary give one answer per input.

Here every sum has a fixed order.  The destinations are sorted stably, the
values gathered in that order, and each segment summed from zero in source
order by ``torch.segment_reduce`` (each thread sums one segment's column in
a loop, with no atomics).  On the CPU this is the sequential order of
``index_add_``, so results there are bitwise those of ``index_add_`` into
zeros.

  * :class:`SegmentSum`: destinations fixed when a plan is built (the block
    Cholesky's levels, the generic assembler's slots).  The sort is made
    once, on the host.  Destinations that never repeat keep the scatter,
    which is deterministic when each address is written once.
  * :func:`segment_order` + :func:`segment_sum`: destinations that come
    from the host at each step (the incremental engine's dirty lists).  The
    sort runs on the values' device, every level of a step in one call.
  * :func:`index_add_ordered`: ``out[dst] += values`` in source order,
    onto a tensor that already holds values (FastL's omega deltas).
"""

from __future__ import annotations

import numpy as np
import torch


def _reduce(values, perm, offsets):
    return torch.segment_reduce(values.index_select(0, perm), "sum", offsets=offsets,
                                axis=0, unsafe=True)


class SegmentSum:
    """``out[d] = sum of values[i] over dst[i] == d`` for n destinations, in
    source order, for destinations fixed at construction (numpy or a
    tensor, any shape; flattened)."""

    def __init__(self, dst, n: int, device):
        if isinstance(dst, torch.Tensor):
            dst = dst.detach().cpu().numpy()
        dst = np.asarray(dst, dtype=np.int64).reshape(-1)
        self.n = int(n)
        counts = np.bincount(dst, minlength=self.n)
        self.unique = bool(len(dst) == 0 or counts.max() <= 1)
        dev = torch.device(device)
        if self.unique:
            self._dst = torch.as_tensor(dst, device=dev)
        else:
            self._perm = torch.as_tensor(np.argsort(dst, kind="stable"), device=dev)
            self._offsets = torch.as_tensor(np.concatenate([[0], np.cumsum(counts)]),
                                            device=dev)

    def __call__(self, values):
        """values [T, ...] in destination order -> sums [n, ...]."""
        if self.unique:
            out = values.new_zeros((self.n,) + tuple(values.shape[1:]))
            return out.index_add_(0, self._dst, values)
        return _reduce(values, self._perm, self._offsets)


def segment_order(dst, n: int):
    """(perm, offsets) of destinations known only at run time: dst [..., T]
    (int64) sorted stably along its last axis, and the [..., n + 1] segment
    offsets of destinations 0..n-1 (a destination >= n, a padding lane, is
    dropped).  Leading axes batch several plans (levels) in one sort."""
    s, perm = torch.sort(dst, dim=-1, stable=True)
    ids = torch.arange(n + 1, device=dst.device, dtype=dst.dtype)
    offsets = torch.searchsorted(s, ids.expand(*dst.shape[:-1], n + 1).contiguous())
    return perm, offsets


def segment_sum(values, perm, offsets):
    """values [T, ...] -> [n, ...] through one row of :func:`segment_order`."""
    return _reduce(values, perm, offsets)


def index_add_ordered(out, dst, values):
    """``out.index_add_(0, dst, values)`` with a fixed order: each touched
    row becomes out[d] + v_1 + v_2 + ... in source order (dst [T], values
    [T, ...]).  Each run of equal sorted destinations sums its row's old
    value and its values (zeros between them keep the order exact), and
    every lane of the run writes the run's one sum back, so repeated writes
    to a row carry equal values.  In place; returns out."""
    T = dst.shape[0]
    if T == 0:
        return out
    s, perm = torch.sort(dst, stable=True)
    first = torch.searchsorted(s, s)                  # start of each lane's run
    end = torch.searchsorted(s, s, right=True)        # its end
    ar = torch.arange(T, device=dst.device)
    head = first == ar
    lanes = head.reshape((T,) + (1,) * (values.dim() - 1))
    init = torch.where(lanes, out.index_select(0, s), torch.zeros_like(values))
    data = torch.stack([init, values.index_select(0, perm)], dim=1).reshape(
        (2 * T,) + tuple(values.shape[1:]))
    # run k: rows [2 * head_k, 2 * end_k); every other lane an empty segment
    starts = torch.where(head, ar, end)
    offsets = torch.cat([2 * starts, starts.new_full((1,), 2 * T)])
    sums = torch.segment_reduce(data, "sum", offsets=offsets, axis=0, unsafe=True)
    out.index_put_((s,), sums.index_select(0, first))
    return out
