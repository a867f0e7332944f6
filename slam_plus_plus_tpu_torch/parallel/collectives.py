"""The collectives of the sharded classes, over one process group.

The JAX package's ``psum`` / ``pmax`` / tiled ``all_gather`` inside
``shard_map`` become ``all_reduce(SUM)``, ``all_reduce(MAX)`` and
``all_gather`` into a list, then ``cat``.  Several tensors summed at one
point go through one flat buffer and one ``all_reduce``.

With ``timing`` on, each collective is timed under its name: CUDA events
around it on a card (read at ``times_ms``, which synchronizes), the host
clock on the CPU, where gloo returns once the data is in place.  Off, it
costs nothing.
"""

from __future__ import annotations

import time
from typing import Dict, List

import torch
import torch.distributed as dist


class Collectives:
    def __init__(self, group=None):
        self.group = group or dist.group.WORLD
        self.rank = dist.get_rank(self.group)
        self.size = dist.get_world_size(self.group)
        self.timing = False
        self._spans: Dict[str, List] = {}

    def _timed(self, name, x, run):
        if not self.timing:
            return run()
        if x.is_cuda:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = run()
            end.record()
            self._spans.setdefault(name, []).append((start, end))
        else:
            t0 = time.perf_counter()
            out = run()
            self._spans.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
        return out

    def times_ms(self) -> Dict[str, float]:
        """Total ms per collective name since the last read."""
        if any(isinstance(s, tuple) for spans in self._spans.values() for s in spans):
            torch.cuda.synchronize()
        out = {name: sum(s[0].elapsed_time(s[1]) if isinstance(s, tuple) else s for s in spans)
               for name, spans in self._spans.items()}
        self._spans = {}
        return out

    def sum(self, name: str, *tensors):
        """Each tensor summed over the group (one all_reduce of one flat
        buffer); returns new tensors of the same shapes."""
        flat = torch.cat([t.reshape(-1) for t in tensors])

        def run():
            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=self.group)
            return flat

        flat = self._timed(name, flat, run)
        out, off = [], 0
        for t in tensors:
            out.append(flat[off:off + t.numel()].reshape(t.shape))
            off += t.numel()
        return tuple(out)

    def max(self, name: str, x):
        """x's elementwise maximum over the group (a new tensor)."""
        y = x.clone()

        def run():
            dist.all_reduce(y, op=dist.ReduceOp.MAX, group=self.group)
            return y

        return self._timed(name, y, run)

    def gather(self, name: str, x):
        """Every rank's x, concatenated along dim 0 in rank order."""
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]

        def run():
            dist.all_gather(parts, x, group=self.group)
            return torch.cat(parts)

        return self._timed(name, x, run)
