"""Spans around the program's public methods, recorded from the benchmark's
side: each wrapped call is synchronised with the device on entry and exit
and timed on the host clock."""

from __future__ import annotations

import time
from collections import defaultdict


def mean_ms(times):
    """Milliseconds per call: the mean of a span's recorded seconds; None
    where the span never ran (nothing to read)."""
    if not times:
        return None
    return 1e3 * sum(times) / len(times)


class Spans:
    def __init__(self, sync):
        self.sync = sync
        self.times = defaultdict(list)        # span name -> seconds of each call
        self._wrapped = []                    # (obj, method, own attribute or None)

    def wrap(self, name: str, obj, method: str) -> None:
        """Time every later call of obj.method (an instance attribute that
        shadows the class's method) until ``unwrap``."""
        inner = getattr(obj, method)
        own = vars(obj).get(method)

        def spanned(*args, **kwargs):
            self.sync()
            t0 = time.perf_counter()
            out = inner(*args, **kwargs)
            self.sync()
            self.times[name].append(time.perf_counter() - t0)
            return out

        setattr(obj, method, spanned)
        self._wrapped.append((obj, method, own))

    def unwrap(self) -> None:
        """Give every wrapped method back what it was."""
        for obj, method, own in reversed(self._wrapped):
            if own is None:
                delattr(obj, method)
            else:
                setattr(obj, method, own)
        self._wrapped.clear()
