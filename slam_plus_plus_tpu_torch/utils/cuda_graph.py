"""What the port's CUDA graph runners share: work on a side stream, and a
capture on it that raises on any host synchronization.

A runner (solvers/fastl_graph.py, linalg/chol_graph.py) runs a chain's
first call eagerly on its side stream, so that the libraries' lazy set-up
happens there, then captures the chain on the same stream into a private
pool and replays it on the caller's stream.
"""

from __future__ import annotations

import torch


def on_side(side, device, fn):
    """fn() on the side stream, ordered after and before the current
    stream's work."""
    main = torch.cuda.current_stream(device)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        out = fn()
    main.wait_stream(side)
    return out


def capture(side, device, fn):
    """(graph, fn()'s outputs): fn captured on the side stream, with the
    sync debug mode raising on any host synchronization.  A capture that
    fails is raised after the current stream is restored and the device
    synchronized."""
    graph = torch.cuda.CUDAGraph()
    main = torch.cuda.current_stream(device)
    side.wait_stream(main)
    try:
        with torch.cuda.graph(graph, stream=side, capture_error_mode="global"):
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = fn()
            finally:
                torch.cuda.set_sync_debug_mode(mode)
    except Exception:
        # a capture that ends in a CUDA error leaves the side stream current
        torch.cuda.set_stream(main)
        torch.cuda.synchronize(device)
        raise
    return graph, out
