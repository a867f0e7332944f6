"""Traffic drivers, one module per ``driver`` named in a traffic file.

A driver module's ``build(system, scene, config, traffic, device)`` returns
an object with:

  * ``warm_up()``: the first-use costs of the cell's own shapes;
  * ``unit(part=None)``: one unit of the traffic (a solve, a replay), its
    result's chi2 as a float (the host has the answer when it returns);
    with part = (begin, end), begin() and end() are called around the
    unit's profiled part (the traffic's ``profile_part`` of a replay's
    stream, the whole of a solve);
  * ``work_per_unit``: what one unit counts for the cell's metric;
  * ``part_work``: what the profiled part counts;
  * ``construct_s``: the solver's own construction seconds;
  * ``answer()``: the program's states after the last unit, {vertex type:
    [n, state] in vertex-id order} and "chi2";
  * ``layers()``: {span name: (object, method)} to time in a traced run;
  * ``counts()``: numbers of the data and of the program's counters.
"""

from __future__ import annotations

import importlib

import numpy as np


def build(system, scene, config: dict, traffic: dict, device):
    mod = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    return mod.build(system, scene, config, traffic, device)


def expected_dtype(config: dict, device):
    """The dtype the configuration states on device (float64 on the CPU,
    where the port runs every route in float64)."""
    import torch

    return torch.float64 if torch.device(device).type == "cpu" else getattr(
        torch, config["dtype"])


def snapshot(system) -> dict:
    """{vertex type: states [n, d] copied} of a GraphSystem, in store order."""
    return {t: s.data.copy() for t, s in system.vertex_stores.items()}


def restore(system, states: dict) -> None:
    for t, arr in states.items():
        system.vertex_stores[t].states[:len(arr)] = arr


def by_id(system) -> dict:
    """{vertex type: states in vertex-id order}."""
    out = {}
    for t, s in system.vertex_stores.items():
        order = np.argsort(np.asarray(s.global_ids))
        out[t] = s.data[order].copy()
    return out
