"""GraphSystem — the typed columnar factor-graph container (numpy, host side).

Port of slam_plus_plus_tpu/graph/system.py (reference CFlatSystem,
include/slam/FlatSystem.h:1915): each vertex/edge type owns columnar numpy
arrays with amortized capacity doubling; edges auto-create missing vertices
through their type's initializer (reference r_Get_Vertex).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from slam_plus_plus_tpu_torch.models.types import EDGE_TYPES, VERTEX_TYPES, EdgeType, VertexType


class _VertexStore:
    def __init__(self, vtype: VertexType):
        self.vtype = vtype
        self.states = np.zeros((16, vtype.state_dim), dtype=np.float64)
        self.n = 0
        self.global_ids: List[int] = []

    def append(self, state: np.ndarray) -> int:
        if self.n == self.states.shape[0]:
            self.states = np.concatenate([self.states, np.zeros_like(self.states)])
        self.states[self.n] = state
        self.n += 1
        return self.n - 1

    @property
    def data(self) -> np.ndarray:
        return self.states[:self.n]


class _EdgeStore:
    def __init__(self, etype: EdgeType):
        self.etype = etype
        cap = 16
        self.vertex_ids = np.zeros((cap, etype.arity), dtype=np.int64)
        self.measurements = np.zeros((cap, etype.measurement_dim), dtype=np.float64)
        self.informations = np.zeros(
            (cap, etype.residual_dim, etype.residual_dim), dtype=np.float64)
        self.n = 0

    def append(self, vertex_ids, z, info) -> int:
        if self.n == self.vertex_ids.shape[0]:
            self.vertex_ids = np.concatenate([self.vertex_ids, np.zeros_like(self.vertex_ids)])
            self.measurements = np.concatenate([self.measurements, np.zeros_like(self.measurements)])
            self.informations = np.concatenate([self.informations, np.zeros_like(self.informations)])
        self.vertex_ids[self.n] = vertex_ids
        self.measurements[self.n] = z
        self.informations[self.n] = info
        self.n += 1
        return self.n - 1


class GraphSystem:
    """Factor graph with typed columnar storage and auto vertex creation."""

    def __init__(self):
        self.vertex_stores: Dict[str, _VertexStore] = {}
        self.edge_stores: Dict[str, _EdgeStore] = {}
        # global vertex id -> (type name, local index)
        self.vertex_directory: Dict[int, Tuple[str, int]] = {}
        # insertion order of global ids = the solver's block ordering
        self.vertex_order: List[int] = []
        self._edge_insert_log: List[Tuple[str, int]] = []  # (edge type, local idx)

    def add_vertex(self, global_id: int, type_name: str, state) -> None:
        """Explicit vertex insertion (a VERTEX_* line)."""
        if global_id in self.vertex_directory:
            # re-declaration updates the initial state in place (datasets may
            # list a vertex after an edge already auto-created it)
            tname, li = self.vertex_directory[global_id]
            self.vertex_stores[tname].states[li] = np.asarray(state, dtype=np.float64)
            return
        store = self.vertex_stores.setdefault(type_name, _VertexStore(VERTEX_TYPES[type_name]))
        li = store.append(np.asarray(state, dtype=np.float64))
        store.global_ids.append(global_id)
        self.vertex_directory[global_id] = (type_name, li)
        self.vertex_order.append(global_id)

    def vertex_state(self, global_id: int) -> np.ndarray:
        tname, li = self.vertex_directory[global_id]
        return self.vertex_stores[tname].states[li]

    def add_edge(self, type_name: str, vertex_ids: Sequence[int], z, info) -> None:
        """Insert an edge, auto-creating missing vertices via the edge type's
        initializer (reference r_Get_Vertex semantics)."""
        etype = EDGE_TYPES[type_name]
        vertex_ids = list(vertex_ids)
        if len(vertex_ids) != etype.arity:
            raise ValueError(f"edge {type_name} takes {etype.arity} vertices, "
                             f"got {len(vertex_ids)}")

        missing = [vid for vid in vertex_ids if vid not in self.vertex_directory]
        if missing:
            existing = tuple(
                self.vertex_state(vid) if vid in self.vertex_directory else None
                for vid in vertex_ids)
            if etype.initializer is None:
                raise ValueError(
                    f"edge {type_name}: vertices {missing} missing and no initializer")
            new_states = etype.initializer(existing, np.asarray(z, dtype=np.float64))
            for slot, vid in enumerate(vertex_ids):
                if vid not in self.vertex_directory:
                    self.add_vertex(vid, etype.vertex_types[slot], new_states[slot])

        for slot, vid in enumerate(vertex_ids):
            tname, _ = self.vertex_directory[vid]
            if tname != etype.vertex_types[slot]:
                raise TypeError(
                    f"edge {type_name} slot {slot}: vertex {vid} has type "
                    f"{tname}, expected {etype.vertex_types[slot]}")

        store = self.edge_stores.setdefault(type_name, _EdgeStore(etype))
        li = store.append(np.asarray(vertex_ids, dtype=np.int64),
                          np.asarray(z, dtype=np.float64),
                          np.asarray(info, dtype=np.float64))
        self._edge_insert_log.append((type_name, li))

    # ---- bulk insertion (the C++ reader's path) ------------------------

    def bulk_add_vertices(self, type_name: str, global_ids, states) -> None:
        """Append many new vertices of one type, as that many add_vertex
        calls would (the ids must be new and distinct)."""
        store = self.vertex_stores.setdefault(type_name, _VertexStore(VERTEX_TYPES[type_name]))
        n_new = len(global_ids)
        need = store.n + n_new
        if need > store.states.shape[0]:
            grown = np.zeros((max(need, 2 * store.states.shape[0]), store.states.shape[1]))
            grown[:store.n] = store.states[:store.n]
            store.states = grown
        store.states[store.n:need] = states
        ids = [int(g) for g in global_ids]
        store.global_ids.extend(ids)
        self.vertex_directory.update(zip(ids, ((type_name, li) for li in range(store.n, need))))
        self.vertex_order.extend(ids)
        store.n = need

    def bulk_add_edges(self, type_name: str, vertex_ids, z, info) -> None:
        """Append many edges of one type, as that many add_edge calls would
        when every vertex exists with the edge's slot types (nothing is
        auto-created here)."""
        etype = EDGE_TYPES[type_name]
        store = self.edge_stores.setdefault(type_name, _EdgeStore(etype))
        E = len(vertex_ids)
        base, need = store.n, store.n + E
        if need > store.vertex_ids.shape[0]:
            cap = max(need, 2 * store.vertex_ids.shape[0])

            def grow(a):
                g = np.zeros((cap,) + a.shape[1:], dtype=a.dtype)
                g[:base] = a[:base]
                return g
            store.vertex_ids = grow(store.vertex_ids)
            store.measurements = grow(store.measurements)
            store.informations = grow(store.informations)
        store.vertex_ids[base:need] = vertex_ids
        store.measurements[base:need] = z
        store.informations[base:need] = info
        store.n = need
        self._edge_insert_log.extend((type_name, li) for li in range(base, need))

    @property
    def num_vertices(self) -> int:
        return len(self.vertex_order)

    @property
    def num_edges(self) -> int:
        return len(self._edge_insert_log)
