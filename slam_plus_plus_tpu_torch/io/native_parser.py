"""The C++ g2o reader (native/g2o_reader.cpp) under the port's parser.

Port of slam_plus_plus_tpu/io/native_parser.py.  The reader tokenizes and
parses the numbers of the whole file at C++ speed and returns columnar
records (kind, up to 3 ids, an offset into one value pool) in line order;
this module builds the GraphSystem from them with io/parser.py's
conventions: runs of the hot BA tokens (VERTEX_CAM, VERTEX_XYZ, EDGE_P2C)
go in through the graph's bulk insertion, every other record through the
Python parser's own per-line dispatch.

Unlike the JAX binding, :func:`parse_g2o_fast` has no fallback and no
hooks: the library is built with g++ at first use (ops/_build.py) and a
failed build raises; ``parse_g2o`` keeps the ``on_marker`` hook.  It never
returns a smaller graph than ``parse_g2o``: a line whose token the Python
parser reads and the C++ reader does not (the C++ table lacks the ternary
SE(3) hyperedge, for one) raises, naming the token.  Tokens neither reads
are counted in ``parse_stats.unknown_tokens``, as ``parse_g2o`` counts them.
"""

from __future__ import annotations

import ctypes
import functools
import sys
from typing import Dict

import numpy as np

from slam_plus_plus_tpu_torch.graph.system import GraphSystem
from slam_plus_plus_tpu_torch.io import parser as pyparser
from slam_plus_plus_tpu_torch.ops import _build

# token kinds, numbered as native/g2o_reader.cpp's TokenKind
(TK_UNKNOWN, TK_VERTEX2, TK_EDGE2, TK_LANDMARK2_XY, TK_LANDMARK2_RB,
 TK_VERTEX3, TK_EDGE3, TK_EDGE3_AXISANGLE, TK_VERTEX_XYZ, TK_LANDMARK3_XYZ,
 TK_VERTEX_CAM, TK_VERTEX_INTRINSICS, TK_VERTEX_SCAM, TK_VERTEX_SPHERON,
 TK_EDGE_P2C, TK_EDGE_P2CI, TK_EDGE_P2SC, TK_EDGE_SPHERON_XYZ,
 TK_ROCV_TRANSMITTER, TK_ROCV_TRANSMITTER_UF, TK_ROCV_RECEIVER,
 TK_ROCV_DELTA_TIME, TK_ROCV_RANGE, TK_CONSISTENCY_MARKER, TK_EQUIV,
 TK_COUNT) = range(26)

#: the C++ reader's token table (g2o_reader.cpp token_map): token -> (kind,
#: ids before the values)
TOKENS = {
    "VERTEX2": (TK_VERTEX2, 1), "VERTEX_SE2": (TK_VERTEX2, 1), "VERTEX": (TK_VERTEX2, 1),
    "EDGE2": (TK_EDGE2, 2), "EDGE_SE2": (TK_EDGE2, 2), "EDGE": (TK_EDGE2, 2),
    "ODOMETRY": (TK_EDGE2, 2),
    "LANDMARK2:XY": (TK_LANDMARK2_XY, 2), "EDGE_SE2_XY": (TK_LANDMARK2_XY, 2),
    "EDGE_BEARING_SE2_XY": (TK_LANDMARK2_XY, 2), "LANDMARK": (TK_LANDMARK2_XY, 2),
    "LANDMARK2:RB": (TK_LANDMARK2_RB, 2), "EDGE_SE2_RB": (TK_LANDMARK2_RB, 2),
    "EDGE_BEARING_SE2_RB": (TK_LANDMARK2_RB, 2),
    "VERTEX3": (TK_VERTEX3, 1), "VERTEX_SE3": (TK_VERTEX3, 1),
    "EDGE3": (TK_EDGE3, 2), "EDGE_SE3": (TK_EDGE3, 2),
    "EDGE3:AXISANGLE": (TK_EDGE3_AXISANGLE, 2), "EDGE_SE3:AXISANGLE": (TK_EDGE3_AXISANGLE, 2),
    "VERTEX_XYZ": (TK_VERTEX_XYZ, 1),
    "LANDMARK3:XYZ": (TK_LANDMARK3_XYZ, 2), "EDGE_SE3_XYZ": (TK_LANDMARK3_XYZ, 2),
    "VERTEX_CAM": (TK_VERTEX_CAM, 1), "VERTEX_INTRINSICS": (TK_VERTEX_INTRINSICS, 1),
    "VERTEX_SCAM": (TK_VERTEX_SCAM, 1), "VERTEX_SPHERON:QUAT": (TK_VERTEX_SPHERON, 1),
    "EDGE_PROJECT_P2MC": (TK_EDGE_P2C, 2), "EDGE_P2MC": (TK_EDGE_P2C, 2),
    "EDGE_P2C": (TK_EDGE_P2C, 2),
    "EDGE_PROJECT_P2MCI": (TK_EDGE_P2CI, 3), "EDGE_P2MCI": (TK_EDGE_P2CI, 3),
    "EDGE_P2CI": (TK_EDGE_P2CI, 3),
    "EDGE_PROJECT_P2SC": (TK_EDGE_P2SC, 2), "EDGE_P2SC": (TK_EDGE_P2SC, 2),
    "EDGE_SPHERON_XYZ": (TK_EDGE_SPHERON_XYZ, 2),
    "ROCV:TRANSMITTER": (TK_ROCV_TRANSMITTER, 1),
    "ROCV:TRANSMITTER_UF": (TK_ROCV_TRANSMITTER_UF, 1),
    "ROCV:RECEIVER": (TK_ROCV_RECEIVER, 1), "ROCV:RECEIVER_GTFAKE": (TK_ROCV_RECEIVER, 1),
    "ROCV:DELTA_TIME": (TK_ROCV_DELTA_TIME, 2), "ROCV:RANGE": (TK_ROCV_RANGE, 2),
    "CONSISTENCY_MARKER": (TK_CONSISTENCY_MARKER, 0),
    "EQUIV": (TK_EQUIV, 2), "PHASE": (TK_EQUIV, 0),
}
#: kind -> (its first token, that token's ids): what the per-record
#: dispatch hands the Python parser
_TOKEN_OF = {kind: (tok, n_ids) for tok, (kind, n_ids) in reversed(TOKENS.items())}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load_host("reader")
    vp = ctypes.c_void_p
    lib.spp_parse.restype = vp
    lib.spp_parse.argtypes = [ctypes.c_char_p]
    for fn in (lib.spp_num_records, lib.spp_num_values):
        fn.restype = ctypes.c_int64
        fn.argtypes = [vp]
    for fn in (lib.spp_copy_records, lib.spp_copy_values):
        fn.restype = None
        fn.argtypes = [vp, vp]
    lib.spp_stat.restype = ctypes.c_int64
    lib.spp_stat.argtypes = [vp, ctypes.c_int]
    lib.spp_free.restype = None
    lib.spp_free.argtypes = [vp]
    return lib


def read_records(path: str):
    """(records [N, 6] int32: kind, id0, id1, id2, value count, value
    offset; values, flat float64; {"lines", "unknown", "truncated"})."""
    lib = _lib()
    h = lib.spp_parse(path.encode())
    if not h:
        raise FileNotFoundError(path)
    try:
        records = np.empty((lib.spp_num_records(h), 6), dtype=np.int32)
        values = np.empty(lib.spp_num_values(h), dtype=np.float64)
        if len(records):
            lib.spp_copy_records(h, records.ctypes.data)
        if len(values):
            lib.spp_copy_values(h, values.ctypes.data)
        stats = {k: int(lib.spp_stat(h, i)) for i, k in enumerate(("lines", "unknown",
                                                                    "truncated"))}
    finally:
        lib.spp_free(h)
    return records, values, stats


def _python_reads(tok: str) -> bool:
    """Whether the Python parser dispatches a token (one it does not read
    lands in its unknown-token counts)."""
    stats = pyparser.ParseStats()
    try:
        pyparser._dispatch_line(tok, [], GraphSystem(), stats, False, False)
    except (IndexError, ValueError):
        return True
    return tok not in stats.unknown_tokens


def _unknown_tokens(path: str) -> Dict[str, int]:
    """Line counts of the tokens outside the C++ table, read the way the
    reader reads a line (comments and blank lines skipped, upper-cased);
    raises on any token the Python parser reads."""
    counts: Dict[str, int] = {}
    with open(path) as f:
        for line in f:
            s = line.strip()
            if not s or s.startswith(("#", "%", "//")):
                continue
            tok = s.split(None, 1)[0].upper()
            if tok not in TOKENS:
                counts[tok] = counts.get(tok, 0) + 1
    lost = {t: n for t, n in counts.items() if _python_reads(t)}
    if lost:
        raise ValueError(
            f"{path}: the C++ reader does not read " +
            ", ".join(f"{t} ({n} lines)" for t, n in lost.items()) +
            "; the Python parser does: parse this file with io.parser.parse_g2o")
    return counts


def _vals(records, values, rows, n):
    """n values of each record in rows: [len(rows), n]."""
    return values[records[rows, 5][:, None] + np.arange(n)]


def _new_ids(system, ids) -> bool:
    return (len(np.unique(ids)) == len(ids) and
            not any(int(g) in system.vertex_directory for g in ids))


def _ids_of(system, tname):
    store = system.vertex_stores.get(tname)
    return np.asarray(store.global_ids if store is not None else [], dtype=np.int64)


def _bulk(system, stats, kind, records, values, rows, is_ba) -> bool:
    """One run of a hot token through the bulk insertion, when it adds what
    per-line insertion would: new vertices, or edges whose vertices all
    exist with the edge's slot types.  False leaves the run to the
    per-record dispatch."""
    ids = records[rows, 1]
    if kind == TK_VERTEX_CAM and _new_ids(system, ids):
        v = _vals(records, values, rows, 12)
        pose = np.stack([pyparser._invert_cam_pose(r[0:3], *r[3:7]) for r in v])
        fx, fy, cx, cy, d = v[:, 7:12].T
        states = np.concatenate([pose, np.stack([fx, fy, cx, cy, d * 0.5 * (fx + fy)], 1)], 1)
        system.bulk_add_vertices("cam", ids, states)
        stats.vertices += len(rows)
        return True
    if kind == TK_VERTEX_XYZ and is_ba and _new_ids(system, ids):
        system.bulk_add_vertices("xyz", ids, _vals(records, values, rows, 3))
        stats.vertices += len(rows)
        return True
    if kind == TK_EDGE_P2C:
        # file order <point> <cam>; the edge's slots are (cam, point)
        vids = np.stack([records[rows, 2], ids], axis=1).astype(np.int64)
        if not (np.isin(vids[:, 0], _ids_of(system, "cam")).all() and
                np.isin(vids[:, 1], _ids_of(system, "xyz")).all()):
            return False
        v = _vals(records, values, rows, 5)
        info = np.stack([v[:, 2:4], v[:, 3:5]], axis=1)     # upper (a, b, c) -> [[a, b], [b, c]]
        system.bulk_add_edges("edge_p2c", vids, v[:, 0:2], info)
        stats.edges += len(rows)
        return True
    return False


def parse_g2o_fast(path: str) -> GraphSystem:
    """The file's GraphSystem through the C++ reader: equal to
    ``parse_g2o(path)`` (the same vertex order, stores and edge insertion
    log) or an error."""
    records, values, rstats = read_records(path)
    system = GraphSystem()
    stats = pyparser.ParseStats()
    stats.lines = rstats["lines"]
    if rstats["unknown"]:
        stats.unknown_tokens = _unknown_tokens(path)
    peek = pyparser.peek_dataset(path)
    is_ba = peek["has_ba"] or peek["has_stereo"] or peek["has_spheron"]

    kinds = records[:, 0]
    cuts = np.flatnonzero(np.diff(kinds)) + 1
    starts = np.concatenate([[0], cuts]) if len(kinds) else []
    for lo, hi in zip(starts, np.concatenate([cuts, [len(kinds)]])):
        kind = int(kinds[lo])
        rows = np.arange(lo, hi)
        if _bulk(system, stats, kind, records, values, rows, is_ba):
            continue
        tok, n_ids = _TOKEN_OF[kind]
        for r in rows.tolist():
            rec = records[r]
            off, n = int(rec[5]), int(rec[4])
            parts = [int(i) for i in rec[1:1 + n_ids]] + values[off:off + n].tolist()
            try:
                pyparser._dispatch_line(tok, parts, system, stats, is_ba, False)
            except (IndexError, ValueError) as e:
                # the Python parser reports such a line and goes on
                print(f"error: {tok} record {r}: {e}", file=sys.stderr)
    system.parse_stats = stats
    return system
