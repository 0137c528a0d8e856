"""Static analysis over post-SPMD compiled HLO text (a copy of
``repro.roofline.hlo``: plain Python over text, no framework).  The port
has no XLA; its dry run records collectives as they are issued and sums
their traffic with ``_wire_bytes`` under ``collective_summary``'s keys.

XLA's ``cost_analysis`` (and a naive text grep) counts a while-loop body
ONCE, but scan-over-layers puts almost all compute and every TP/EP
collective inside while bodies — so flat numbers undercount by the trip
count (we measured 100x on a 64-layer model).  This module parses the HLO
into computations, walks the while-loop call graph from ENTRY, extracts
each loop's trip count from its condition's comparison constant, and
accumulates collective traffic weighted by the product of enclosing trip
counts.

Trip-count extraction: a lowered ``lax.scan``'s condition is
``compare(get-tuple-element(iter), constant(N)), direction=LT`` — we take
the max integer constant in the condition computation (and record a
``trip_confidence`` flag when a condition has no constant, defaulting to 1).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Optional

_DTYPE_BYTES = {"f64": 8, "f32": 4, "f16": 2, "bf16": 2, "s64": 8, "u64": 8,
                "s32": 4, "u32": 4, "s16": 2, "u16": 2, "s8": 1, "u8": 1,
                "pred": 1, "c64": 8, "c128": 16, "f8e4m3fn": 1, "f8e5m2": 1}

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

_TY_RE = re.compile(r"\b(" + "|".join(_DTYPE_BYTES) + r")\[([0-9,]*)\]")
_COMP_HDR = re.compile(r"^(ENTRY\s+)?%?([\w\.\-]+)\s*\(.*\)\s*->.*{\s*$")
_WHILE_RE = re.compile(
    r"\bwhile\(.*?\),?.*?condition=%?([\w\.\-]+),.*?body=%?([\w\.\-]+)")
_WHILE_RE2 = re.compile(
    r"\bwhile\(.*?\),?.*?body=%?([\w\.\-]+),.*?condition=%?([\w\.\-]+)")
_CONST_RE = re.compile(r"constant\((\d+)\)")
_OP_RE = re.compile(r"=\s+(\(?[^()]*(?:\([^)]*\))?[^()=]*?)\s+([a-z\-]+)\(")
_GROUPS_IOTA_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")
_GROUPS_LIST_RE = re.compile(r"replica_groups=\{\{([0-9, ]+)\}")


def _type_bytes(m) -> int:
    dt, dims = m.groups()
    n = 1
    for d in dims.split(","):
        if d:
            n *= int(d)
    return n * _DTYPE_BYTES[dt]


@dataclasses.dataclass
class Computation:
    name: str
    is_entry: bool = False
    collectives: list = dataclasses.field(default_factory=list)  # (op,R,g)
    whiles: list = dataclasses.field(default_factory=list)       # (cond,body)
    max_const: int = 0


def parse_computations(text: str) -> dict:
    comps: dict[str, Computation] = {}
    cur: Optional[Computation] = None
    for line in text.splitlines():
        hdr = _COMP_HDR.match(line)
        if hdr:
            cur = Computation(name=hdr.group(2), is_entry=bool(hdr.group(1)))
            comps[cur.name] = cur
            continue
        if cur is None:
            continue
        ls = line.strip()
        if ls == "}":
            continue
        m = _WHILE_RE.search(ls) or None
        if m:
            cur.whiles.append((m.group(1), m.group(2)))
        else:
            m2 = _WHILE_RE2.search(ls)
            if m2:
                cur.whiles.append((m2.group(2), m2.group(1)))
        for c in _CONST_RE.finditer(ls):
            cur.max_const = max(cur.max_const, int(c.group(1)))
        om = _OP_RE.search(ls)
        if om:
            op = om.group(2)
            base = op[:-6] if op.endswith("-start") else op
            if base in COLLECTIVES and not op.endswith("-done"):
                restypes = om.group(1)
                R = sum(_type_bytes(t) for t in _TY_RE.finditer(restypes))
                if op.endswith("-start") and restypes.startswith("("):
                    R //= 2   # (operand, result) alias tuple
                g = _group_size(ls)
                cur.collectives.append((base, R, g))
    return comps


def _group_size(line: str) -> int:
    m = _GROUPS_IOTA_RE.search(line)
    if m:
        return int(m.group(2))
    m = _GROUPS_LIST_RE.search(line)
    if m:
        return len(m.group(1).split(","))
    return 0


def _wire_bytes(base: str, R: float, g: int) -> float:
    """Per-chip ring traffic for one collective with result bytes R."""
    g = max(g, 1)
    if base == "all-reduce":
        return 2.0 * R * (g - 1) / g
    if base in ("all-gather", "all-to-all"):
        return R * (g - 1) / g
    if base == "reduce-scatter":
        return R * (g - 1)
    return float(R)  # collective-permute


def collective_summary(text: str, default_group: int) -> dict:
    """Trip-count-weighted per-device collective traffic."""
    comps = parse_computations(text)
    entry = next((c for c in comps.values() if c.is_entry), None)
    if entry is None:
        return {"total_wire_bytes": 0.0, "error": "no ENTRY computation"}

    wire = {k: 0.0 for k in COLLECTIVES}
    result = {k: 0.0 for k in COLLECTIVES}
    counts = {k: 0.0 for k in COLLECTIVES}
    unknown_trip = [0]

    seen_stack = set()

    def visit(comp: Computation, mult: float):
        if comp.name in seen_stack:       # defensive: no recursion in HLO
            return
        seen_stack.add(comp.name)
        for base, R, g in comp.collectives:
            g = g or default_group
            wire[base] += mult * _wire_bytes(base, R, g)
            result[base] += mult * R
            counts[base] += mult
        for cond_name, body_name in comp.whiles:
            cond = comps.get(cond_name)
            trip = cond.max_const if (cond and cond.max_const > 0) else 1
            if cond is None or cond.max_const == 0:
                unknown_trip[0] += 1
            body = comps.get(body_name)
            if body is not None:
                visit(body, mult * trip)
        seen_stack.discard(comp.name)

    visit(entry, 1.0)
    return {
        "wire_bytes": wire,
        "result_bytes": result,
        "counts": counts,
        "total_wire_bytes": sum(wire.values()),
        "unknown_trip_conditions": unknown_trip[0],
    }


def while_trip_counts(text: str) -> list:
    """Debug helper: [(body_name, trip)] for every while in the module."""
    comps = parse_computations(text)
    out = []
    for c in comps.values():
        for cond_name, body_name in c.whiles:
            cond = comps.get(cond_name)
            out.append((body_name, cond.max_const if cond else -1))
    return out
