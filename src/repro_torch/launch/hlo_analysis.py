"""Trip-count-corrected cost extraction from partitioned HLO text.

A verbatim copy of ``repro/launch/hlo_analysis.py`` (it reads text only).

XLA's ``HloCostAnalysis`` (behind ``compiled.cost_analysis()``) visits
every computation once — a ``lax.scan`` body (while loop) is counted a
single time regardless of trip count, so scanned-layer models report
~L× too few FLOPs.  This module re-derives costs from ``as_text()``:

1. split the module into computations;
2. build the call graph (``body=``/``condition=``/``calls=``/``to_apply=``);
3. recover each while's trip count from the integer constant in its
   condition computation (jax lowers scan to ``i < trip``);
4. multiplier(comp) = Σ over call sites of multiplier(caller) x trip;
5. FLOPs: ``dot``/``convolution`` ops — 2 x |result| x contraction size
   (elementwise flops are ignored: matmul-dominated modules, documented);
6. HBM-traffic proxy: Σ (result + operand bytes) over instructions at
   fusion boundaries (parameters/tuples/gtes/bitcasts/copies excluded)
   — pessimistic for TPU (CPU fusions are smaller), documented;
7. collective bytes by op kind, trip-corrected.

All shapes in partitioned HLO are per-partition => every number here is
per-device.
"""
from __future__ import annotations

import math
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16, "f8e4m3fn": 1, "f8e5m2": 1, "token": 0,
    "f8e4m3": 1, "f8e5m2fnuz": 1, "f8e4m3fnuz": 1,
}
_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_DEF_RE = re.compile(r"^\s*(?:ROOT\s+)?%([\w.\-]+)\s*=\s*(.*)$")
_CALL_ATTR_RE = re.compile(r"(?:body|condition|calls|to_apply)=%([\w.\-]+)")
_WHILE_RE = re.compile(r"while\(.*\), condition=%([\w.\-]+), body=%([\w.\-]+)")
_OPERAND_RE = re.compile(r"%([\w.\-]+)")
_CONST_RE = re.compile(r"constant\((\d+)\)")
_COLL_KINDS = (
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
    "collective-permute",
)
_SKIP_OPS = (
    "parameter(", "get-tuple-element(", "tuple(", "constant(", "bitcast(",
    "after-all(", "partition-id(", "replica-id(", "iota(",
)


def _shape_bytes(text: str) -> int:
    total = 0
    for dt, dims in _SHAPE_RE.findall(text):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def _shape_dims(text: str) -> List[Tuple[str, List[int]]]:
    out = []
    for dt, dims in _SHAPE_RE.findall(text):
        if dt in _DTYPE_BYTES:
            out.append((dt, [int(d) for d in dims.split(",")] if dims else []))
    return out


@dataclass
class Computation:
    name: str
    lines: List[str] = field(default_factory=list)
    result_bytes: Dict[str, int] = field(default_factory=dict)
    result_dims: Dict[str, List[int]] = field(default_factory=dict)


def split_computations(hlo: str) -> Dict[str, Computation]:
    comps: Dict[str, Computation] = {}
    cur: Optional[Computation] = None
    for line in hlo.splitlines():
        if cur is None:
            m = re.match(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s*\(.*\)\s*->.*{", line)
            if m:
                cur = Computation(name=m.group(1))
            continue
        if line.startswith("}"):
            comps[cur.name] = cur
            cur = None
            continue
        cur.lines.append(line)
        d = _DEF_RE.match(line)
        if d:
            name = d.group(1)
            head = d.group(2).split("(", 1)[0]
            cur.result_bytes[name] = _shape_bytes(head)
            shapes = _shape_dims(head)
            cur.result_dims[name] = shapes[0][1] if len(shapes) == 1 else []
    return comps


def _while_trip(cond: Computation) -> int:
    """Trip bound = the max integer constant in the condition body."""
    best = 1
    for line in cond.lines:
        for c in _CONST_RE.findall(line):
            best = max(best, int(c))
    return best


def compute_multipliers(comps: Dict[str, Computation]) -> Dict[str, float]:
    """multiplier(comp) = Σ_callsites multiplier(caller) * weight."""
    entry = None
    called = set()
    calls: Dict[str, List[Tuple[str, float]]] = {c: [] for c in comps}
    for cname, comp in comps.items():
        for line in comp.lines:
            wm = _WHILE_RE.search(line)
            if wm:
                cond_name, body_name = wm.group(1), wm.group(2)
                trip = _while_trip(comps[cond_name]) if cond_name in comps else 1
                if body_name in comps:
                    calls[body_name].append((cname, float(trip)))
                    called.add(body_name)
                if cond_name in comps:
                    calls[cond_name].append((cname, float(trip)))
                    called.add(cond_name)
                continue
            for callee in _CALL_ATTR_RE.findall(line):
                if callee in comps:
                    calls[callee].append((cname, 1.0))
                    called.add(callee)
    roots = [c for c in comps if c not in called]
    mult: Dict[str, float] = {}

    def visit(c: str, seen) -> float:
        if c in mult:
            return mult[c]
        if c in seen:  # recursion guard (shouldn't happen in HLO)
            return 1.0
        seen = seen | {c}
        if c in [r for r in roots]:
            mult[c] = 1.0
            return 1.0
        total = 0.0
        for caller, w in calls[c]:
            total += visit(caller, seen) * w
        mult[c] = total if total > 0 else 1.0
        return mult[c]

    for c in comps:
        visit(c, frozenset())
    return mult


def _dot_flops(comp: Computation, line: str) -> float:
    d = _DEF_RE.match(line)
    if not d:
        return 0.0
    body = d.group(2)
    head = body.split("(", 1)[0]
    result_shapes = _shape_dims(head)
    if not result_shapes:
        return 0.0
    result_elems = math.prod(result_shapes[0][1]) if result_shapes[0][1] else 1
    # contraction size from lhs operand + lhs_contracting_dims
    ops = _OPERAND_RE.findall(body.split("(", 1)[1].split(")", 1)[0])
    lhs_dims = comp.result_dims.get(ops[0], []) if ops else []
    m = re.search(r"lhs_contracting_dims={([\d,]*)}", line)
    contract = 1
    if m and lhs_dims:
        for idx in m.group(1).split(","):
            if idx != "" and int(idx) < len(lhs_dims):
                contract *= lhs_dims[int(idx)]
    return 2.0 * result_elems * contract


@dataclass
class HloCost:
    flops: float = 0.0
    traffic_bytes: float = 0.0
    collectives: Dict[str, float] = field(default_factory=dict)
    n_while: int = 0
    max_trip: int = 1

    @property
    def collective_total(self) -> float:
        return sum(self.collectives.values())


def analyze_hlo(hlo: str) -> HloCost:
    comps = split_computations(hlo)
    mult = compute_multipliers(comps)
    cost = HloCost(collectives={k: 0.0 for k in _COLL_KINDS})
    for cname, comp in comps.items():
        m = mult.get(cname, 1.0)
        for line in comp.lines:
            d = _DEF_RE.match(line)
            if not d:
                continue
            body = d.group(2)
            if " dot(" in line or body.startswith("dot("):
                cost.flops += m * _dot_flops(comp, line)
            if "while(" in body:
                cost.n_while += 1
            for kind in _COLL_KINDS:
                if re.search(r"\b" + kind + r"(-start)?\(", body):
                    b = comp.result_bytes.get(d.group(1), 0)
                    if kind + "-start(" in body:
                        b //= 2  # start tuples carry (input, output)
                    if "-done(" not in body:
                        cost.collectives[kind] += m * b
                    break
            # HBM traffic proxy at fusion boundaries
            if not any(s in body for s in _SKIP_OPS):
                rb = comp.result_bytes.get(d.group(1), 0)
                ob = 0
                inner = body.split("(", 1)[1].split(")", 1)[0] if "(" in body else ""
                for op in _OPERAND_RE.findall(inner):
                    ob += comp.result_bytes.get(op, 0)
                cost.traffic_bytes += m * (rb + ob)
    for c in comps.values():
        pass
    cost.max_trip = int(max([_while_trip(c) for c in comps.values()] + [1]))
    return cost
