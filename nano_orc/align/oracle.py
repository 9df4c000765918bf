"""Pure-Python definitional oracle for alignment semantics.

Two algorithm families, both definitional (clarity over speed — tests only):

* :func:`locate` — cutadapt-equivalent semi-global aligner per the spec in
  ``spec.py`` (reference usage: 02_cutadapt_loop.sh:64-102,
  04_cleaning_primers.sh:371-388).
* :func:`edit_distance` — edlib-equivalent unit-cost edit distance in
  NW/SHW/HW modes (reference usage: amplicon_sorter.py:225-235 ``distance``).

A faster C++ oracle with identical semantics lives in ``nano_orc/native``;
the batched JAX/Pallas device implementations are property-tested against
this module.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..io import encode
from .spec import Flag, Location, DEFAULT_MIN_OVERLAP


def _masks(seq, is_ref: bool) -> np.ndarray:
    if isinstance(seq, np.ndarray):
        return seq
    return encode.encode_ref_masks(seq) if is_ref else encode.encode_read_masks(seq)


def locate(reference, query, max_error_rate: float, flags: Flag,
           min_overlap: int = DEFAULT_MIN_OVERLAP) -> Optional[Location]:
    """Find the best location of ``reference`` (adapter) in ``query`` (read).

    Inputs may be ASCII strings or pre-encoded uint8 match-mask arrays
    (reference side via :func:`encode.encode_ref_masks`, query side via
    :func:`encode.encode_read_masks`).

    Returns the best :class:`Location` or None if no acceptable match.
    Semantics: see ``spec.py`` docstring (single source of truth).
    """
    ref = _masks(reference, True)
    qry = _masks(query, False)
    m, n = len(ref), len(qry)
    start_in_ref = bool(flags & Flag.START_WITHIN_SEQ1)
    start_in_qry = bool(flags & Flag.START_WITHIN_SEQ2)
    stop_in_ref = bool(flags & Flag.STOP_WITHIN_SEQ1)
    stop_in_qry = bool(flags & Flag.STOP_WITHIN_SEQ2)

    # prefix counts of 'N' wildcards in the reference (mask == all-match)
    is_n = (ref & 0b1111) == 0b1111
    n_prefix = np.zeros(m + 1, dtype=np.int64)
    np.cumsum(is_n, out=n_prefix[1:])

    # DP state per row i: cost, matches, origin
    cost = np.zeros(m + 1, dtype=np.int64)
    matches = np.zeros(m + 1, dtype=np.int64)
    origin = np.zeros(m + 1, dtype=np.int64)
    for i in range(1, m + 1):
        if start_in_ref:
            cost[i], matches[i], origin[i] = 0, 0, -i
        else:
            cost[i], matches[i], origin[i] = i, 0, 0

    best: Optional[Location] = None
    best_key = None  # (-matches, errors) lexicographic; first wins ties

    def consider(i: int, j: int, c: int, mt: int, og: int):
        nonlocal best, best_key
        refstart = -og if og < 0 else 0
        length = i - refstart
        if length < min_overlap:
            return
        eff = length - int(n_prefix[i] - n_prefix[refstart])
        if c > max_error_rate * eff:
            return
        key = (-mt, c)
        if best_key is None or key < best_key:
            qstart = og if og > 0 else 0
            best = Location(refstart, i, qstart, j, mt, c)
            best_key = key

    # column 0 candidate (row m): only meaningful for degenerate e >= 1
    consider(m, 0, int(cost[m]), int(matches[m]), int(origin[m]))

    for j in range(1, n + 1):
        qc = int(qry[j - 1])
        diag_c, diag_m, diag_o = int(cost[0]), int(matches[0]), int(origin[0])
        if start_in_qry:
            cost[0], matches[0], origin[0] = 0, 0, j
        else:
            cost[0], matches[0], origin[0] = j, 0, 0
        for i in range(1, m + 1):
            pc, pm, po = int(cost[i]), int(matches[i]), int(origin[i])  # (i, j-1)
            if ref[i - 1] & qc:
                nc, nm, no = diag_c, diag_m + 1, diag_o
            else:
                cd = diag_c + 1          # mismatch (diagonal)
                ch = pc + 1              # consume query char (horizontal)
                cv = int(cost[i - 1]) + 1  # consume ref char (vertical, current col)
                if cd <= ch and cd <= cv:
                    nc, nm, no = cd, diag_m, diag_o
                elif ch <= cv:
                    nc, nm, no = ch, pm, po
                else:
                    nc, nm, no = cv, int(matches[i - 1]), int(origin[i - 1])
            cost[i], matches[i], origin[i] = nc, nm, no
            diag_c, diag_m, diag_o = pc, pm, po
        if stop_in_qry or j == n:
            consider(m, j, int(cost[m]), int(matches[m]), int(origin[m]))
    if stop_in_ref:
        for i in range(0, m + 1):
            consider(i, n, int(cost[i]), int(matches[i]), int(origin[i]))
    return best


# ---------------------------------------------------------------------------
# edlib-equivalent edit distance (NW / SHW / HW)
# ---------------------------------------------------------------------------

def edit_distance(query, target, mode: str = "NW", use_iupac: bool = False) -> int:
    """Unit-cost edit distance with edlib mode conventions.

    * NW : global — both sequences fully aligned.
    * SHW: query fully aligned to a *prefix* of target (free target suffix).
    * HW : query fully aligned *within* target (free target prefix+suffix).

    ``use_iupac=False`` compares characters literally (the reference's
    amplicon_sorter ``distance()`` calls edlib without additionalEqualities,
    amplicon_sorter.py:232); ``use_iupac=True`` treats IUPAC wildcards as
    matching (used in its consensus path, :333-340).
    """
    if use_iupac:
        q = encode.encode_ref_masks(query) if isinstance(query, str) else query
        t = encode.encode_ref_masks(target) if isinstance(target, str) else target
        eq = (q[:, None] & t[None, :]) != 0
    else:
        q = encode.encode_codes(query) if isinstance(query, str) else query
        t = encode.encode_codes(target) if isinstance(target, str) else target
        eq = q[:, None] == t[None, :]
    mq, nt = len(q), len(t)
    prev = np.arange(nt + 1, dtype=np.int64)
    if mode in ("SHW", "HW"):
        pass  # free target prefix only applies to HW below
    if mode == "HW":
        prev = np.zeros(nt + 1, dtype=np.int64)
    cur = np.empty_like(prev)
    for i in range(1, mq + 1):
        cur[0] = i
        sub = prev[:-1] + (~eq[i - 1]).astype(np.int64)
        ins = prev[1:] + 1
        np.minimum(sub, ins, out=sub)
        # resolve horizontal chain cur[j] = min(sub[j], cur[j-1]+1) sequentially:
        c = int(cur[0])
        for j in range(1, nt + 1):
            c = min(int(sub[j - 1]), c + 1)
            cur[j] = c
        prev, cur = cur, prev
    if mode == "NW":
        return int(prev[nt])
    return int(prev.min())  # SHW / HW: free target suffix


def similarity(a: str, b: str, mode: str = "NW") -> float:
    """Reference similarity measure: round(1 - d/len(longer), 3)
    (amplicon_sorter.py:225-235)."""
    d = edit_distance(a, b, mode)
    return round(1.0 - d / max(len(a), len(b)), 3)
