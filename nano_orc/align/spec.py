"""Semi-global alignment location specs (cutadapt-equivalent semantics).

The reference pipeline's demultiplexing and primer trimming are defined by
cutadapt v4.9's ``locate()`` semi-global aligner (invoked at
the reference's scripts/02_cutadapt_loop.sh:64-102 and
04_cleaning_primers.sh:371-388). We re-specify those semantics here as an
explicit flag algebra; every implementation in this package (Python oracle,
C++ oracle, batched JAX, Pallas) follows this one definition:

Alignment of a *reference* (adapter/primer, length m) against a *query*
(read, length n) with unit costs (mismatch/insertion/deletion = 1).
Flags declare which sequence ends may be skipped at zero cost:

    START_WITHIN_SEQ1  alignment may start at refstart  > 0 (skip adapter prefix)
    START_WITHIN_SEQ2  alignment may start at querystart> 0 (skip read prefix)
    STOP_WITHIN_SEQ1   alignment may end   at refstop   < m (skip adapter suffix)
    STOP_WITHIN_SEQ2   alignment may end   at querystop < n (skip read suffix)

Adapter types (matching cutadapt):

    FRONT (-g, regular 5'):  START_WITHIN_SEQ1 | START_WITHIN_SEQ2 | STOP_WITHIN_SEQ2
        adapter 3' end must be aligned; trim read[:querystop].
    BACK  (-a, regular 3'):  START_WITHIN_SEQ2 | STOP_WITHIN_SEQ1 | STOP_WITHIN_SEQ2
        adapter 5' end must be aligned; trim read[querystart:].
    PREFIX (anchored 5'):    STOP_WITHIN_SEQ2
    SUFFIX (anchored 3'):    START_WITHIN_SEQ2

Acceptance of a candidate alignment covering ref[refstart:refstop]:

    length     = refstop - refstart
    eff_length = length - (# of 'N' chars in ref[refstart:refstop])
    accept iff length >= min_overlap and errors <= max_error_rate * eff_length

Best-match selection among accepted candidates (cutadapt order): maximize
``matches``; ties broken by smaller ``errors``; remaining ties by earliest
candidate in scan order (columns j = 0..n left to right, then — only when
STOP_WITHIN_SEQ1 — the final column scanned by increasing row).

DP tie-breaking inside a cell (affects matches/origin bookkeeping, hence
results): on equal cost prefer diagonal (mismatch), then horizontal
(consume query char), then vertical (consume reference char).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Optional


class Flag(enum.IntFlag):
    START_WITHIN_SEQ1 = 1
    START_WITHIN_SEQ2 = 2
    STOP_WITHIN_SEQ1 = 4
    STOP_WITHIN_SEQ2 = 8


FRONT = Flag.START_WITHIN_SEQ1 | Flag.START_WITHIN_SEQ2 | Flag.STOP_WITHIN_SEQ2
BACK = Flag.START_WITHIN_SEQ2 | Flag.STOP_WITHIN_SEQ1 | Flag.STOP_WITHIN_SEQ2
PREFIX = Flag.STOP_WITHIN_SEQ2
SUFFIX = Flag.START_WITHIN_SEQ2

DEFAULT_MIN_OVERLAP = 3  # cutadapt default minimum overlap


@dataclass(frozen=True)
class Location:
    """Result of a locate() call (cutadapt's match tuple)."""
    refstart: int
    refstop: int
    querystart: int
    querystop: int
    matches: int
    errors: int

    def astuple(self):
        return (self.refstart, self.refstop, self.querystart, self.querystop,
                self.matches, self.errors)


Match = Optional[Location]
