"""Batched JAX implementation of cutadapt-equivalent locate().

Semantics: bit-identical to ``nano_orc.align.oracle.locate`` (see spec.py),
vectorized over [B reads x A adapters] on device. This is the demux compute
path; reference behavior being replaced: cutadapt's semi-global aligner as
driven by the reference's scripts/02_cutadapt_loop.sh:64-102.

Design notes
------------
* The column DP is a ``lax.fori_loop`` over read positions; state is
  [B, A, M+1] int32 — static shapes, no data-dependent control flow.
* The intra-column (vertical) dependency ``cur[i] = min(cand[i],
  cur[i-1]+1)`` (strict preference for ``cand`` on ties) is resolved with a
  Kogge-Stone (min,+) prefix scan on the index-adjusted cost ``v[i] =
  cand[i] - i`` with tie-to-**larger** index, which is provably equivalent
  to the sequential rule (a vertical step is taken only when strictly
  cheaper).
* cutadapt's error threshold ``errors <= e * effective_length`` is IEEE
  double math in the original; we precompute integer tables
  ``k_table[a, eff] = floor_f64(e * eff)`` on host so the device compares
  integers only — exact double semantics without enabling x64.
* NO gathers in the column loop. Row-m candidate
  fields are extracted with a one-hot masked reduction; table lookups
  keyed on runtime indices (refstart, eff) use one-hot compare+reduce;
  the STOP_WITHIN_SEQ1 final-column candidates are captured by
  snapshotting the column state where ``j == read_len`` and evaluated
  once after the scan.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .spec import Flag, DEFAULT_MIN_OVERLAP

BIG = 1 << 28


class LocateResult(NamedTuple):
    """Best location per (read, adapter); fields [B, A] int32.

    valid==0 rows have unspecified other fields. refstart/refstop/
    querystart/querystop follow spec.py conventions.

    ``nloc``/``nacc`` — hit-multiplicity evidence for the reorient
    fast path (demux/reorient.py): the number of RUNS of acceptable
    end columns (rising edges of the per-column acceptance series the
    scan already evaluates) and the total count of acceptable columns.
    Two acceptable locations with DISJOINT spans always either produce
    two runs or stretch one run wider than a single location can
    (span length >= len(adapter) - k), so ``nloc <= 1`` together with
    ``nacc <= len(adapter) - k`` proves the best hit is the ONLY
    disjoint acceptable location of that adapter — which is exactly
    the completeness precondition pychopper's enumeration establishes
    by masked re-scanning. Meaningful for STOP_WITHIN_SEQ2 modes
    (FRONT/INFIX); zeros on paths that don't compute them (the native
    small-batch shortcut, the BACK snapshot candidates).
    """
    valid: jnp.ndarray
    matches: jnp.ndarray
    errors: jnp.ndarray
    refstart: jnp.ndarray
    refstop: jnp.ndarray
    querystart: jnp.ndarray
    querystop: jnp.ndarray
    nloc: jnp.ndarray
    nacc: jnp.ndarray


def make_k_table(max_error_rate: float, ref_masks: np.ndarray,
                 ref_lens: np.ndarray) -> np.ndarray:
    """Host-side exact-double error-budget tables: [A, M+1] int32 with
    entry [a, eff] = floor(e * eff) in float64 (cutadapt's C-double
    semantics)."""
    A, M = ref_masks.shape
    eff = np.arange(M + 1, dtype=np.float64)
    row = np.floor(max_error_rate * eff).astype(np.int32)
    return np.broadcast_to(row, (A, M + 1)).copy()


def make_n_prefix(ref_masks: np.ndarray) -> np.ndarray:
    """[A, M+1] int32 prefix counts of N wildcards per adapter row."""
    is_n = (ref_masks & 0b1111) == 0b1111
    out = np.zeros((ref_masks.shape[0], ref_masks.shape[1] + 1), dtype=np.int32)
    np.cumsum(is_n, axis=1, out=out[:, 1:])
    return out


def _prefix_min_scan(v, matches, origin):
    """Inclusive prefix-min over the row axis (last), tie -> larger index."""
    R = v.shape[-1]
    d = 1
    while d < R:
        pad = [(0, 0)] * (v.ndim - 1) + [(d, 0)]
        sv = jnp.pad(v, pad, constant_values=BIG)[..., :R]
        sm = jnp.pad(matches, pad)[..., :R]
        so = jnp.pad(origin, pad)[..., :R]
        take = sv < v  # strictly cheaper only: tie keeps the later (current)
        v = jnp.where(take, sv, v)
        matches = jnp.where(take, sm, matches)
        origin = jnp.where(take, so, origin)
        d *= 2
    return v, matches, origin


def _onehot_lookup(table_bar, idx_ba):
    """table [1, A, R] x idx [B, A] -> [B, A] via one-hot reduce (no
    gather)."""
    R = table_bar.shape[-1]
    iota = jax.lax.broadcasted_iota(jnp.int32, (1, 1, R), 2)
    oh = (iota == idx_ba[:, :, None])
    return jnp.sum(jnp.where(oh, table_bar, 0), axis=2)


@functools.partial(jax.jit, static_argnames=("flags", "min_overlap"))
def batched_locate(ref_masks, ref_lens, k_table, n_prefix,
                   read_masks, read_lens,
                   flags: int, min_overlap: int = DEFAULT_MIN_OVERLAP
                   ) -> LocateResult:
    """Locate every adapter in every read.

    ref_masks [A, M] uint8, ref_lens [A] int32, k_table/n_prefix [A, M+1]
    int32, read_masks [B, L] uint8, read_lens [B] int32. ``flags`` static.
    """
    start_in_ref = bool(flags & Flag.START_WITHIN_SEQ1)
    start_in_qry = bool(flags & Flag.START_WITHIN_SEQ2)
    stop_in_ref = bool(flags & Flag.STOP_WITHIN_SEQ1)
    stop_in_qry = bool(flags & Flag.STOP_WITHIN_SEQ2)
    if start_in_ref and stop_in_ref:
        raise NotImplementedError(
            "START_WITHIN_SEQ1 + STOP_WITHIN_SEQ1 together are not used "
            "by any cutadapt adapter type (spec.py) and the snapshot "
            "evaluation assumes refstart==0 in the final-column scan")

    A, M = ref_masks.shape
    B, L = read_masks.shape
    R = M + 1

    ref_masks = ref_masks.astype(jnp.int32)
    read_masks = read_masks.astype(jnp.int32)
    ref_lens = ref_lens.astype(jnp.int32)
    read_lens = read_lens.astype(jnp.int32)
    k_table = k_table.astype(jnp.int32)[None]        # [1, A, R]
    n_prefix = n_prefix.astype(jnp.int32)[None]      # [1, A, R]

    rows = jax.lax.broadcasted_iota(jnp.int32, (1, 1, R), 2)
    onehot_m = (rows == ref_lens[None, :, None])     # [1, A, R] row-m mask

    # n_prefix at row m, per adapter: [1, A]
    n_pref_at_m = jnp.sum(jnp.where(onehot_m, n_prefix, 0), axis=2)

    # --- initial column (j = 0) -------------------------------------------
    if start_in_ref:
        cost0 = jnp.zeros((B, A, R), jnp.int32)
        origin0 = jnp.broadcast_to(-rows, (B, A, R))
    else:
        cost0 = jnp.broadcast_to(rows, (B, A, R)).astype(jnp.int32)
        origin0 = jnp.zeros((B, A, R), jnp.int32)
    matches0 = jnp.zeros((B, A, R), jnp.int32)

    m_row = ref_lens[None, :]                        # [1, A]
    lens_b = read_lens[:, None]                      # [B, 1]

    def row_m_fields(cost, matches, origin):
        """Extract row-m values per (b, a) with a masked reduce."""
        c = jnp.sum(jnp.where(onehot_m, cost, 0), axis=2)
        mt = jnp.sum(jnp.where(onehot_m, matches, 0), axis=2)
        og = jnp.sum(jnp.where(onehot_m, origin, 0), axis=2)
        return c, mt, og

    def eval_row_m_candidate(c, mt, og, j):
        """Acceptance test of the row-m candidate at column j (no
        gathers)."""
        refstart = jnp.maximum(-og, 0)
        length = m_row - refstart
        n_start = _onehot_lookup(n_prefix, refstart)
        eff = length - (n_pref_at_m - n_start)
        kmax = _onehot_lookup(k_table, jnp.clip(eff, 0, M))
        ok = (length >= min_overlap) & (c <= kmax) & (j <= lens_b)
        if not stop_in_qry:
            ok = ok & (j == lens_b)
        return ok

    # --- running best -----------------------------------------------------
    best0 = (
        jnp.zeros((B, A), jnp.bool_),                 # valid
        jnp.full((B, A), -1, jnp.int32),              # matches
        jnp.full((B, A), BIG, jnp.int32),             # errors
        jnp.zeros((B, A), jnp.int32),                 # origin
        jnp.zeros((B, A), jnp.int32),                 # qstop
    )

    def update_best(best, ok, mt, c, og, qstop):
        bvalid, bm, bc, bo, bq = best
        better = ok & ((mt > bm) | ((mt == bm) & (c < bc)))
        sel = lambda new, old: jnp.where(better, new, old)
        return (bvalid | better, sel(mt, bm), sel(c, bc), sel(og, bo),
                sel(qstop, bq))

    c0, m0, o0 = row_m_fields(cost0, matches0, origin0)
    ok0 = eval_row_m_candidate(c0, m0, o0, jnp.int32(0))
    best = update_best(best0, ok0, m0, c0, o0,
                       jnp.zeros((B, A), jnp.int32))
    # acceptable-column run counting (LocateResult.nloc/nacc docstring)
    ok0i = ok0.astype(jnp.int32)
    runs0 = (ok0i, ok0i, ok0i)  # (prev_ok, nloc, nacc)

    # snapshot of the column state at j == read_len (for STOP_WITHIN_SEQ1)
    snap0 = (cost0, matches0, origin0)

    def body(j, carry):
        cost, matches, origin, best, snap, runs = carry
        qc = jax.lax.dynamic_slice_in_dim(read_masks, j - 1, 1, axis=1)
        eq = (ref_masks[None] & qc[:, :, None]) != 0  # [B, A, M]

        if start_in_qry:
            r0c = jnp.zeros((B, A), jnp.int32)
            r0o = jnp.full((B, A), j, jnp.int32)
        else:
            r0c = jnp.full((B, A), j, jnp.int32)
            r0o = jnp.zeros((B, A), jnp.int32)
        r0m = jnp.zeros((B, A), jnp.int32)

        diag_c, diag_m, diag_o = cost[..., :M], matches[..., :M], origin[..., :M]
        horiz_c, horiz_m, horiz_o = cost[..., 1:], matches[..., 1:], origin[..., 1:]

        dc = jnp.where(eq, diag_c, diag_c + 1)
        dm = jnp.where(eq, diag_m + 1, diag_m)
        hc = horiz_c + 1
        use_h = hc < dc
        cand_c = jnp.where(use_h, hc, dc)
        cand_m = jnp.where(use_h, horiz_m, dm)
        cand_o = jnp.where(use_h, horiz_o, diag_o)

        full_c = jnp.concatenate([r0c[:, :, None], cand_c], axis=2)
        full_m = jnp.concatenate([r0m[:, :, None], cand_m], axis=2)
        full_o = jnp.concatenate([r0o[:, :, None], cand_o], axis=2)
        v = full_c - rows
        v, sm, so = _prefix_min_scan(v, full_m, full_o)
        ncost = v + rows
        nmatches, norigin = sm, so

        cm, mm, om = row_m_fields(ncost, nmatches, norigin)
        ok = eval_row_m_candidate(cm, mm, om, j)
        best = update_best(best, ok, mm, cm, om,
                           jnp.full((B, A), j, jnp.int32))
        prev_ok, nloc, nacc = runs
        oki = ok.astype(jnp.int32)
        runs = (oki, nloc + oki * (1 - prev_ok), nacc + oki)
        if stop_in_ref:
            at_end = (j == lens_b)[:, :, None]        # [B, 1, 1]
            snap = tuple(jnp.where(at_end, new, old)
                         for new, old in zip((ncost, nmatches, norigin),
                                             snap))
        return ncost, nmatches, norigin, best, snap, runs

    cost, matches, origin, best, snap, runs = jax.lax.fori_loop(
        1, L + 1, body, (cost0, matches0, origin0, best, snap0, runs0))

    bvalid, bm, bc, bo, bq = best

    if stop_in_ref:
        # evaluate all-row candidates ONCE on the snapshot (state at
        # j == read_len; for reads with len == 0 the snapshot is column 0,
        # matching the oracle's final-column scan on an empty read).
        scost, smatches, sorigin = snap
        row_ids = jnp.broadcast_to(rows, (B, A, R))
        refstart = jnp.maximum(-sorigin, 0)
        length = row_ids - refstart
        # refstart == 0 whenever START_WITHIN_SEQ1 is unset, which holds
        # for every STOP_WITHIN_SEQ1 user in spec.py (BACK/SUFFIX);
        # combining both flags is rejected below.
        eff = length - jnp.broadcast_to(n_prefix, (B, A, R))
        kmax = _ktable_by_eff(k_table, eff, M)
        okf = ((length >= min_overlap) & (scost <= kmax)
               & (row_ids <= ref_lens[None, :, None]))
        key = jnp.where(
            okf,
            ((M - smatches) << 16) + (jnp.minimum(scost, 255) << 8)
            + row_ids,
            BIG)
        kbest = jnp.min(key, axis=2)
        okb = kbest < BIG
        fm = M - (kbest >> 16)
        fc = (kbest >> 8) & 255
        frow = kbest & 255
        oh = (key == kbest[:, :, None]) & okf
        # first (smallest-row) argmin == decoded row; origin via one-hot
        fo = jnp.sum(jnp.where((row_ids == frow[:, :, None]) & oh,
                               sorigin, 0), axis=2)
        better = okb & ((fm > bm) | ((fm == bm) & (fc < bc)))
        sel = lambda new, old: jnp.where(better, new, old)
        bvalid = bvalid | better
        bm, bc, bo = sel(fm, bm), sel(fc, bc), sel(fo, bo)
        bq = sel(jnp.broadcast_to(lens_b, (B, A)), bq)
        brow = jnp.where(better, frow,
                         jnp.broadcast_to(m_row, (B, A)))
    else:
        brow = jnp.broadcast_to(m_row, (B, A))

    return LocateResult(
        valid=bvalid.astype(jnp.int32),
        matches=bm, errors=bc,
        refstart=jnp.maximum(-bo, 0), refstop=brow,
        querystart=jnp.maximum(bo, 0), querystop=bq,
        nloc=runs[1], nacc=runs[2],
    )


def revcomp_masks_device(read_masks, read_lens):
    """Reverse-complement match-mask rows on device.

    Complement permutes mask bits (A1<->T8, C2<->G4; N16 fixed); reversal
    of the variable-length prefix is a flip + per-row left-shift. Saves
    uploading the rc copy of every batch through the (slow) host->device
    link.
    """
    m = read_masks.astype(jnp.int32)
    comp = (((m & 1) << 3) | ((m & 8) >> 3) | ((m & 2) << 1)
            | ((m & 4) >> 1) | (m & 16))
    flipped = jnp.flip(comp, axis=1)
    L = read_masks.shape[1]

    def shift_row(row, ln):
        return jax.lax.dynamic_slice_in_dim(
            jnp.concatenate([row, jnp.zeros_like(row)]), L - ln, L)

    out = jax.vmap(shift_row)(flipped, read_lens.astype(jnp.int32))
    return out.astype(read_masks.dtype)


@functools.partial(jax.jit, static_argnames=("flags", "min_overlap"))
def batched_locate_with_rc(ref_masks, ref_lens, k_table, n_prefix,
                           read_masks, read_lens, flags: int,
                           min_overlap: int = DEFAULT_MIN_OVERLAP):
    """Run locate on each read and its reverse complement (the --rc path)
    with a single host->device upload. Returns (fwd, rc) LocateResults."""
    rc = revcomp_masks_device(jnp.asarray(read_masks),
                              jnp.asarray(read_lens))
    both = jnp.concatenate([jnp.asarray(read_masks), rc], axis=0)
    lens2 = jnp.concatenate([read_lens, read_lens])
    res = batched_locate(ref_masks, ref_lens, k_table, n_prefix,
                         both, lens2, flags, min_overlap)
    B = read_masks.shape[0]
    fwd = LocateResult(*[v[:B] for v in res])
    rcr = LocateResult(*[v[B:] for v in res])
    return fwd, rcr


def _ktable_by_eff(k_table, eff, M):
    """k_table [1, A, R] looked up at eff [B, A, R] — since k_table rows
    are the same floor(e*i) sequence for all adapters, clip+identity:
    floor(e*eff) == k_table[0, 0, eff]; use the monotone identity
    k_table value at index i equals floor(e*i), so lookup by eff equals
    building from eff directly is not possible without e... use take
    along the last axis once (post-loop, acceptable)."""
    kb = jnp.broadcast_to(k_table, eff.shape[:2] + (k_table.shape[-1],))
    return jnp.take_along_axis(kb, jnp.clip(eff, 0, M), axis=2)
