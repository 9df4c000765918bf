"""Fused dual-round demux: both cutadapt rounds in ONE device program.

The unfused path (demux.py) uploads round-1 masks, downloads trim
points, slices strings on host, re-encodes and uploads round-2 masks.
Here a single uint8 [B, L] batch is uploaded once; on device we
  1. reverse-complement (log-step shift, no gathers) and score round 1
     (FRONT, 12 SP5 adapters, fwd+rc) with the XLA locate
     (align/batched.py),
  2. pick the best (adapter, orientation) per read exactly like
     cutadapt --rc (max matches; forward wins ties; across adapters
     first-in-file wins ties),
  3. trim on device by left-shifting each read past its round-1
     querystop,
  4. score round 2 (BACK, 12 SP27-rc adapters, fwd+rc of the *trimmed*
     read) and pick again.
Only eight [B] int32 vectors return to host; host does string slicing
and file IO. Semantics are identical to running demux.assign_reads
twice (asserted by tests/test_fused.py against the unfused path, which
is itself oracle-parity-tested). The same ``dual_round`` body runs per
device under ``shard_map`` in dist/sharded.py.

Reference behavior replaced: 02_cutadapt_loop.sh round 1 (:64-72) +
round 2 (:91-103), both `--rc -e 0.1 --action=trim`.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..align.batched import batched_locate
from ..align.spec import BACK, FRONT
from ..io import encode
from ..io.fastq import Record
from .adapters import AdapterBank

#: batch rows are padded to a multiple of this (bounds compiled shapes)
ROWS = 256


class FusedDecision(NamedTuple):
    """Per-read demux decisions, all [B] int32 numpy."""
    idx1: np.ndarray     # round-1 adapter index (-1 = unknown)
    rc1: np.ndarray      # 1 if round 1 chose the reverse complement
    qe1: np.ndarray      # round-1 trim point (keep seq[qe1:]) in oriented coords
    idx2: np.ndarray     # round-2 adapter index (-1 = unknown)
    rc2: np.ndarray      # 1 if round 2 chose the rc of the trimmed read
    qs2: np.ndarray      # round-2 trim point (keep trimmed[:qs2])
    err1: np.ndarray     # round-1 match error count (cutadapt JSON report)
    err2: np.ndarray     # round-2 match error count


def _shift_left(x, s):
    """Left-shift each row of x [B, L] by s [B] (log-step rolls; values
    wrapped into the tail are garbage the locate kernel never reads
    because every acceptance test is gated on j <= len)."""
    L = x.shape[1]
    k = 0
    while (1 << k) < L:
        x = jnp.where(((s >> k) & 1)[:, None] != 0,
                      jnp.roll(x, -(1 << k), axis=1), x)
        k += 1
    return x


def _revcomp_rows(m, lens):
    """Reverse-complement mask rows [B, L] int32 on device (flip +
    variable left-shift; complement permutes the ACGT mask bits)."""
    comp = (((m & 1) << 3) | ((m & 8) >> 3) | ((m & 2) << 1)
            | ((m & 4) >> 1) | (m & 16))
    L = m.shape[1]
    return _shift_left(jnp.flip(comp, axis=1), L - lens)


def best_per_read(res):
    """cutadapt's across-adapter selection on a LocateResult [B, A]:
    max matches, first adapter in file order wins ties. Returns (idx
    [B] with -1 for none, matches, querystart, querystop, errors)."""
    matches = jnp.where(res.valid.astype(bool), res.matches, -1)
    idx = jnp.argmax(matches, axis=1).astype(jnp.int32)
    b = jnp.arange(matches.shape[0])
    best_m = matches[b, idx]
    idx = jnp.where(best_m < 0, -1, idx)
    safe = jnp.maximum(idx, 0)
    return (idx, best_m, res.querystart[b, safe], res.querystop[b, safe],
            res.errors[b, safe])


def _pick_orientation(res, B):
    """--rc: the reverse complement (rows B:) wins only with strictly
    more matches. Returns (use_rc, idx, querystart, querystop, errors)."""
    idx, m, qs, qe, e = best_per_read(res)
    use_rc = (m[B:] >= 0) & ((m[:B] < 0) | (m[B:] > m[:B]))
    pick = lambda x: jnp.where(use_rc, x[B:], x[:B])
    return use_rc, pick(idx), pick(qs), pick(qe), pick(e)


def dual_round(bank5, bank27, m32, lens):
    """Both cutadapt rounds for a batch of read masks [B, L] int32:
    round 1 FRONT over SP5 (fwd + rc), on-device trim past the round-1
    querystop, round 2 BACK over SP27-rc (fwd + rc of the trimmed
    read). ``bank*`` = (masks, lens, k_table, n_prefix). Returns the
    eight [B] int32 vectors of FusedDecision."""
    lens = lens.astype(jnp.int32)
    B = m32.shape[0]
    rc = _revcomp_rows(m32, lens)
    res = batched_locate(*bank5, jnp.concatenate([m32, rc]),
                         jnp.concatenate([lens, lens]), int(FRONT))
    use_rc1, idx1, _, qe1, err1 = _pick_orientation(res, B)
    qe1 = jnp.where(idx1 >= 0, qe1, 0)
    trimmed = _shift_left(jnp.where(use_rc1[:, None], rc, m32), qe1)
    lens_t = lens - qe1
    rc_t = _revcomp_rows(trimmed, lens_t)
    res2 = batched_locate(*bank27, jnp.concatenate([trimmed, rc_t]),
                          jnp.concatenate([lens_t, lens_t]), int(BACK))
    use_rc2, idx2, qs2, _, err2 = _pick_orientation(res2, B)
    # round 2 runs on the round-1 bins only (02_cutadapt_loop.sh:91-103)
    idx2 = jnp.where(idx1 >= 0, idx2, -1)
    qs2 =jnp.where(idx2 >= 0, jnp.maximum(qs2, 0), 0)
    err1 = jnp.where(idx1 >= 0, err1, 0)
    err2 = jnp.where(idx2 >= 0, err2, 0)
    return (idx1, use_rc1.astype(jnp.int32), qe1, idx2,
            use_rc2.astype(jnp.int32), qs2, err1, err2)


@jax.jit
def _fused_core(bank5, bank27, masks, lens):
    """masks [B, L] uint8, lens [B] -> stacked [8, B] decisions (one
    device->host transfer)."""
    return jnp.stack(dual_round(bank5, bank27, masks.astype(jnp.int32),
                                lens))


class FusedDemux:
    """Reusable fused dual-round demuxer for one (SP5, SP27-rc) bank pair.

    Each call uploads one uint8 batch and downloads eight [B] vectors.
    """

    def __init__(self, sp5: AdapterBank, sp27rc: AdapterBank):
        self.sp5, self.sp27 = sp5, sp27rc
        self._per_dev = {}  # device -> (bank5, bank27) arrays

    def _banks_on(self, dev=None):
        """Bank arrays committed to one device (cached: the bank
        replicates per device, SURVEY.md §2.4)."""
        if dev not in self._per_dev:
            put = (jnp.asarray if dev is None
                   else lambda x: jax.device_put(x, dev))
            self._per_dev[dev] = tuple(
                tuple(put(x) for x in (b.masks, b.lens, b.k_table,
                                       b.n_prefix))
                for b in (self.sp5, self.sp27))
        return self._per_dev[dev]

    def decide(self, masks: np.ndarray, lens: np.ndarray) -> FusedDecision:
        """masks [B0, L] uint8, lens [B0] -> FusedDecision (numpy)."""
        B0 = masks.shape[0]
        out = np.asarray(self._dispatch(masks, lens))
        return FusedDecision(*(out[k, :B0] for k in range(8)))

    def decide_multi(self, masks: np.ndarray, lens: np.ndarray,
                     devices) -> FusedDecision:
        """Multi-device demux decisions: batch rows striped over explicit
        devices, each stripe running the same fused program as
        ``decide`` committed to its device; all stripes dispatch before
        any fetch, so devices compute concurrently; host concatenates."""
        devices = list(devices)
        B0 = masks.shape[0]
        stripe = -(-B0 // len(devices))
        lazies = []
        for k, dev in enumerate(devices):
            r0, r1 = k * stripe, min((k + 1) * stripe, B0)
            if r0 >= r1:
                break
            lazies.append((r1 - r0, self._dispatch(masks[r0:r1],
                                                   lens[r0:r1], dev)))
        full = np.concatenate([np.asarray(o)[:, :n] for n, o in lazies],
                              axis=1)
        return FusedDecision(*(full[k] for k in range(8)))

    def assign(self, records: Sequence[Record], batch_size: int = 2048,
               max_len: int = 256):
        """Per read (rec_index, sp5_name|None, trimmed1 Record,
        sp27_name|None, final Record, rc1, err1, rc2, err2) — the exact
        per-read decisions of running demux.assign_reads for round 1
        then round 2. Host work is vectorized: one ascii gather per chunk
        in, one vectorized materialization out."""
        from collections import deque

        from .demux import materialize_batch
        recs = list(records)
        out = []
        # chunks pack + dispatch ahead of the fetches through a bounded
        # window (dispatch is asynchronous), so host materialization of
        # chunk k overlaps device compute of chunks k+1...; the window
        # bounds the read matrices staged on the device at once
        MAX_INFLIGHT = 8
        pending = deque()

        def _drain_one():
            s, chunk, lazy, B0, amat, lens = pending.popleft()
            full = np.asarray(lazy)
            d = FusedDecision(*(full[k, :B0] for k in range(8)))
            mat = materialize_batch(chunk, self.sp5.names,
                                    self.sp27.names, d.idx1, d.rc1,
                                    d.qe1, d.idx2, d.rc2, d.qs2,
                                    amat=amat, lens=lens)
            for i, dec in enumerate(mat):
                out.append((s + i,) + dec
                           + (bool(d.rc1[i]) and int(d.idx1[i]) >= 0,
                              int(d.err1[i]),
                              bool(d.rc2[i]) and int(d.idx2[i]) >= 0,
                              int(d.err2[i])))

        for s in range(0, len(recs), batch_size):
            chunk = recs[s:s + batch_size]
            amat, lens = encode.ascii_matrix(
                [r.seq for r in chunk],
                max_len=_pick_len(max((len(r.seq) for r in chunk),
                                      default=1), max_len))
            lazy = self._dispatch(encode.read_masks_matrix(amat, lens),
                                  lens)
            pending.append((s, chunk, lazy, len(chunk), amat, lens))
            if len(pending) >= MAX_INFLIGHT:
                _drain_one()
        while pending:
            _drain_one()
        return out

    def _dispatch(self, masks: np.ndarray, lens: np.ndarray, dev=None):
        """Upload + launch the fused program; returns the lazy [8, B]
        device array (no fetch)."""
        B0, L = masks.shape
        B = -(-B0 // ROWS) * ROWS
        if B != B0:
            masks = np.concatenate(
                [masks, np.zeros((B - B0, L), masks.dtype)])
            lens = np.concatenate([lens, np.zeros(B - B0, lens.dtype)])
        put = jnp.asarray if dev is None else (
            lambda x: jax.device_put(x, dev))
        b5, b27 = self._banks_on(dev)
        return _fused_core(b5, b27, put(masks),
                           put(np.asarray(lens, np.int32)))


def _pick_len(n: int, default_cap: int) -> int:
    """Bucket the padded length to bound device recompiles. The kernel
    column loop is O(L), so finer buckets around the COI amplicon range
    (300-900 bp + adapters) directly cut scan columns (384 saves 25% of
    the columns a 512 pad wastes on ~380 bp reads)."""
    for cap in (128, 256, 384, 512, 640, 768, 1024, 1536, 2048, 4096,
                8192):
        if n <= cap:
            return max(cap, default_cap) if cap <= default_cap else cap
    return encode.pad_to(n, 8192)
