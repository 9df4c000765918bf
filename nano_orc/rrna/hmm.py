"""Profile-HMM scoring on device (barrnap/nhmmer-equivalent core).

The reference pipeline locates 18S/28S eukaryotic rRNA with barrnap
(Perl + nhmmer HMM scan, 05a_barrnap_rRNA_extract.sh:70-72). Its HMM
database is external to the repo; this module provides the equivalent
*capability* on the device:

* :func:`parse_hmmer3` — load a HMMER3 .hmm file (DNA profile), e.g.
  barrnap's euk models, into dense emission/transition score arrays;
* :func:`profile_from_seqs` — build a profile from example gene sequences
  (star-alignment pileup -> per-column emission frequencies), so users
  without HMM files can construct 18S/28S models from a few references;
* :func:`viterbi_scan` — batched local (glocal-free) Viterbi over contigs
  on device. The per-position D-state chain (D[k] -> D[k+1]) is resolved
  with the same Kogge-Stone (max,+) prefix scan used by the locate kernel
  — no data-dependent control flow, fixed shapes.

Scores are natural-log odds vs a 0.25-uniform background.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

NEG = -1e9
DD_FLOOR = -30.0  # finite clamp for 'impossible' D->D (see _viterbi_kernel)


@dataclass
class ProfileHMM:
    name: str
    match_scores: np.ndarray   # [K, 4] log-odds emission scores (A C G T)
    t: np.ndarray              # [K, 7] log transition (MM MI MD IM II DM DD)
    insert_scores: Optional[np.ndarray] = None  # [K, 4], default zeros (bg)

    @property
    def K(self) -> int:
        return self.match_scores.shape[0]


# ---------------------------------------------------------------------------
# HMMER3 parser (HMMER3/f DNA profiles, e.g. barrnap's euk.hmm entries)
# ---------------------------------------------------------------------------

def parse_hmmer3(path: str) -> List[ProfileHMM]:
    """Parse all models in a HMMER3 .hmm text file (DNA alphabet).

    Verified against the real HMMER3/f layout (HMMER User Guide "HMM
    file format"; tests/fixtures/gen_euk_hmm_fixture.py writes a
    full-annotation multi-model fixture):

    * header block: NAME/ACC/DESC/LENG/MAXL/ALPH/RF/MM/CONS/CS/MAP/
      DATE/COM/NSEQ/EFFN/CKSUM/STATS/GA/TC/NC lines in any order;
    * ``HMM  A  C  G  T`` alphabet line (DNA enforced — protein models
      are rejected, not silently mis-read) + the transition-name line;
    * optional COMPO line; node-0 insert-emission + transition lines;
    * per node: match-emission line ``k  eA eC eG eT  MAP CONS RF MM
      CS`` (annotation columns present or absent), insert-emission
      line, 7-column transition line; node indices are VERIFIED;
    * ``*`` = -inf (zero probability; e.g. the last node's m->d/d->d).

    HMMER stores negative natural-log probabilities. Emission scores
    are converted to log-odds against the 0.25 background.
    """
    models = []
    with open(path) as fh:
        lines = fh.read().splitlines()
    i = 0
    while i < len(lines):
        if not lines[i].startswith("HMMER3"):
            i += 1
            continue
        name = "model"
        K = 0
        while i < len(lines) and not lines[i].strip().startswith("HMM "):
            if lines[i].startswith("NAME"):
                name = lines[i].split()[1]
            if lines[i].startswith("LENG"):
                K = int(lines[i].split()[1])
            i += 1
        if i >= len(lines):
            raise ValueError(f"{path}: model {name!r}: no HMM table")
        if K <= 0:
            raise ValueError(f"{path}: model {name!r}: missing LENG")
        alpha = lines[i].split()[1:]
        if alpha[:4] != ["A", "C", "G", "T"]:
            raise ValueError(
                f"{path}: model {name!r}: not a DNA profile "
                f"(alphabet {alpha[:4]})")
        # "HMM A C G T" line + transition-name line
        i += 2
        def val(tok: str) -> float:
            return NEG if tok == "*" else -float(tok)
        # optional COMPO line (average match emissions)
        if i < len(lines) and lines[i].strip().startswith("COMPO"):
            i += 1
        # node 0: insert emissions + begin transitions
        i += 2
        match = np.zeros((K, 4))
        trans = np.full((K, 7), NEG)
        for k in range(K):
            toks = lines[i].split()
            if not toks or toks[0] != str(k + 1):
                raise ValueError(
                    f"{path}: model {name!r}: expected node {k + 1} "
                    f"match line, got: {lines[i]!r}")
            ems = [val(t) for t in toks[1:5]]
            match[k] = [e - math.log(0.25) for e in ems]
            i += 1
            i += 1  # insert emissions (background in practice)
            toks = lines[i].split()
            if len(toks) < 7:
                raise ValueError(
                    f"{path}: model {name!r}: node {k + 1} transition "
                    f"line has {len(toks)} columns, expected 7")
            trans[k] = [val(t) for t in toks[:7]]
            i += 1
        models.append(ProfileHMM(name, match, trans))
        while i < len(lines) and not lines[i].startswith("//"):
            i += 1
        i += 1
    return models


# ---------------------------------------------------------------------------
# Profile builder from example sequences
# ---------------------------------------------------------------------------

def profile_from_seqs(seq_codes: Sequence[np.ndarray], name: str = "profile",
                      pseudocount: float = 1.0,
                      p_gap: float = 0.05) -> ProfileHMM:
    """Build a profile from example gene sequences via star-alignment
    pileup (no external MSA tool). Columns with majority-gap are treated
    as insert states and dropped from the match profile."""
    from ..cluster.consensus import _align_rows, build_consensus

    cons = build_consensus(list(seq_codes))
    aln = _align_rows(cons, list(seq_codes))  # [n+1, W], GAP=255
    n = aln.shape[0]
    keep = (aln != 255).sum(axis=0) > n / 2
    cols = aln[:, keep]
    K = cols.shape[1]
    match = np.zeros((K, 4))
    for b in range(4):
        match[:, b] = (cols == b).sum(axis=0)
    freq = (match + pseudocount) / (match.sum(axis=1, keepdims=True)
                                    + 4 * pseudocount)
    match_scores = np.log(freq) - math.log(0.25)
    lg = math.log(p_gap)
    l1 = math.log(1 - 2 * p_gap)
    lstay = math.log(0.5)
    t = np.tile(np.array([l1, lg, lg,            # MM MI MD
                          lstay, lstay,          # IM II
                          lstay, lstay]),        # DM DD
                (K, 1))
    return ProfileHMM(name, match_scores, t)


# ---------------------------------------------------------------------------
# Batched local Viterbi on device
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("K",))
def _viterbi_kernel(match_s, trans, seqs, lens, K: int):
    """Local Viterbi: alignment may start/end at any model/sequence
    position. seqs [B, L] uint8 codes (pad 4). Returns (best_score [B],
    best_end_pos [B], best_end_node [B])."""
    B, L = seqs.shape
    MM, MI, MD, IM, II, DM, DD = [trans[:, i] for i in range(7)]
    # Position-dependent D->D chain: clamp 'impossible' (-1e9) DD to a
    # finite floor so prefix sums stay in float32 range/precision; a
    # -30 nat per-node penalty (~1e-13 probability) is below any real
    # path's tolerance. The same clamp is applied by the host reference
    # (viterbi_host) so kernel/host parity is exact.
    DDc = jnp.maximum(DD, DD_FLOOR)
    # S[k] = sum_{t<k} DD[t]; chain cost k'->k is S[k] - S[k']
    S = jnp.concatenate([jnp.zeros(1), jnp.cumsum(DDc[:-1])])

    m0 = jnp.full((B, K), NEG)
    i0 = jnp.full((B, K), NEG)
    best0 = jnp.full((B,), NEG)
    bpos0 = jnp.zeros((B,), jnp.int32)
    bnode0 = jnp.zeros((B,), jnp.int32)

    def shift1(x):  # shift along model axis: out[k] = x[k-1]
        return jnp.pad(x, ((0, 0), (1, 0)), constant_values=NEG)[:, :K]

    def step(carry, inp):
        M, I, best, bpos, bnode = carry
        c, j = inp  # c [B] codes, j scalar position (1-based)
        em = jnp.where(c[:, None] < 4,
                       jnp.take(match_s, jnp.minimum(c, 3), axis=1).T,
                       0.0)  # N/pad emits background (score 0)
        # candidates into M[k] (before D-chain): from M[k-1], I[k-1], start
        prevM = shift1(M)
        prevI = shift1(I)
        fromM = prevM + shift1(MM[None, :].repeat(B, 0))
        fromI = prevI + shift1(IM[None, :].repeat(B, 0))
        start = jnp.zeros((B, K))  # local: free start at any node
        base = jnp.maximum(jnp.maximum(fromM, fromI), start)
        # D-chain: Mnew[k] can also come via a run of D states entered at
        # some k' <= k: D[k] = max_{k'<=k}(entry[k'] + sum_{t=k'}^{k-1}
        # DD[t]). With prefix sums S this is a (max,+) Kogge-Stone scan
        # on (entry - S), exact for POSITION-DEPENDENT DD (HMMER3 models
        # have per-node DD; the old constant-DD form was only correct
        # for profile_from_seqs output).
        entry = shift1(M + MD[None, :].repeat(B, 0))  # D[k] entered at k
        v = entry - S[None, :]
        v = jax.lax.associative_scan(jnp.maximum, v, axis=1)
        dpath = v + S[None, :] + DM[None, :]
        cand = jnp.maximum(base, shift1(dpath))
        Mn = cand + em
        # I states: stay or enter
        In = jnp.maximum(M + MI[None, :], I + II[None, :])
        valid = (j <= lens)[:, None]
        Mn = jnp.where(valid, Mn, M)
        In = jnp.where(valid, In, I)
        # local end: best M anywhere
        mrow = jnp.max(Mn, axis=1)
        node = jnp.argmax(Mn, axis=1).astype(jnp.int32)
        better = (mrow > best) & (j <= lens)
        best = jnp.where(better, mrow, best)
        bpos = jnp.where(better, j, bpos)
        bnode = jnp.where(better, node, bnode)
        return (Mn, In, best, bpos, bnode), None

    cols = seqs.T.astype(jnp.int32)
    js = jnp.arange(1, L + 1, dtype=jnp.int32)
    (M, I, best, bpos, bnode), _ = jax.lax.scan(
        step, (m0, i0, best0, bpos0, bnode0), (cols, js))
    return best, bpos, bnode


def viterbi_host(profile: ProfileHMM, seq_codes: np.ndarray
                 ) -> Tuple[float, int, int]:
    """Naive host Viterbi (float64 numpy), the parity reference for
    :func:`_viterbi_kernel`. Same local semantics: free start at any
    node, best M anywhere is the end; N emits background (0); DD uses
    the same finite clamp. Returns (score, end_pos_1based, end_node)."""
    ms = profile.match_scores.astype(np.float64)
    t = profile.t.astype(np.float64)
    K = profile.K
    MM, MI, MD, IM, II, DM, DD = [t[:, i] for i in range(7)]
    DDc = np.maximum(DD, DD_FLOOR)
    M = np.full(K, NEG)
    I = np.full(K, NEG)
    best, bpos, bnode = NEG, 0, 0
    seq = np.asarray(seq_codes)
    for j, c in enumerate(seq, start=1):
        em = ms[:, int(c)] if c < 4 else np.zeros(K)
        # D states from the previous column's M (no emission)
        D = np.full(K, NEG)
        for k in range(1, K):
            entry = M[k - 1] + MD[k - 1]
            chain = D[k - 1] + DDc[k - 1]
            D[k] = max(entry, chain)
        Mn = np.full(K, NEG)
        for k in range(K):
            cand = 0.0  # free local start
            if k > 0:
                cand = max(cand, M[k - 1] + MM[k - 1],
                           I[k - 1] + IM[k - 1], D[k - 1] + DM[k - 1])
            Mn[k] = cand + em[k]
        In = np.maximum(M + MI, I + II)
        M, I = Mn, In
        k_best = int(np.argmax(M))
        if M[k_best] > best:
            best, bpos, bnode = float(M[k_best]), j, k_best
    return best, bpos, bnode


def viterbi_scan(profile: ProfileHMM, seqs_codes: np.ndarray,
                 lens: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Score contigs [B, L] against the profile. Returns (score, end_pos,
    end_node) arrays [B]."""
    best, bpos, bnode = _viterbi_kernel(
        jnp.asarray(profile.match_scores), jnp.asarray(profile.t),
        jnp.asarray(seqs_codes), jnp.asarray(lens, dtype=jnp.int32),
        profile.K)
    return np.asarray(best), np.asarray(bpos), np.asarray(bnode)
