"""Myers bit-parallel edit distance, batched over [patterns x texts] tiles.

This is the device replacement for the reference's edlib core
(amplicon_sorter.py:225-235 ``distance`` — plain NW distance; ``HW`` infix
mode used consensus-vs-read at :1698-1708). The all-vs-all gene-stage
scoring (SURVEY.md §3.2 hot loop 1) runs on tiles of this kernel.

Formulation: Hyyrö/Myers block algorithm with 32-bit words in int lanes.
Each word step is ~17 bitwise VPU ops covering 32 DP cells per lane —
cells/op ~ 2, vs 1 cell/op for a scalar wavefront DP. The word chain within
a column passes a horizontal delta (hin/hout in {-1,0,+1}); columns advance
via ``lax.scan``.

Modes (edlib conventions):
  NW : global distance; result at column n (per-lane text length).
  SHW: pattern vs text *prefix* (free text suffix); min over columns.
  HW : pattern *within* text (free text prefix+suffix); min over columns.

Pattern lengths vary per lane: the score is tracked at the per-lane row
``m_i`` by testing bit (m_i-1) of the pre-shift Ph/Mh in word (m_i-1)//32;
bits above m_i never influence bits below (vertical deltas propagate
upward only), so per-lane padding is harmless.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

WORD = 32


def n_words(max_len: int) -> int:
    return max(1, -(-max_len // WORD))


def build_peq(codes: jnp.ndarray, W: int,
              m_lens: jnp.ndarray | None = None) -> jnp.ndarray:
    """codes [P, M] uint8 (0..3 bases, 4 = N) -> Peq [P, W, 6] uint32.

    Channel 4 is the N channel: a literal N in the pattern matches a
    literal N in the text (edlib compares bytes, so N==N is a match in the
    reference's distance() path, amplicon_sorter.py:232). Channel 5 is the
    dead pad channel (matches nothing). Pattern positions at or beyond
    ``m_lens`` are forced onto the pad channel.
    """
    P, M = codes.shape
    Mp = W * WORD
    pad = jnp.full((P, Mp - M), 5, jnp.uint8) if Mp > M else None
    c = jnp.concatenate([codes, pad], axis=1) if pad is not None else codes[:, :Mp]
    c = c.astype(jnp.int32)
    if m_lens is not None:
        pos = jnp.arange(Mp, dtype=jnp.int32)[None, :]
        c = jnp.where(pos < jnp.asarray(m_lens, jnp.int32)[:, None], c, 5)
    c = c.reshape(P, W, WORD)
    onehot = (c[..., None] == jnp.arange(5, dtype=jnp.int32)).astype(jnp.uint32)
    weights = (jnp.uint32(1) << jnp.arange(WORD, dtype=jnp.uint32))
    peq5 = jnp.sum(onehot * weights[None, None, :, None], axis=2)  # [P, W, 5]
    zero = jnp.zeros((P, W, 1), jnp.uint32)
    return jnp.concatenate([peq5, zero], axis=2)


@functools.partial(jax.jit, static_argnames=("mode", "W"))
def myers_tile(peq: jnp.ndarray, m_lens: jnp.ndarray,
               texts: jnp.ndarray, n_lens: jnp.ndarray,
               mode: str = "NW", W: int | None = None) -> jnp.ndarray:
    """Edit distance of every pattern against every text.

    peq    [P, W, 5] uint32 (from build_peq)
    m_lens [P] int32 pattern lengths (>= 1)
    texts  [T, N] uint8 codes (pad = 4)
    n_lens [T] int32 text lengths
    Returns [P, T] int32 distances.
    """
    if W is None:
        W = peq.shape[1]
    P = peq.shape[0]
    T, N = texts.shape

    w_idx = ((m_lens - 1) // WORD).astype(jnp.int32)[:, None]        # [P,1]
    r_idx = ((m_lens - 1) % WORD).astype(jnp.uint32)[:, None]        # [P,1]

    ones = jnp.full((W, P, T), 0xFFFFFFFF, jnp.uint32)
    VP0 = ones
    VN0 = jnp.zeros((W, P, T), jnp.uint32)
    score0 = jnp.broadcast_to(m_lens[:, None], (P, T)).astype(jnp.int32)
    hin0 = 0 if mode == "HW" else 1
    best0 = score0  # column 0 value of D[m][j]

    cols = texts.T.astype(jnp.int32)           # [N, T]
    col_ids = jnp.arange(1, N + 1, dtype=jnp.int32)  # 1-based column numbers

    def step(carry, inp):
        VP, VN, score, best, bpos = carry
        c, j = inp                              # c [T], j scalar
        valid = (j <= n_lens)[None, :]          # [1, T]
        hin = jnp.full((P, T), hin0, jnp.int32)
        vp_out = []
        vn_out = []
        for w in range(W):
            Eq = jnp.take(peq[:, w, :], c, axis=1)      # [P, T] uint32
            hin_neg = (hin < 0).astype(jnp.uint32)
            hin_pos = (hin > 0).astype(jnp.uint32)
            Pv, Mv = VP[w], VN[w]
            Xv = Eq | Mv
            Eq_ = Eq | hin_neg
            Xh = (((Eq_ & Pv) + Pv) ^ Pv) | Eq_
            Ph = Mv | ~(Xh | Pv)
            Mh = Pv & Xh
            # per-lane score at row m_i (pre-shift bit r_idx)
            at_m = (w_idx == w)                 # [P, 1]
            d_at_m = (((Ph >> r_idx) & 1).astype(jnp.int32)
                      - ((Mh >> r_idx) & 1).astype(jnp.int32))
            score = score + jnp.where(at_m & valid, d_at_m, 0)
            hout = (((Ph >> 31) & 1).astype(jnp.int32)
                    - ((Mh >> 31) & 1).astype(jnp.int32))
            Ph = (Ph << 1) | hin_pos
            Mh = (Mh << 1) | hin_neg
            vp_out.append(Mh | ~(Xv | Ph))
            vn_out.append(Ph & Xv)
            hin = hout
        VPn = jnp.stack(vp_out)
        VNn = jnp.stack(vn_out)
        improved = valid & (score < best)
        best = jnp.where(improved, score, best)
        bpos = jnp.where(improved, j, bpos)
        return (VPn, VNn, score, best, bpos), None

    bpos0 = jnp.zeros((P, T), jnp.int32)
    (VP, VN, score, best, bpos), _ = jax.lax.scan(
        step, (VP0, VN0, score0, best0, bpos0), (cols, col_ids))
    if mode == "NW":
        return score, jnp.broadcast_to(n_lens[None, :], (P, T))
    return best, bpos


def distances(patterns_codes: np.ndarray, m_lens: np.ndarray,
              texts_codes: np.ndarray, n_lens: np.ndarray,
              mode: str = "NW") -> np.ndarray:
    """Convenience host wrapper: codes in, [P, T] distances out."""
    return distances_with_pos(patterns_codes, m_lens, texts_codes, n_lens,
                              mode)[0]


def distances_with_pos(patterns_codes: np.ndarray, m_lens: np.ndarray,
                       texts_codes: np.ndarray, n_lens: np.ndarray,
                       mode: str = "NW"):
    """Codes in, ([P, T] distances, [P, T] best text end positions) out.
    For NW the position is just the text length; for SHW/HW it is the
    1-based column achieving the minimum (earliest on ties)."""
    W = n_words(int(patterns_codes.shape[1]))
    peq = build_peq(jnp.asarray(patterns_codes), W,
                    jnp.asarray(m_lens, dtype=jnp.int32))
    d, p = myers_tile(peq, jnp.asarray(m_lens, dtype=jnp.int32),
                      jnp.asarray(texts_codes),
                      jnp.asarray(n_lens, dtype=jnp.int32), mode, W)
    return np.asarray(d), np.asarray(p)


def similarity_matrix(dist: np.ndarray, m_lens: np.ndarray,
                      n_lens: np.ndarray) -> np.ndarray:
    """Reference similarity: round(1 - d/len(longer), 3)
    (amplicon_sorter.py:225-235). Rounding matches Python round-half-even
    on the float64 quotient."""
    longer = np.maximum(np.asarray(m_lens)[:, None], np.asarray(n_lens)[None, :])
    sim = 1.0 - dist / np.maximum(longer, 1)
    return np.round(sim, 3)
