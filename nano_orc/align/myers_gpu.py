"""Myers bit-parallel edit distance as a Pallas kernel for NVIDIA GPUs.

Same semantics as :func:`nano_orc.align.myers.myers_tile` (NW / SHW / HW,
per-lane pattern and text lengths); that XLA scan stays the reference.
The scan writes the whole ``[W, P, T]`` VP/VN state to device memory on
every text column. This kernel keeps each pair's words in registers for
the whole text instead.

Layout (Pallas, Triton route):

* One program computes one pattern against a tile of ``TJ`` texts. Its
  ``(pattern, text tile)`` coordinates come from an int32 list indexed
  by ``program_id``; padding entries are ``-1`` and the program returns
  at once. Dense all-vs-all and the gated upper-triangle block are both
  just lists.
* The pattern's equality masks are three bit planes per 32-bit word
  (bit ``k`` of the 3-bit base code), so ``Eq`` for a text base ``c`` is
  ``AND_k (c_k ? B_k : ~B_k)``: three scalar words per pattern word,
  five lane operations per word step. Pattern padding is code 5, which
  no text base (0-4) equals.
* Words are processed in strips of ``S <= S_MAX`` words held in
  registers; the text streams through a loop inside the program. A
  pattern longer than one strip runs strip after strip over the whole
  text, passing the horizontal delta of the strip's top word to the
  next strip through a per-program scratch buffer, two bit planes per
  32 columns. Strips above the pattern's own last word are skipped, and
  so are text chunks past the tile's longest text.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

WORD = 32
#: most pattern words one strip keeps in registers (2 state words each)
S_MAX = 16
#: texts per program; one text per thread at 4 warps
TJ = 128
NUM_WARPS = 4
PAD_CODE = 5  # pattern padding: matches no text base


def strip_words(W: int) -> tuple[int, int]:
    """(S, NG): words per strip and number of strips for W words."""
    S = min(W, S_MAX)
    return S, -(-W // S)


def bit_planes(codes: np.ndarray, m_lens: np.ndarray, Wp: int) -> np.ndarray:
    """codes [P, M] uint8 (0-3 bases, 4 = N) -> [P, Wp*3] uint32 bit
    planes: entry ``w*3 + k`` has bit ``b`` set when bit ``k`` of the code
    at pattern position ``32*w + b`` is 1. Positions at or past
    ``m_lens`` carry PAD_CODE."""
    P, M = codes.shape
    c = np.full((P, Wp * WORD), PAD_CODE, np.uint32)
    n = min(M, Wp * WORD)
    c[:, :n] = codes[:, :n]
    c[np.arange(Wp * WORD)[None, :] >= np.asarray(m_lens)[:, None]] = PAD_CODE
    c = c.reshape(P, Wp, WORD)
    weights = np.uint32(1) << np.arange(WORD, dtype=np.uint32)
    out = np.empty((P, Wp, 3), np.uint32)
    for k in range(3):
        out[:, :, k] = (((c >> k) & 1) * weights).sum(axis=2,
                                                       dtype=np.uint64)
    return out.reshape(P, Wp * 3)


def tile_list(P0: int, T0: int, gate: np.ndarray | None = None
              ) -> np.ndarray:
    """[G, 2] int32 (pattern row, text tile) pairs covering the True
    entries of ``gate`` [P0, T0] (all pairs when None), padded with -1
    sentinel rows to a power of two so the number of compiled shapes
    stays small."""
    nt = -(-T0 // TJ)
    if gate is None:
        need = np.ones((P0, nt), bool)
    else:
        g = np.zeros((P0, nt * TJ), bool)
        g[:, :T0] = gate
        need = g.reshape(P0, nt, TJ).any(axis=2)
    pairs = np.argwhere(need).astype(np.int32)
    G = 1
    while G < len(pairs):
        G *= 2
    out = np.full((G, 2), -1, np.int32)
    out[:len(pairs)] = pairs
    return out


def _kernel(mode, S, NG, NK, tiles_ref, planes_ref, mlen_ref, texts_ref,
            nlen_ref, dist_ref, pos_ref, hv_ref):
    prog = pl.program_id(0)
    i = tiles_ref[prog, 0]
    jt = tiles_ref[prog, 1]

    @pl.when(i >= 0)
    def _():
        cols = pl.ds(pl.multiple_of(jt * TJ, TJ), TJ)
        m = mlen_ref[i]
        w_m = (m - 1) // WORD
        r = ((m - 1) % WORD).astype(jnp.uint32)
        nl = nlen_ref[cols]
        nk = jnp.minimum((jnp.max(nl) + WORD - 1) // WORD, NK)
        ones = jnp.full((TJ,), 0xFFFFFFFF, jnp.uint32)
        zeros = jnp.zeros((TJ,), jnp.uint32)
        one = jnp.uint32(1)
        hp0 = ones if mode != "HW" else zeros   # top-row boundary delta

        def strip(g, acc):
            B = [[planes_ref[i, (g * S + s) * 3 + k] for k in range(3)]
                 for s in range(S)]
            at_m = [(g * S + s) == w_m for s in range(S)]

            def chunk(k, st):
                vp, vn, score, best, bpos = st
                if NG > 1:
                    hpin = jnp.where(g > 0, hv_ref[prog, k, 0, :], hp0)
                    hmin = jnp.where(g > 0, hv_ref[prog, k, 1, :], zeros)
                else:
                    hpin, hmin = hp0, zeros

                def col(b, st2):
                    vp, vn, score, best, bpos, outp, outm = st2
                    j = k * WORD + b
                    c = texts_ref[j, cols].astype(jnp.int32)
                    neg = [((c >> q) & 1).astype(jnp.uint32) - one
                           for q in range(3)]
                    bu = b.astype(jnp.uint32)
                    hp = (hpin >> bu) & one
                    hm = (hmin >> bu) & one
                    phw = zeros
                    mhw = zeros
                    vp2, vn2 = [], []
                    for s in range(S):
                        eq = ((B[s][0] ^ neg[0]) & (B[s][1] ^ neg[1])
                              & (B[s][2] ^ neg[2]))
                        Pv, Mv = vp[s], vn[s]
                        Xv = eq | Mv
                        Eq_ = eq | hm
                        Xh = (((Eq_ & Pv) + Pv) ^ Pv) | Eq_
                        Ph = Mv | ~(Xh | Pv)
                        Mh = Pv & Xh
                        phw = jnp.where(at_m[s], Ph, phw)
                        mhw = jnp.where(at_m[s], Mh, mhw)
                        hp_o = Ph >> 31
                        hm_o = Mh >> 31
                        Ph = (Ph << 1) | hp
                        Mh = (Mh << 1) | hm
                        vp2.append(Mh | ~(Xv | Ph))
                        vn2.append(Ph & Xv)
                        hp, hm = hp_o, hm_o
                    valid = (j + 1) <= nl
                    d = (((phw >> r) & one).astype(jnp.int32)
                         - ((mhw >> r) & one).astype(jnp.int32))
                    score = score + jnp.where(valid, d, 0)
                    if mode != "NW":
                        better = valid & (score < best)
                        best = jnp.where(better, score, best)
                        bpos = jnp.where(better, j + 1, bpos)
                    return (tuple(vp2), tuple(vn2), score, best, bpos,
                            outp | (hp << bu), outm | (hm << bu))

                vp, vn, score, best, bpos, outp, outm = jax.lax.fori_loop(
                    0, WORD, col, (vp, vn, score, best, bpos, zeros, zeros))
                if NG > 1:
                    hv_ref[prog, k, 0, :] = outp
                    hv_ref[prog, k, 1, :] = outm
                return vp, vn, score, best, bpos

            score, best, bpos = acc
            st = ((ones,) * S, (zeros,) * S, score, best, bpos)
            _, _, score, best, bpos = jax.lax.fori_loop(0, nk, chunk, st)
            return score, best, bpos

        score0 = jnp.full((TJ,), m, jnp.int32)
        acc = (score0, score0, jnp.zeros((TJ,), jnp.int32))
        if NG > 1:
            acc = jax.lax.fori_loop(0, w_m // S + 1, strip, acc)
        else:
            acc = strip(0, acc)
        score, best, bpos = acc
        if mode == "NW":
            dist_ref[i, cols] = score
            pos_ref[i, cols] = nl
        else:
            dist_ref[i, cols] = best
            pos_ref[i, cols] = bpos


@functools.partial(jax.jit, static_argnames=("mode", "W", "interpret"))
def myers_pairs(tiles, planes, m_lens, texts_T, n_lens, mode: str = "NW",
                W: int = 1, interpret: bool = False):
    """tiles [G, 2] int32 (tile_list), planes [P, NG*S*3] uint32
    (bit_planes), m_lens [P] int32, texts_T [N, T] uint8 column-major
    texts with N % 32 == 0 and T % TJ == 0, n_lens [T] int32.
    Returns (dist [P, T], pos [P, T]) int32; entries of unlisted tiles
    are unspecified."""
    S, NG = strip_words(W)
    G = tiles.shape[0]
    P = planes.shape[0]
    N, T = texts_T.shape
    NK = N // WORD
    hv_shape = (G, NK, 2, TJ) if NG > 1 else (1, 1, 2, TJ)
    dist, pos, _ = pl.pallas_call(
        functools.partial(_kernel, mode, S, NG, NK),
        grid=(G,),
        out_shape=[jax.ShapeDtypeStruct((P, T), jnp.int32),
                   jax.ShapeDtypeStruct((P, T), jnp.int32),
                   jax.ShapeDtypeStruct(hv_shape, jnp.uint32)],
        compiler_params=pl_triton.CompilerParams(num_warps=NUM_WARPS,
                                                 num_stages=1),
        backend="triton",
        interpret=interpret,
        name=f"myers_{mode.lower()}",
    )(tiles, planes, m_lens, texts_T, n_lens)
    return dist, pos


def distances(pat_codes: np.ndarray, m_lens: np.ndarray,
              txt_codes: np.ndarray, n_lens: np.ndarray, mode: str = "NW",
              gate: np.ndarray | None = None, interpret: bool = False,
              device=None, lazy: bool = False):
    """Host wrapper mirroring ``myers.distances_with_pos``: codes in,
    ([P0, T0] distances, [P0, T0] end positions) out. ``gate`` [P0, T0]
    limits the work to the text tiles holding a True entry (other
    entries unspecified). ``device`` commits the inputs to one device;
    ``lazy`` returns the padded device arrays without fetching."""
    pat_codes = np.asarray(pat_codes)
    txt_codes = np.asarray(txt_codes)
    P0, T0 = pat_codes.shape[0], txt_codes.shape[0]
    W = max(1, -(-int(pat_codes.shape[1]) // WORD))
    S, NG = strip_words(W)
    planes = bit_planes(pat_codes, m_lens, NG * S)
    T = -(-T0 // TJ) * TJ
    N = -(-max(int(txt_codes.shape[1]), 1) // WORD) * WORD
    tt = np.full((N, T), 4, np.uint8)
    tt[:txt_codes.shape[1], :T0] = txt_codes.T
    nl = np.ones(T, np.int32)
    nl[:T0] = n_lens
    ml = np.asarray(m_lens, np.int32)
    tiles = tile_list(P0, T0, gate)
    put = (jnp.asarray if device is None
           else functools.partial(jax.device_put, device=device))
    d, p = myers_pairs(put(tiles), put(planes), put(ml), put(tt), put(nl),
                       mode, W, interpret)
    if lazy:
        return d, p
    return np.asarray(d)[:, :T0], np.asarray(p)[:, :T0]
