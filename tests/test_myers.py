"""Myers bit-parallel kernel vs the definitional DP oracle."""
import numpy as np
import pytest

from nano_orc.align.oracle import edit_distance
from nano_orc.align.myers import distances, n_words
from nano_orc.io import encode


def run_tile(patterns, texts, mode):
    pc, pl = encode.pack_batch(patterns, pad_multiple=32)
    tc, tl = encode.pack_batch(texts, pad_multiple=32)
    return distances(pc, pl, tc, tl, mode)


@pytest.mark.parametrize("mode", ["NW", "SHW", "HW"])
def test_small_exact(mode):
    pats = ["ACGT", "AAAA", "ACGTACGTACGT"]
    txts = ["ACGT", "TTTTACGTTTTT", "A"]
    got = run_tile(pats, txts, mode)
    for i, p in enumerate(pats):
        for j, t in enumerate(txts):
            want = edit_distance(p, t, mode)
            assert got[i, j] == want, (p, t, mode, got[i, j], want)


@pytest.mark.parametrize("mode", ["NW", "SHW", "HW"])
def test_random_parity(mode, rng):
    pats = ["".join(rng.choice(list("ACGT"), size=int(rng.integers(1, 70))))
            for _ in range(8)]
    txts = ["".join(rng.choice(list("ACGT"), size=int(rng.integers(1, 90))))
            for _ in range(8)]
    got = run_tile(pats, txts, mode)
    for i, p in enumerate(pats):
        for j, t in enumerate(txts):
            want = edit_distance(p, t, mode)
            assert got[i, j] == want, (i, j, len(p), len(t), mode,
                                       int(got[i, j]), want)


def test_multiword_long_sequences(rng):
    """Cross the 32-bit word boundary multiple times (COI-length reads)."""
    base = "".join(rng.choice(list("ACGT"), size=700))
    mutants = []
    for k in (0, 3, 17, 60):
        s = list(base)
        for _ in range(k):
            pos = int(rng.integers(0, len(s)))
            op = int(rng.integers(0, 3))
            if op == 0:
                s[pos] = str(rng.choice(list("ACGT")))
            elif op == 1 and len(s) > 1:
                del s[pos]
            else:
                s.insert(pos, str(rng.choice(list("ACGT"))))
        mutants.append("".join(s))
    got = run_tile([base], mutants, "NW")
    for j, mseq in enumerate(mutants):
        want = edit_distance(base, mseq, "NW")
        assert got[0, j] == want, (j, int(got[0, j]), want)


def test_n_semantics():
    # edlib compares bytes: N==N matches, N vs A mismatches. Non-ACGT chars
    # are equivalence-classed as N in the code encoding (documented).
    assert run_tile(["ACNGT"], ["ACNGT"], "NW")[0, 0] == 0
    assert run_tile(["ACNGT"], ["ACAGT"], "NW")[0, 0] == 1
    assert edit_distance("ACNGT", "ACNGT", "NW") == 0


def test_pattern_padding_is_dead():
    # a pattern shorter than its pad must not "match" text Ns in the pad row
    got = run_tile(["ACGT"], ["ACGTNNNN"], "NW")
    assert got[0, 0] == edit_distance("ACGT", "ACGTNNNN", "NW") == 4
