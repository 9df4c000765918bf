"""C++ oracle parity with the Python oracle and the JAX kernels."""
import numpy as np
import pytest

from nano_orc import native
from nano_orc.align import FRONT, BACK, PREFIX, SUFFIX
from nano_orc.align.oracle import locate as py_locate, edit_distance as py_ed
from nano_orc.io import encode


@pytest.mark.parametrize("mode", ["NW", "SHW", "HW"])
def test_edit_distance_parity(mode, rng):
    for _ in range(40):
        a = "".join(rng.choice(list("ACGTN"), size=int(rng.integers(1, 200))))
        b = "".join(rng.choice(list("ACGTN"), size=int(rng.integers(1, 200))))
        got = native.edit_distance(encode.encode_codes(a),
                                   encode.encode_codes(b), mode)
        want = py_ed(a, b, mode)
        assert got == want, (len(a), len(b), mode, got, want)


def test_edit_distance_long(rng):
    a = "".join(rng.choice(list("ACGT"), size=3500))
    b = list(a)
    for _ in range(120):
        pos = int(rng.integers(0, len(b)))
        b[pos] = str(rng.choice(list("ACGT")))
    b = "".join(b)
    d = native.edit_distance(encode.encode_codes(a), encode.encode_codes(b))
    assert 0 < d <= 120


@pytest.mark.parametrize("flags", [FRONT, BACK, PREFIX, SUFFIX],
                         ids=["FRONT", "BACK", "PREFIX", "SUFFIX"])
def test_locate_parity(flags, rng):
    for _ in range(60):
        m = int(rng.integers(3, 25))
        n = int(rng.integers(0, 60))
        ref = "".join(rng.choice(list("ACGTN"), size=m))
        qry = "".join(rng.choice(list("ACGT"), size=n))
        e = float(rng.choice([0.0, 0.1, 0.2, 0.3]))
        want = py_locate(ref, qry, e, flags)
        got = native.locate(encode.encode_ref_masks(ref),
                            encode.encode_read_masks(qry), e, int(flags))
        if want is None:
            assert got is None, (ref, qry, e, got)
        else:
            assert got == want.astuple(), (ref, qry, e, got, want.astuple())


def test_locate_batch_matches_single(rng):
    refs = ["ACGTACGTA", "TTGGCCAAT"]
    qrys = ["".join(rng.choice(list("ACGT"), size=30)) for _ in range(10)]
    out, valid = native.locate_batch(
        [encode.encode_ref_masks(r) for r in refs],
        [encode.encode_read_masks(q) for q in qrys], 0.2, int(FRONT))
    for b, q in enumerate(qrys):
        for a, r in enumerate(refs):
            single = native.locate(encode.encode_ref_masks(r),
                                   encode.encode_read_masks(q), 0.2,
                                   int(FRONT))
            if single is None:
                assert not valid[b, a]
            else:
                assert valid[b, a] and tuple(out[b, a]) == single


def test_all_vs_all_band_gate(rng):
    seqs = ["ACGT" * 30, "ACGT" * 30, "ACGT" * 50]
    codes = [encode.encode_codes(s) for s in seqs]
    D = native.all_vs_all(codes, band=1.05)
    assert D[0, 1] == 0
    assert D[0, 2] == -1  # 120 * 1.05 < 200 -> gated
    assert D[1, 0] == -1  # lower triangle untouched


def test_nw_path_reconstructs_alignment(rng):
    for _ in range(20):
        a = "".join(rng.choice(list("ACGT"), size=int(rng.integers(5, 120))))
        b = list(a)
        for _ in range(int(rng.integers(0, 10))):
            op = int(rng.integers(0, 3))
            pos = int(rng.integers(0, max(len(b), 1)))
            if op == 0 and b:
                b[pos] = str(rng.choice(list("ACGT")))
            elif op == 1 and len(b) > 1:
                del b[pos]
            else:
                b.insert(pos, str(rng.choice(list("ACGT"))))
        b = "".join(b)
        ac, bc = encode.encode_codes(a), encode.encode_codes(b)
        ops = native.nw_path(ac, bc)
        # replay: ops must consume exactly a and b, with cost == distance
        i = j = cost = 0
        for op in ops:
            if op == 0:
                cost += int(ac[i] != bc[j]); i += 1; j += 1
            elif op == 1:
                cost += 1; i += 1
            else:
                cost += 1; j += 1
        assert (i, j) == (len(a), len(b))
        assert cost == native.edit_distance(ac, bc)
