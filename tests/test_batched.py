"""Bit-parity of the batched JAX locate against the Python oracle."""
import numpy as np
import pytest

from nano_orc.align import FRONT, BACK, PREFIX, SUFFIX
from nano_orc.align.oracle import locate
from nano_orc.align.batched import batched_locate, make_k_table, make_n_prefix
from nano_orc.io import encode


def run_both(refs, reads, e, flags, min_overlap=3):
    A = len(refs)
    M = max(len(r) for r in refs)
    ref_masks = np.zeros((A, M), dtype=np.uint8)
    ref_lens = np.zeros(A, dtype=np.int32)
    for i, r in enumerate(refs):
        m = encode.encode_ref_masks(r)
        ref_masks[i, :len(m)] = m
        ref_lens[i] = len(m)
    read_masks, read_lens = encode.pack_batch(
        reads, pad_multiple=16, encoder=encode.encode_read_masks, pad_value=0)
    k_table = make_k_table(e, ref_masks, ref_lens)
    n_prefix = make_n_prefix(ref_masks)
    res = batched_locate(ref_masks, ref_lens, k_table, n_prefix,
                         read_masks, read_lens, int(flags), min_overlap)
    res = {k: np.asarray(v) for k, v in res._asdict().items()}
    mism = []
    for b, read in enumerate(reads):
        for a, ref in enumerate(refs):
            want = locate(ref, read, e, flags, min_overlap)
            got_valid = bool(res["valid"][b, a])
            if want is None:
                if got_valid:
                    mism.append((b, a, "expected None", _got(res, b, a)))
                continue
            if not got_valid:
                mism.append((b, a, want.astuple(), "got None"))
                continue
            got = (int(res["refstart"][b, a]), int(res["refstop"][b, a]),
                   int(res["querystart"][b, a]), int(res["querystop"][b, a]),
                   int(res["matches"][b, a]), int(res["errors"][b, a]))
            if got != want.astuple():
                mism.append((b, a, want.astuple(), got))
    return mism


def _got(res, b, a):
    return tuple(int(res[k][b, a]) for k in
                 ("refstart", "refstop", "querystart", "querystop",
                  "matches", "errors"))


@pytest.mark.parametrize("flags", [FRONT, BACK, PREFIX, SUFFIX],
                         ids=["FRONT", "BACK", "PREFIX", "SUFFIX"])
@pytest.mark.parametrize("e", [0.0, 0.1, 0.2])
def test_random_parity(flags, e, rng):
    refs = ["".join(rng.choice(list("ACGT"), size=int(rng.integers(4, 14))))
            for _ in range(5)]
    reads = ["".join(rng.choice(list("ACGT"), size=int(rng.integers(0, 40))))
             for _ in range(12)]
    mism = run_both(refs, reads, e, flags)
    assert not mism, mism[:5]


@pytest.mark.parametrize("flags", [FRONT, BACK], ids=["FRONT", "BACK"])
def test_planted_adapter_parity(flags, rng):
    """Reads built from mutated real-style adapters (with N17 wildcard runs)."""
    refs = [
        "CATGTAATGCACGTACTTTCAGGGTGAGCGTCTAATCGTAATTGTAAAACGACGGCCAG",
        "CATGTAATGCACGTACTTTCAGGGTCTACCGTGGATATTCAATGTAAAACGACGGCCAG",
        "CATGTAATGCACGTACTTTCAGGGTNNNNNNNNNNNNNNNNNTGTAAAACGACGGCCAG",
    ]
    reads = []
    for _ in range(10):
        ad = list(refs[int(rng.integers(0, 3))].replace("N", "A"))
        for _ in range(int(rng.integers(0, 6))):  # up to 5 edits
            op = rng.integers(0, 3)
            pos = int(rng.integers(0, len(ad)))
            if op == 0:
                ad[pos] = str(rng.choice(list("ACGT")))
            elif op == 1 and len(ad) > 1:
                del ad[pos]
            else:
                ad.insert(pos, str(rng.choice(list("ACGT"))))
        insert = "".join(rng.choice(list("ACGT"), size=60))
        prefix = "".join(rng.choice(list("ACGT"), size=int(rng.integers(0, 5))))
        if flags is FRONT:
            reads.append(prefix + "".join(ad) + insert)
        else:
            reads.append(insert + "".join(ad) + prefix)
    mism = run_both(refs, reads, 0.1, flags)
    assert not mism, mism[:5]


def test_n_wildcards_and_iupac_parity(rng):
    refs = ["ACGTNNNNNACGT", "TNTCNACNAAYCAYAARGAYATTGG"]  # real COI primer
    reads = ["".join(rng.choice(list("ACGTN"), size=int(rng.integers(10, 50))))
             for _ in range(10)]
    for flags in (FRONT, BACK):
        mism = run_both(refs, reads, 0.2, flags)
        assert not mism, (flags, mism[:5])


def test_empty_and_short_reads():
    refs = ["ACGTACGT"]
    reads = ["", "A", "ACG", "ACGTACGT"]
    for flags in (FRONT, BACK, PREFIX, SUFFIX):
        mism = run_both(refs, reads, 0.1, flags)
        assert not mism, (flags, mism)
