import numpy as np

from nano_orc.io import encode


def test_code_roundtrip():
    s = "ACGTNacgtn"
    codes = encode.encode_codes(s)
    assert list(codes) == [0, 1, 2, 3, 4, 0, 1, 2, 3, 4]
    assert encode.decode(codes) == "ACGTNACGTN"


def test_revcomp_iupac():
    # superset of reference compl_reverse (amplicon_sorter.py:237-242)
    assert encode.revcomp("ACGT") == "ACGT"
    assert encode.revcomp("AACG") == "CGTT"
    assert encode.revcomp("RYKMSWN") == "NWSKMRY"
    assert encode.revcomp("acgt") == "ACGT"


def test_revcomp_codes():
    codes = encode.encode_codes("AACGN")
    rc = encode.revcomp_codes(codes)
    assert encode.decode(rc) == "NCGTT"


def test_ref_masks_wildcards():
    m = encode.encode_ref_masks("ANRT")
    r = encode.encode_read_masks("AGTN")
    # A vs A match
    assert m[0] & r[0]
    # N (ref) matches G and also read-N
    assert m[1] & r[1] and m[1] & r[3]
    # R = A/G does not match T, does not match read-N
    assert not (m[2] & r[2]) and not (m[2] & r[3])
    # T vs read N: no match (read wildcards disabled)
    assert not (m[3] & r[3])


def test_pack_batch_padding():
    arr, lens = encode.pack_batch(["ACGT", "AC"], pad_multiple=128)
    assert arr.shape == (2, 128)
    assert list(lens) == [4, 2]
    assert arr[1, 2] == 4  # pad value = OTHER


def test_length_buckets():
    ids, caps = encode.length_buckets([100, 300, 5000, 100000])
    assert list(ids) == [0, 1, 5, 5]


def test_mean_q_batch_matches_per_record():
    from nano_orc.io.fastq import Record, mean_q_batch
    quals = ["IIII", "", None, "!#5I~", "I" * 1000, None, "!"]
    got = mean_q_batch(quals)
    for i, q in enumerate(quals):
        want = Record("r", "r", "A" * (len(q) if q else 0), q).mean_q()
        assert abs(got[i] - want) < 1e-9, (i, got[i], want)
    assert list(mean_q_batch([])) == []
