"""Vectorized host packing/materialization parity (round-3 demux host
optimization, VERDICT r2 next#3).

materialize_batch / ascii_matrix / codes_matrix / read_masks_matrix
replace per-read Python loops in the demux hot path;
each must match its per-read reference implementation exactly.
"""
import random

import numpy as np
import pytest

from nano_orc.io import encode
from nano_orc.io.fastq import Record
from nano_orc.demux.demux import materialize_batch, materialize_decision


@pytest.fixture(scope="module")
def seqs():
    random.seed(11)
    return ["".join(random.choice("ACGTNacgtn")
                    for _ in range(random.randrange(1, 70)))
            for _ in range(300)]


def test_ascii_matrix_matches_pack_batch(seqs):
    amat, lens = encode.ascii_matrix(seqs, max_len=96)
    m_new = encode.read_masks_matrix(amat, lens)
    m_old, lens_old = encode.pack_batch(
        [s.upper() for s in seqs], max_len=96, pad_multiple=1,
        encoder=encode.encode_read_masks, pad_value=0)
    np.testing.assert_array_equal(lens, lens_old)
    np.testing.assert_array_equal(m_new, m_old)
    c_new = encode.codes_matrix(amat, lens)
    c_old, _ = encode.pack_batch(
        [s.upper() for s in seqs], max_len=96, pad_multiple=1,
        encoder=encode.encode_codes, pad_value=4)
    np.testing.assert_array_equal(c_new, c_old)


def test_revcomp_matrix_matches_revcomp(seqs):
    amat, lens = encode.ascii_matrix(seqs, max_len=96)
    rc = encode.revcomp_matrix(amat, lens)
    for i, s in enumerate(seqs):
        assert rc[i, :lens[i]].tobytes().decode() == encode.revcomp(s)


def test_materialize_batch_matches_per_read():
    random.seed(3)
    recs = []
    for i in range(400):
        n = random.randrange(1, 80)
        s = "".join(random.choice("ACGTN") for _ in range(n))
        q = "".join(chr(33 + random.randrange(40)) for _ in range(n))
        # every 5th read has no qualities (mixed batch -> per-read path)
        recs.append(Record(f"r{i}", f"r{i} extra", s,
                           q if i % 5 else None))
    sp5n = [f"SP5_{k:03d}" for k in range(12)]
    sp27n = [f"SP27_{k:03d}" for k in range(12)]
    B = len(recs)
    rng = np.random.default_rng(2)
    idx1 = rng.integers(-1, 12, B)
    rc1 = rng.integers(0, 2, B).astype(bool)
    lens_r = np.array([len(r.seq) for r in recs])
    qe1 = np.minimum(rng.integers(0, 30, B), lens_r)
    idx2 = rng.integers(-1, 12, B)
    rc2 = rng.integers(0, 2, B).astype(bool)
    qs2 = np.minimum(rng.integers(0, 50, B),
                     np.maximum(lens_r - qe1, 0))
    got = materialize_batch(recs, sp5n, sp27n, idx1, rc1, qe1, idx2,
                            rc2, qs2)
    for i, r in enumerate(recs):
        want = materialize_decision(
            r, sp5n, sp27n, int(idx1[i]), bool(rc1[i]), int(qe1[i]),
            int(idx2[i]), bool(rc2[i]), int(qs2[i]))
        g = got[i]
        assert g[0] == want[0] and g[2] == want[2]
        for a, b in ((g[1], want[1]), (g[3], want[3])):
            assert (a.id, a.desc, a.seq, a.qual) == (b.id, b.desc,
                                                     b.seq, b.qual)


def test_materialize_batch_all_qual():
    """Fully-qualified batch exercises the vectorized qual path."""
    random.seed(7)
    recs = []
    for i in range(64):
        n = random.randrange(4, 40)
        s = "".join(random.choice("ACGT") for _ in range(n))
        q = "".join(chr(33 + random.randrange(40)) for _ in range(n))
        recs.append(Record(f"r{i}", f"r{i}", s, q))
    B = len(recs)
    rng = np.random.default_rng(9)
    idx1 = rng.integers(0, 3, B)
    rc1 = rng.integers(0, 2, B).astype(bool)
    lens_r = np.array([len(r.seq) for r in recs])
    qe1 = np.minimum(rng.integers(0, 10, B), lens_r)
    idx2 = rng.integers(-1, 3, B)
    rc2 = rng.integers(0, 2, B).astype(bool)
    qs2 = np.minimum(rng.integers(0, 30, B),
                     np.maximum(lens_r - qe1, 0))
    got = materialize_batch(recs, ["a", "b", "c"], ["x", "y", "z"],
                            idx1, rc1, qe1, idx2, rc2, qs2)
    for i, r in enumerate(recs):
        want = materialize_decision(
            r, ["a", "b", "c"], ["x", "y", "z"], int(idx1[i]),
            bool(rc1[i]), int(qe1[i]), int(idx2[i]), bool(rc2[i]),
            int(qs2[i]))
        g = got[i]
        for a, b in ((g[1], want[1]), (g[3], want[3])):
            assert (a.seq, a.qual, a.desc) == (b.seq, b.qual, b.desc)
            assert len(a.seq) == len(a.qual or a.seq)


def test_decide_multi_striping(monkeypatch):
    """decide_multi's stripe/pad/concat logic: with the device core
    stubbed to a deterministic function of its inputs, striping over 4
    devices must reproduce the single-call result row for row."""
    import jax
    from nano_orc.demux import fused as F
    from nano_orc.demux.adapters import AdapterBank
    sp5 = AdapterBank(["A1"], ["ACGTACGT"], 0.1)
    sp27 = AdapterBank(["B1"], ["TTGGCCAA"], 0.1)
    fd = F.FusedDemux(sp5, sp27)

    def fake_core(b5, b27, masks, lens):
        m = np.asarray(masks).astype(np.int64)
        ln = np.asarray(lens).astype(np.int64)
        h = (m.sum(axis=1) * 7 + ln * 13) % 97
        rows = [h, h % 2, h % 5, (h * 3) % 11, (h + 1) % 2, h % 7,
                h % 3, h % 4]
        return np.stack(rows).astype(np.int32)

    monkeypatch.setattr(F, "_fused_core", fake_core)
    rng = np.random.default_rng(4)
    B, L = 300, 128  # not a multiple of ROWS or of ndev
    masks = rng.integers(0, 17, (B, L)).astype(np.uint8)
    lens = rng.integers(1, L, B).astype(np.int32)
    want = fake_core(None, None, masks, lens)
    got = fd.decide_multi(masks, lens, jax.devices()[:4])
    for k, name in enumerate(got._fields):
        np.testing.assert_array_equal(getattr(got, name), want[k], name)
