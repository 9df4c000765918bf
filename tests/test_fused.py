"""Fused dual-round demux parity vs the unfused (oracle-verified) path.

The fused device program (demux/fused.py) must reproduce, read for read,
the decisions of running demux.assign_reads twice (round 1 FRONT on SP5,
round 2 BACK on SP27-rc), i.e. the cutadapt dual-round semantics of
the reference's scripts/02_cutadapt_loop.sh:64-103.
"""
import numpy as np
import pytest

from nano_orc.demux.adapters import AdapterBank
from nano_orc.demux.demux import assign_reads, bin_reads, UNKNOWN
from nano_orc.demux.fused import FusedDemux
from nano_orc.io import encode
from nano_orc.io.fastq import Record


@pytest.fixture(scope="module")
def banks(adapters_dir):
    sp5 = AdapterBank.from_fasta(f"{adapters_dir}/M13_amplicon_indices_forward.fa",
                                 0.1)
    sp27 = AdapterBank.from_fasta(
        f"{adapters_dir}/M13_amplicon_indices_reverse_rc.fa", 0.1)
    return sp5, sp27


def make_reads(rng, sp5, sp27, n=64):
    reads = []
    for i in range(n):
        ins = "".join(rng.choice(list("ACGT"), size=int(rng.integers(40, 200))))
        kind = i % 4
        if kind == 0:      # clean dual-adapter read
            s = sp5.seqs[i % 12] + ins + sp27.seqs[i % 8]
        elif kind == 1:    # mutated adapters
            a = list(sp5.seqs[(i + 3) % 12])
            for _ in range(3):
                a[int(rng.integers(0, len(a)))] = str(rng.choice(list("ACGT")))
            s = "".join(a) + ins + sp27.seqs[(i + 1) % 8]
        elif kind == 2:    # SP5 only
            s = sp5.seqs[i % 12] + ins
        else:              # garbage
            s = ins
        if i % 2:
            s = encode.revcomp(s)
        qual = "I" * len(s)
        reads.append(Record(f"r{i}", f"r{i} meta", s, qual))
    return reads


def unfused_decisions(reads, sp5, sp27):
    """Round 1 then round 2 via the unfused path; returns per-read
    (sp5_name, trimmed1_seq, sp27_name, final_seq, final_qual)."""
    r1 = assign_reads(reads, sp5, "front", rc=True)
    out = []
    for a in r1:
        if a.adapter is None:
            out.append((None, a.trimmed.seq, None, a.trimmed.seq, None))
            continue
        r2 = assign_reads([a.trimmed], sp27, "back", rc=True)[0]
        out.append((a.adapter, a.trimmed.seq, r2.adapter, r2.trimmed.seq,
                    r2.trimmed.qual))
    return out


def test_fused_matches_unfused(banks, rng):
    sp5, sp27 = banks
    reads = make_reads(rng, sp5, sp27, n=64)
    fused = FusedDemux(sp5, sp27)
    got = fused.assign(reads, batch_size=32, max_len=128)
    want = unfused_decisions(reads, sp5, sp27)
    assert len(got) == len(want)
    for (ridx, sp5n, t1, sp27n, fin, *_), (w5, wt1, w27, wfin, wq) in zip(
            got, want):
        assert sp5n == w5, (ridx, sp5n, w5)
        assert t1.seq == wt1, (ridx, "round1 trim")
        if w5 is None:
            continue
        assert sp27n == w27, (ridx, sp27n, w27)
        assert fin.seq == wfin, (ridx, "round2 trim")
        if wq is not None:
            assert fin.qual == wq, (ridx, "qual trim")


def test_fused_empty_and_short_reads(banks):
    sp5, sp27 = banks
    reads = [Record("e0", "e0", "", ""),
             Record("e1", "e1", "ACG", "III"),
             Record("e2", "e2", sp5.seqs[0], "I" * len(sp5.seqs[0]))]
    fused = FusedDemux(sp5, sp27)
    got = fused.assign(reads, batch_size=4, max_len=128)
    want = unfused_decisions(reads, sp5, sp27)
    for (ridx, sp5n, t1, sp27n, fin, *_), (w5, wt1, w27, wfin, wq) in zip(
            got, want):
        assert sp5n == w5 and t1.seq == wt1
        if w5 is not None:
            assert sp27n == w27 and fin.seq == wfin


def test_fused_report_fields_match_unfused(banks, rng):
    """Every per-read field, the orientation and error count of each
    round included, equals the unfused path's; also for reads round 1
    leaves unbinned, which round 2 never sees."""
    from nano_orc.demux.demux import _decisions_unfused
    sp5, sp27 = banks
    reads = make_reads(rng, sp5, sp27, n=64)
    got = [t[1:] for t in FusedDemux(sp5, sp27).assign(
        reads, batch_size=32, max_len=128)]
    assert got == _decisions_unfused(reads, sp5, sp27, 32)
