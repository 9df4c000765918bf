"""Demux pipeline tests: device path vs oracle-driven reference path, plus
synthetic-plate end-to-end binning (02_cutadapt_loop.sh equivalence)."""
import os

import numpy as np
import pytest

from nano_orc.align import FRONT, BACK
from nano_orc.align.oracle import locate
from nano_orc.demux.adapters import AdapterBank
from nano_orc.demux.demux import (assign_reads, dual_round_demux, UNKNOWN)
from nano_orc.io import encode
from nano_orc.io.fastq import Record, read_records


def oracle_assign(records, bank, where, rc=True, min_overlap=3):
    """cutadapt selection semantics implemented directly on the oracle
    (independent slow path used to validate the device pipeline)."""
    flags = FRONT if where == "front" else BACK
    out = []
    for rec in records:
        def best_of(seq):
            best = None
            for ai, aseq in enumerate(bank.seqs):
                loc = locate(aseq, seq.upper(), bank.max_error_rate, flags,
                             min_overlap)
                if loc and (best is None or loc.matches > best[1].matches):
                    best = (ai, loc)
            return best
        fwd = best_of(rec.seq)
        rcs = encode.revcomp(rec.seq)
        rvc = best_of(rcs)
        use_rc = rvc is not None and (fwd is None or rvc[1].matches > fwd[1].matches)
        if use_rc:
            seq, qual = rcs, (rec.qual[::-1] if rec.qual else None)
            ai, loc = rvc
        else:
            seq, qual = rec.seq, rec.qual
            ai, loc = fwd if fwd else (-1, None)
        if loc is None:
            out.append((None, rec.seq))
            continue
        if where == "front":
            out.append((bank.names[ai], seq[loc.querystop:]))
        else:
            out.append((bank.names[ai], seq[:loc.querystart]))
    return out


@pytest.fixture(scope="module")
def sp5(adapters_dir):
    return AdapterBank.from_fasta(f"{adapters_dir}/M13_amplicon_indices_forward.fa", 0.1)


@pytest.fixture(scope="module")
def sp27rc(adapters_dir):
    return AdapterBank.from_fasta(f"{adapters_dir}/M13_amplicon_indices_reverse_rc.fa", 0.1)


def mutate(rng, s, n_edits):
    s = list(s)
    for _ in range(n_edits):
        op = int(rng.integers(0, 3))
        pos = int(rng.integers(0, max(len(s), 1)))
        if op == 0 and s:
            s[pos] = str(rng.choice(list("ACGT")))
        elif op == 1 and len(s) > 1:
            del s[pos]
        else:
            s.insert(pos, str(rng.choice(list("ACGT"))))
    return "".join(s)


def make_plate_reads(rng, sp5, sp27rc, n=60):
    """Synthetic reads: SP5_x + insert + SP27rc_y (+ errors, random strand)."""
    reads, truth = [], []
    for i in range(n):
        a5 = int(rng.integers(0, len(sp5)))
        a27 = int(rng.integers(0, 8))  # valid combos only use SP27 1..8
        insert = "".join(rng.choice(list("ACGT"), size=int(rng.integers(80, 200))))
        seq = (mutate(rng, sp5.seqs[a5], int(rng.integers(0, 4)))
               + insert
               + mutate(rng, sp27rc.seqs[a27], int(rng.integers(0, 4))))
        flip = bool(rng.integers(0, 2))
        if flip:
            seq = encode.revcomp(seq)
        reads.append(Record(f"r{i}", f"r{i}", seq, "I" * len(seq)))
        truth.append((sp5.names[a5], sp27rc.names[a27], insert, flip))
    return reads, truth


def test_assign_parity_with_oracle_front(adapters_dir, sp5, rng):
    reads, _ = make_plate_reads(rng, sp5,
                                AdapterBank.from_fasta(
                                    f"{adapters_dir}/M13_amplicon_indices_reverse_rc.fa", 0.1),
                                n=20)
    # add junk + empty-ish reads
    reads += [Record("j1", "j1", "".join(rng.choice(list("ACGT"), size=50)), "I" * 50),
              Record("j2", "j2", "ACG", "III")]
    got = assign_reads(reads, sp5, "front", rc=True)
    want = oracle_assign(reads, sp5, "front", rc=True)
    for g, (wname, wseq) in zip(got, want):
        assert g.adapter == wname, (g.trimmed.id, g.adapter, wname)
        if wname is not None:
            assert g.trimmed.seq == wseq, g.trimmed.id


def test_assign_parity_with_oracle_back(sp27rc, rng):
    base = "".join(rng.choice(list("ACGT"), size=150))
    reads = []
    for i in range(20):
        a = int(rng.integers(0, len(sp27rc)))
        seq = base + mutate(rng, sp27rc.seqs[a], int(rng.integers(0, 4)))
        if rng.integers(0, 2):
            seq = encode.revcomp(seq)
        reads.append(Record(f"b{i}", f"b{i}", seq, "I" * len(seq)))
    got = assign_reads(reads, sp27rc, "back", rc=True)
    want = oracle_assign(reads, sp27rc, "back", rc=True)
    for g, (wname, wseq) in zip(got, want):
        assert g.adapter == wname
        if wname is not None:
            assert g.trimmed.seq == wseq


def test_dual_round_end_to_end(tmp_path, sp5, sp27rc, rng):
    reads, truth = make_plate_reads(rng, sp5, sp27rc, n=60)
    report = dual_round_demux(reads, sp5, sp27rc, "unittest", str(tmp_path),
                              write=True)
    # each read with few-enough errors must land in its true bin
    binned = report["final_bins"]
    assert sum(binned.values()) >= 0.8 * len(reads)
    # spot-check: bins on disk match the report and contain the inserts
    for comb, count in binned.items():
        path = tmp_path / "SP27" / f"{comb}_unittest.fastq.gz"
        assert path.exists()
        recs = list(read_records(str(path)))
        assert len(recs) == count
    # no unknown or invalid-combo files remain
    for p in (tmp_path / "SP27").iterdir():
        assert "unknown" not in p.name
        for bad in ("SP27_009", "SP27_010", "SP27_011", "SP27_012"):
            assert bad not in p.name
    # report totals consistent
    assert report["total_reads"] == len(reads)


def test_trimmed_insert_recovery(tmp_path, sp5, sp27rc, rng):
    """Error-free reads must be trimmed back to exactly the insert."""
    reads, truth = [], []
    for i in range(12):
        a5, a27 = i % 12, i % 8
        insert = "".join(rng.choice(list("ACGT"), size=120))
        seq = sp5.seqs[a5] + insert + sp27rc.seqs[a27]
        reads.append(Record(f"e{i}", f"e{i}", seq, "I" * len(seq)))
        truth.append((sp5.names[a5], sp27rc.names[a27], insert))
    r1 = assign_reads(reads, sp5, "front", rc=True)
    for a, (n5, n27, insert) in zip(r1, truth):
        assert a.adapter == n5
    r2 = assign_reads([a.trimmed for a in r1], sp27rc, "back", rc=True)
    for a, (n5, n27, insert) in zip(r2, truth):
        assert a.adapter == n27
        assert a.trimmed.seq == insert


def test_cutadapt_json_schema_reports(adapters_dir, tmp_path, rng):
    """dual_round_demux writes real cutadapt-schema --json reports
    (02_cutadapt_loop.sh:72,102): SP5/cutadapt_SP5_<ds>.json + one
    SP27/<id>_<ds>.json per SP5 bin, with the documented top-level keys,
    read/basepair counts, and per-adapter trimmed_lengths histograms
    keyed by error count."""
    import json
    sp5 = AdapterBank.from_fasta(f"{adapters_dir}/M13_amplicon_indices_forward.fa",
                                 0.1)
    sp27 = AdapterBank.from_fasta(
        f"{adapters_dir}/M13_amplicon_indices_reverse_rc.fa", 0.1)
    recs = []
    for i in range(20):
        ins = "".join(rng.choice(list("ACGT"), size=150))
        s = sp5.seqs[i % 3] + ins + sp27.seqs[i % 2]
        if i % 2:
            s = encode.revcomp(s)
        recs.append(Record(f"r{i}", f"r{i}", s, "I" * len(s)))
    recs.append(Record("junkread_x", "junkread_x",
                       "".join(rng.choice(list("AC"), size=40)), None))
    dual_round_demux(recs, sp5, sp27, "ds", str(tmp_path))
    r1 = json.load(open(tmp_path / "SP5" / "cutadapt_SP5_ds.json"))
    assert r1["tag"] == "Cutadapt report"
    assert r1["schema_version"] == [0, 3]
    for key in ("read_counts", "basepair_counts", "adapters_read1",
                "input", "command_line_arguments"):
        assert key in r1
    rc = r1["read_counts"]
    assert rc["input"] == 21
    assert rc["read1_with_adapter"] == 20
    assert rc["reverse_complemented"] == 10
    assert rc["filtered"]["too_short"] is None
    names = [a["name"] for a in r1["adapters_read1"]]
    assert names == sp5.names
    a0 = [a for a in r1["adapters_read1"] if a["total_matches"]][0]
    fe = a0["five_prime_end"]
    assert fe["type"] == "regular_five_prime"
    assert fe["three_prime_end"] is None if "three_prime_end" in fe \
        else a0["three_prime_end"] is None
    assert fe["error_lengths"][-1] == len(fe["sequence"])
    tl = fe["trimmed_lengths"]
    assert tl and all(set(x) == {"len", "expect", "counts"} for x in tl)
    # exact-match synthetic adapters -> all matches in the 0-error bucket
    assert sum(x["counts"][0] for x in tl) == a0["total_matches"]
    # round-2 reports: one per SP5 bin seen
    bins = {n for n, *_ in
            [(r1_adapter["name"],) for r1_adapter in r1["adapters_read1"]
             if r1_adapter["total_matches"]]}
    for b in bins:
        r2 = json.load(open(tmp_path / "SP27" / f"{b}_ds.json"))
        assert r2["tag"] == "Cutadapt report"
        ae = [a for a in r2["adapters_read1"] if a["total_matches"]]
        assert ae and ae[0]["three_prime_end"]["type"] == \
            "regular_three_prime"
        assert ae[0]["five_prime_end"] is None


def test_locate_batch_lazy_collect_parity(sp5, rng):
    """The pipelined phase-A/phase-B locate (reorient's hot path) must
    return exactly what the direct locate_batch returns, including on
    the XLA fallback where the handle is a pass-through."""
    from nano_orc.demux.demux import locate_batch, locate_batch_lazy, \
        locate_batch_collect
    seqs = []
    for i in range(37):
        ins = "".join(rng.choice(list("ACGT"), size=int(rng.integers(40, 200))))
        seqs.append(sp5.seqs[i % len(sp5)] + ins if i % 3 else ins)
    direct = locate_batch(sp5, seqs, FRONT)
    handles = [locate_batch_lazy(sp5, seqs[s:s + 16], FRONT)
               for s in range(0, len(seqs), 16)]
    got = [locate_batch_collect(h) for h in handles]
    valid = np.asarray(direct.valid).astype(bool)
    cat_valid = np.concatenate([np.asarray(g.valid) for g in got])
    np.testing.assert_array_equal(cat_valid.astype(bool), valid)
    # fields of valid==0 entries are UNSPECIFIED by contract
    # (LocateResult docstring) — the 16-read chunks here route through
    # the native small-batch path whose sentinel differs; compare where
    # valid only
    for f in direct._fields:
        if f in ("valid", "nloc", "nacc"):
            # nloc/nacc are documented zeros on the native small-batch
            # path (LocateResult docstring)
            continue
        cat = np.concatenate([np.asarray(getattr(g, f)) for g in got])
        np.testing.assert_array_equal(
            np.where(valid, cat, 0),
            np.where(valid, np.asarray(getattr(direct, f)), 0),
            err_msg=f)
