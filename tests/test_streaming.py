"""Streaming input paths (VERDICT r4 missing#4): block-streamed
reorient and chunk-streamed demux must produce outputs identical to the
one-shot list paths, with memory O(block)."""
import gzip
import os

import numpy as np
import pytest

from nano_orc.demux.adapters import AdapterBank
from nano_orc.demux.demux import dual_round_demux, dual_round_demux_stream
from nano_orc.demux.reorient import ReorientConfig, reorient_file
from nano_orc.io import encode
from nano_orc.io.fastq import Record, read_records, write_records


@pytest.fixture(scope="module")
def banks(adapters_dir):
    sp5 = AdapterBank.from_fasta(f"{adapters_dir}/M13_amplicon_indices_forward.fa",
                                 0.1)
    sp27 = AdapterBank.from_fasta(
        f"{adapters_dir}/M13_amplicon_indices_reverse_rc.fa", 0.1)
    return sp5, sp27


def _demux_reads(banks, n=400, seed=0):
    sp5, sp27 = banks
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(n):
        ins = "".join(rng.choice(list("ACGT"), size=120))
        s = sp5.seqs[i % 12] + ins + sp27.seqs[i % 8]
        if i % 2:
            s = encode.revcomp(s)
        if i % 23 == 0:
            s = ins  # unknown bin
        recs.append(Record(f"r{i}", f"r{i}", s, "I" * len(s)))
    return recs


def _tree(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            rel = os.path.relpath(p, root)
            if f.endswith(".gz"):
                with gzip.open(p, "rt") as fh:
                    out[rel] = fh.read()
            else:
                with open(p) as fh:
                    out[rel] = fh.read()
    return out


def test_demux_stream_equals_list(tmp_path, banks):
    sp5, sp27 = banks
    recs = _demux_reads(banks)
    rep_list = dual_round_demux(recs, sp5, sp27, "ds",
                                str(tmp_path / "list"))
    rep_stream = dual_round_demux_stream(iter(recs), sp5, sp27, "ds",
                                         str(tmp_path / "stream"),
                                         chunk_size=64)
    assert rep_list == rep_stream
    assert _tree(tmp_path / "list") == _tree(tmp_path / "stream")


def test_demux_stream_never_materializes(tmp_path, banks):
    """The stream path must pull the input generator at most one chunk
    ahead of the work it has completed (no up-front list())."""
    sp5, sp27 = banks
    recs = _demux_reads(banks, n=300)
    state = {"pulled": 0, "done": 0, "max_ahead": 0}

    def gen():
        for r in recs:
            state["pulled"] += 1
            state["max_ahead"] = max(state["max_ahead"],
                                     state["pulled"] - state["done"])
            yield r

    # chunk_size=50: the generator can only be 50 reads ahead of the
    # last processed chunk boundary; a list() materialization would
    # pull all 300 before any processing (max_ahead == 300). 'done'
    # advances via the report accumulator, called once per read as
    # each chunk is processed.
    from nano_orc.demux import report as report_mod

    class SpyAccum(report_mod.RoundReportAccum):
        def add(self, rec, row):
            state["done"] += 1
            super().add(rec, row)

    old = report_mod.RoundReportAccum
    report_mod.RoundReportAccum = SpyAccum
    try:
        rep = dual_round_demux_stream(gen(), sp5, sp27, "ds",
                                      str(tmp_path / "s"), write=False,
                                      chunk_size=50)
    finally:
        report_mod.RoundReportAccum = old
    assert rep["total_reads"] == 300
    assert state["max_ahead"] <= 50, state["max_ahead"]


def test_reorient_file_stream_equals_oneshot(adapters_dir, tmp_path):
    from nano_orc.io.fastq import read_fasta
    rng = np.random.default_rng(7)
    m13 = {r.id: r.seq.upper()
           for r in read_fasta(f"{adapters_dir}/M13_seqs_for_pychopper.fa")}

    def conc(p):
        return "".join(str(rng.choice(list("ACGT"))) if c == "N" else c
                       for c in p)

    recs = []
    for i in range(180):
        ins = "".join(rng.choice(list("ACGT"), size=150))
        s = conc(m13["SP5"]) + ins + encode.revcomp(conc(m13["SP27"]))
        if i % 3 == 1:
            s = encode.revcomp(s)
        if i % 19 == 0:
            s = ins
        recs.append(Record(f"q{i}", f"q{i}", s, "I" * len(s)))
    fq = str(tmp_path / "in.fastq")
    write_records(fq, recs, fmt="fastq")
    cfgp = f"{adapters_dir}/M13_config_for_pychopper.txt"
    pf = f"{adapters_dir}/M13_seqs_for_pychopper.fa"
    r1 = reorient_file(fq, pf, cfgp, str(tmp_path / "one"), "x",
                       ReorientConfig(q=0.75))
    r2 = reorient_file(fq, pf, cfgp, str(tmp_path / "blk"), "x",
                       ReorientConfig(q=0.75), stream_block=48)
    assert r1.stats == r2.stats
    assert _tree(tmp_path / "one") == _tree(tmp_path / "blk")
    # multi-block runs return stats only (documented contract)
    assert r2.passed == []
    assert len(r1.passed) == r1.stats["pass"]
