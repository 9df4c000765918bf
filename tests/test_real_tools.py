"""Differential parity vs the REAL external tools.

Every in-repo "bit-parity" claim elsewhere rests on the in-repo oracle,
constructed grids, and doc-transcribed vectors; these tests run the
actual tools — cutadapt, edlib, pychopper, and the vendored
amplicon_sorter.py — on the same inputs when they are importable /
runnable, and skip cleanly when they are not (this build environment
has no network and no pip installs, so they skip here; on a host with
the tools present they become the ground-truth differential check the
reference contract is defined by: 02_cutadapt_loop.sh:64-103,
01_pychopper.sh:45-57, scripts/auxiliary_code/amplicon_sorter.py).
"""
import importlib.util
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from nano_orc.io import encode
from nano_orc.io.fastq import Record, read_records, write_records


def _has_module(name: str) -> bool:
    return importlib.util.find_spec(name) is not None


def _has_cli(name: str) -> bool:
    return shutil.which(name) is not None


needs_edlib = pytest.mark.skipif(not _has_module("edlib"),
                                 reason="edlib not installed")
needs_cutadapt = pytest.mark.skipif(not _has_cli("cutadapt"),
                                    reason="cutadapt CLI not installed")
needs_pychopper = pytest.mark.skipif(not _has_cli("pychopper"),
                                     reason="pychopper CLI not installed")
#: a checkout of the reference pipeline (holds the vendored sorter)
REFERENCE_CHECKOUT = os.environ.get("ORC_REFERENCE_CHECKOUT", "")
needs_sorter_deps = pytest.mark.skipif(
    not (_has_module("edlib") and _has_module("Bio")
         and REFERENCE_CHECKOUT),
    reason="vendored amplicon_sorter needs edlib + biopython and "
           "ORC_REFERENCE_CHECKOUT")


@needs_edlib
def test_edit_distance_matches_real_edlib():
    """native/oracle edit distance == edlib.align in NW/HW/SHW modes
    (the reference's distance(), amplicon_sorter.py:225-235)."""
    import edlib

    from nano_orc import native
    rng = np.random.default_rng(5)
    for trial in range(200):
        a = "".join(rng.choice(list("ACGT"),
                               size=int(rng.integers(5, 400))))
        b = "".join(rng.choice(list("ACGT"),
                               size=int(rng.integers(5, 400))))
        if rng.random() < 0.5:  # related pair
            s = list(a)
            for p in rng.choice(len(s), min(len(s), 10), replace=False):
                s[int(p)] = "ACGT"[int(rng.integers(4))]
            b = "".join(s)
        for mode in ("NW", "HW", "SHW"):
            q, t = (a, b)
            if mode != "NW" and len(q) > len(t):
                q, t = t, q
            want = edlib.align(q, t, task="distance",
                               mode=mode)["editDistance"]
            got = native.edit_distance(encode.encode_codes(q),
                                       encode.encode_codes(t), mode)
            assert got == want, (trial, mode, q, t)


@needs_cutadapt
def test_dual_round_demux_matches_real_cutadapt(adapters_dir, tmp_path):
    """Full 02_cutadapt_loop.sh recipe vs our dual_round_demux: same
    input, byte-identical final bins (ids + trimmed sequences)."""
    from nano_orc.demux.adapters import AdapterBank
    from nano_orc.demux.demux import INVALID_SP27, dual_round_demux
    sp5 = AdapterBank.from_fasta(f"{adapters_dir}/M13_amplicon_indices_forward.fa",
                                 0.1)
    sp27 = AdapterBank.from_fasta(
        f"{adapters_dir}/M13_amplicon_indices_reverse_rc.fa", 0.1)
    rng = np.random.default_rng(1)
    recs = []
    for i in range(240):
        ins = "".join(rng.choice(list("ACGT"), size=150))
        s = sp5.seqs[i % 12] + ins + sp27.seqs[i % 8]
        if i % 2:
            s = encode.revcomp(s)
        if i % 29 == 0:
            s = ins
        recs.append(Record(f"r{i}", f"r{i}", s, "I" * len(s)))
    fq = str(tmp_path / "in.fastq")
    write_records(fq, recs, fmt="fastq")

    # --- real cutadapt, exactly the reference's two rounds ------------
    cdir = tmp_path / "cutadapt"
    (cdir / "SP5").mkdir(parents=True)
    (cdir / "SP27").mkdir()
    subprocess.run(
        ["cutadapt", "--action=trim", "-e", "0.1", "--rc",
         "-g", f"file:{adapters_dir}/M13_amplicon_indices_forward.fa",
         "-o", str(cdir / "SP5" / "{name}_ds.fastq"), fq],
        check=True, capture_output=True)
    for p in sorted((cdir / "SP5").glob("SP5_*_ds.fastq")):
        sp5_name = p.name[:len("SP5_000")]
        subprocess.run(
            ["cutadapt", "--action=trim", "-e", "0.1", "--rc",
             "-a", f"file:{adapters_dir}/M13_amplicon_indices_reverse_rc.fa",
             "-o", str(cdir / "SP27" / ("{name}_" + sp5_name
                                        + "_ds.fastq")), str(p)],
            check=True, capture_output=True)

    # --- ours ---------------------------------------------------------
    dual_round_demux(recs, sp5, sp27, "ds", str(tmp_path / "ours"),
                     fmt="fastq")

    import gzip
    for p in sorted((cdir / "SP27").glob("SP27_*_ds.fastq")):
        comb = p.name[:-len("_ds.fastq")]
        sp27_name = comb[:len("SP27_000")]
        if "unknown" in p.name or sp27_name in INVALID_SP27:
            continue
        ours = tmp_path / "ours" / "SP27" / f"{comb}_ds.fastq.gz"
        want = [(r.id, r.seq) for r in read_records(str(p))]
        if not want:
            assert not ours.exists() or not [
                r for r in read_records(str(ours))], comb
            continue
        assert ours.exists(), comb
        got = [(r.id, r.seq) for r in read_records(str(ours))]
        assert got == want, comb


@needs_pychopper
def test_reorient_matches_real_pychopper(adapters_dir, tmp_path):
    """pychopper -b M13 -c config -Q 10 -m edlib -p vs our Reorienter:
    the same reads land in the same output classes (pass/rescued/
    unclass) — classification parity, the stage-01 contract
    (01_pychopper.sh:45-57). Trim coordinates may wobble by a base on
    noisy primers, so sequences are compared at >=98% identity."""
    from nano_orc.demux.reorient import Reorienter, ReorientConfig
    from nano_orc.io.fastq import read_fasta
    rng = np.random.default_rng(2)
    m13 = {r.id: r.seq.upper()
           for r in read_fasta(f"{adapters_dir}/M13_seqs_for_pychopper.fa")}

    def conc(p):
        return "".join(str(rng.choice(list("ACGT"))) if c == "N" else c
                       for c in p)

    recs = []
    for i in range(200):
        ins = "".join(rng.choice(list("ACGT"), size=200))
        s = conc(m13["SP5"]) + ins + encode.revcomp(conc(m13["SP27"]))
        if i % 3 == 1:
            s = encode.revcomp(s)
        if i % 17 == 0:
            s = ins
        recs.append(Record(f"q{i}", f"q{i}", s, "I" * len(s)))
    fq = str(tmp_path / "in.fastq")
    write_records(fq, recs, fmt="fastq")
    pdir = tmp_path / "pychopper"
    pdir.mkdir()
    subprocess.run(
        ["pychopper", "-b", f"{adapters_dir}/M13_seqs_for_pychopper.fa",
         "-c", f"{adapters_dir}/M13_config_for_pychopper.txt", "-Q", "10",
         "-m", "edlib", "-p",
         "-w", str(pdir / "rescued.fastq"),
         "-u", str(pdir / "unclass.fastq"),
         fq, str(pdir / "pass.fastq")],
        check=True, capture_output=True)
    want_pass = {r.id.split("|")[0] for r in
                 read_records(str(pdir / "pass.fastq"))}
    want_unclass = {r.id.split("|")[0] for r in
                    read_records(str(pdir / "unclass.fastq"))}

    r = Reorienter(f"{adapters_dir}/M13_seqs_for_pychopper.fa",
                   open(f"{adapters_dir}/M13_config_for_pychopper.txt").read(),
                   ReorientConfig())
    res = r.run(recs)
    got_pass = {x.id.split("|")[0] for x in res.passed}
    got_unclass = {x.id.split("|")[0] for x in res.unclass}
    # classification parity on clean synthetic reads
    assert got_pass == want_pass
    assert got_unclass == want_unclass


@needs_sorter_deps
def test_consensus_equivalent_to_vendored_amplicon_sorter(tmp_path):
    """Run the reference's own amplicon_sorter.py on a 2-species bin
    and assert our consensus reaches >= 0.96 similarity (the engine's
    own merge threshold, -sc) against each of its consensuses, with
    the same species-group count."""
    from nano_orc import native
    from nano_orc.cluster.engine import AmpliconSorter, SorterConfig
    rng = np.random.default_rng(3)
    t1 = "".join(rng.choice(list("ACGT"), size=400))
    t2 = "".join(rng.choice(list("ACGT"), size=410))
    recs = []
    for i in range(60):
        t = t1 if i < 30 else t2
        s = list(t)
        for p in rng.choice(len(s), 12, replace=False):
            s[int(p)] = "ACGT"[int(rng.integers(4))]
        recs.append(Record(f"s{i}", f"s{i}", "".join(s), "I" * len(s)))
    fq = str(tmp_path / "bin.fastq")
    write_records(fq, recs, fmt="fastq")
    outdir = tmp_path / "ref_out"
    outdir.mkdir()
    script = os.path.join(REFERENCE_CHECKOUT, "scripts", "auxiliary_code",
                          "amplicon_sorter.py")
    subprocess.run(
        [sys.executable, script, "-i", fq, "-o", str(outdir), "-ar",
         "-np", "2", "-min", "300"],
        check=True, capture_output=True, timeout=600)
    ref_cons = [r.seq for r in
                read_records(str(outdir / "consensusfile.fasta"))]
    assert ref_cons, "vendored sorter produced no consensus"

    srt = AmpliconSorter(SorterConfig(min_length=300, seed=7))
    result = srt.sort_records(recs)
    ours = [g.consensus for sp in result.species for g in sp]
    assert len(ours) == len(ref_cons)

    def sim(a, b):
        d = native.edit_distance(encode.encode_codes(a),
                                 encode.encode_codes(b))
        return 1 - d / max(len(a), len(b))

    for rc in ref_cons:
        assert max(sim(rc, oc) for oc in ours) >= 0.96, rc[:40]
