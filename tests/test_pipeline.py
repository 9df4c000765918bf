"""Pipeline host-side components + CLI end-to-end (run-all on a tiny
synthetic dataset)."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from nano_orc.io.fastq import Record, write_records, read_fasta
from nano_orc.pipeline.qc import compute_stats, n50
from nano_orc.pipeline.extractors import (categorize_by_length,
                                         extract_coi_max,
                                         extract_ribo_max, get_readcount)
from nano_orc.pipeline.downstream import (blast_top5_filter,
                                         prep_anchor_selection,
                                         reorganise_barcodes,
                                         sanitize_header)
from nano_orc.pipeline.summary import expected_barcodes, summarize_barcode_dir

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_n50():
    assert n50(np.array([2, 2, 2, 3, 3, 4])) == 3
    assert n50(np.array([10])) == 10


def test_compute_stats():
    recs = [Record("a", "a", "ACGT" * 25, "I" * 100),
            Record("b", "b", "ACGT" * 50, "5" * 200)]
    s = compute_stats(recs)
    assert s.number_of_reads == 2
    assert s.number_of_bases == 300
    assert s.n50 == 200
    assert s.mean_qual is not None


def test_get_readcount():
    assert get_readcount("BC_group1_readcount_42") == 42
    assert get_readcount("no_count_here") == 0


def test_categorize_by_length():
    recs = [Record("m", "m", "A" * 700), Record("s", "s", "A" * 200),
            Record("d", "d", "A" * 400)]
    m, s, d = categorize_by_length(recs)
    assert [r.id for r in m] == ["m"]
    assert [r.id for r in s] == ["s"]
    assert [r.id for r in d] == ["d"]


def test_extract_ribo_max(tmp_path):
    d = tmp_path / "bins" / "BC01"
    d.mkdir(parents=True)
    write_records(str(d / "BC01_18S.fa"), [
        Record("x_readcount_5", "x_readcount_5", "ACGT"),
        Record("y_readcount_9", "y_readcount_9", "ACGT")], fmt="fasta")
    out = extract_ribo_max(str(tmp_path / "bins"), str(tmp_path / "out"))
    assert len(out["18S"]) == 1 and out["18S"][0].id == "y_readcount_9"
    assert (tmp_path / "out" / "18S_max_readcount.fa").exists()


def test_extract_coi_max(tmp_path):
    d = tmp_path / "bins" / "BC02"
    d.mkdir(parents=True)
    write_records(str(d / "BC02_COI.fasta"), [
        Record("m_readcount_3", "m_readcount_3", "A" * 650),
        Record("m2_readcount_8", "m2_readcount_8", "A" * 700),
        Record("s_readcount_2", "s_readcount_2", "A" * 300)], fmt="fasta")
    out = extract_coi_max(str(tmp_path / "bins"), str(tmp_path / "out"))
    assert out["moorea"][0].id == "m2_readcount_8"
    assert out["sauron"][0].id == "s_readcount_2"


def test_blast_top5(tmp_path):
    rows = []
    for q in ("q1", "q2"):
        for i in range(8):
            rows.append(f"{q}\t100\ts{i}\t{10**-i}\t50\t98\t123")
    p = tmp_path / "in.tsv"
    p.write_text("\n".join(rows) + "\n")
    out = tmp_path / "out.tsv"
    n = blast_top5_filter(str(p), str(out))
    assert n == 10
    lines = out.read_text().strip().split("\n")
    # per query, the 5 smallest e-values kept, ascending
    q1 = [l.split("\t") for l in lines if l.startswith("q1")]
    assert len(q1) == 5
    assert float(q1[0][3]) <= float(q1[-1][3])
    assert float(q1[0][3]) == 1e-7 and float(q1[-1][3]) == 1e-3


def test_expected_barcodes_grid():
    g = expected_barcodes()
    assert len(g) == 96
    assert "SP27_001_SP5_001" in g and "SP27_008_SP5_012" in g
    assert not any("SP27_009" in b for b in g)


def test_summary_grid_backfill(tmp_path):
    d = tmp_path / "sorted"
    d.mkdir()
    write_records(str(d / "SP27_001_SP5_003_consensus_coi.fasta"), [
        Record("SP27_001_SP5_003_group1_readcount_12",
               "SP27_001_SP5_003_group1_readcount_12", "ACGT")],
        fmt="fasta")
    rows = summarize_barcode_dir(str(d), str(tmp_path / "sum.tsv"))
    assert len(rows) == 96
    hit = [r for r in rows if r["sample"] == "SP27_001_SP5_003"][0]
    assert hit["amplicon_found"] == "yes"
    assert hit["best_hit_readcount"] == 12
    assert sum(1 for r in rows if r["amplicon_found"] == "no") == 95


def test_sanitize_and_prep_anchors(tmp_path):
    assert sanitize_header("a b|c:d") == "a_b_c_d"
    aligned = tmp_path / "aligned.fa"
    samples = tmp_path / "samples.fa"
    write_records(str(aligned), [Record("s1|x", "s1|x", "ACGT"),
                                 Record("anch 1", "anch 1", "ACGT")],
                  fmt="fasta")
    write_records(str(samples), [Record("s1|x", "s1|x", "ACGT")],
                  fmt="fasta")
    clean, meta = prep_anchor_selection(str(aligned), str(samples), "COI",
                                        str(tmp_path / "out"))
    txt = open(meta).read()
    assert "s1_x,sample" in txt and "anch_1,anchor" in txt


def test_reorganise_barcodes(tmp_path):
    csv = tmp_path / "curated.csv"
    csv.write_text(
        "sample,fasta_header,barcode,expected_taxon,name\n"
        "SP27_001_SP5_003_lakes,BC1_group1_readcount_9,COI,Mollusca,snailA\n")
    coi = tmp_path / "coi.fa"
    write_records(str(coi), [
        Record("consensus_BC1_group1_readcount_9",
               "consensus_BC1_group1_readcount_9", "ACGTACGT")],
        fmt="fasta")
    counts = reorganise_barcodes(str(csv), {"COI": str(coi)},
                                 str(tmp_path))
    assert counts == {"Mollusca/COI": 1}
    out = tmp_path / "trees" / "Mollusca" / "COI.fasta"
    assert out.read_text().startswith(">snailA|SP27_001_SP5_003|lakes")


@pytest.mark.slow
def test_cli_run_all(adapters_dir, tmp_path):
    """Full 00->05 via the CLI on a miniature two-species dataset."""
    rng = np.random.default_rng(7)
    from nano_orc.demux.adapters import AdapterBank
    sp5 = AdapterBank.from_fasta(f"{adapters_dir}/M13_amplicon_indices_forward.fa",
                                 0.1)
    sp27 = AdapterBank.from_fasta(
        f"{adapters_dir}/M13_amplicon_indices_reverse_rc.fa", 0.1)

    def noisy(s, err=0.03):
        out = []
        for ch in s:
            r = rng.random()
            if r < err * 0.4:
                continue
            if r < err * 0.7:
                out.append(str(rng.choice(list("ACGT"))))
                out.append(ch)
            elif r < err:
                out.append(str(rng.choice(list("ACGT"))))
            else:
                out.append(ch)
        return "".join(out)

    template = "".join(rng.choice(list("ACGT"), size=420))
    reads = []
    for i in range(30):
        amplicon = noisy(template)
        seq = sp5.seqs[0] + amplicon + sp27.seqs[0]
        reads.append(Record(f"r{i}", f"r{i}", seq, "I" * len(seq)))
    raw = tmp_path / "raw.fastq"
    write_records(str(raw), reads, fmt="fastq")

    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-m", "nano_orc.cli", "run-all", str(raw),
         "-o", str(tmp_path / "out"), "-n", "mini", "-a", "COI",
         "--adapters-dir", adapters_dir],
        capture_output=True, text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    rep = json.loads(out.stdout.strip().split("\n")[-1])
    assert rep["qc"]["reads"] == 30
    assert rep["demux"]["binned_reads"] == 30
    assert (tmp_path / "out" / "amplicon_summary.tsv").exists()
    assert (tmp_path / "out" / "run_report.json").exists()


def test_host_file_shard_partition():
    from nano_orc.dist.multihost import host_file_shard
    paths = [f"bin_{i:02d}.fastq" for i in range(10)]
    all_assigned = []
    for pid in range(3):
        shard = host_file_shard(paths, process_id=pid, num_processes=3)
        all_assigned += shard
    assert sorted(all_assigned) == sorted(paths)  # disjoint and complete
    assert host_file_shard(paths, 0, 3) != host_file_shard(paths, 1, 3)


def test_reorganise_cois(tmp_path):
    """05b (05b_reorganise_COIs.sh:20-51): primerless/<sample>/[COIs/]
    cleaned*.fasta -> COI_gene/<sample>/<sample>_COI.fasta."""
    from nano_orc.pipeline.stages import stage_reorganise_cois
    # reference nested layout
    d1 = tmp_path / "primerless" / "SP27_001_SP5_001" / "COIs"
    d1.mkdir(parents=True)
    (d1 / "cleaned_amplicon_1.fasta").write_text(">c1\nACGT\n")
    # our flat layout
    d2 = tmp_path / "primerless" / "SP27_002_SP5_001"
    d2.mkdir(parents=True)
    (d2 / "cleaned_SP27_002_SP5_001.fasta").write_text(">c2\nTTAA\n")
    copied = stage_reorganise_cois(str(tmp_path))
    assert set(copied) == {"SP27_001_SP5_001", "SP27_002_SP5_001"}
    p = tmp_path / "COI_gene" / "SP27_001_SP5_001" / \
        "SP27_001_SP5_001_COI.fasta"
    assert p.read_text() == ">c1\nACGT\n"
    p2 = tmp_path / "COI_gene" / "SP27_002_SP5_001" / \
        "SP27_002_SP5_001_COI.fasta"
    assert p2.read_text() == ">c2\nTTAA\n"


def test_run_all_rna_stage05_default(adapters_dir, tmp_path, rng):
    """run_all on an RNA dataset runs stage 05 OUT OF THE BOX (no model
    files): contigs split at the universal junction anchors into
    rRNA_genes/<bin>_18S.fa / _28S.fa (VERDICT r1 missing#3)."""
    from nano_orc.demux.adapters import AdapterBank
    from nano_orc.demux.primer_clean import parse_primer_pairs
    from nano_orc.pipeline.stages import PipelineConfig, run_all
    from nano_orc.rrna.anchors import ANCHOR_18S_END, ANCHOR_28S_START
    from nano_orc.io import encode
    sp5 = AdapterBank.from_fasta(f"{adapters_dir}/M13_amplicon_indices_forward.fa",
                                 0.1)
    sp27 = AdapterBank.from_fasta(f"{adapters_dir}/M13_amplicon_indices_reverse_rc.fa",
                                  0.1)
    pairs = parse_primer_pairs(f"{adapters_dir}/RNA_primers.fa")
    pa = pairs[0]

    def conc(s):
        tab = {"R": "AG", "Y": "CT", "S": "GC", "W": "AT", "K": "GT",
               "M": "AC"}
        return "".join(str(rng.choice(list(tab.get(c, c)))) for c in s)

    def pad(n):
        return "".join(rng.choice(list("ACGT"), size=n))

    def noisy(s, k):
        s = list(s)
        for _ in range(k):
            s[int(rng.integers(0, len(s)))] = str(rng.choice(list("ACGT")))
        return "".join(s)

    gene = (pad(500) + ANCHOR_18S_END + pad(260)
            + ANCHOR_28S_START + pad(600))
    recs = []
    for i in range(24):
        insert = conc(pa.fwd) + noisy(gene, 25) + conc(pa.rev)
        s = sp5.seqs[0] + insert + sp27.seqs[0]
        if i % 2:
            s = encode.revcomp(s)
        recs.append(Record(f"r{i}", f"r{i}", s, "I" * len(s)))
    fq = tmp_path / "rna.fastq"
    write_records(str(fq), recs, fmt="fastq")
    rep = run_all(str(fq), str(tmp_path / "out"), "rnatest", "RNA",
                  cfg=PipelineConfig(adapters_dir))
    (bc,) = rep["barcodes"].keys()
    assert rep["barcodes"][bc]["rrna"]["18S"] >= 1
    assert rep["barcodes"][bc]["rrna"]["28S"] >= 1
    g18 = tmp_path / "out" / "rRNA_genes" / f"{bc}_18S.fa"
    g28 = tmp_path / "out" / "rRNA_genes" / f"{bc}_28S.fa"
    assert g18.exists() and g28.exists()
    seq18 = "".join(g18.read_text().splitlines()[1:])
    # the 18S segment ends at/near the junction anchor (cons may differ
    # by a base or two from the template)
    assert abs(len(seq18) - (500 + len(ANCHOR_18S_END))) <= 6


def test_cli_sort_flags_sfq_gz(tmp_path, rng):
    """CLI sort exposes the full amplicon_sorter flag surface: -sfq
    writes per-group fastq (with quals), -c gzips group files, and the
    threshold flags reach SorterConfig."""
    import gzip
    import subprocess
    import sys

    t = "".join(rng.choice(list("ACGT"), size=400))
    recs = []
    for i in range(12):
        s = list(t)
        for _ in range(8):
            s[int(rng.integers(0, len(s)))] = str(rng.choice(list("ACGT")))
        s = "".join(s)
        recs.append(Record(f"r{i}", f"r{i}", s, "I" * len(s)))
    fq = tmp_path / "bin.fastq"
    write_records(str(fq), recs, fmt="fastq")
    r = subprocess.run(
        [sys.executable, "-m", "nano_orc.cli", "sort", str(fq),
         "-o", str(tmp_path), "-b", "BC9", "--sfq", "--gz",
         "--sg", "0.8", "--ss", "0.85", "--sc", "0.96", "--ldc", "8",
         "--np", "4"],
        capture_output=True, text=True,
        env={**os.environ, "JAX_PLATFORMS": "cpu",
             "PYTHONPATH": os.pathsep.join(
                 [os.getcwd()] + os.environ.get(
                     "PYTHONPATH", "").split(os.pathsep))})
    assert r.returncode == 0, r.stderr[-2000:]
    rep = json.loads(r.stdout.strip().splitlines()[-1])
    assert rep["species_groups"] == 1
    gdir = tmp_path / "sorted" / "BC9"
    fastas = list(gdir.glob("BC9_*_*.fasta.gz"))
    fastqs = list(gdir.glob("BC9_*_*.fastq.gz"))
    assert fastas and fastqs
    txt = gzip.open(fastqs[0], "rt").read()
    assert txt.startswith("@") and "+\n" in txt


def test_run_all_bin_workers_byte_identical(adapters_dir, tmp_path, rng):
    """bin_workers=2 (concurrent barcode bins, the SLURM-array analogue)
    produces byte-identical pipeline artifacts to the sequential run."""
    import filecmp
    import gzip
    from nano_orc.demux.adapters import AdapterBank
    from nano_orc.io import encode
    from nano_orc.pipeline.stages import PipelineConfig, run_all
    sp5 = AdapterBank.from_fasta(f"{adapters_dir}/M13_amplicon_indices_forward.fa",
                                 0.1)
    sp27 = AdapterBank.from_fasta(f"{adapters_dir}/M13_amplicon_indices_reverse_rc.fa",
                                  0.1)
    tmpls = ["".join(rng.choice(list("ACGT"), size=380)) for _ in range(3)]

    def noisy(t, k):
        s = list(t)
        for _ in range(k):
            s[int(rng.integers(0, len(s)))] = str(rng.choice(list("ACGT")))
        return "".join(s)

    recs = []
    for i in range(36):
        b = i % 3                       # 3 distinct bins
        s = sp5.seqs[b] + noisy(tmpls[b], 10) + sp27.seqs[b]
        if i % 4 == 0:
            s = encode.revcomp(s)
        recs.append(Record(f"r{i}", f"r{i}", s, "I" * len(s)))
    fq = tmp_path / "in.fastq"
    write_records(str(fq), recs, fmt="fastq")

    rep1 = run_all(str(fq), str(tmp_path / "seq"), "ds", "COI",
                   cfg=PipelineConfig(adapters_dir, bin_workers=1))
    rep2 = run_all(str(fq), str(tmp_path / "par"), "ds", "COI",
                   cfg=PipelineConfig(adapters_dir, bin_workers=2))
    assert len(rep1["barcodes"]) == 3
    assert rep1["barcodes"] == rep2["barcodes"]
    skip = {"metrics.json", "run_report.json"}
    for root, _, files in os.walk(tmp_path / "seq"):
        for f in files:
            if f in skip:
                continue
            a = os.path.join(root, f)
            b = a.replace(str(tmp_path / "seq"), str(tmp_path / "par"))
            assert os.path.exists(b), b
            if f.endswith(".gz"):
                assert gzip.open(a).read() == gzip.open(b).read(), a
            else:
                assert filecmp.cmp(a, b, shallow=False), a
