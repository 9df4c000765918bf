"""Clustering engine tests: consensus quality + species separation on
synthetic nanopore-noise data (the 'equivalent consensus' contract,
SURVEY.md §7.4.3)."""
import numpy as np
import pytest

from nano_orc.cluster.consensus import build_consensus, consensus_direction
from nano_orc.cluster.engine import (AmpliconSorter, SorterConfig,
                                    estimate_ssg)
from nano_orc.cluster.unionfind import UnionFind
from nano_orc.io import encode
from nano_orc.io.fastq import Record
from nano_orc import native


def noisy(rng, s, err=0.08):
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


def sim(a, b):
    d = native.edit_distance(encode.encode_codes(a), encode.encode_codes(b))
    return 1 - d / max(len(a), len(b))


def test_unionfind_components():
    uf = UnionFind(6)
    uf.union(0, 1)
    uf.union(1, 2)
    uf.union(4, 5)
    comps = uf.components()
    assert [0, 1, 2] in comps and [4, 5] in comps and [3] in comps


def test_estimate_ssg_mass():
    sims = np.array([0.99] * 10 + [0.90] * 200 + [0.81] * 50)
    v = estimate_ssg(sims)
    assert 0.80 <= v <= 0.99


def test_consensus_recovers_template(rng):
    template = "".join(rng.choice(list("ACGT"), size=500))
    reads = [noisy(rng, template, 0.08) for _ in range(40)]
    codes = [encode.encode_codes(r) for r in reads]
    cons = encode.decode(build_consensus(codes))
    assert sim(cons, template) >= 0.98, sim(cons, template)


def test_consensus_direction_orients(rng):
    template = "".join(rng.choice(list("ACGT"), size=300))
    reads = [noisy(rng, template, 0.05) for _ in range(6)]
    flipped = [encode.encode_codes(encode.revcomp(r)) if i % 2 else
               encode.encode_codes(r) for i, r in enumerate(reads)]
    oriented = consensus_direction(flipped)
    c = encode.decode(build_consensus(oriented))
    assert sim(c, template) >= 0.97


@pytest.mark.slow
def test_two_species_sorting():
    """Two species in one barcode bin: the sorter must produce two species
    groups whose consensuses match the true templates."""
    rng = np.random.default_rng(123)  # hermetic: independent of test order
    spA = "".join(rng.choice(list("ACGT"), size=620))
    # species B: ~85% similar to A (same gene, different species)
    spB = list(spA)
    n_mut = int(len(spB) * 0.12)
    for pos in rng.choice(len(spB), n_mut, replace=False):
        spB[pos] = str(rng.choice(list("ACGT")))
    spB = "".join(spB)
    reads = []
    for i in range(45):
        reads.append(Record(f"a{i}", f"a{i}", noisy(rng, spA, 0.07)))
    for i in range(35):
        reads.append(Record(f"b{i}", f"b{i}", noisy(rng, spB, 0.07)))
    srt = AmpliconSorter(SorterConfig(min_length=300, seed=1))
    res = srt.sort_records(reads)
    assert not res.skipped
    assert len(res.gene_groups) == 1, res.gene_groups
    species = res.species[0]
    assert len(species) == 2, [len(s.members) for s in species]
    cons = [s.consensus for s in species]
    simsA = [sim(c, spA) for c in cons]
    simsB = [sim(c, spB) for c in cons]
    best_to_A = int(np.argmax(simsA))
    best_to_B = int(np.argmax(simsB))
    assert best_to_A != best_to_B
    assert simsA[best_to_A] >= 0.97, simsA
    assert simsB[best_to_B] >= 0.97, simsB
    # membership purity: group matching A should be mostly a-reads
    a_grp = species[best_to_A].members
    purity = np.mean([srt.ids[i].startswith("a") for i in a_grp])
    assert purity >= 0.9


@pytest.mark.slow
def test_two_genes_sorting():
    """Two unrelated genes (e.g. COI + rRNA fragment) must split into two
    gene groups at the 0.80 stage."""
    rng = np.random.default_rng(321)  # hermetic
    g1 = "".join(rng.choice(list("ACGT"), size=500))
    g2 = "".join(rng.choice(list("ACGT"), size=520))
    reads = [Record(f"x{i}", f"x{i}", noisy(rng, g1, 0.06))
             for i in range(20)]
    reads += [Record(f"y{i}", f"y{i}", noisy(rng, g2, 0.06))
              for i in range(20)]
    srt = AmpliconSorter(SorterConfig(min_length=300, seed=2))
    res = srt.sort_records(reads)
    assert len(res.gene_groups) == 2, [len(g) for g in res.gene_groups]


def test_skip_few_reads():
    recs = [Record(f"r{i}", f"r{i}", "ACGT" * 100) for i in range(3)]
    res = AmpliconSorter(SorterConfig()).sort_records(recs)
    assert res.skipped


def test_deterministic(rng):
    template = "".join(rng.choice(list("ACGT"), size=400))
    reads = [Record(f"r{i}", f"r{i}", noisy(rng, template, 0.06))
             for i in range(30)]
    r1 = AmpliconSorter(SorterConfig(seed=7)).sort_records(reads)
    r2 = AmpliconSorter(SorterConfig(seed=7)).sort_records(reads)
    assert [s.consensus for g in r1.species for s in g] == \
           [s.consensus for g in r2.species for s in g]
    assert r1.gene_groups == r2.gene_groups


def test_species_stage_no_cross_group_leak():
    """A read outside the gene group that shares one >=ssg edge with a
    member must NOT be unioned into this group's species components —
    the reference's read_indexes (amplicon_sorter.py:1341-1461) operates
    strictly within one gene group. Models a dropped <=5-read gene group
    leaking into a kept one."""
    from nano_orc.cluster.scoring import PairHits
    rng = np.random.default_rng(5)
    tA = "".join(rng.choice(list("ACGT"), size=400))
    tB = "".join(rng.choice(list("ACGT"), size=400))
    reads = [Record(f"a{i}", f"a{i}", noisy(rng, tA, 0.04))
             for i in range(10)]
    reads.append(Record("z0", "z0", noisy(rng, tB, 0.04)))
    srt = AmpliconSorter(SorterConfig(min_length=300, seed=3))
    srt.ids = [r.id for r in reads]
    srt.seqs = [r.seq for r in reads]
    srt.codes = [encode.encode_codes(s) for s in srt.seqs]
    ii, jj, ss = [], [], []
    for i in range(10):
        for j in range(i + 1, 10):
            ii.append(i), jj.append(j), ss.append(0.93)
    ii.append(0), jj.append(10), ss.append(0.92)   # the leak edge
    edges = PairHits(np.asarray(ii), np.asarray(jj), np.asarray(ss, float),
                     np.zeros(len(ii), bool))
    species = srt._species_stage(list(range(10)), edges, ssg=0.85)
    members = [m for s in species for m in s.members]
    assert 10 not in members, "outside read leaked into species group"
    assert len(species) >= 1 and len(members) >= 5


def test_ambiguous_consensus_iupac():
    """-amb equivalent: a 50/50 split column becomes an IUPAC code.
    Local fixed-seed rng: with the session rng the template depends on
    test order, and a template whose het site lands inside a repeat can
    legitimately shift the column layout."""
    from nano_orc.cluster.consensus import build_consensus_iupac
    rng = np.random.default_rng(1234)
    template = "".join(rng.choice(list("ACGT"), size=200))
    reads = []
    for i in range(30):
        s = list(template)
        s[100] = "C" if i % 2 else "T"   # heterozygous-like site
        reads.append(encode.encode_codes("".join(s)))
    cons = build_consensus_iupac(reads)
    assert "Y" in cons, cons[95:105]
    # the rest matches the template
    plain = cons.replace("Y", template[100])
    assert sim(plain, template) >= 0.995


def test_native_pileup_matches_python_path(rng):
    """The fused C++ pileup (native.pileup_batch) reproduces the Python
    _align_rows + column_counts reference path bit-for-bit, including
    merged/right-aligned insertion columns and the draft row's vote."""
    from nano_orc.cluster import consensus as C
    for trial in range(8):
        L = int(rng.integers(30, 350))
        base = rng.integers(0, 4, size=L).astype(np.uint8)
        reads = []
        for _ in range(int(rng.integers(0, 18))):
            s = list(base)
            for _ in range(int(rng.integers(0, max(2, L // 6)))):
                op = int(rng.integers(0, 3))
                p = int(rng.integers(0, len(s)))
                if op == 0:
                    s[p] = int(rng.integers(0, 5))
                elif op == 1 and len(s) > 1:
                    del s[p]
                else:
                    s.insert(p, int(rng.integers(0, 5)))
            reads.append(np.array(s, np.uint8))
        a = C.pileup_counts(base, reads, backend="python")
        b = C.pileup_counts(base, reads, backend="native")
        assert a.shape == b.shape
        assert (a == b).all()


def test_nw_dist_batch_matches_singles(rng):
    from nano_orc import native
    q = rng.integers(0, 4, size=200).astype(np.uint8)
    seqs = [rng.integers(0, 4, size=int(rng.integers(50, 400))
                         ).astype(np.uint8) for _ in range(15)]
    d = native.nw_dist_batch(q, seqs)
    for k, s in enumerate(seqs):
        assert d[k] == native.edit_distance(q, s)


def test_all_vs_all_threaded_matches_single(rng):
    from nano_orc import native
    seqs = [rng.integers(0, 4, size=int(rng.integers(100, 200))
                         ).astype(np.uint8) for _ in range(20)]
    d1 = native.all_vs_all(seqs, band=1.05, nthreads=1)
    d2 = native.all_vs_all(seqs, band=1.05, nthreads=4)
    assert (d1 == d2).all()


def test_hw_sims_pairs_matches_per_pair(rng):
    """The batched G^2 consensus-pair scorer (one native crossing,
    orc_hw_pairs) returns exactly what per-pair _hw_sim computes."""
    from nano_orc.cluster.engine import AmpliconSorter, SorterConfig
    eng = AmpliconSorter(SorterConfig())
    cons = []
    for _ in range(7):
        n = int(rng.integers(60, 200))
        cons.append("".join("ACGT"[c] for c in rng.integers(0, 4, n)))
    pairs = [(a, b) for a in range(len(cons) - 1)
             for b in range(a + 1, len(cons))]
    sims = eng._hw_sims_pairs(cons, pairs)
    for (a, b), s in zip(pairs, sims):
        assert abs(s - eng._hw_sim(cons[a], cons[b])) < 1e-9, (a, b)


def _mutate_reads(rng, base, n, rate=8):
    reads = []
    for _ in range(n):
        s = list(base)
        for _ in range(int(rng.integers(0, max(2, len(base) // rate)))):
            op = int(rng.integers(0, 3))
            p = int(rng.integers(0, len(s)))
            if op == 0:
                s[p] = int(rng.integers(0, 5))
            elif op == 1 and len(s) > 1:
                del s[p]
            else:
                s.insert(p, int(rng.integers(0, 5)))
        reads.append(np.array(s, np.uint8))
    return reads


def test_engine_sort_device_backend_identical(monkeypatch):
    """Full sort with the python pileup backend == native backend:
    identical species groups and consensus strings."""
    from nano_orc.cluster import consensus as C
    from nano_orc.cluster.engine import AmpliconSorter, SorterConfig
    from nano_orc.io.fastq import Record

    rng = np.random.default_rng(23)
    t1 = "".join("ACGT"[c] for c in rng.integers(0, 4, 320))
    t2 = "".join("ACGT"[c] for c in rng.integers(0, 4, 340))
    recs = []
    for k, t in enumerate((t1, t2)):
        for i in range(30):
            s = list(t)
            for _ in range(int(rng.integers(0, 12))):
                p = int(rng.integers(0, len(s)))
                s[p] = "ACGT"[int(rng.integers(0, 4))]
            recs.append(Record(f"r{k}_{i}", f"r{k}_{i}", "".join(s)))
    results = {}
    for backend in ("native", "python"):
        monkeypatch.setattr(C, "PILEUP_BACKEND", backend)
        eng = AmpliconSorter(SorterConfig(min_length=1, seed=5))
        res = eng.sort_records(recs)
        results[backend] = [
            (tuple(sorted(g.members)), g.consensus)
            for gg in res.species for g in gg]
    assert results["native"] == results["python"]


def test_entries_from_counts_matches_python_homopolymersort():
    """The lexsort-vectorized consensus pass equals the per-run Python
    sort reference on random pileups (incl. tie columns)."""
    import numpy as np
    from nano_orc.cluster.consensus import (_entries_from_counts,
                                           _homopolymersort,
                                           top2_from_counts)
    rng = np.random.default_rng(123)
    for trial in range(20):
        W = int(rng.integers(1, 120))
        c = int(rng.integers(2, 40))
        counts = rng.integers(0, c, size=(W, 5)).astype(np.int64)
        counts[rng.random(W) < 0.3] = 0  # empty columns
        thr = float(rng.choice([0.45, 0.15, 0.5]))
        tb, tc = top2_from_counts(counts)
        keep = (tb[:, 0] >= 0) & (tc[:, 0] > c * 0.10)
        want_entries = _homopolymersort(
            [(int(b0), int(c0), int(b1), int(c1))
             for b0, c0, b1, c1 in zip(tb[keep, 0], tc[keep, 0],
                                       tb[keep, 1], tc[keep, 1])])
        want_cons = np.asarray(
            [e[0] for e in want_entries if e[1] > c * thr], np.uint8)
        got_entries, got_cons = _entries_from_counts(counts, c, thr)
        assert got_entries == want_entries, trial
        assert np.array_equal(got_cons, want_cons), trial


def test_sort_cli_flags_aln_all_ho(tmp_path):
    """Reference CLI surface: -a/--all (one comparison block), -aln
    (per-group star-alignment fasta), -ho (histogram figure only) —
    amplicon_sorter.py:172-184."""
    import json
    import numpy as np
    from nano_orc.cli import main as cli_main
    from nano_orc.io.fastq import Record, write_records

    rng = np.random.default_rng(31)
    t1 = "".join(rng.choice(list("ACGT"), size=340))
    recs = []
    for i in range(12):
        s = list(t1)
        for p in rng.choice(len(s), 5, replace=False):
            s[int(p)] = "ACGT"[int(rng.integers(4))]
        recs.append(Record(f"m{i}", f"m{i}", "".join(s), "I" * len(s)))
    fq = str(tmp_path / "bin.fastq")
    write_records(fq, recs, fmt="fastq")

    # --ho: histogram only, no sorted outputs
    cli_main(["sort", fq, "-o", str(tmp_path / "ho"), "-b", "B1",
              "--ho"])
    figs = list((tmp_path / "ho").glob("*_total_outputfig.pdf"))
    assert len(figs) == 1 and figs[0].stat().st_size > 500
    assert not (tmp_path / "ho" / "sorted").exists()

    # --all + --aln: sorted outputs + per-group alignment fasta
    cli_main(["sort", fq, "-o", str(tmp_path / "srt"), "-b", "B1",
              "--all", "--aln"])
    alns = list((tmp_path / "srt" / "sorted" / "B1").glob(
        "*_alignment.fasta"))
    assert alns, "no alignment fasta written"
    txt = open(alns[0]).read()
    lines = txt.splitlines()
    assert lines[0] == ">consensus"
    widths = {len(ln) for ln in lines[1::2]}
    assert len(widths) == 1  # all rows share the alignment width
    assert txt.count(">") == 13  # consensus + 12 members


def test_sort_cli_folder_input(tmp_path):
    """Reference -i accepts a FOLDER of bin files (amplicon_sorter.py
    main loop): every file sorts into its own outputs."""
    import json

    import numpy as np
    from nano_orc.cli import main as cli_main
    from nano_orc.io.fastq import Record, write_records

    rng = np.random.default_rng(41)
    ind = tmp_path / "bins"
    ind.mkdir()
    for b in range(2):
        t = "".join(rng.choice(list("ACGT"), size=330))
        recs = []
        for i in range(8):
            s = list(t)
            for p in rng.choice(len(s), 4, replace=False):
                s[int(p)] = "ACGT"[int(rng.integers(4))]
            recs.append(Record(f"b{b}r{i}", f"b{b}r{i}", "".join(s),
                               "I" * len(s)))
        write_records(str(ind / f"bin{b}.fastq"), recs, fmt="fastq")
    cli_main(["sort", str(ind), "-o", str(tmp_path / "out")])
    for b in range(2):
        p = (tmp_path / "out" / "sorted"
             / f"bin{b}_consensus_amplicons.fasta")
        assert p.exists(), p
        assert open(p).read().count(">") >= 1
