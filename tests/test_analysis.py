"""Analysis layer tests: LCA, distance matrices, NJ/PD, anchor filter."""
import numpy as np
import pytest

from nano_orc.analysis.lca import (compute_lca, derive_metadata, lca_table,
                                  RANKS)
from nano_orc.analysis.phylo import (aln_matrix, dist_matrix, faith_pd,
                                    midpoint_root, nj_tree, overlap_matrix,
                                    parse_newick)
from nano_orc.analysis.anchors import AnchorFilterConfig, run_anchor_filter
from nano_orc.io.fastq import Record, write_records


def test_derive_metadata_primer_sets():
    m = derive_metadata("SP27_001_SP5_003_group1_readcount_7", 450)
    assert m == {"readcount": 7, "sample": "SP27_001_SP5_003",
                 "barcode": "COI", "primer_set": "Sauron"}
    assert derive_metadata("x_18S_rRNA", 1800)["primer_set"] == "18S+"
    assert derive_metadata("x_28S_y", 3000)["primer_set"] == "28S_solo"
    assert derive_metadata("c_readcount_2", 700)["primer_set"] == "Moorea"


def test_compute_lca_agreement():
    lin = [{"domain": "Euk", "phylum": "Mollusca", "class": "Gastropoda",
            "order": None, "family": None, "genus": None, "species": None},
           {"domain": "Euk", "phylum": "Mollusca", "class": "Bivalvia",
            "order": None, "family": None, "genus": None, "species": None}]
    r = compute_lca(lin)
    assert r["lca"] == "Mollusca" and r["lca_rank"] == "phylum"


def test_lca_table_end_to_end(tmp_path):
    tsv = tmp_path / "b.tsv"
    tsv.write_text(
        "SP27_001_SP5_002_group1_readcount_5\t620\ts1\t1e-50\t200\t99.0\t1\n"
        "SP27_001_SP5_002_group1_readcount_5\t620\ts2\t1e-40\t180\t97.0\t2\n")
    tax = {"1": dict(zip(RANKS, ["Euk", "Annelida", "Clitellata", "Hirudinida",
                                 "Hirudinidae", "Hirudo", "H. medicinalis"])),
           "2": dict(zip(RANKS, ["Euk", "Annelida", "Clitellata", "Hirudinida",
                                 "Hirudinidae", "Hirudo", "H. verbana"]))}
    rows = lca_table(str(tsv), tax, str(tmp_path / "out.csv"))
    assert len(rows) == 1
    assert rows[0]["lca"] == "Hirudo" and rows[0]["lca_rank"] == "genus"
    assert rows[0]["primer_set"] == "Moorea"
    assert (tmp_path / "out.csv").exists()


def test_dist_matrix_raw_and_k80():
    recs = [Record("a", "a", "AAAAAAAAAA"),
            Record("b", "b", "AAAAAAAAAG"),   # 1 transition / 10
            Record("c", "c", "AAAA--AAAC")]   # gap cols dropped pairwise
    M, labels = aln_matrix(recs)
    D = dist_matrix(M, "raw")
    assert D[0, 1] == pytest.approx(0.1)
    assert D[0, 2] == pytest.approx(1 / 8)
    K = dist_matrix(M, "K80")
    assert K[0, 1] > D[0, 1]  # K80 corrects upward


def test_overlap_matrix():
    recs = [Record("a", "a", "ACGT--GT"), Record("s", "s", "ACGTAC--")]
    M, _ = aln_matrix(recs)
    ov = overlap_matrix(M, [0], [1])
    assert ov[0, 0] == 4


def test_nj_and_pd():
    # 4 tips: two tight pairs far apart
    labels = ["a1", "a2", "b1", "b2"]
    D = np.array([[0.0, 0.02, 0.5, 0.5],
                  [0.02, 0.0, 0.5, 0.5],
                  [0.5, 0.5, 0.0, 0.02],
                  [0.5, 0.5, 0.02, 0.0]])
    t = nj_tree(D, labels)
    pd_all = faith_pd(t, labels)
    pd_pair = faith_pd(t, ["a1", "a2"])
    pd_cross = faith_pd(t, ["a1", "b1"])
    assert pd_pair == pytest.approx(0.02, abs=1e-6)
    assert pd_cross > 0.4
    assert pd_all >= pd_cross


def test_parse_newick_pd():
    """FastTree-shaped newick (internal support values, nested clades)
    parses into a Tree whose PD uses the ML branch lengths
    (phylo_anchor_filter.Rmd:72-92)."""
    nwk = "((a1:0.01,a2:0.01)0.99:0.24,(b1:0.01,b2:0.01)0.95:0.24):0.0;"
    t = parse_newick(nwk)
    assert sorted(t.labels) == ["a1", "a2", "b1", "b2"]
    assert t.n_tips == 4
    assert faith_pd(t, ["a1", "a2"]) == pytest.approx(0.02, abs=1e-9)
    assert faith_pd(t, ["a1", "b1"]) == pytest.approx(0.50, abs=1e-9)
    assert faith_pd(t, t.labels) == pytest.approx(0.52, abs=1e-9)


def test_midpoint_root():
    """Midpoint rooting places the root halfway along the longest
    tip-to-tip path; tip-to-tip path lengths (and PD) are preserved."""
    # caterpillar: a --5-- x --1-- y --2-- b, c hangs off y at 0.5
    nwk = "(a:5.0,(b:2.0,c:0.5)y:1.0)x;"
    t = midpoint_root(parse_newick(nwk))
    # longest path a-b = 8; root at 4 from a -> on edge a-x, 1 from x
    depths = {}
    for k, lab in enumerate(t.labels):
        d, v = 0.0, k
        while t.parent[v] >= 0:
            d += float(t.length[v])
            v = t.parent[v]
        depths[lab] = d
    assert depths["a"] == pytest.approx(4.0, abs=1e-9)
    assert depths["b"] == pytest.approx(4.0, abs=1e-9)
    assert faith_pd(t, ["a", "b"]) == pytest.approx(8.0, abs=1e-9)
    assert faith_pd(t, ["b", "c"]) == pytest.approx(2.5, abs=1e-9)


def test_anchor_filter_pipeline(tmp_path, rng):
    base = "".join(rng.choice(list("ACGT"), size=300))

    def mut(s, k):
        s = list(s)
        for pos in rng.choice(len(s), k, replace=False):
            s[int(pos)] = str(rng.choice(list("ACGT")))
        return "".join(s)

    recs, meta = [], ["label,type"]
    for i in range(3):
        recs.append(Record(f"s{i}", f"s{i}", mut(base, 3)))
        meta.append(f"s{i},sample")
    # several close anchors (whitelist; enough cover that the sole-cover
    # rule, which requires >=3 remaining coverers, permits dedup), one
    # duplicate pair, one divergent
    anchor_names = []
    for i in range(4):
        recs.append(Record(f"anch_c{i}", f"anch_c{i}", mut(base, 8 + i)))
        anchor_names.append(f"anch_c{i}")
    recs.append(Record("anch_dup1", "anch_dup1", mut(base, 12)))
    dup = recs[-1].seq
    recs.append(Record("anch_dup2", "anch_dup2", dup))
    far = "".join(rng.choice(list("ACGT"), size=300))
    recs.append(Record("anch_far", "anch_far", far))
    anchor_names += ["anch_dup1", "anch_dup2", "anch_far"]
    for a in anchor_names:
        meta.append(f"{a},anchor")
    aligned = tmp_path / "aln.fa"
    write_records(str(aligned), recs, fmt="fasta")
    mcsv = tmp_path / "meta.csv"
    mcsv.write_text("\n".join(meta) + "\n")
    res = run_anchor_filter(str(aligned), str(mcsv), str(tmp_path / "out"),
                            AnchorFilterConfig(threshold=0.2, dedup=0.005,
                                               subset=10))
    assert "anch_c0" in res.whitelisted
    assert "anch_far" in res.non_whitelisted
    # one of the duplicate pair dropped
    dropped = {d for d, _ in res.dedup_dropped}
    assert len({"anch_dup1", "anch_dup2"} & dropped) == 1
    assert "anch_far" in res.final_anchors  # PD fill uses leftover slots
    assert res.final_pd > 0
    assert (tmp_path / "out" / "anchor_filter_result.csv").exists()


def test_wrangle_metadata(tmp_path):
    from nano_orc.analysis.reports import wrangle_metadata, success_metrics
    blast = [dict(plate="day1", SP27="1", SP5="3", barcode="CO1",
                  max_readcount_group="2", max_readcount="40",
                  hit1_expect="Y", hit1_primer_set="Moorea",
                  hit2_group="", hit2_readcount="", hit2_expect="",
                  final_expect="Y"),
             dict(plate="day1", SP27="2", SP5="4", barcode="CO1",
                  max_readcount_group="1", max_readcount="9",
                  hit1_expect="N", hit1_primer_set="",
                  hit2_group="3", hit2_readcount="7", hit2_expect="Y",
                  final_expect="Y")]
    names = [dict(plate="day1", sample="SP27_001_SP5_003", barcode="CO1",
                  new_code="snail A", expected_taxon="Mollusca"),
             dict(plate="day1", sample="SP27_002_SP5_004", barcode="CO1",
                  new_code="cf. worm", expected_taxon="Annelida")]
    rows = wrangle_metadata(blast, names, str(tmp_path / "names.csv"))
    assert len(rows) == 2
    assert rows[0]["name"] == "snail_A"
    assert rows[0]["fasta_headers"].endswith("group2_readcount_40")
    assert rows[1]["fasta_headers"].endswith("group3_readcount_7")
    assert rows[1]["name"] == "worm"
    m = success_metrics(blast)
    assert m["MRC_match"] == 1 and m["AC_match"] == 1


def test_stage_read_flow(tmp_path):
    from nano_orc.analysis.reports import stage_read_flow
    rows = stage_read_flow({"raw": {"b1": 100}, "demux": {"b1": 80}},
                           str(tmp_path / "flow.tsv"))
    assert len(rows) == 2
    assert (tmp_path / "flow.tsv").exists()
