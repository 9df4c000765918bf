"""Primer cleanup (stage 04 equivalent) tests using the real COI/RNA
primer FASTAs."""
import pytest

from nano_orc.demux.primer_clean import (clean_primers, linked_trim,
                                        parse_primer_pairs,
                                        residual_primer_failsafe)
from nano_orc.io import encode
from nano_orc.io.fastq import Record


def concretize(rng, s):
    """IUPAC degenerate primer -> one concrete realization."""
    table = {"R": "AG", "Y": "CT", "S": "GC", "W": "AT", "K": "GT",
             "M": "AC", "B": "CGT", "D": "AGT", "H": "ACT", "V": "ACG",
             "N": "ACGT"}
    return "".join(str(rng.choice(list(table.get(c, c)))) for c in s)


def test_parse_coi_pairs(adapters_dir):
    pairs = parse_primer_pairs(f"{adapters_dir}/COI_primers.fa")
    ids = [p.pair_id for p in pairs]
    assert ids == ["A", "B"]
    # the shared reverse primer (Moorea_and_Sauron_Reverse_A_B) must be
    # assigned to both pairs
    assert pairs[0].rev == pairs[1].rev


def test_parse_rna_pairs(adapters_dir):
    pairs = parse_primer_pairs(f"{adapters_dir}/RNA_primers.fa")
    assert len(pairs) >= 2


def test_linked_trim_recovers_insert(adapters_dir, rng):
    pairs = parse_primer_pairs(f"{adapters_dir}/COI_primers.fa")
    insert = "".join(rng.choice(list("ACGT"), size=600))
    pa = pairs[0]
    seq = concretize(rng, pa.fwd) + insert + concretize(rng, pa.rev)
    recs = [Record("c1", "c1", seq)]
    trimmed, untrimmed = linked_trim(recs, pairs)
    assert len(trimmed) == 1 and not untrimmed
    assert trimmed[0].seq == insert


def test_linked_requires_both(adapters_dir):
    # Local pinned rng, NOT the shared session stream: the REV primer
    # has 9 IUPAC wildcards and a floor(0.1*26)=2 error budget, so ~3%
    # of random 400 bp inserts contain a chance REV match (cutadapt
    # would trim those too — faithful, but it made this test fragile to
    # upstream tests consuming the session rng). Seed 1 verified
    # REV-free.
    import numpy as np
    rng = np.random.default_rng(1)
    pairs = parse_primer_pairs(f"{adapters_dir}/COI_primers.fa")
    insert = "".join(rng.choice(list("ACGT"), size=400))
    seq = concretize(rng, pairs[0].fwd) + insert  # no reverse primer
    trimmed, untrimmed = linked_trim([Record("u", "u", seq)], pairs)
    assert not trimmed and len(untrimmed) == 1


def test_failsafe_drops_residual(adapters_dir, rng):
    pairs = parse_primer_pairs(f"{adapters_dir}/COI_primers.fa")
    good = Record("g", "g", "".join(rng.choice(list("ACGT"), size=500)))
    bad_seq = ("".join(rng.choice(list("ACGT"), size=30))
               + concretize(rng, pairs[0].fwd)
               + "".join(rng.choice(list("ACGT"), size=400)))
    bad = Record("b", "b", bad_seq)
    clean, dropped = residual_primer_failsafe(
        [good, bad], [pairs[0].fwd, pairs[0].rev])
    assert [r.id for r in clean] == ["g"]
    assert dropped == ["b"]


def test_failsafe_checks_revcomp(adapters_dir, rng):
    pairs = parse_primer_pairs(f"{adapters_dir}/COI_primers.fa")
    seq = ("".join(rng.choice(list("ACGT"), size=300))
           + encode.revcomp(concretize(rng, pairs[0].rev))
           + "".join(rng.choice(list("ACGT"), size=40)))
    clean, dropped = residual_primer_failsafe(
        [Record("rc", "rc", seq)], [pairs[0].rev])
    assert dropped == ["rc"]


def test_failsafe_middle_not_checked(adapters_dir, rng):
    """A primer buried mid-contig (outside the 100 bp ends) is allowed —
    matches the reference's ends-only scan."""
    pairs = parse_primer_pairs(f"{adapters_dir}/COI_primers.fa")
    seq = ("".join(rng.choice(list("ACGT"), size=200))
           + concretize(rng, pairs[0].fwd)
           + "".join(rng.choice(list("ACGT"), size=200)))
    clean, dropped = residual_primer_failsafe(
        [Record("m", "m", seq)], [pairs[0].fwd])
    assert not dropped


def test_clean_primers_end_to_end(adapters_dir, tmp_path, rng):
    pairs = parse_primer_pairs(f"{adapters_dir}/COI_primers.fa")
    recs = []
    inserts = []
    for i in range(5):
        ins = "".join(rng.choice(list("ACGT"), size=550))
        inserts.append(ins)
        recs.append(Record(f"k{i}", f"k{i}",
                           concretize(rng, pairs[i % 2].fwd) + ins
                           + concretize(rng, pairs[i % 2].rev)))
    recs.append(Record("junk", "junk",
                       "".join(rng.choice(list("ACGT"), size=500))))
    clean, rep = clean_primers(recs, f"{adapters_dir}/COI_primers.fa",
                               outdir=str(tmp_path), name="t")
    assert rep.total == 6
    assert rep.trimmed == 5 and rep.untrimmed == 1
    assert {r.seq for r in clean} == set(inserts)
    assert (tmp_path / "cleaned_t.fasta").exists()


def test_match_read_wildcards_on_amb_consensus(adapters_dir, rng):
    """An -amb consensus can carry IUPAC codes inside the primer region;
    with --match-read-wildcards they count as matches (so the linked trim
    still fires at e=0.1), without it they count as mismatches."""
    pairs = parse_primer_pairs(f"{adapters_dir}/COI_primers.fa")
    pa = pairs[0]
    insert = "".join(rng.choice(list("ACGT"), size=600))
    fwd = list(concretize(rng, pa.fwd))
    # plant enough ambiguity codes to bust the error budget when they
    # are treated as mismatches: floor(0.1 * len) + 1 of them
    k = int(0.1 * len(fwd)) + 1
    for pos in range(0, 3 * k, 3):
        fwd[pos] = {"A": "R", "C": "Y", "G": "R", "T": "Y"}[fwd[pos]]
    seq = "".join(fwd) + insert + concretize(rng, pa.rev)
    rec = Record("amb1", "amb1", seq, None)

    t_lit, u_lit = linked_trim([rec], pairs, 0.1,
                               match_read_wildcards=False)
    t_wc, u_wc = linked_trim([rec], pairs, 0.1,
                             match_read_wildcards=True)
    assert not t_lit and len(u_lit) == 1   # literal: budget exceeded
    assert len(t_wc) == 1 and not u_wc     # wildcards: full linked trim
    assert t_wc[0].seq == insert


def test_failsafe_wildcards_spot_ambiguous_residual(adapters_dir, rng):
    """Residual-primer failsafe with wildcards: a leftover primer whose
    ambiguity codes survived into the contig is still detected."""
    pairs = parse_primer_pairs(f"{adapters_dir}/COI_primers.fa")
    pa = pairs[0]
    residual = pa.fwd  # keep the degenerate codes verbatim in the contig
    body = "".join(rng.choice(list("ACGT"), size=300))
    rec = Record("c1", "c1", residual + body, None)
    clean_wc, dropped_wc = residual_primer_failsafe(
        [rec], [pa.fwd], match_read_wildcards=True)
    assert dropped_wc == ["c1"]
