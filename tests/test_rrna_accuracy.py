"""rRNA junction placement accuracy in nucleotides (VERDICT r3 next#3).

Fixtures here synthesize REALISTIC full-length rDNA amplicon
architecture — 18S | ITS1 | 5.8S | ITS2 | 28S with the published
conserved cores at their documented gene positions, random variable
regions between them, an UNCONSERVED 28S 5' leader ahead of the LSU
core block (the region responsible for the r3 ±25 nt structural bias),
and 5-8% read-level noise (subs + indels) applied segment-wise so the
true junction positions are tracked exactly.

The tests MEASURE the junction placement error of the zero-config
block-profile detector in nt and ASSERT bounds: median <= 10 nt and
p90 <= 25 nt per junction (18S/ITS1 and ITS2/28S), both strands.
"""
import numpy as np
import pytest

from nano_orc.io import encode
from nano_orc.io.fastq import Record
from nano_orc.rrna.profiles import (EUK_LSU_BLOCKS, EUK_SSU_BLOCKS,
                                   find_rrna_default)

IUPAC = {"R": "AG", "Y": "CT", "S": "GC", "W": "AT", "K": "GT",
         "M": "AC", "B": "CGT", "D": "AGT", "H": "ACT", "V": "ACG",
         "N": "ACGT"}


def _conc(rng, s):
    return "".join(str(rng.choice(list(IUPAC[c]))) if c in IUPAC else c
                   for c in s)


def _rand(rng, n):
    return "".join(rng.choice(list("ACGT"), size=n))


def _noise(rng, s, rate):
    out = []
    for ch in s:
        r = rng.random()
        if r < rate / 3:
            continue                              # deletion
        if r < 2 * rate / 3:
            out.append(str(rng.choice(list("ACGT"))))  # substitution
        elif r < rate:
            out.append(ch)
            out.append(str(rng.choice(list("ACGT"))))  # insertion
        else:
            out.append(ch)
    return "".join(out)


def make_rdna_contig(rng, noise_rate):
    """(contig, true_end18, true_start28) with noise applied
    segment-wise so the truth positions are exact."""
    ssu = {name: seq for name, seq, _pos in EUK_SSU_BLOCKS}
    lsu_core = EUK_LSU_BLOCKS[0][1]
    lsu_lead = EUK_LSU_BLOCKS[0][2]   # documented gene pos of the core
    # 18S: conserved cores at roughly their documented spacings,
    # ending WITH the ITS1 site (the 18S 3' terminus)
    parts_18s = [_rand(rng, 59), _conc(rng, ssu["SSU_F04"]),
                 _rand(rng, 470), _conc(rng, ssu["SSU_V4"]),
                 _rand(rng, 1030), _conc(rng, ssu["SSU_1389F"]),
                 _rand(rng, 130), _conc(rng, ssu["ITS1_site"])]
    # 5.8S: ~155 nt, includes the universal ITS3-primer region
    parts_58s = [_rand(rng, 40), "GCATCGATGAAGAACGCAGC", _rand(rng, 95)]
    # 28S: UNCONSERVED 5' leader (the documented lsu_lead nt) ahead of
    # the conserved core — the region the detector must extrapolate
    parts_28s = [_rand(rng, lsu_lead), _conc(rng, lsu_core),
                 _rand(rng, 540), _conc(rng, EUK_LSU_BLOCKS[1][1]),
                 _rand(rng, 290), _conc(rng, EUK_LSU_BLOCKS[2][1]),
                 _rand(rng, 90)]
    n18s = _noise(rng, "".join(parts_18s), noise_rate)
    nits1 = _noise(rng, _rand(rng, 220), noise_rate)
    n58s = _noise(rng, "".join(parts_58s), noise_rate)
    nits2 = _noise(rng, _rand(rng, 200), noise_rate)
    n28s = _noise(rng, "".join(parts_28s), noise_rate)
    contig = n18s + nits1 + n58s + nits2 + n28s
    return contig, len(n18s), len(contig) - len(n28s)


def _junction_errors(noise_rate, n_contigs, seed):
    rng = np.random.default_rng(seed)
    recs, truth = [], []
    for i in range(n_contigs):
        contig, e18, s28 = make_rdna_contig(rng, noise_rate)
        if i % 2:
            contig = encode.revcomp(contig)
        recs.append(Record(f"c{i}", f"c{i}", contig))
        truth.append((e18, s28, len(contig)))
    hits = find_rrna_default(recs)
    by18 = {h.contig_id: h for h in hits["18S"]}
    by28 = {h.contig_id: h for h in hits["28S"]}
    err18, err28 = [], []
    for i, (e18, s28, n) in enumerate(truth):
        cid = f"c{i}"
        # gene-oriented lengths are strand-agnostic: |18S| = end18,
        # |28S| = n - start28
        if cid in by18:
            err18.append(abs(len(by18[cid].seq) - e18))
        if cid in by28:
            err28.append(abs(len(by28[cid].seq) - (n - s28)))
    return err18, err28, len(recs)


@pytest.mark.parametrize("noise,seed", [(0.05, 11), (0.08, 12)])
def test_junction_error_bounds(noise, seed):
    """The product's rRNA accuracy headline: on realistic noisy
    full-length rDNA, both junctions are detected on every contig and
    placed with median error <= 10 nt and p90 <= 25 nt."""
    err18, err28, n = _junction_errors(noise, n_contigs=16, seed=seed)
    assert len(err18) == n, "18S junction missed on some contigs"
    assert len(err28) == n, "28S junction missed on some contigs"
    for name, errs in (("18S/ITS1", err18), ("ITS2/28S", err28)):
        med = float(np.median(errs))
        p90 = float(np.percentile(errs, 90))
        print(f"{name} @noise={noise}: median={med:.1f}nt "
              f"p90={p90:.1f}nt max={max(errs)}nt")
        assert med <= 10.0, f"{name} median {med} > 10 nt ({errs})"
        assert p90 <= 25.0, f"{name} p90 {p90} > 25 nt ({errs})"


def test_28s_lead_extrapolation_unbiased():
    """The r3 structural bias specifically: with ZERO noise the
    detected 28S start must land at the true ITS2/28S boundary (the
    start of the unconserved leader), not at the conserved core 25 nt
    downstream."""
    rng = np.random.default_rng(3)
    contig, e18, s28 = make_rdna_contig(rng, 0.0)
    hits = find_rrna_default([Record("z", "z", contig)])
    h28 = {h.contig_id: h for h in hits["28S"]}["z"]
    assert abs(h28.start - s28) <= 3, (h28.start, s28)
    h18 = {h.contig_id: h for h in hits["18S"]}["z"]
    assert abs(h18.end - e18) <= 3, (h18.end, e18)
