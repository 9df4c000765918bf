"""Generator for the end-to-end golden fixtures (run ONCE; outputs are
checked in). Regenerate only for an intentional behavior change and
document it in the commit message.

Runs on the CPU path (JAX_PLATFORMS=cpu) against the seeded banks of
nano_orc.synth (seed 0, as the tests' ``adapters_dir`` fixture).

Produces:
  golden_coi.fastq   30 COI-length reads (SP5_004/SP27_005, COI primer
                     pair A, ~450 bp inserts, half reverse-complemented)
  golden_rrna.fastq  24 rRNA-length reads (SP5_002/SP27_003, RNA primer
                     pair A, ~3.7 kb inserts with the universal 18S/ITS
                     and ITS/28S junction anchors planted)
  golden_e2e_expected.json  expected run_all outputs for both datasets:
                     demux bins, species groups, consensus seqs, stage-04
                     cleaned contigs, stage-05 18S/28S extractions, and
                     COI_gene reorganisation.

Usage (from the repository root): PYTHONPATH=. python tests/fixtures/gen_golden_e2e.py
"""
import json
import os
import random

from nano_orc.demux.adapters import AdapterBank
from nano_orc.demux.primer_clean import parse_primer_pairs
from nano_orc.io import encode
from nano_orc.io.fastq import Record, write_records
from nano_orc.rrna.anchors import ANCHOR_18S_END, ANCHOR_28S_START

FIX = os.path.dirname(os.path.abspath(__file__))

random.seed(20260819)


def rand(n):
    return "".join(random.choice("ACGT") for _ in range(n))


def mutate(s, rate):
    out = []
    for ch in s:
        r = random.random()
        if r < rate / 3:
            continue                      # deletion
        if r < 2 * rate / 3:
            out.append(random.choice("ACGT"))   # substitution
            out.append(ch) if random.random() < 0 else None
        elif r < rate:
            out.append(ch)
            out.append(random.choice("ACGT"))   # insertion
        else:
            out.append(ch)
    return "".join(out)


def concretize(s):
    tab = {"R": "AG", "Y": "CT", "S": "GC", "W": "AT", "K": "GT",
           "M": "AC", "B": "CGT", "D": "AGT", "H": "ACT", "V": "ACG",
           "N": "ACGT"}
    return "".join(random.choice(tab.get(c, c)) for c in s)


def main():
    import tempfile

    from nano_orc import synth
    # the same banks as the tests' adapters_dir fixture (seed 0)
    adapters_dir = synth.write_banks(tempfile.mkdtemp(), seed=0)
    sp5 = AdapterBank.from_fasta(f"{adapters_dir}/M13_amplicon_indices_forward.fa",
                                 0.1)
    sp27 = AdapterBank.from_fasta(
        f"{adapters_dir}/M13_amplicon_indices_reverse_rc.fa", 0.1)
    coi_pairs = parse_primer_pairs(f"{adapters_dir}/COI_primers.fa")
    rna_pairs = parse_primer_pairs(f"{adapters_dir}/RNA_primers.fa")

    # --- COI dataset: two species templates, 450 bp -----------------------
    t1, t2 = rand(450), rand(450)
    # one concrete realization of the degenerate primers per dataset so
    # the consensus primer region is clean (a 50/50 degenerate mixture
    # would make boundary columns ambiguous in any engine)
    coi_f = concretize(coi_pairs[0].fwd)
    coi_r = concretize(coi_pairs[0].rev)
    coi = []
    for i in range(30):
        tmpl = t1 if i % 2 else t2
        insert = coi_f + mutate(tmpl, 0.015) + coi_r
        s = sp5.seqs[3] + insert + sp27.seqs[4]
        if i % 3 == 0:
            s = encode.revcomp(s)
        coi.append(Record(f"coi{i}", f"coi{i}", s, "I" * len(s)))
    write_records(os.path.join(FIX, "golden_coi.fastq"), coi, fmt="fastq")

    # --- rRNA dataset: one template, ~3.7 kb -----------------------------
    # Junctions are MUTATED + INDEL'D variants of the universal anchors
    # (2 subs + 1 del each -> identity ~0.84), NOT the module constants
    # verbatim (VERDICT r2 #5 de-circularization): the anchor finder
    # must succeed through its error tolerance, not by string equality.
    def perturb_anchor(a):
        s = list(a)
        for p in random.sample(range(1, len(s) - 1), 2):
            s[p] = random.choice([c for c in "ACGT" if c != s[p]])
        del s[random.randrange(1, len(s) - 1)]
        return "".join(s)

    j18 = perturb_anchor(ANCHOR_18S_END)
    j28 = perturb_anchor(ANCHOR_28S_START)
    gene = rand(700) + j18 + rand(280) + j28 + rand(2500)
    rna_f = concretize(rna_pairs[0].fwd)
    rna_r = concretize(rna_pairs[0].rev)
    rrna = []
    for i in range(24):
        insert = rna_f + mutate(gene, 0.015) + rna_r
        s = sp5.seqs[1] + insert + sp27.seqs[2]
        if i % 4 == 0:
            s = encode.revcomp(s)
        rrna.append(Record(f"rrna{i}", f"rrna{i}", s, "I" * len(s)))
    write_records(os.path.join(FIX, "golden_rrna.fastq"), rrna,
                  fmt="fastq")

    # --- run both pipelines and freeze the outputs -----------------------
    import tempfile

    from nano_orc.pipeline.stages import PipelineConfig, run_all
    exp = {}
    for name, amp, path in (("coi", "COI", "golden_coi.fastq"),
                            ("rrna", "RNA", "golden_rrna.fastq")):
        with tempfile.TemporaryDirectory() as td:
            rep = run_all(os.path.join(FIX, path), td, name, amp,
                          cfg=PipelineConfig(adapters_dir))
            ds = {"demux_bins": rep["demux"],
                  "barcodes": rep["barcodes"]}
            (bc,) = rep["barcodes"].keys()
            consensus = open(os.path.join(
                td, "sorted", bc, "consensusfile.fasta")).read()
            ds["consensusfile"] = consensus
            cleaned = os.path.join(td, "primerless", bc,
                                   f"cleaned_{bc}.fasta")
            ds["cleaned"] = open(cleaned).read()
            if amp == "COI":
                ds["coi_gene"] = open(os.path.join(
                    td, "COI_gene", bc, f"{bc}_COI.fasta")).read()
            else:
                for g in ("18S", "28S"):
                    p = os.path.join(td, "rRNA_genes", f"{bc}_{g}.fa")
                    ds[f"rrna_{g}"] = open(p).read()
            exp[name] = ds
    with open(os.path.join(FIX, "golden_e2e_expected.json"), "w") as fh:
        json.dump(exp, fh, indent=1)
    print("wrote fixtures;",
          {k: list(v["barcodes"].keys()) for k, v in exp.items()})


if __name__ == "__main__":
    main()
