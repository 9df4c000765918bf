"""Generate a realistic HMMER3/f multi-model DNA fixture (VERDICT r2 #5).

Writes ``euk_rrna.hmm`` with three models — 18S_rRNA (K=80), 5_8S_rRNA
(K=40), 28S_rRNA (K=80) — in the FULL HMMER3/f text layout per the
HMMER User Guide "HMM file format" section: every header field barrnap's
euk files carry (NAME/ACC/DESC/LENG/MAXL/ALPH/RF/MM/CONS/CS/MAP/DATE/
NSEQ/EFFN/CKSUM/STATS/GA/TC/NC), a COMPO line, node-0 insert/transition
lines, and per-node match lines WITH the MAP/CONS/RF/MM/CS annotation
columns. The last node's m->d and d->d are '*' (zero probability) as
hmmbuild emits.

Each model's consensus is a fixed generated sequence (written into the
fixture as the CONS column and into euk_rrna_consensus.json), with match
emissions peaked at the consensus base (p=0.91, others 0.03) — so tests
can sample sequences from the model and assert Viterbi finds them at
the right coordinates. The emissions/transitions are written as
NEGATIVE NATURAL LOGS exactly as HMMER stores them.

Usage (from the repository root): PYTHONPATH=. python tests/fixtures/gen_euk_hmm_fixture.py
"""
import json
import math
import os
import random

FIX = os.path.dirname(os.path.abspath(__file__))
random.seed(20260820)

P_MATCH = 0.91
P_OTHER = 0.03
BASES = "ACGT"
# transitions (probabilities -> -ln written to file)
T = {"mm": 0.95, "mi": 0.025, "md": 0.025,
     "im": 0.50, "ii": 0.50, "dm": 0.60, "dd": 0.40}


def nl(p):
    return "*" if p <= 0 else f"{-math.log(p):.5f}"


def model_text(name, acc, desc, cons):
    K = len(cons)
    out = []
    out.append("HMMER3/f [3.1b2 | February 2015]")
    out.append(f"NAME  {name}")
    out.append(f"ACC   {acc}")
    out.append(f"DESC  {desc}")
    out.append(f"LENG  {K}")
    out.append(f"MAXL  {K + 60}")
    out.append("ALPH  DNA")
    out.append("RF    no")
    out.append("MM    no")
    out.append("CONS  yes")
    out.append("CS    no")
    out.append("MAP   yes")
    out.append("DATE  Thu Aug 20 00:00:00 2026")
    out.append("NSEQ  12")
    out.append("EFFN  3.162743")
    out.append("CKSUM 1234567890")
    out.append("GA    50.00;")
    out.append("TC    55.00;")
    out.append("NC    45.00;")
    out.append("STATS LOCAL MSV      -10.1234  0.70000")
    out.append("STATS LOCAL VITERBI  -11.2345  0.70000")
    out.append("STATS LOCAL FORWARD   -4.5678  0.70000")
    out.append("HMM          A        C        G        T")
    out.append("            m->m     m->i     m->d     i->m     i->i"
               "     d->m     d->d")
    bg = nl(0.25)
    out.append(f"  COMPO   {bg}  {bg}  {bg}  {bg}")
    # node 0: insert emissions + begin transitions (B->M1 ~ mm)
    out.append(f"          {bg}  {bg}  {bg}  {bg}")
    out.append(f"          {nl(T['mm'])}  {nl(T['mi'])}  {nl(T['md'])}"
               f"  {nl(T['im'])}  {nl(T['ii'])}  {nl(0.0)}  {nl(0.0)}")
    for k in range(1, K + 1):
        c = cons[k - 1]
        ems = "  ".join(nl(P_MATCH if b == c else P_OTHER)
                        for b in BASES)
        # match line with MAP CONS RF MM CS annotation columns
        out.append(f"{k:7d}   {ems} {k:7d} {c.lower()} - - -")
        out.append(f"          {bg}  {bg}  {bg}  {bg}")
        if k == K:  # hmmbuild: last node has m->d = d->d = 0 prob
            out.append(f"          {nl(T['mm'] + T['md'])}"
                       f"  {nl(T['mi'])}  *  {nl(T['im'])}"
                       f"  {nl(T['ii'])}  {nl(1.0)}  *")
        else:
            out.append(f"          {nl(T['mm'])}  {nl(T['mi'])}"
                       f"  {nl(T['md'])}  {nl(T['im'])}  {nl(T['ii'])}"
                       f"  {nl(T['dm'])}  {nl(T['dd'])}")
    out.append("//")
    return "\n".join(out)


def main():
    cons = {
        "18S_rRNA": "".join(random.choice(BASES) for _ in range(80)),
        "5_8S_rRNA": "".join(random.choice(BASES) for _ in range(40)),
        "28S_rRNA": "".join(random.choice(BASES) for _ in range(80)),
    }
    txt = "\n".join(model_text(n, f"RF{k:05d}", f"{n} eukaryote fixture",
                               c)
                    for k, (n, c) in enumerate(cons.items())) + "\n"
    with open(os.path.join(FIX, "euk_rrna.hmm"), "w") as fh:
        fh.write(txt)
    with open(os.path.join(FIX, "euk_rrna_consensus.json"), "w") as fh:
        json.dump(cons, fh, indent=1)
    print("wrote euk_rrna.hmm:", {n: len(c) for n, c in cons.items()})


if __name__ == "__main__":
    main()
