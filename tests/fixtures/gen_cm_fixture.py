"""Generate an Infernal-1.1-layout .cm fixture wrapping the repo's
HMMER3/f euk fixture models as each CM's embedded p7 FILTER HMM.

Infernal .cm files ("CM file format", Infernal User Guide; the
Rfam 14.10 models the reference's pybarrnap variant uses,
the reference README.md:50-51) store, per model:

    INFERNAL1/a [...]          header + key-value fields
    CM                         covariance-model node/state body
    //                         CM terminator
    HMMER3/f [...]             the p7 FILTER HMM (RNA alphabet)
    //                         filter terminator

The generated fixture carries a minimal-but-shaped CM body (the
nano_orc CM ingestion reads only the header fields and the embedded
filter HMM — docstring of nano_orc/rrna/cm.py) and the real fixture
HMMs re-alphabetized to RNA (T -> U) exactly as cmbuild stores
filters.

Usage (from the repository root): PYTHONPATH=. python tests/fixtures/gen_cm_fixture.py
"""
import os
import re

FIX = os.path.dirname(os.path.abspath(__file__))

NAMES = {"18S_rRNA": ("SSU_rRNA_eukarya", "RF01960"),
         "5_8S_rRNA": ("5_8S_rRNA", "RF00002"),
         "28S_rRNA": ("LSU_rRNA_eukarya", "RF02543")}


def split_models(text):
    out = []
    cur = []
    for line in text.splitlines():
        if line.startswith("HMMER3") and cur:
            out.append("\n".join(cur) + "\n")
            cur = []
        cur.append(line)
    if cur:
        out.append("\n".join(cur) + "\n")
    return out


def to_rna(hmm_text):
    """Re-alphabetize a DNA p7 text to the RNA form cm files embed."""
    hmm_text = hmm_text.replace("ALPH  DNA", "ALPH  RNA")
    return re.sub(r"^HMM          A        C        G        T",
                  "HMM          A        C        G        U",
                  hmm_text, flags=re.M)


def cm_shell(name, acc, clen):
    body = [
        "INFERNAL1/a [1.1.4 | Dec 2020]",
        f"NAME     {name}",
        f"ACC      {acc}",
        f"DESC     {name} fixture covariance model",
        "STATES   120",
        "NODES    40",
        f"CLEN     {clen}",
        "W        160",
        "ALPH     RNA",
        "RF       no",
        "CONS     yes",
        "MAP      yes",
        "DATE     Thu Aug 20 00:00:00 2026",
        "COM      [1] cmbuild fixture.cm fixture.sto",
        "PBEGIN   0.05",
        "PEND     0.05",
        "WBETA    1e-07",
        "QDBBETA1 1e-07",
        "QDBBETA2 1e-15",
        "N2OMEGA  1.52588e-05",
        "N3OMEGA  1.52588e-05",
        "ELSELF   -0.08926734",
        "NSEQ     12",
        "EFFN     3.162743",
        "CKSUM    1234567890",
        "GA       50.00",
        "TC       55.00",
        "NC       45.00",
        "ECMLC    0.62369    -8.95393  0.81613     1600000  531847  0.002258",
        "CM",
        # minimal shaped CM body: ROOT node + MATL chain stub — the
        # nano_orc reader skips to the filter HMM, but keep the grammar
        # recognizable for eyeballing
        "                                             [ ROOT    0 ]"
        "      -      -      -      -      -      -",
        "     S     0    -1 0     1     4     0     1   160   160"
        "  -7.902  -8.141  -0.043  -5.566",
        "    IL     1     1 2     1     4     0     1   161   161"
        "  -2.817  -4.319  -0.613  -2.698"
        "  0.000  0.000  0.000  0.000",
        "//",
    ]
    return "\n".join(body) + "\n"


def main():
    src = open(os.path.join(FIX, "euk_rrna.hmm")).read()
    models = split_models(src)
    out = []
    for text in models:
        name = re.search(r"^NAME  (\S+)", text, re.M).group(1)
        leng = re.search(r"^LENG  (\d+)", text, re.M).group(1)
        cm_name, acc = NAMES[name]
        out.append(cm_shell(cm_name, acc, leng))
        rna = to_rna(text)
        # cm files keep the filter under the CM's name
        rna = re.sub(r"^NAME  \S+", f"NAME  {cm_name}-p7filter", rna,
                     flags=re.M)
        out.append(rna)
        if not rna.endswith("//\n"):
            out.append("//\n")
    with open(os.path.join(FIX, "euk_rrna.cm"), "w") as fh:
        fh.write("".join(out))
    print("wrote", os.path.join(FIX, "euk_rrna.cm"))


if __name__ == "__main__":
    main()
