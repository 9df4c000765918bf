"""Seeded synthetic inputs: adapter/primer banks and amplicon read sets.

``write_banks`` writes, from a seed, the files the pipeline reads from an
adapters directory, with the names and shape of the reference's
``adapters_primers/``:

* ``M13_amplicon_indices_forward.fa``: 12 SP5 adapters, a 25 bp prefix +
  a 17 bp index + the 17 bp M13 forward primer, so all 12 end in the
  shared ``...GGCCAG`` suffix;
* ``M13_amplicon_indices_reverse_rc.fa``: the reverse complements of 12
  SP27 adapters (a 23 bp prefix + a 17 bp index + the M13 reverse primer
  ``CAGGAAACAGCTATGAC``); SP27_009-012 are the plate's impossible
  combinations (02_cutadapt_loop.sh:114-118);
* ``M13_seqs_for_pychopper.fa``: the SP5 and SP27 profiles with the index
  as ``N17``, and ``M13_config_for_pychopper.txt``:
  ``+:SP5,-SP27|-:SP27,-SP5``;
* ``COI_primers.fa`` and ``RNA_primers.fa``: degenerate primer pairs
  named as the reference names them (``..._Forward_A``, a reverse
  primer shared by pairs A and B as ``..._Reverse_A_B``).

Indices are random 17-mers at least 8 substitutions apart within a bank.
The read generators build raw reads with the structure of a real run
(SP5 adapter + primer + insert + primer + SP27-rc adapter, half of them
reverse-complemented) and nanopore-like errors.
"""
from __future__ import annotations

import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .io import encode
from .io.fastq import Record

SP5_FASTA = "M13_amplicon_indices_forward.fa"
SP27RC_FASTA = "M13_amplicon_indices_reverse_rc.fa"
PYCHOPPER_FASTA = "M13_seqs_for_pychopper.fa"
PYCHOPPER_CONFIG = "M13_config_for_pychopper.txt"
COI_PRIMERS = "COI_primers.fa"
RNA_PRIMERS = "RNA_primers.fa"

M13_FORWARD = "TGTAAAACGACGGCCAG"
M13_REVERSE = "CAGGAAACAGCTATGAC"
CONFIG = "+:SP5,-SP27|-:SP27,-SP5"
N_INDICES = 12
INDEX_LEN = 17
IUPAC = {"R": "AG", "Y": "CT", "S": "GC", "W": "AT", "K": "GT", "M": "AC",
         "B": "CGT", "D": "AGT", "H": "ACT", "V": "ACG", "N": "ACGT"}
_BASES = np.frombuffer(b"ACGT", np.uint8)


def _rand(rng: np.random.Generator, n: int) -> str:
    return _BASES[rng.integers(0, 4, n)].tobytes().decode()


def _indices(rng: np.random.Generator, n: int, min_dist: int = 8
             ) -> List[str]:
    out: List[np.ndarray] = []
    while len(out) < n:
        c = rng.integers(0, 4, INDEX_LEN)
        if all((c != o).sum() >= min_dist for o in out):
            out.append(c)
    return [_BASES[c].tobytes().decode() for c in out]


def _degenerate(rng: np.random.Generator, n: int, n_wild: int) -> str:
    s = list(_rand(rng, n))
    codes = "KMRSWY"  # two-base codes
    for p in rng.choice(np.arange(2, n - 2), n_wild, replace=False):
        s[p] = codes[int(rng.integers(0, len(codes)))]
    return "".join(s)


def _fasta(path: str, recs: Sequence[Tuple[str, str]]) -> None:
    with open(path, "w") as fh:
        fh.write("".join(f">{n}\n{s}\n" for n, s in recs))


def write_banks(outdir: str, seed: int = 0) -> str:
    """Write the seeded adapter/primer files into ``outdir``; returns it."""
    rng = np.random.default_rng(seed)
    os.makedirs(outdir, exist_ok=True)
    p5, p27 = _rand(rng, 25), _rand(rng, 23)
    i5, i27 = _indices(rng, N_INDICES), _indices(rng, N_INDICES)
    _fasta(os.path.join(outdir, SP5_FASTA),
           [(f"SP5_{k + 1:03d}", p5 + ix + M13_FORWARD)
            for k, ix in enumerate(i5)])
    _fasta(os.path.join(outdir, SP27RC_FASTA),
           [(f"SP27_{k + 1:03d}", encode.revcomp(p27 + ix + M13_REVERSE))
            for k, ix in enumerate(i27)])
    _fasta(os.path.join(outdir, PYCHOPPER_FASTA),
           [("SP5", p5 + "N" * INDEX_LEN + M13_FORWARD),
            ("SP27", p27 + "N" * INDEX_LEN + M13_REVERSE)])
    with open(os.path.join(outdir, PYCHOPPER_CONFIG), "w") as fh:
        fh.write(CONFIG + "\n")
    coi_rev = _degenerate(rng, 26, 5)
    _fasta(os.path.join(outdir, COI_PRIMERS),
           [("Moorea_Forward_A", _degenerate(rng, 25, 3)),
            ("Sauron_Forward_B", _degenerate(rng, 26, 3)),
            ("Moorea_and_Sauron_Reverse_A_B", coi_rev)])
    _fasta(os.path.join(outdir, RNA_PRIMERS),
           [("RNA_Forward_A", _degenerate(rng, 22, 2)),
            ("RNA_Reverse_A", _degenerate(rng, 21, 2)),
            ("RNA_Forward_B", _degenerate(rng, 20, 2)),
            ("RNA_Reverse_B", _degenerate(rng, 22, 2))])
    return outdir


def concretize(rng: np.random.Generator, s: str) -> str:
    """One concrete realization of a degenerate (IUPAC) sequence."""
    return "".join(c if c not in IUPAC
                   else IUPAC[c][int(rng.integers(0, len(IUPAC[c])))]
                   for c in s)


def nanopore_errors(rng: np.random.Generator, seq: str, sub: float = 0.015,
                    ins: float = 0.01, dele: float = 0.015) -> str:
    """Per-base substitutions, insertions and deletions (~4% in all)."""
    a = np.frombuffer(seq.encode(), np.uint8)
    u = rng.random(len(a))
    keep = u >= dele
    subs = (u >= dele) & (u < dele + sub)
    a = a.copy()
    a[subs] = _BASES[rng.integers(0, 4, int(subs.sum()))]
    insert = (rng.random(len(a)) < ins) & keep
    reps = keep.astype(np.int64) + insert
    out = np.repeat(a, reps)
    # the extra copy of each inserted base becomes a random base
    last = np.cumsum(reps) - 1
    pos = last[insert]
    out[pos] = _BASES[rng.integers(0, 4, len(pos))]
    return out.tobytes().decode()


def _quality(rng: np.random.Generator, n: int) -> str:
    return (rng.integers(8, 31, n) + 33).astype(np.uint8).tobytes().decode()


def amplicon_reads(rng: np.random.Generator, sp5: str, sp27rc: str,
                   fwd: str, rev: str, templates: Sequence[str], n: int,
                   tag: str) -> List[Record]:
    """``n`` raw reads of one barcode bin: adapter + primers + one of
    ``templates`` (round robin), errors over the whole read, every other
    read reverse-complemented."""
    out = []
    for r in range(n):
        s = (sp5 + concretize(rng, fwd) + templates[r % len(templates)]
             + concretize(rng, rev) + sp27rc)
        s = nanopore_errors(rng, s)
        if r % 2:
            s = encode.revcomp(s)
        rid = f"{tag}_{r}"
        out.append(Record(rid, rid, s, _quality(rng, len(s))))
    return out


def read_bank(path: str) -> Dict[str, str]:
    from .io.fastq import read_fasta
    return {r.id: r.seq.upper() for r in read_fasta(path)}


def coi_plate(adapters_dir: str, seed: int, reads_per_bin: int = 80,
              large_bins: int = 4, large_reads: int = 1000,
              n5: int = 12, n27: int = 8) -> Tuple[List[Record], Dict]:
    """A 96-bin COI plate (n5 SP5 x n27 SP27 bins). Every bin holds one
    species with a 300-900 bp insert, except the first ``large_bins``,
    which hold two species and ``large_reads`` reads. Returns the
    shuffled reads and {bin name: reads made}."""
    from .demux.primer_clean import parse_primer_pairs
    rng = np.random.default_rng(seed)
    sp5 = list(read_bank(os.path.join(adapters_dir, SP5_FASTA)).values())
    sp27 = list(read_bank(os.path.join(adapters_dir, SP27RC_FASTA)).values())
    pair = parse_primer_pairs(os.path.join(adapters_dir, COI_PRIMERS))[0]
    recs: List[Record] = []
    made: Dict[str, int] = {}
    for b in range(n5 * n27):
        a5, a27 = b // n27, b % n27
        big = b < large_bins
        n = large_reads if big else reads_per_bin
        t = _rand(rng, int(rng.integers(300, 901)))
        templates = [t, nanopore_errors(rng, t, 0.05, 0.02, 0.02)] \
            if big else [t]
        recs += amplicon_reads(rng, sp5[a5], sp27[a27], pair.fwd, pair.rev,
                               templates, n, f"p{a5}_{a27}")
        made[f"SP27_{a27 + 1:03d}_SP5_{a5 + 1:03d}"] = n
    order = rng.permutation(len(recs))
    return [recs[i] for i in order], made


def rrna_input(adapters_dir: str, seed: int, bins: int = 2,
               reads_per_bin: int = 300, length: int = 3500
               ) -> List[Record]:
    """``bins`` barcode bins of ~3.5 kb 18S-ITS-28S amplicons with the
    universal 18S-end and 28S-start junction anchors planted."""
    from .demux.primer_clean import parse_primer_pairs
    from .rrna.anchors import ANCHOR_18S_END, ANCHOR_28S_START
    rng = np.random.default_rng(seed)
    sp5 = list(read_bank(os.path.join(adapters_dir, SP5_FASTA)).values())
    sp27 = list(read_bank(os.path.join(adapters_dir, SP27RC_FASTA)).values())
    pair = parse_primer_pairs(os.path.join(adapters_dir, RNA_PRIMERS))[0]
    recs: List[Record] = []
    for b in range(bins):
        head = int(length * 0.35)
        gene = (_rand(rng, head) + ANCHOR_18S_END + _rand(rng, 280)
                + ANCHOR_28S_START)
        gene += _rand(rng, length - len(gene))
        recs += amplicon_reads(rng, sp5[b], sp27[b], pair.fwd, pair.rev,
                               [gene], reads_per_bin, f"r{b}")
    order = rng.permutation(len(recs))
    return [recs[i] for i in order]


if __name__ == "__main__":
    import sys
    print(write_banks(sys.argv[1], int(sys.argv[2]) if len(sys.argv) > 2
                      else 0))
