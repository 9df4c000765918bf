"""Seeded banks and read sets (nano_orc.synth) and the compile cache."""
import os
import subprocess
import sys

import numpy as np
import pytest

from nano_orc import synth
from nano_orc.io.fastq import read_fasta

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fa(d, name):
    return [(r.id, r.seq) for r in read_fasta(os.path.join(d, name))]


def test_banks_have_the_reference_shape(adapters_dir):
    sp5 = _fa(adapters_dir, synth.SP5_FASTA)
    sp27 = _fa(adapters_dir, synth.SP27RC_FASTA)
    assert [n for n, _ in sp5] == [f"SP5_{k:03d}" for k in range(1, 13)]
    assert [n for n, _ in sp27] == [f"SP27_{k:03d}" for k in range(1, 13)]
    assert all(s.endswith("GGCCAG") and len(s) == 59 for _, s in sp5)
    assert all(s.startswith("GTCATAGCTGTTTCCTG") for _, s in sp27)
    prof = dict(_fa(adapters_dir, synth.PYCHOPPER_FASTA))
    assert prof["SP5"].count("N") == 17 and prof["SP27"].count("N") == 17
    with open(os.path.join(adapters_dir, synth.PYCHOPPER_CONFIG)) as fh:
        assert fh.read().strip() == "+:SP5,-SP27|-:SP27,-SP5"


def test_bank_indices_are_far_apart(adapters_dir):
    for name in (synth.SP5_FASTA, synth.SP27RC_FASTA):
        seqs = [np.frombuffer(s.encode(), np.uint8) for _, s in
                _fa(adapters_dir, name)]
        for i in range(len(seqs)):
            for j in range(i):
                assert (seqs[i] != seqs[j]).sum() >= 8


def test_banks_depend_only_on_the_seed(tmp_path, adapters_dir):
    again = synth.write_banks(str(tmp_path / "again"), seed=0)
    other = synth.write_banks(str(tmp_path / "other"), seed=1)
    for name in os.listdir(adapters_dir):
        a = open(os.path.join(adapters_dir, name)).read()
        assert a == open(os.path.join(again, name)).read()
    assert (open(os.path.join(other, synth.SP5_FASTA)).read()
            != open(os.path.join(adapters_dir, synth.SP5_FASTA)).read())


def test_primer_files_parse_as_pairs(adapters_dir):
    from nano_orc.demux.primer_clean import parse_primer_pairs
    coi = parse_primer_pairs(os.path.join(adapters_dir, synth.COI_PRIMERS))
    assert [p.pair_id for p in coi] == ["A", "B"]
    assert coi[0].rev == coi[1].rev
    rna = parse_primer_pairs(os.path.join(adapters_dir, synth.RNA_PRIMERS))
    assert [p.pair_id for p in rna] == ["A", "B"]


def test_nanopore_errors_rate():
    rng = np.random.default_rng(0)
    s = "ACGT" * 2500
    from nano_orc import native
    from nano_orc.io import encode
    e = synth.nanopore_errors(rng, s)
    d = native.edit_distance(encode.encode_codes(s), encode.encode_codes(e))
    assert 0.025 < d / len(s) < 0.05


def test_coi_plate_layout(adapters_dir):
    recs, made = synth.coi_plate(adapters_dir, 0, reads_per_bin=3,
                                 large_bins=2, large_reads=5)
    assert len(made) == 96 and len(recs) == 94 * 3 + 2 * 5
    assert made["SP27_001_SP5_001"] == 5 and made["SP27_008_SP5_012"] == 3
    assert len({r.id for r in recs}) == len(recs)


@pytest.mark.parametrize("env_dir", [None, "custom-cache"])
def test_compile_cache_dir(tmp_path, env_dir):
    """JAX_COMPILATION_CACHE_DIR when set, else <checkout>/.jax_cache."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    want = os.path.join(REPO, ".jax_cache")
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = want = str(tmp_path / env_dir)
    out = subprocess.run(
        [sys.executable, "-c", "import jax, nano_orc; "
         "print(jax.config.jax_compilation_cache_dir)"],
        capture_output=True, text=True, env=env, cwd=str(tmp_path),
        timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == want
