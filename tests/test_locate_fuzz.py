"""Large random cross-check of the cutadapt-locate implementations:
100k random (adapter, read) pairs through the C++ oracle and the XLA
batched locate — results must be IDENTICAL field for field; a random
subsample additionally runs the pure-Python definitional oracle.

Marked slow: minutes on a small host.
"""
import numpy as np
import pytest

from nano_orc import native
from nano_orc.align import oracle
from nano_orc.align.batched import batched_locate
from nano_orc.align.spec import FRONT, BACK
from nano_orc.io import encode

N_CASES = 100_000
PY_SAMPLE = 400


def _random_reads(rng, n, adapters):
    """Reads with planted full/partial/absent adapter occurrences, N's,
    and mutations — the distribution covers accept/reject boundaries."""
    reads = []
    bases = np.array(list("ACGT"))
    for i in range(n):
        L = int(rng.integers(8, 90))
        read = list(rng.choice(bases, size=L))
        if i % 3 != 2:  # plant an (possibly mangled) occurrence
            a = adapters[int(rng.integers(0, len(adapters)))]
            occ = list(a)
            for _ in range(int(rng.integers(0, 4))):
                p = int(rng.integers(0, len(occ)))
                r = rng.random()
                if r < 0.5:
                    occ[p] = str(rng.choice(bases))
                elif r < 0.75 and len(occ) > 4:
                    del occ[p]
                else:
                    occ.insert(p, str(rng.choice(bases)))
            cut = int(rng.integers(0, len(occ) // 2 + 1))
            if i % 2:
                occ = occ[cut:]  # partial at start
                pos = 0
            else:
                pos = int(rng.integers(0, max(1, L - len(occ))))
            read[pos:pos + len(occ)] = occ
        if rng.random() < 0.15:  # sprinkle N's
            for _ in range(int(rng.integers(1, 3))):
                read[int(rng.integers(0, len(read)))] = "N"
        reads.append("".join(read))
    return reads


@pytest.mark.slow
@pytest.mark.parametrize("flags", [FRONT, BACK])
def test_locate_fuzz_100k(flags):
    rng = np.random.default_rng(int(flags) * 7919 + 13)
    adapters = ["ACGTACGTACGT", "TTGACCATTGAC", "ACGNNACGTTAGCA",
                "CATCATTACCGG"]
    reads = _random_reads(rng, N_CASES, adapters)
    ref_masks = [encode.encode_ref_masks(a) for a in adapters]
    qry_masks = [encode.encode_read_masks(r) for r in reads]

    # C++ oracle (threaded)
    c_out, c_valid = native.locate_batch(ref_masks, qry_masks, 0.1,
                                         int(flags))

    # XLA batched kernel in chunks (bucketed padding)
    amax = max(len(a) for a in adapters)
    bm = np.zeros((len(adapters), amax), np.uint8)
    bl = np.zeros(len(adapters), np.int32)
    for k, m in enumerate(ref_masks):
        bm[k, :len(m)] = m
        bl[k] = len(m)
    from nano_orc.demux.adapters import AdapterBank
    bank = AdapterBank([f"A{k}" for k in range(len(adapters))], adapters,
                       0.1)
    CH = 4096
    for s in range(0, N_CASES, CH):
        sub = reads[s:s + CH]
        L = max(len(r) for r in sub)
        masks, lens = encode.pack_batch(
            sub, max_len=L, pad_multiple=1,
            encoder=encode.encode_read_masks, pad_value=0)
        res = batched_locate(bank.masks, bank.lens, bank.k_table,
                             bank.n_prefix, masks, lens, int(flags))
        v = np.asarray(res.valid).astype(bool)
        np.testing.assert_array_equal(v, c_valid[s:s + CH],
                                      err_msg=f"valid chunk {s}")
        for field, col in (("matches", 4), ("errors", 5),
                           ("refstart", 0), ("refstop", 1),
                           ("querystart", 2), ("querystop", 3)):
            got = np.asarray(getattr(res, field))[v]
            want = c_out[s:s + CH][:, :, col][c_valid[s:s + CH]]
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"{field} chunk {s}")

    # Python definitional oracle on a random subsample
    pick = rng.choice(N_CASES, PY_SAMPLE, replace=False)
    for i in pick:
        for a_idx in range(len(adapters)):
            loc = oracle.locate(ref_masks[a_idx], qry_masks[i], 0.1,
                                flags)
            if loc is None:
                assert not c_valid[i, a_idx], (i, a_idx)
            else:
                assert c_valid[i, a_idx], (i, a_idx)
                np.testing.assert_array_equal(
                    np.array(loc.astuple()), c_out[i, a_idx],
                    err_msg=f"py oracle case {i} adapter {a_idx}")
