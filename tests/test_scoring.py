"""Scorer backend parity: the device tile path and the native C++ path
must produce identical edges/sims (they implement one spec)."""
import numpy as np

from nano_orc.cluster.scoring import DeviceScorer
from nano_orc.io import encode


def make_family(rng, n, L, err=0.06):
    base = "".join(rng.choice(list("ACGT"), size=L))
    out = []
    for _ in range(n):
        s = [c for c in base]
        for _ in range(int(err * L)):
            pos = int(rng.integers(0, len(s)))
            op = int(rng.integers(0, 3))
            if op == 0:
                s[pos] = str(rng.choice(list("ACGT")))
            elif op == 1 and len(s) > 1:
                del s[pos]
            else:
                s.insert(pos, str(rng.choice(list("ACGT"))))
        out.append(encode.encode_codes("".join(s)))
    return out


def test_allvsall_backend_parity(rng):
    codes = make_family(rng, 24, 300)
    # flip a few to reverse-complement to exercise the rc-retry rule
    for k in (3, 11, 17):
        codes[k] = encode.revcomp_codes(codes[k])
    dev = DeviceScorer(tile=64, backend="xla")
    nat = DeviceScorer(backend="native")
    hd = dev.allvsall_effective_sims(codes, keep_threshold=0.7)
    hn = nat.allvsall_effective_sims(codes, keep_threshold=0.7)
    ed = {(int(i), int(j)): (float(s), bool(r))
          for i, j, s, r in zip(hd.i, hd.j, hd.sim, hd.reverse)}
    en = {(int(i), int(j)): (float(s), bool(r))
          for i, j, s, r in zip(hn.i, hn.j, hn.sim, hn.reverse)}
    assert ed == en


def test_reads_vs_consensus_backend_parity(rng):
    codes = make_family(rng, 12, 250)
    cons = make_family(rng, 3, 250, err=0.0)
    dev = DeviceScorer(backend="xla")
    nat = DeviceScorer(backend="native")
    sd = dev.reads_vs_consensus_sims(codes, cons)
    sn = nat.reads_vs_consensus_sims(codes, cons)
    assert np.allclose(np.nan_to_num(sd, nan=-9),
                       np.nan_to_num(sn, nan=-9))
