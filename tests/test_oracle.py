"""Semantic tests of the Python alignment oracle (the ground truth)."""
import numpy as np
import pytest

from nano_orc.align import FRONT, BACK, PREFIX, SUFFIX
from nano_orc.align.oracle import locate, edit_distance, similarity


def brute_force_locate(ref, qry, e, flags, min_overlap=3):
    """Independent O(n^2 m^2)-ish check: enumerate all (refstart, qrystart)
    and run a plain NW forward DP, replicating spec.py acceptance rules.
    Only tracks cost (not matches), so we compare costs/validity only.

    NOTE this is strictly MORE permissive than cutadapt/spec.py: the real
    DP keeps ONE (cost, origin) per cell, so an acceptable alignment can
    be shadowed by an equal-or-lower-cost path with a different origin
    that fails acceptance (shorter overlap). Returns (best_cost, hits)
    where hits is every acceptable (rs, qs, re, qe, cost)."""
    from nano_orc.align.spec import Flag
    from nano_orc.io import encode
    rm = encode.encode_ref_masks(ref)
    qm = encode.encode_read_masks(qry)
    m, n = len(rm), len(qm)
    # An alignment may skip the prefix of *either* sequence for free, never
    # both (the DP's origin is a single scalar); same for the stop side.
    starts = {(0, 0)}
    if flags & Flag.START_WITHIN_SEQ1:
        starts |= {(rs, 0) for rs in range(m + 1)}
    if flags & Flag.START_WITHIN_SEQ2:
        starts |= {(0, qs) for qs in range(n + 1)}
    best = None
    hits = []
    # endpoint -> [(cost, acceptable)] over ALL origins (shadow detection)
    cell_all = {}
    nprefix = np.concatenate([[0], np.cumsum((rm & 15) == 15)])
    for rs, qs in sorted(starts):
        if True:
            sub_r, sub_q = rm[rs:], qm[qs:]
            M, N = len(sub_r), len(sub_q)
            D = np.zeros((M + 1, N + 1), dtype=int)
            D[:, 0] = np.arange(M + 1)
            D[0, :] = np.arange(N + 1)
            for i in range(1, M + 1):
                for j in range(1, N + 1):
                    eqc = 0 if (sub_r[i - 1] & sub_q[j - 1]) else 1
                    D[i, j] = min(D[i-1, j-1] + eqc, D[i-1, j] + 1, D[i, j-1] + 1)
            from nano_orc.align.spec import Flag as F
            ends = {(M, N)}
            if flags & F.STOP_WITHIN_SEQ1:
                ends |= {(re_, N) for re_ in range(M + 1)}
            if flags & F.STOP_WITHIN_SEQ2:
                ends |= {(M, qe) for qe in range(N + 1)}
            for re_, qe in ends:
                end_key = (rs + re_, qs + qe)
                c = int(D[re_, qe])
                length = re_
                eff = length - (nprefix[rs + re_] - nprefix[rs])
                acceptable = length >= min_overlap and c <= e * eff
                cell_all.setdefault(end_key, []).append((c, acceptable))
                if acceptable:
                    hits.append((rs, qs, re_, qe, c))
                    if best is None or c < best:
                        best = c
    return best, hits, cell_all


def test_exact_front_match():
    loc = locate("ACGT", "ACGTTTTT", 0.0, FRONT)
    assert loc is not None
    assert loc.astuple() == (0, 4, 0, 4, 4, 0)


def test_front_internal_occurrence():
    # full adapter internal: read prefix skipped free, trim point = query end
    loc = locate("ACGT", "TTACGTGGG", 0.0, FRONT)
    assert loc.astuple() == (0, 4, 2, 6, 4, 0)


def test_front_partial_at_start():
    # adapter suffix 'GT' overlaps read start -> refstart > 0
    loc = locate("AACCGT", "CGTAAAAAAA", 0.0, FRONT, min_overlap=3)
    assert loc is not None
    assert loc.refstart == 3 and loc.querystart == 0 and loc.querystop == 3


def test_back_partial_at_end():
    loc = locate("ACGTAC", "TTTTTACG", 0.0, BACK, min_overlap=3)
    assert loc is not None
    assert loc.refstart == 0 and loc.querystart == 5 and loc.querystop == 8
    assert loc.refstop == 3


def test_back_internal():
    loc = locate("ACGT", "TTACGTGG", 0.0, BACK)
    assert loc.querystart == 2 and loc.querystop == 6


def test_min_overlap_rejects():
    assert locate("AACCGT", "GTAAAAAAA", 0.0, FRONT, min_overlap=3) is None


def test_error_rate_floor():
    # e=0.1: length-9 match allows 0 errors, length-10 allows 1
    assert locate("ACGTACGTA", "ACGTACGTC" + "T" * 10, 0.1, PREFIX) is None
    loc = locate("ACGTACGTAC", "ACGTACGTCC" + "T" * 10, 0.1, PREFIX)
    assert loc is not None and loc.errors == 1


def test_n_wildcard_effective_length():
    # adapter with Ns: Ns match anything but don't count toward error budget
    ref = "ACGTNNNNNNNNNNNNNNNNNACGT"  # 8 real bases, 17 Ns
    read = "ACGTGGGGGGGGGGGGGGGGGACGATTTT"  # 1 error in real bases
    # eff length 8 -> e=0.1 allows 0 errors
    assert locate(ref, read, 0.1, PREFIX) is None
    # e=0.2 allows floor(0.2*8)=1
    assert locate(ref, read, 0.2, PREFIX) is not None


def test_indels_allowed():
    loc = locate("ACGTACGTAC", "ACGTCGTACTTTT", 0.1, FRONT)  # one deletion
    assert loc is not None and loc.errors == 1 and loc.querystop == 9


@pytest.mark.parametrize("flags", [FRONT, BACK, PREFIX, SUFFIX])
def test_locate_cost_matches_bruteforce(flags):
    # local deterministic stream: the shared session rng's state depends
    # on which other tests ran first, which made this test's data (and a
    # rare shadowing case, see below) order-dependent
    rng = np.random.default_rng(1000 + int(flags))
    for trial in range(60):
        m = int(rng.integers(3, 12))
        n = int(rng.integers(0, 25))
        ref = "".join(rng.choice(list("ACGT"), size=m))
        qry = "".join(rng.choice(list("ACGT"), size=n))
        e = float(rng.choice([0.0, 0.1, 0.2, 0.3]))
        loc = locate(ref, qry, e, flags)
        bf, hits, cell_all = brute_force_locate(ref, qry, e, flags)
        if bf is None:
            assert loc is None, (ref, qry, e, loc)
        elif loc is not None:
            assert loc.errors >= bf  # oracle may prefer more-matches over min-cost
            # but the chosen alignment must itself be acceptable
            # (checked inside locate)
        else:
            # The spec's DP keeps ONE (cost, origin) per cell, so an
            # acceptable alignment may be shadowed at its endpoint by an
            # equal-or-lower-cost path whose origin fails acceptance
            # (cutadapt behaves identically). Oracle-None is legitimate
            # only if EVERY brute-force hit is shadowed that way.
            for (rs, qs, re_, qe, c) in hits:
                end_key = (rs + re_, qs + qe)
                shadowed = any(c2 <= c and not ok2
                               for c2, ok2 in cell_all[end_key])
                assert shadowed, (ref, qry, e, (rs, qs, re_, qe, c))


def test_edit_distance_modes():
    assert edit_distance("ACGT", "ACGT") == 0
    assert edit_distance("ACGT", "ACTT") == 1
    assert edit_distance("ACGT", "AACGTT") == 2
    assert edit_distance("ACGT", "AACGTT", mode="SHW") == 1  # prefix AACGT? no: free suffix
    assert edit_distance("ACGT", "TTACGTTT", mode="HW") == 0
    assert edit_distance("ACGT", "TTACTTTT", mode="HW") == 1


def test_edit_distance_vs_dp(rng):
    for _ in range(20):
        a = "".join(rng.choice(list("ACGT"), size=int(rng.integers(1, 30))))
        b = "".join(rng.choice(list("ACGT"), size=int(rng.integers(1, 30))))
        d = edit_distance(a, b)
        # simple reference DP
        import numpy as np
        D = np.zeros((len(a) + 1, len(b) + 1), dtype=int)
        D[:, 0] = np.arange(len(a) + 1)
        D[0, :] = np.arange(len(b) + 1)
        for i in range(1, len(a) + 1):
            for j in range(1, len(b) + 1):
                D[i, j] = min(D[i-1, j-1] + (a[i-1] != b[j-1]),
                              D[i-1, j] + 1, D[i, j-1] + 1)
        assert d == D[len(a), len(b)]


def test_similarity_reference_formula():
    # round(1 - d/len(longer), 3): amplicon_sorter.py:225-235
    assert similarity("ACGT", "ACGT") == 1.0
    assert similarity("ACGTACGTAC", "ACGTACGTA") == 0.9
