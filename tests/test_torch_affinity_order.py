"""The rule by which the card decides the affinity stage's exact-order
candidate enumeration (`csrc/affinity_enum.cu`), rehearsed on the CPU.

`two_pass` below is a plain transcription of the kernel's launches (prep,
pass 1, pass 2 counting, the prefix sum, pass 2 writing), function for
function; it is test code only.  Its stream must equal the native walk's
(`affinity.enumerate_candidates` on the CPU, `affinity_enumerate_packed`)
element for element: on random small graphs (correspondences across
views, as the pipeline gives them, and with pairs and partners inside a
view and on the key itself, which the walk takes all the same) and on
hand-built cases (`torch_port_helpers.AFFINITY_ORDER_CASES`), whose
expected entries are checked too.  The kernel asks whether a run of a
source's A entries expanded to a segment either by a scan of the run or
through the transposed collinearity CSR, whichever is shorter; each way
alone must give the walk's stream too, and the random graphs take both."""
from bisect import bisect_left

import numpy as np
import pytest

from line3d_tpu_torch.cluster import affinity
from torch_port_helpers import AFFINITY_ORDER_CASES, affinity_enum_inputs, \
    affinity_random_case, assert_same_stream


RULES = ("kernel", "scan", "transposed")


def two_pass(key_sorted, order, pk, row_lookup, ptr, coll_j, coll_w, S, M,
             rule="kernel", taken=None):
    """The kernel's decision in Python: (src_rows, tgt_rows, kinds, cws).
    `rule` answers `hit_by` as the kernel does ("kernel": the shorter of
    the two ways), or always by a scan of the run, or always through the
    transposed CSR; `taken` counts the ways taken."""
    ks, od, pk, rl = (x.tolist() for x in (key_sorted, order, pk, row_lookup))
    ptr, cj, cw = ptr.tolist(), coll_j.tolist(), coll_w.tolist()
    B, P = len(ks), len(pk)
    # the transposed CSR: for key k, the segments of its view whose rows
    # list k's segment, ascending
    listed = [[] for _ in range(M)]
    for k in range(M):
        for c in range(ptr[k], ptr[k + 1]):
            listed[k - k % S + cj[c]].append(k % S)
    taken = {} if taken is None else taken

    def collinear(k, seg):
        i = bisect_left(cj, seg, ptr[k], ptr[k + 1])
        return i < ptr[k + 1] and cj[i] == seg

    def has_pair(lo, hi, key):
        i = bisect_left(pk, key, lo, hi)
        return i < hi and pk[i] == key

    def hit_by(base, q0, q1, vb, seg):
        if q0 >= q1:
            return False
        rows = listed[vb + seg]
        way = rule if rule != "kernel" else \
            "scan" if q1 - q0 <= len(rows) else "transposed"
        taken[way] = taken.get(way, 0) + 1
        if way == "scan":
            return any(executed[q] and collinear(pk[q] - base, seg)
                       for q in range(q0, q1))
        return any(has_pair(q0, q1, base + vb + i) and
                   executed[bisect_left(pk, base + vb + i, q0, q1)]
                   for i in rows)

    def marked_below(c, sv, sseg):
        if c // S == sv and collinear(c, sseg):
            return True
        base, hi = c * M, corr_ptr[c + 1]
        q0 = bisect_left(pk, base + sv * S, corr_ptr[c], hi)
        q1 = bisect_left(pk, base + sv * S + S, q0, hi)
        return hit_by(base, q0, q1, sv * S, sseg)

    # prep
    corr_ptr = [bisect_left(pk, k * M) for k in range(M + 1)]
    rank_lt = [bisect_left(ks, k) for k in range(M + 1)]
    # pass 1: each source's A chain, in order
    executed = [False] * P
    for s in ks:
        base, g0, view = s * M, 0, -1
        for q in range(corr_ptr[s], corr_ptr[s + 1]):
            t = pk[q] - base
            if t // S != view:
                view, g0 = t // S, q
            executed[q] = t >= s and rl[t] >= 0 and \
                not hit_by(base, g0, q, t - t % S, t % S)

    # pass 2: each slot's candidates
    def item(i):
        is_c = i >= P
        s = ks[i - P] if is_c else pk[i] // M
        rank = rank_lt[s]
        slot = corr_ptr[s + 1] + i - P if is_c else i + rank
        base, lo, sv, sseg = s * M, corr_ptr[s], s // S, s % S
        out = []
        if not is_c and executed[i]:
            q = i
            t = pk[q] - base
            tb = t // S * S
            out.append((od[rank], rl[t], 0, 1.0))
            g0 = bisect_left(pk, base + tb, lo, q)
            for c in range(ptr[t], ptr[t + 1]):
                j = cj[c]
                ck = tb + j
                if rl[ck] < 0 or (c > ptr[t] and cj[c - 1] == j) or \
                        has_pair(lo, q + 1, base + ck) or \
                        hit_by(base, g0, q, tb, j) or \
                        (ck < s and marked_below(ck, sv, sseg)):
                    continue
                out.append((od[rank], rl[ck], 1, 1.0))
        elif is_c:
            hi, sb = corr_ptr[s + 1], sv * S
            g0 = bisect_left(pk, base + sb, lo, hi)
            g1 = bisect_left(pk, base + sb + S, g0, hi)
            for c in range(ptr[s], ptr[s + 1]):
                j = cj[c]
                ck = sb + j
                if rl[ck] < 0 or (c > ptr[s] and cj[c - 1] == j) or \
                        has_pair(lo, hi, base + ck) or \
                        hit_by(base, g0, g1, sb, j) or \
                        (ck < s and marked_below(ck, sv, sseg)):
                    continue
                out.append((od[rank], rl[ck], 2, cw[c]))
        return slot, out

    items = [item(i) for i in range(P + B)]
    assert sorted(slot for slot, _ in items) == list(range(P + B))
    cnt = np.zeros(P + B, np.int64)
    for slot, out in items:
        cnt[slot] = len(out)
    end = np.cumsum(cnt)
    stream = [None] * int(end[-1]) if len(end) else []
    for slot, out in items:
        at = int(end[slot] - cnt[slot])
        stream[at:at + len(out)] = out
    src, tgt, kind, w = zip(*stream) if stream else ((), (), (), ())
    return (np.array(src, np.int64), np.array(tgt, np.int64),
            np.array(kind, np.int8), np.array(w, np.float64))


def walk(inputs):
    return affinity.enumerate_candidates(*inputs, device="cpu")


@pytest.mark.parametrize("general", [False, True])
@pytest.mark.parametrize("block", range(8))
def test_two_pass_equals_the_walk_on_random_graphs(general, block):
    seen = np.zeros(3, np.int64)
    taken = {}
    for seed in range(40 * block, 40 * block + 40):
        inputs = affinity_random_case(seed, general)
        want = walk(inputs)
        for rule in RULES:
            assert_same_stream(two_pass(*inputs, rule=rule,
                                        taken=taken if rule == "kernel"
                                        else None), want)
        seen += np.bincount(want[2], minlength=3)
    # every kind of entry is emitted, and the kernel's rule takes both ways
    assert (seen > 0).all(), seen
    assert taken.get("scan", 0) > 0 and taken.get("transposed", 0) > 0, taken


@pytest.mark.parametrize("name", sorted(AFFINITY_ORDER_CASES))
def test_two_pass_equals_the_walk_on_hand_built_cases(name):
    keys, pairs, coll, must, must_not = AFFINITY_ORDER_CASES[name]
    inputs = affinity_enum_inputs(keys, pairs, coll, 3, 8)
    want = walk(inputs)
    for rule in RULES:
        assert_same_stream(two_pass(*inputs, rule=rule), want)
    key_of = np.asarray(keys)
    got = set(zip(key_of[want[0]].tolist(), key_of[want[1]].tolist(),
                  want[2].tolist()))
    assert set(must) <= got, (name, sorted(got))
    assert not set(must_not) & got, (name, sorted(got))


def test_two_pass_on_an_empty_stream():
    inputs = affinity_enum_inputs([0, 9], [], [], 3, 8)
    got = two_pass(*inputs)
    assert all(len(x) == 0 for x in got)
    assert_same_stream(got, walk(inputs))
