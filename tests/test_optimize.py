"""Graph transformation equivalence: epsilon removal and out-degree
splitting must preserve best-path cost and word sequence."""
import numpy as np
import pytest

from vosk_tpu.graph.fst import EPSILON, StdFst, flatten_fst
from vosk_tpu.graph.optimize import remove_epsilons, split_high_degree
from vosk_tpu.graph.ref_decoder import ref_decode
from vosk_tpu.ops.viterbi import BatchViterbi, DecodeParams

from test_viterbi import random_fst


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_remove_epsilons_preserves_best_path(seed):
    fst = random_fst(seed, n_states=20, with_eps=True)
    rng = np.random.default_rng(seed + 10)
    ll = rng.standard_normal((12, 6)).astype(np.float32)

    c0, ols0, _ = ref_decode(fst, ll)
    fst2 = remove_epsilons(fst)
    c1, ols1, _ = ref_decode(fst2, ll)
    assert c1 == pytest.approx(c0, rel=1e-5)
    assert ols1 == ols0  # our random eps arcs carry olabels -> kept intact


def test_remove_epsilons_drops_unlabeled_only():
    f = StdFst()
    f.add_states(4)
    f.set_start(0)
    f.add_arc(0, 1, 7, 0.5, 1)
    f.add_arc(1, EPSILON, EPSILON, 0.25, 2)  # removable
    f.add_arc(2, 2, 0, 0.5, 3)
    f.set_final(3, 0.125)
    f2 = remove_epsilons(f)
    assert f2.num_states > 0
    c0, ols0, _ = ref_decode(f, np.zeros((2, 2), np.float32))
    c1, ols1, _ = ref_decode(f2, np.zeros((2, 2), np.float32))
    assert c1 == pytest.approx(c0)
    assert ols1 == ols0 == [7]
    # no unlabeled eps arcs remain
    for s in range(f2.num_states):
        for il, ol, w, ns in f2.arcs[s]:
            assert not (il == EPSILON and ol == EPSILON)


@pytest.mark.parametrize("seed", [1, 3])
def test_split_high_degree_preserves_decode(seed):
    rng = np.random.default_rng(seed)
    f = StdFst()
    n = 10
    f.add_states(n)
    f.set_start(0)
    # hub state 0 with 30 outgoing arcs
    for _ in range(30):
        f.add_arc(0, int(rng.integers(1, 5)), int(rng.integers(0, 3)),
                  float(rng.uniform(0, 2)), int(rng.integers(1, n)))
    for s in range(1, n):
        for _ in range(3):
            f.add_arc(s, int(rng.integers(1, 5)), int(rng.integers(0, 3)),
                      float(rng.uniform(0, 2)), int(rng.integers(0, n)))
        f.set_final(s, float(rng.uniform(0, 1)))
    ll = rng.standard_normal((8, 4)).astype(np.float32)
    c0, ols0, _ = ref_decode(f, ll)

    f2 = split_high_degree(f, max_out=8)
    assert max(sum(1 for a in arcs if a[0] != EPSILON) for arcs in f2.arcs) <= 8
    c1, ols1, _ = ref_decode(f2, ll)
    assert c1 == pytest.approx(c0, rel=1e-5)
    assert ols1 == ols0

    # and through the device decoder with the padded layout
    graph = flatten_fst(f2)
    dec = BatchViterbi(graph, DecodeParams(beam=1e9, max_active=64))
    assert dec.layout == "padded"
    fr = dec.init_frontier(1)
    fr, recs, _, _ = dec.decode_chunk(fr, ll[None])
    c2, ols2, _ = dec.traceback([recs], fr, 0)
    assert c2 == pytest.approx(c0, rel=1e-4)
    assert ols2 == ols0
