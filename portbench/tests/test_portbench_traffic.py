"""The traffic generator gives every seed the same work, and a closed-loop
client's kept answers are drawn from its whole window, not its start."""

import numpy as np
import pytest

from portbench import harness, loadgen, traffic


def _offer_all(sample, sizes):
    kept = set()
    for i, n in enumerate(sizes):
        keep, evicted = sample.offer(i, n)
        kept.discard(evicted)
        if keep:
            kept.add(i)
    return kept


@pytest.mark.parametrize("n", [5, 24, 3000])
def test_a_client_keeps_k_answers_drawn_from_its_seed(n):
    sizes = [1] * n
    a = _offer_all(loadgen.Sample(24, 7, sizes), sizes)
    b = _offer_all(loadgen.Sample(24, 7, sizes), sizes)
    assert a == b and len(a) == min(n, 24)
    assert _offer_all(loadgen.Sample(24, 8, sizes), sizes) != a or n <= 24


def test_the_kept_answers_span_the_whole_window():
    n, k = 2000, 24
    sizes = [1] * n
    late = []
    for seed in range(200):
        kept = _offer_all(loadgen.Sample(k, seed, sizes), sizes)
        late.append(sum(i >= n // 2 for i in kept) / k)
    # each answer is kept with the same chance, k / n
    assert np.mean(late) == pytest.approx(0.5, abs=0.03)


def test_half_the_kept_answers_are_of_the_longest_requests():
    rng = np.random.default_rng(0)
    sizes = [int(s) for s in rng.choice([1, 2, 3, 4], 500,
                                        p=[0.4, 0.25, 0.15, 0.2])]
    kept = _offer_all(loadgen.Sample(6, 3, sizes), sizes)
    assert len(kept) == 6
    assert sum(sizes[i] == 4 for i in kept) == 3


@pytest.mark.parametrize("cell", ["serve.single-client",
                                  "serve.closed-mixed"])
def test_every_seed_gets_the_same_work(cell):
    t = harness.load_json(harness.HERE / "workloads" /
                          f"{cell}.json")["traffic"]
    runs = [traffic.schedule(t, seed, 5.0) for seed in (1, (1 << 31) + 5)]
    sizes = [sorted(len(r["pitches"]) for c in s["clients"] for r in c)
             for s in runs]
    assert sizes[0] == sizes[1]
    for s in runs:
        assert len(s["keep"]["seeds"]) == t["clients"]
        assert s["keep"]["per_client"] == t["keep"]["per_client"]
