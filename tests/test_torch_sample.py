"""The sampler's per-slot Philox draws (ops/sample.py, the twin of
csrc/sample.cu) on the CPU: Random123's known answers for
philox4x32-10, the categorical draw's frequencies against its
distribution (chi-square), each row's draws independent of the other
rows and of the number of slots, and the counters advancing by the draws
made. The kernel itself is held against this twin on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import numpy as np
import pytest
import torch

from powerserve_tpu_torch.ops.sample import (philox4x32_10,
                                             sample_categorical,
                                             sample_gumbel, sample_uniform,
                                             unit_floats)
from powerserve_tpu_torch.sampling.sampler import (DrawState,
                                                   categorical_from_dist,
                                                   uniform_draws)
from torch_threads import one_torch_thread  # noqa: F401

# Random123's kat_vectors for philox4x32_10: counter, key -> output
KNOWN = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("ctr,key,want", KNOWN)
def test_philox_known_answers(ctr, key, want):
    got = philox4x32_10(tuple(torch.tensor([c]) for c in ctr),
                        tuple(torch.tensor([k]) for k in key))
    assert tuple(int(w) for w in got) == want


def test_unit_floats_are_exact_and_in_range():
    words = torch.tensor([0, 255, 256, 0xFFFFFFFF, 0x80000000])
    u = unit_floats(words)
    assert u.dtype == torch.float32
    assert u.tolist() == [0.0, 0.0, 2.0 ** -24, 1 - 2.0 ** -24, 0.5]


def test_categorical_frequencies_chi_square():
    """20,000 draws (a slot's counter advancing) from a fixed 12-way
    distribution with a zero: the zero is never drawn, and the counts
    pass a chi-square test at the 0.1% level (11 degrees of freedom:
    31.26)."""
    p = torch.tensor([0.3, 0.2, 0.15, 0.1, 0.08, 0.06, 0.04, 0.03, 0.02,
                      0.015, 0.005, 0.0])
    n = 20000
    state = DrawState.create(n, "cpu", range(100, 100 + n))
    toks = categorical_from_dist(p.expand(n, -1), state).numpy()
    counts = np.bincount(toks, minlength=12)
    assert counts[11] == 0
    want = p.numpy()[:11].astype(np.float64) * n
    chi2 = float(((counts[:11] - want) ** 2 / want).sum())
    assert chi2 < 31.26, (chi2, counts)


@pytest.mark.parametrize("mode", ["categorical", "uniform", "gumbel"])
def test_row_draws_depend_on_their_slot_alone(mode):
    """A slot's draws are the same whatever the other slots' seeds and
    counters and whatever the number of slots, with several rows a slot
    too (a tree's nodes)."""
    V, m = 40, 3
    dist = torch.softmax(torch.from_numpy(np.random.default_rng(3)
                                          .standard_normal((8 * m, V))
                                          .astype(np.float32)), dim=-1)

    def draw(seeds, counters, rows):
        seed = torch.tensor(seeds)
        counter = torch.tensor(counters)
        R = len(seeds) * m
        if mode == "categorical":
            return sample_categorical(rows[:R].contiguous(), seed, counter)
        fn = sample_uniform if mode == "uniform" else sample_gumbel
        return fn(seed, counter, R, V)

    alone = draw([11], [5], dist[2 * m:3 * m])
    many = draw([7, 9, 11, 13], [0, 2, 5, 1], torch.cat(
        [dist[:2 * m], dist[2 * m:3 * m], dist[3 * m:4 * m]]))
    assert torch.equal(alone, many[2 * m:3 * m])
    other = draw([8, 10, 11], [4, 4, 5], torch.cat(
        [dist[5 * m:7 * m], dist[2 * m:3 * m]]))
    assert torch.equal(alone, other[2 * m:3 * m])
    assert not torch.equal(alone, many[:m])


def test_counters_advance_by_the_draws_made():
    state = DrawState.create(3, "cpu", [1, 2, 3])
    state.counter[1] = 9
    uniform_draws(state, 3, 5, "cpu")  # one draw a slot
    assert state.counter.tolist() == [1, 10, 1]
    sample_gumbel(state.seed, state.counter, 6, 4)  # two rows a slot
    assert state.counter.tolist() == [3, 12, 3]
    categorical_from_dist(torch.full((12, 7), 1 / 7), state)
    assert state.counter.tolist() == [7, 16, 7]
    categorical_from_dist(torch.full((3, 7), 1 / 7), None)  # no draw
    assert state.counter.tolist() == [7, 16, 7]
    state.reset_slot(1, 2 ** 64 - 1)  # a seed takes its low 64 bits
    assert state.seed.tolist() == [1, -1, 3]
    assert state.counter.tolist() == [7, 0, 7]


def test_successive_draws_differ_and_replay():
    """Each call draws anew (the counter moves on); the same seeds and
    counters give the same values again; uniforms lie in [0, 1) and the
    Gumbel noise is -log(-log(u)) of the same words."""
    a = DrawState.create(2, "cpu", [4, 5])
    b = DrawState.create(2, "cpu", [4, 5])
    u1 = uniform_draws(a, 2, 64, "cpu")
    u2 = uniform_draws(a, 2, 64, "cpu")
    assert not torch.equal(u1, u2)
    assert torch.equal(u1, uniform_draws(b, 2, 64, "cpu"))
    assert (u1 >= 0).all() and (u1 < 1).all()
    g = sample_gumbel(b.seed, b.counter, 2, 64)
    assert torch.equal(g, -torch.log(-torch.log(u2.clamp(min=1e-20))))


def test_categorical_edges():
    """One-hot rows draw their index (a greedy slot), an index without
    mass is never drawn, and a row without any mass gives 0."""
    state = DrawState.create(4, "cpu", range(4))
    dist = torch.zeros(4, 9)
    dist[0, 6] = 1.0
    dist[1, 2] = dist[1, 7] = 0.5
    dist[2, 8] = 3.0  # unnormalized
    for _ in range(20):
        toks = categorical_from_dist(dist, state).tolist()
        assert toks[0] == 6 and toks[1] in (2, 7) and toks[2] == 8
        assert toks[3] == 0
