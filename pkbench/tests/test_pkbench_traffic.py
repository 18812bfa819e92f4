"""The benchmark's inputs are a function of ``--seed``: the same seed
gives the same weights, batches and requests, and another seed the same
amount of work in another order."""

import pkbench_tiny  # noqa: F401
import torch

from pkbench.harness import spec, weights
from pkbench.reference import mamba
from pkbench.traffic import closed_loop, lm_batches

SEED = pkbench_tiny.SEED


def _requests(seed, n=200):
    mix = spec.load("traffic", "longdoc_64c")
    gen = closed_loop.ClosedLoop(mix, 1000, seed)
    return [gen.next(i % mix["clients"]) for i in range(n)]


def test_closed_loop_is_a_function_of_the_seed():
    a, b = _requests(SEED), _requests(SEED)
    assert a == b
    assert _requests(SEED + 1) != a


def test_every_seed_asks_for_the_same_sizes():
    for name in ("longdoc_64c", "chat_64c"):
        mix = spec.load("traffic", name)
        sizes = []
        for seed in (SEED, 7):
            gen = closed_loop.ClosedLoop(mix, 50, seed)
            n = mix["clients"] * mix["per_client"]
            reqs = [gen.next(c) for c in range(mix["clients"])
                    for _ in range(mix["per_client"])]
            sizes.append(sorted((len(p), o) for p, o in reqs))
            assert len(reqs) == n
            lo, hi = mix["prompt"]["lo"], mix["prompt"]["hi"]
            assert all(lo <= len(p) <= hi for p, _ in reqs)
        assert sizes[0] == sizes[1]


def test_lm_batches_are_seeded_and_every_row_differs():
    mix = {"batch": 8, "seq": 16}
    a = lm_batches.Batches(mix, 500, SEED, "cpu")
    b = lm_batches.Batches(mix, 500, SEED, "cpu")
    for i in range(3):
        assert torch.equal(a.batch(i)["tokens"], b.batch(i)["tokens"])
    rows = torch.cat([a.batch(i)["tokens"] for i in range(3)])
    assert len({tuple(r.tolist()) for r in rows}) == len(rows)
    t = a.batch(0)
    assert torch.equal(t["tokens"][:, 1:], t["targets"][:, :-1])


def test_weights_are_seeded():
    dm = mamba.dims(pkbench_tiny.config("falcon-mamba-7b-16l"))
    specs = mamba.param_specs(dm)
    a = weights.make(specs, SEED, dm["d"], "cpu")
    b = weights.make(specs, SEED, dm["d"], "cpu")
    c = weights.make(specs, SEED + 1, dm["d"], "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["in_proj"], c["in_proj"])
    assert a["in_proj"].dtype == torch.bfloat16
    assert a["A_log"].dtype == torch.float32
    assert abs(float(a["in_proj"].float().std()) - dm["d"] ** -0.5) < 0.01
