"""The port's RSMix (``adaptpoint_tpu_torch/adapt/rsmix.py``) against the JAX
package's, on the CPU: both are host numpy, so the same batch and the same
``np.random.Generator`` state must give the same mixed batch, lambdas and
labels bit for bit, and leave the generator in the same state.

Cases: ball and kNN subsets over several seeds and subset sizes, a small
beta (cut radii near 0 and 1), clouds whose erase or add set is empty (a
cloud of NaN coordinates: no point lies within any radius of it), the
helpers on their own (an empty ball, the count control both ways), and the
epoch's zero-beta path, which passes the batch through unmixed.
"""
import importlib

import numpy as np
import pytest

from adaptpoint_tpu_torch.adapt import rsmix as port_rsmix_fn

# the modules (each package's adapt/__init__ may bind the name to the
# function)
jax_rsmix = importlib.import_module("adaptpoint_tpu.adapt.rsmix")
port_rsmix = importlib.import_module("adaptpoint_tpu_torch.adapt.rsmix")


def _batch(seed, b=8, n=256, c=3, scale=1.0):
    rng = np.random.default_rng(seed)
    data = (rng.standard_normal((b, n, c)) * scale).astype(np.float32)
    return data, rng.integers(0, 40, (b,)).astype(np.int64)


def _both(data, y, seed, **kwargs):
    """The two functions on copies of ``data`` with generators of one
    seed; also each generator's next draw."""
    out = []
    for fn in (jax_rsmix.rsmix, port_rsmix.rsmix):
        rng = np.random.default_rng(seed)
        res = fn(data.copy(), y.copy(), rng=rng, **kwargs)
        out.append((res, rng.random()))
    return out


def _assert_same(a, b):
    (ra, na), (rb, nb) = a, b
    assert na == nb  # the generators advanced alike
    for x, y in zip(ra, rb):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("knn", [False, True], ids=["ball", "knn"])
@pytest.mark.parametrize("seed,n_sample", [(0, 64), (1, 512), (2, 16)])
def test_rsmix_equals_the_jax_function(knn, seed, n_sample):
    data, y = _batch(seed, c=4)
    a, b = _both(data, y, seed + 10, beta=1.0, n_sample=n_sample, knn=knn)
    _assert_same(a, b)
    mixed, lam, y_a, y_b = b[0]
    assert mixed.shape == data.shape and (y_a == y).all()
    assert sorted(y_b) == sorted(y) and (lam >= 0).all() and (lam <= 1).all()
    assert (lam > 0).any()  # something was mixed


def test_rsmix_with_a_small_beta_equals_the_jax_function():
    """beta 0.1 puts the cut radius near 0 or 1; far-apart points leave
    the erase ball with the query point alone."""
    data, y = _batch(3, b=4, n=64, scale=100.0)
    for seed in range(6):
        a, b = _both(data, y, seed, beta=0.1, n_sample=16, knn=False)
        _assert_same(a, b)


@pytest.mark.parametrize("empty", ["erase", "add"])
def test_rsmix_with_an_empty_ball_equals_the_jax_function(empty):
    """A cloud of NaN coordinates has no point within any radius: as the
    cloud mixed into (``erase``: it stays as it is, lambda 0) or as the
    partner (``add``: the erased points are replaced by copies of kept
    ones, lambda 0)."""
    data, y = _batch(4, b=2, n=64)
    for seed in range(8):
        rng = np.random.default_rng(seed)
        rng.beta(1.0, 1.0)
        perm = rng.choice(2, 2, replace=False)
        if perm[0] == 1:  # cloud 0's partner is cloud 1
            break
    nan_cloud = 0 if empty == "erase" else 1
    data[nan_cloud] = np.nan
    a, b = _both(data, y, seed, beta=1.0, n_sample=32, knn=False)
    (ra, na), (rb, nb) = a, b
    assert na == nb
    for x, z in zip(ra, rb):
        np.testing.assert_array_equal(x, z)  # NaNs in the same places
    mixed, lam = rb[0], rb[1]
    assert lam[0] == 0.0
    if empty == "erase":
        assert np.isnan(mixed[0]).all()
    else:
        assert np.isfinite(mixed[0]).all()
        assert {tuple(p) for p in mixed[0]} <= {tuple(p) for p in data[0]}


def test_the_helpers_equal_the_jax_ones():
    data, _ = _batch(5, b=1, n=128)
    xyz = data[0]
    for query, radius in ((xyz[3], 0.8), (np.full(3, 50.0, np.float32), 0.5)):
        got = port_rsmix._ball_subset(xyz, query, radius, 32)
        ref = jax_rsmix._ball_subset(xyz, query, radius, 32)
        np.testing.assert_array_equal(got, ref)
    assert len(got) == 0  # the far query's ball is empty
    np.testing.assert_array_equal(port_rsmix._knn_subset(xyz, xyz[7], 20),
                                  jax_rsmix._knn_subset(xyz, xyz[7], 20))
    for ne, na in ((10, 4), (4, 10), (6, 6)):
        erase, add = np.arange(ne), np.arange(100, 100 + na)
        r1, r2 = np.random.default_rng(ne), np.random.default_rng(ne)
        np.testing.assert_array_equal(port_rsmix._ctrl_count(erase, add, r1),
                                      jax_rsmix._ctrl_count(erase, add, r2))
        assert r1.random() == r2.random()


@pytest.mark.parametrize("beta", [0.0, 1.0], ids=["zero_beta", "beta_1"])
def test_the_epochs_host_mixing_equals_the_jax_one(beta):
    """``train_one_epoch_rsmix``'s host side: a coin every batch, then
    rsmix where ``beta > 0`` and the coin falls under ``rsmix_prob``, else
    the batch unmixed with lambda 0 (the zero-beta path). The JAX epoch
    is replayed with its own calls on a generator of the same seed."""
    import torch
    from adaptpoint_tpu_torch.engine import corrupt_main
    from adaptpoint_tpu_torch.utils import EasyConfig

    cfg = EasyConfig({"num_classes": 40, "rsmix_params": EasyConfig(
        {"beta": beta, "rsmix_prob": 0.5, "nsample": 32, "knn": True})})
    loader = [dict(zip(("x", "y"), _batch(20 + i, b=4, n=96, c=4)))
              for i in range(6)]
    seen = []

    def step(state, batch, rng, lr):
        seen.append({k: v.clone() for k, v in batch.items()})
        return state, torch.zeros(()), batch["y"]

    state = type("S", (), {"device": torch.device("cpu")})()
    corrupt_main.train_one_epoch_rsmix(
        step, state, loader, None, 0.1, cfg,
        np_rng=np.random.default_rng(7))
    rng = np.random.default_rng(7)
    mixed_any = False
    for batch, got in zip(loader, seen):
        r = rng.random()
        if beta > 0 and r < 0.5:
            mixed, lam, y_a, y_b = jax_rsmix.rsmix(
                batch["x"], batch["y"], beta=beta, n_sample=32, knn=True,
                rng=rng)
            mixed_any = True
        else:
            mixed, lam, y_a, y_b = (batch["x"], np.zeros(4, np.float32),
                                    batch["y"], batch["y"])
        np.testing.assert_array_equal(got["x"].numpy(), mixed)
        np.testing.assert_array_equal(got["lam"].numpy(), lam)
        np.testing.assert_array_equal(got["y"].numpy(), y_a)
        np.testing.assert_array_equal(got["y_b"].numpy(), y_b)
    assert mixed_any == (beta > 0)
    assert port_rsmix_fn is port_rsmix.rsmix
