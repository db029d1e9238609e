#!/usr/bin/env python3
"""Train-mode BatchNorm variance: the port against flax, on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/torch_bn_variance_vs_flax.py

For (rows x 64) f32 batches of unit spread around a mean of 10, 100 and
1000 times that spread, prints one JSON line per case: how far flax's own
f32 sums (``E[x]``, ``E[x^2]``) lie from the exactly rounded ones, in ulps,
and the largest distance from flax's batch variance and normalised output
of (a) the port's ``BatchNorm`` (two-pass variance, PyTorch's
normalisation) and (b) flax's formula ``max(0, E[x^2] - E[x]^2)`` in f32
with PyTorch's sums. Neither form tracks flax once the mean dominates: the
spread between them is that of any two f32 summation orders.
"""
import json
import os
import sys
import warnings

import numpy as np
import torch

import jax
import jax.numpy as jnp
import flax.linen as nn

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from adaptpoint_tpu_torch.models.layers.blocks import BatchNorm


def ulps(a, b):
    return int(np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32).astype(np.int64)).max())


def main():
    warnings.filterwarnings("ignore")
    rng = np.random.default_rng(0)
    for rows in (64, 1024, 16384):
        for ratio in (10, 100, 1000):
            x = (rng.standard_normal((rows, 64))
                 + ratio * rng.choice([-1, 1], 64)).astype(np.float32)
            bn = nn.BatchNorm(use_running_average=False, momentum=0.9,
                              epsilon=1e-5)
            v = bn.init(jax.random.PRNGKey(0), x)
            y, upd = bn.apply(v, x, mutable=["batch_stats"])
            y = np.asarray(y)
            fvar = (np.asarray(upd["batch_stats"]["var"]) - 0.9) / 0.1
            m = np.asarray(jnp.mean(x, 0))
            m2 = np.asarray(jnp.mean(x * x, 0))
            t = torch.from_numpy(x)
            exact_m = t.double().mean(0).float().numpy()
            exact_m2 = (t.double() ** 2).mean(0).float().numpy()
            port = BatchNorm(64)
            yp = port(t).detach().numpy()
            pvar = (port.running_var.numpy() - 0.9) / 0.1
            tm, tm2 = t.mean(0), (t * t).mean(0)
            tvar = (tm2 - tm * tm).clamp(min=0)
            yt = ((t - tm) * torch.rsqrt(tvar + 1e-5)).numpy()
            print(json.dumps({
                "rows": rows, "mean_over_std": ratio,
                "flax_sums_ulps_from_exact": {"mean": ulps(m, exact_m),
                                              "mean2": ulps(m2, exact_m2)},
                "port_two_pass": {
                    "var_abs": float(np.abs(pvar - fvar).max()),
                    "out_abs": float(np.abs(yp - y).max())},
                "flax_formula_torch_sums": {
                    "var_abs": float(np.abs(tvar.numpy() - fvar).max()),
                    "out_abs": float(np.abs(yt - y).max())}}))


if __name__ == "__main__":
    main()
