"""The augmentor on the route the card takes, against the JAX augmentor on its TPU grouper kernel interpreted on the CPU.

``tests/test_torch_adapt_models.py`` holds the augmentor against the JAX
package's XLA route, on which the grouper keeps f32 values. Here both
packages take the accelerator's grouping route: the port's own
``ops.ball_group_max`` (its plain version on the CPU, which the CUDA kernel
equals), the JAX augmentor ``ball_group_maxpool_pallas`` in TPU interpret mode
(``test_torch_gan_route.pallas_ball_group_max``). Both round the grouper's
values to bf16, bit for bit alike on the same input
(``test_torch_gan_route``). But the packages' grouper inputs differ in their
last f32 bits (another sum order in the convolutions before them), and a bf16
rounding that falls the other way moves a value by 2^-8 of itself. At these
sizes no seed leaves every rounding alike: on the forward's cloud 4, 15, 114
and 863 values of the four groupers round the other way (of 98,304 each).
So the tolerances here are from readings, about twice each (measured in
brackets): R/S/T logits 1e-2 * (1 + |ref|) (4.5e-3), clouds 6e-4 (2.8e-4),
each parameter gradient 0.15 in relative 2-norm (8.7e-2); the keep/drop
mask is exact and the BN statistics keep ``TOL_AUGMENTOR``'s (2.1e-5 and
6.8e-5 in its units).
"""
import pytest

from test_torch_adapt_models import (TOL_AUGMENTOR, check_augmentor_forward,
                                     check_augmentor_gradients, gen_pair)
from test_torch_gan_route import interpreted_grouper

__all__ = ["gen_pair", "interpreted_grouper"]  # fixtures this module uses

TOL_AUGMENTOR_ROUTE = dict(TOL_AUGMENTOR, prob=1e-2, gen=6e-4, bn=(1e-4, 5e-5),
                           loss=(2e-3, 1e-4), grad_l2=0.15)


@pytest.mark.usefixtures("interpreted_grouper")
def test_augmentor_on_the_kernel_route_matches_jax(gen_pair):
    print("augmentor forward, kernel route:",
          check_augmentor_forward(gen_pair, TOL_AUGMENTOR_ROUTE))


@pytest.mark.usefixtures("interpreted_grouper")
def test_augmentor_gradients_on_the_kernel_route_match_jax(gen_pair):
    print("augmentor gradients, kernel route:",
          check_augmentor_gradients(gen_pair, TOL_AUGMENTOR_ROUTE))
