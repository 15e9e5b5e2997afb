"""Training of the port against the reference, on the CPU, for the SSM and
hybrid families: the loss and every gradient of the reduced mamba2-370m
and zamba2-2.7b against ``jax.value_and_grad`` of the JAX package, and
three ``make_train_step`` steps in both packages.  The checks and their
tolerances are ``tests/test_torch_train.py``'s; the gradients reach the
SSD chunk kernel's autograd function (two chunks of 16 a layer) and, in
the hybrid's shared block, the flash attention kernel's."""

import pytest

from test_torch_train import check_loss_and_gradients, check_three_train_steps

LOSS_ARCHS = ["mamba2_370m", "zamba2_2_7b"]


@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_loss_and_gradients_match_the_reference(arch):
    check_loss_and_gradients(arch)


def test_three_train_steps_match_the_reference():
    check_three_train_steps("mamba2_370m")
