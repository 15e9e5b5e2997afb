"""Training of the port against the reference, on the CPU, for the MoE
family: the loss (with its load-balancing term) and every gradient of the
reduced llama4-maverick (with its shared expert) and olmoe-1b-7b against
``jax.value_and_grad`` of the JAX package, and three ``make_train_step``
steps in both packages.  The checks, their tolerances and the routing
guard are ``tests/test_torch_train.py``'s; the gradients reach the tokens
through the MoE dispatch kernel's autograd function and the attention
through the flash attention kernel's."""

import pytest

from test_torch_train import check_loss_and_gradients, check_three_train_steps

LOSS_ARCHS = ["llama4_maverick", "olmoe_1b_7b"]


@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_loss_and_gradients_match_the_reference(arch):
    check_loss_and_gradients(arch)


def test_three_train_steps_match_the_reference():
    check_three_train_steps("olmoe_1b_7b")
