"""The PyTorch port's solver vs. ``lara_tpu.solver.device_solver`` (CPU).

The same numpy batch (``__graft_entry__._example_batch``) goes to both
packages through ``lara_tpu_torch.convert``; the whole carry must be equal
after 1, 7 and 20 iterations, and so must the results of a full
``solve_batch``.  Zero tolerance: the one float32 step keeps the
reference's operation order.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from __graft_entry__ import _example_batch
from lara_tpu.solver import device_solver as jax_solver
from lara_tpu_torch import convert
from lara_tpu_torch.solver import device_solver

CPU = torch.device("cpu")
LA_MAX = LB_MAX = 32
STEP0 = np.float32(1.0)


@pytest.fixture(scope="module")
def batch():
    return _example_batch()


def _assert_carry_equal(got, want):
    for field, g, w in zip(device_solver._Carry._fields,
                           convert.carry_to_numpy(got),
                           convert.carry_to_numpy(want)):
        np.testing.assert_array_equal(g, w, err_msg=field)


@pytest.mark.parametrize("steps", [1, 7, 20])
def test_carry_matches_jax_after_steps(batch, steps):
    model, go, ge = batch
    b, d = model.dual_l.shape
    jax_model = jax_solver.BatchModel(*(jnp.asarray(x) for x in model))
    jax_carry = jax_solver._init_carry(b, d, LA_MAX, STEP0, 20)
    want = jax_solver.solve_batch_chunk(jax_model, jax_carry, go, ge, LA_MAX,
                                        LB_MAX, steps, 5, 5)
    port_carry = convert.carry_to_torch(
        jax_solver._init_carry(b, d, LA_MAX, STEP0, 20), CPU)
    got = device_solver.solve_batch_chunk(
        convert.model_to_torch(model, CPU), port_carry, go, ge, LA_MAX,
        LB_MAX, steps, 5, 5)
    _assert_carry_equal(got, want)


def test_carry_resumes_across_dispatches(batch):
    """Two dispatches of 4 and 3 iterations == one of 7."""
    model, go, ge = batch
    b, d = model.dual_l.shape
    tmodel = convert.model_to_torch(model, CPU)
    carry = device_solver._init_carry(b, d, LA_MAX, STEP0, 20, CPU)
    once = device_solver.solve_batch_chunk(tmodel, carry, go, ge, LA_MAX,
                                           LB_MAX, 7, 5, 5)
    twice = device_solver.solve_batch_chunk(tmodel, carry, go, ge, LA_MAX,
                                            LB_MAX, 4, 5, 5)
    twice = device_solver.solve_batch_chunk(tmodel, twice, go, ge, LA_MAX,
                                            LB_MAX, 3, 5, 5)
    _assert_carry_equal(twice, once)


def test_solve_batch_matches_jax(batch):
    model, go, ge = batch
    want = jax_solver.solve_batch(
        jax_solver.BatchModel(*(jnp.asarray(x) for x in model)), go, ge,
        STEP0, LA_MAX, LB_MAX, 20, 5, 5)
    got = device_solver.solve_batch(convert.model_to_torch(model, CPU), go,
                                    ge, STEP0, LA_MAX, LB_MAX, 20, 5, 5)
    for field, g, w in zip(device_solver.BatchResult._fields, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=field)
    assert (got.iterations > 0).all()
