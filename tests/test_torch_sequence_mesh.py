"""The sequence axis beside fsdp, on the CPU (f32; gloo worlds of 4):
five mesh steps at ``fsdp=2, sequence=2`` for ring standard, zigzag and
Ulysses against JAX's ``make_train_window`` on a host mesh of the same
sizes (``test_torch_sequence_train.check_mesh_steps``: losses and grad
norms rtol 1e-5, gathered params rtol 1e-5, atol 2e-6). The gradients
are reduce-scattered over fsdp and all-reduced over the sequence peers.
"""

import pytest

from test_torch_sequence_train import IMPL_IDS, IMPLS, check_mesh_steps


@pytest.mark.parametrize("impl,schedule", IMPLS, ids=IMPL_IDS)
def test_fsdp2_sequence2_steps_match_jax(tmp_path, impl, schedule):
    check_mesh_steps(tmp_path, 4, dict(fsdp=2, sequence=2), impl, schedule)
