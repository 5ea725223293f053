"""Four sequence ranks, on the CPU (f32; gloo worlds of 4): five mesh
steps at ``sequence=4`` for ring standard, zigzag and Ulysses against
JAX's ``make_train_window`` on a host mesh of the same sizes
(``test_torch_sequence_train.check_mesh_steps``: losses and grad norms
rtol 1e-5, gathered params rtol 1e-5, atol 2e-6): every row's 32
columns in four chunks of 8 (zigzag: half-chunks of 4), one head a rank
under Ulysses.
"""

import pytest

from test_torch_sequence_train import IMPL_IDS, IMPLS, check_mesh_steps


@pytest.mark.parametrize("impl,schedule", IMPLS, ids=IMPL_IDS)
def test_sequence4_steps_match_jax(tmp_path, impl, schedule):
    check_mesh_steps(tmp_path, 4, dict(fsdp=1, sequence=4), impl, schedule)
