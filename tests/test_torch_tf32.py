"""The transformer's train step holds its f32 products to f32, as the MLP's
and ``entry.train_flagship`` do: with
``torch.backends.cuda.matmul.allow_tf32`` on, ``make_train_step`` raises
before it builds a step (the flag restored after each case)."""

import pytest
import torch
import torch.distributed as dist

from rabit_tpu_torch.models import transformer as tf
from rabit_tpu_torch.parallel.mesh import make_mesh


@pytest.fixture
def tf32_on():
    saved = torch.backends.cuda.matmul.allow_tf32
    mesh = make_mesh((1, 1, 1), "cpu")
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        yield mesh
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
        dist.destroy_process_group()


@pytest.mark.parametrize("grad_sync", tf.GRAD_SYNCS)
def test_transformer_step_refuses_tf32(tf32_on, grad_sync):
    with pytest.raises(RuntimeError, match="allow_tf32"):
        tf.make_train_step(tf32_on, lr=0.1, grad_sync=grad_sync)


def test_transformer_step_builds_with_tf32_off():
    mesh = make_mesh((1, 1, 1), "cpu")
    try:
        assert not torch.backends.cuda.matmul.allow_tf32
        assert callable(tf.make_train_step(mesh, lr=0.1))
    finally:
        dist.destroy_process_group()
