"""The port's multi-process runtime (parallel/multiproc.py): 2 OS
processes from the torchrun variables on localhost, gloo collectives, the
sharded loader partitioning each epoch by rank, and the sharded train
step keeping the parameters identical on every rank; then every rank's
chip-local containers reproduced by a separately spawned single-process
coder.  The assertions are tests/test_multiproc.py's of the JAX package.
The ranks run on the CPU because the test asks for it; by default they
run on the card."""

import pytest
import torch

from finalproject_losslessimagecompression_tpu_torch.parallel.multiproc import (  # noqa: E501
    launch,
)


def test_two_process_distributed_train():
    out = launch(num_processes=2, steps=4, local_batch=4, timeout_s=120.0,
                 device="cpu")
    assert out["ok"]
    assert out["num_processes"] == 2
    assert out["global_devices"] == 2 and out["local_devices"] == 1
    assert out["mesh_shape"] == {"data": 2, "tile": 1}
    assert out["epoch_coverage"]["disjoint"]
    assert out["epoch_coverage"]["per_rank_samples"] == [16, 16]
    assert out["epoch_coverage"]["union_size"] == 32
    assert len(out["identical_loss_series"]) == 4
    # every rank's chip-local container is byte-identical to a separately
    # spawned single-process compress of the same shard with the same
    # trained params, and decodes bit-exactly
    assert out["coding"]["byte_identical"]
    assert out["coding"]["bit_exact"]
    assert len(out["coding"]["per_rank_container_sha256"]) == 2


def test_launch_runs_on_the_card_unless_the_cpu_is_asked(monkeypatch):
    # the default device is the card: without one, launch raises before it
    # spawns anything, and never falls back to the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch(num_processes=2)


def test_launch_needs_a_measured_step():
    # each rank's first step runs eagerly and its second captures, so the
    # collective time needs a third: fewer steps raise before spawning
    with pytest.raises(ValueError, match="at least 3"):
        launch(num_processes=2, steps=2, device="cpu")
