"""The port's scaling harness (parallel/scaling.py, cli/scaling.py) on 2
gloo ranks on the CPU.  No efficiency threshold is asserted: the ranks
share this machine's cores, so the numbers measure nothing of a card."""

import json
import os

import pytest

from finalproject_losslessimagecompression_tpu_torch.cli import scaling
from finalproject_losslessimagecompression_tpu_torch.parallel.multiproc import (  # noqa: E501
    spawn_ranks,
)

TINY = ["--size", "8", "--growth", "8", "--depth", "1", "--nflows", "1",
        "--nsplit", "1", "--steps", "2"]


def _measure(out):
    """One rank: measure_scaling on the 8x8 flow at 1 and 2 ranks, both
    modes; rank 0 saves the results."""
    import torch
    import torch.distributed as dist

    from finalproject_losslessimagecompression_tpu_torch.parallel.mesh import (  # noqa: E501
        init_distributed,
    )
    from finalproject_losslessimagecompression_tpu_torch.parallel.multiproc import (  # noqa: E501
        _worker_flow_cfg,
    )
    from finalproject_losslessimagecompression_tpu_torch.models import IDFlow
    from finalproject_losslessimagecompression_tpu_torch.parallel.scaling import (  # noqa: E501
        measure_scaling,
    )

    torch.set_num_threads(1)
    init_distributed("gloo", "cpu", timeout_s=60.0)
    model = IDFlow(_worker_flow_cfg(), device="cpu", seed=0)
    res = {mode: measure_scaling(model, per_device_batch=1, steps=2,
                                 device_counts=[1, 2], mode=mode)
           for mode in ("weak", "overhead")}
    if dist.get_rank() == 0:
        with open(out, "w") as f:
            json.dump(res, f)
    dist.destroy_process_group()


def test_measure_scaling_both_modes(tmp_path):
    out = str(tmp_path / "res.json")
    spawn_ranks(_measure, 2, (out,), timeout_s=120.0)
    with open(out) as f:
        res = json.load(f)
    for mode in ("weak", "overhead"):
        assert set(res[mode]) == {"1", "2"}
        for r in res[mode].values():
            assert r["images_per_s"] > 0
            assert r["efficiency"] > 0
            # gloo: the mesh's host seconds; device time is NCCL's only
            assert r["collective_host_ms"] >= 0
            assert "collective_device_ms" not in r
        assert res[mode]["1"]["efficiency"] == 1.0
        # one rank runs no collective; two all_reduce every step
        assert res[mode]["1"]["collective_host_ms"] == 0.0
        assert res[mode]["2"]["collective_host_ms"] > 0


def test_cli_writes_the_artifact_with_weak_scaling_unmeasured(tmp_path):
    """cli.scaling spawns its 2 gloo ranks on the CPU and writes the JSON
    artifact: both modes at 1 and 2 ranks, weak scaling on hardware
    stamped unmeasured."""
    path = str(tmp_path / "SCALING.json")
    out = scaling.main(["--device", "cpu", "--out", path, "--timeout", "120"]
                       + TINY)
    assert os.path.exists(path)
    with open(path) as f:
        assert json.load(f) == out
    assert out["platform"] == "cpu" and out["backend"] == "gloo"
    assert out["n_devices"] == 2 and out["distinct_cards"] == 0
    assert out["cards"] == [None, None]
    assert out["weak_scaling_on_hardware"].startswith("unmeasured")
    for mode in ("overhead", "weak"):
        assert set(out[mode]) == {"1", "2"}
        assert all(r["images_per_s"] > 0 for r in out[mode].values())


class _HostMesh:
    """A gloo mesh's collective count: each call of `collective` adds its
    host seconds to `comm_s`."""
    backend = "gloo"
    comm_s = 0.5

    def collective(self, s):
        self.comm_s += s


def test_collective_ms_is_per_step_and_names_what_it_measured():
    """utils.profiling.collective_ms over gloo: the mesh's host seconds
    during run(), per step, under the host's name (the device's name is
    NCCL's only); zero steps measure nothing and raise."""
    from finalproject_losslessimagecompression_tpu_torch.utils.profiling import (  # noqa: E501
        collective_ms,
    )

    mesh = _HostMesh()
    out = collective_ms(mesh, lambda: [mesh.collective(0.004)
                                       for _ in range(2)], 2)
    assert out.keys() == {"collective_host_ms"}
    assert out["collective_host_ms"] == pytest.approx(4.0)
    with pytest.raises(ValueError, match="0 steps"):
        collective_ms(mesh, lambda: None, 0)
