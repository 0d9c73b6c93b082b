"""The dry run's multi-pod cell of ``tests/test_dryrun.py``:
``granite-moe-1b-a400m`` x ``train_4k`` on the (2, 16, 16) mesh of a fake
512-rank process group, microbatches 2, against the JAX package's
sanitized specs and analytic cost (see ``tests/test_torch_dryrun.py``).
"""
from test_torch_dryrun import _check, fake_world  # noqa: F401 - a fixture

from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh


def test_multipod_mesh_shards_pod_axis(fake_world):  # noqa: F811
    fake_world(512)
    mesh = make_production_mesh(multi_pod=True, device_type="cpu")
    assert mesh.mesh_dim_names == ("pod", "data", "model")
    assert tuple(mesh.shape) == (2, 16, 16)
    rec = dryrun.lower_cell("granite-moe-1b-a400m", "train_4k", mesh,
                            microbatches=2)
    _check(rec, "granite-moe-1b-a400m", "train_4k", 512, (2, 16, 16))
    assert rec["microbatches"] == 2
    assert rec["memory"]["opt_bytes"] > 2 * rec["memory"]["param_bytes"]
    assert rec["collective_counts"]["all-reduce"] > 0
