"""The port's synthetic LM data (``repro_torch.data``) against
``repro.data`` on the CPU: the same ``(seed, step)`` gives the same tokens
bit for bit, and ``batch_for`` the same batch for every config; plus the
port analogs of ``tests/test_data.py``."""
import numpy as np
import pytest

from repro.configs import ALL_ARCHS
from repro.configs import get_config as jget_config
from repro.configs.base import ShapeConfig as JShape
from repro.data import SyntheticLMDataset as JDataset
from repro.data import batch_for as jbatch_for
from repro_torch.configs import get_config as tget_config
from repro_torch.configs.base import ShapeConfig as TShape
from repro_torch.data import SyntheticLMDataset, batch_for


@pytest.mark.parametrize("kw", [
    dict(vocab_size=512, seq_len=64, global_batch=8, seed=3),
    dict(vocab_size=49155, seq_len=128, global_batch=4, seed=0),
    dict(vocab_size=512, seq_len=32, global_batch=8, seed=1, num_hosts=4,
         host_id=2),
    dict(vocab_size=1000, seq_len=16, global_batch=2, seed=7,
         markov_order=False),
])
def test_batch_at_matches_reference(kw):
    mine, ref = SyntheticLMDataset(**kw), JDataset(**kw)
    np.testing.assert_array_equal(mine._jump, ref._jump)
    for step in (0, 1, 5, 100, 12345):
        a, b = mine.batch_at(step), ref.batch_at(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("step", [0, 3])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_batch_for_matches_reference(arch, step):
    """Every smoke config's train and prefill batch (vlm patch embeddings
    and audio frames included), on two hosts' slices."""
    for kind in ("train", "prefill"):
        for host in (0, 1):
            seq = 32 + tget_config(arch, smoke=True).num_patches
            a = batch_for(tget_config(arch, smoke=True),
                          TShape("s", seq, 4, kind), step=step, seed=2,
                          num_hosts=2, host_id=host)
            b = jbatch_for(jget_config(arch, smoke=True),
                           JShape("s", seq, 4, kind), step=step, seed=2,
                           num_hosts=2, host_id=host)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k])


def test_restart_determinism():
    """Step k yields identical data across dataset instances (restart-safe)."""
    a = SyntheticLMDataset(512, 64, 8, seed=3)
    b = SyntheticLMDataset(512, 64, 8, seed=3)
    for k in (0, 5, 100):
        np.testing.assert_array_equal(a.batch_at(k)["tokens"],
                                      b.batch_at(k)["tokens"])
    assert not np.array_equal(a.batch_at(0)["tokens"],
                              a.batch_at(1)["tokens"])
    it = iter(a)
    np.testing.assert_array_equal(next(it)["tokens"], a.batch_at(0)["tokens"])
    np.testing.assert_array_equal(next(it)["tokens"], a.batch_at(1)["tokens"])


def test_host_sharding_partitions_batch():
    parts = [SyntheticLMDataset(512, 32, 8, seed=1, num_hosts=4, host_id=i)
             for i in range(4)]
    assert [p.batch_at(0)["tokens"].shape[0] for p in parts] == [2, 2, 2, 2]
    assert not np.array_equal(parts[0].batch_at(0)["tokens"],
                              parts[1].batch_at(0)["tokens"])


def test_labels_are_next_tokens_and_markov():
    ds = SyntheticLMDataset(512, 4096, 2, seed=7)
    b = ds.batch_at(0)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    toks, labels = b["tokens"], b["labels"]
    pred = (toks.astype(np.int64) + ds._jump[toks % 256]) % 512
    assert 0.75 < float(np.mean(pred == labels)) < 0.95
