"""The control plane and the fleet on the card: kernels launched from several
host threads at once, as ``FederatedScheduler(parallel=True)`` launches
them from its members' worker threads.

Needs a CUDA card and ``nvcc``: every test carries the ``gpu`` marker and
skips without a card.  Imports neither JAX nor the ``repro`` package:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_fleet_gpu.py
"""
import threading

import numpy as np
import pytest
import torch

from repro_torch.fed import run_fleet
from repro_torch.kernels import ops, policy_mlp as pm, predict_mlp as qm
from repro_torch.predict import RuntimePredictor

THREADS = 4
CALLS = 200


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _inputs(seed, device):
    """One thread's policy-MLP and predictor-MLP inputs, unit scale."""
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.tensor(rng.normal(size=shape), dtype=torch.float32,
                            device=device)
    actor = [{"w": t(a, b), "b": t(b)} for a, b in ((8, 64), (64, 32),
                                                     (32, 1))]
    Q, B = 256 + 37 * seed, 1 + 97 * seed
    mask = torch.tensor(np.arange(Q) % 3 != 0, dtype=torch.float32,
                        device=device)
    quantile = dict(zip(("w1", "b1", "w2", "b2", "w3", "b3"),
                        (t(21, 24), t(24), t(24, 12), t(12), t(12, 2),
                         t(2))))
    return (t(Q, 8), actor, mask), (t(B, 21), quantile)


def _work(policy_args, predict_args):
    """Alternate the two kernels CALLS times; return every output."""
    outs = []
    with torch.no_grad():
        for _ in range(CALLS):
            outs.append(ops.policy_mlp(*policy_args).cpu())
            outs.append(ops.predict_mlp(*predict_args).cpu())
    return outs


@pytest.mark.gpu
def test_kernels_from_threads_count_exactly_and_match_one_thread(cuda_device):
    inputs = [_inputs(s, cuda_device) for s in range(THREADS)]
    alone = [_work(*args) for args in inputs]
    pm.launches = qm.launches = 0
    start = threading.Barrier(THREADS)
    got: list = [None] * THREADS
    errors: list = []

    def run(i):
        try:
            start.wait(timeout=60)
            got[i] = _work(*inputs[i])
        except Exception as exc:          # reported below, not swallowed
            errors.append(exc)

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    torch.cuda.synchronize()
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:3]
    assert (pm.launches, qm.launches) == (THREADS * CALLS, THREADS * CALLS)
    for mine, ref in zip(got, alone):
        assert all(torch.equal(a, b) for a, b in zip(mine, ref))


def _fleet_sig(sr):
    jobs = tuple(sorted((j.job_id, j.first_start_time, j.finish_time,
                         j.restarts) for j in sr.result.jobs))
    return jobs, tuple((e.decisions, e.milp_calls, e.backfills,
                        e.bf_reservations, e.bf_overruns)
                       for e in sr.fed.engines)


@pytest.mark.gpu
def test_parallel_fleet_on_the_card_equals_serial(cuda_device):
    """A small assisted fleet: members stepped in parallel on the card give
    the serial run's schedule and the same predictor launches."""
    out = []
    for parallel in (True, False):
        preds = []

        def factory(i, spec):
            preds.append(RuntimePredictor(assist=True, seed=i,
                                          device=cuda_device))
            return preds[-1]
        qm.launches = 0
        sr = run_fleet("fleet-skewed-flash", num_jobs=300, seed=0,
                       router="jsq", allocator="pack", rescan_interval=60.0,
                       parallel=parallel, predictor_factory=factory)
        out.append((_fleet_sig(sr), qm.launches))
        assert all(p.device.type == "cuda" for p in preds)
    assert out[0] == out[1]
    assert out[0][1] > 0 and sum(e[3] for e in out[0][0][1]) > 0
