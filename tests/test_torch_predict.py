"""The port's runtime predictor and its ``predict_mlp`` module against the
JAX package's.

On the CPU ``repro_torch.kernels.ops.predict_mlp`` runs the plain torch
version (``ref.predict_mlp_ref``).  It is held to the Pallas kernel run as
``tests/test_predict.py`` runs it (interpret mode through
``repro.kernels.ops``) and to the numpy ``QuantileMLP.forward``, within atol
1e-5 (the bound of ``test_predict.py::test_kernel_forward_matches_numpy``:
f32 sums in another order).  Training stays numpy on the host in both
packages, so the training stream is held exactly.  The CUDA kernel itself
is compared with the plain version on the card by
``test_torch_kernels_gpu.py``."""
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro.kernels import ops as j_ops
from repro.predict import QuantileMLP as JQuantileMLP
from repro.predict import RuntimePredictor as JRuntimePredictor
from repro.sched import SchedulerEngine as JSchedulerEngine
from repro_torch import convert
from repro_torch.kernels import ops, predict_mlp as pm
from repro_torch.kernels.ref import predict_mlp_ref
from repro_torch.predict import PREDICT_FEATURES, RuntimePredictor
from repro_torch.sched import SchedulerEngine
from test_torch_stream import _signature

ATOL = 1e-5
RTOL_QUANTILES = 1e-6


def _mlp_params(seed: int) -> dict:
    """``QuantileMLP`` weights at its own init plus a random non-zero head
    (the zero-initialised head would hide every error past layer 2)."""
    mlp = JQuantileMLP(seed=seed)
    rng = np.random.default_rng(seed + 100)
    for k in ("w3", "b3"):
        mlp.params[k][:] = rng.normal(0, 0.5, mlp.params[k].shape)
    return mlp.params


def _torch_params(params: dict, device="cpu") -> dict:
    return {k: torch.tensor(v, device=device) for k, v in params.items()}


@pytest.mark.parametrize("B", [1, 6, 300, 2560])
def test_predict_mlp_matches_pallas_and_numpy(B):
    params = _mlp_params(B)
    x = np.random.default_rng(B).normal(
        0, 1, (B, PREDICT_FEATURES)).astype(np.float32)
    got = ops.predict_mlp(torch.tensor(x), _torch_params(params)).numpy()
    pallas = np.asarray(j_ops.predict_mlp(jnp.asarray(x), params,
                                          interpret=True))
    mlp = JQuantileMLP()
    mlp.params = params
    want = mlp.forward(x)
    assert got.shape == (B, 2) and got.dtype == np.float32
    assert np.abs(want).max() > 0.1               # the head is not zero
    np.testing.assert_allclose(got, pallas, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_ops_sends_cpu_tensors_to_the_plain_version():
    params = _torch_params(_mlp_params(1))
    x = torch.tensor(np.random.default_rng(1).normal(
        0, 1, (40, PREDICT_FEATURES)).astype(np.float32))
    before = pm.launches
    via_ops = ops.predict_mlp(x, params)
    assert pm.launches == before
    direct = predict_mlp_ref(x, *(params[k] for k in
                                  ("w1", "b1", "w2", "b2", "w3", "b3")))
    assert torch.equal(via_ops, direct)


def test_dispatch_rejects_other_and_mixed_devices():
    params = _mlp_params(2)
    meta = {k: torch.empty(v.shape, device="meta") for k, v in params.items()}
    with pytest.raises(ValueError, match="device type"):
        ops.predict_mlp(torch.empty((4, PREDICT_FEATURES), device="meta"), meta)
    with pytest.raises(ValueError, match="several devices"):
        ops.predict_mlp(torch.zeros((4, PREDICT_FEATURES)), meta)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The wrapper never falls back: CPU tensors are an error there (the
    CPU path is chosen by ops), and nothing is built or launched."""
    params = _torch_params(_mlp_params(3))
    before = pm.launches
    with pytest.raises(ValueError, match="CUDA"):
        pm.predict_mlp(torch.zeros((4, PREDICT_FEATURES)),
                       *(params[k] for k in ("w1", "b1", "w2", "b2", "w3",
                                             "b3")))
    assert pm.launches == before


def test_runtime_predictor_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RuntimePredictor()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RuntimePredictor(device="cuda")
    assert RuntimePredictor(device="cpu").device == torch.device("cpu")


def _est_pri(pkg):
    return pkg.PolicyPrioritizer(pkg.make_policy("fcfs", use_estimates=True))


def test_training_stream_identical():
    """The same submissions and completions through both predictors, each
    bound to its package's engine: identical train steps, MAPEs, bias
    tables and weights after every completion, and batched quantiles within
    rtol 1e-6 right after each SGD step (a stale device copy of the weights
    would show here: the head moves at every step)."""
    preds, engines, traces = [], [], []
    for pkg, Pred, Eng, kw in ((J, JRuntimePredictor, JSchedulerEngine, {}),
                               (T, RuntimePredictor, SchedulerEngine,
                                {"device": "cpu"})):
        pred = Pred(assist=True, seed=0, **kw)
        engines.append(Eng(pkg.make_cluster("helios"), _est_pri(pkg),
                           allocator="pack", hooks=(pred,), predictor=pred))
        preds.append(pred)
        traces.append(pkg.generate_trace("helios", 160, seed=4))
    jp, tp = preds
    for k in range(len(traces[0])):
        for pred, jobs in zip(preds, traces):
            job = jobs[k]
            pred.on_submit(job, job.submit_time)
            if k >= 20 and k % 2 == 0:
                done = jobs[k - 20]
                pred.on_finish(done, done.submit_time + done.runtime)
        if k >= 20 and k % 2 == 0:
            probe = [jobs[max(0, k - 30):k + 1] for jobs in traces]
            want = jp.predict_quantiles(probe[0])
            got = tp.predict_quantiles(probe[1])
            for w, g in zip(want, got):
                np.testing.assert_allclose(g, w, rtol=RTOL_QUANTILES, atol=0)
    assert tp.train_steps == jp.train_steps == 70
    assert tp.mlp.updates == 70
    assert (tp.mape(), tp.baseline_mape()) == (jp.mape(), jp.baseline_mape())
    assert (tp.rolling_mape(), tp.baseline_rolling_mape()) == \
        (jp.rolling_mape(), jp.baseline_rolling_mape())
    assert tp._bias_sum == jp._bias_sum and tp._bias_n == jp._bias_n
    for k, v in jp.mlp.params.items():
        assert np.array_equal(tp.mlp.params[k], v), k
    assert np.abs(tp.mlp.params["w3"]).max() > 0       # the head trained


def test_device_copy_follows_in_place_updates():
    """``sgd_step`` rewrites the numpy weights in place, so the dict keeps
    its identity; the device copy must still be replaced."""
    p = RuntimePredictor(device="cpu")
    jobs = T.generate_trace("helios", 8, seed=2)
    first = p._device_params()
    assert p._device_params() is first              # no change: reused
    ident = id(p.mlp.params)
    p.on_submit(jobs[0], 0.0)
    p.on_finish(jobs[0], jobs[0].runtime)
    assert id(p.mlp.params) == ident
    second = p._device_params()
    assert second is not first
    for k, v in p.mlp.params.items():
        assert np.array_equal(second[k].numpy(), v)
        assert second[k].data_ptr() != v.ctypes.data    # copied, not aliased


def test_convert_quantile_mlp_copies_weights():
    src = _mlp_params(5)
    jp = JRuntimePredictor(assist=True)
    jp.mlp.params = {k: v.copy() for k, v in src.items()}
    tp = RuntimePredictor(device="cpu")
    tp._device_params()                              # an upload to go stale
    convert.load_quantile_mlp_params(tp.mlp, src)
    for k, v in src.items():
        assert np.array_equal(tp.mlp.params[k], v)
        assert not np.shares_memory(tp.mlp.params[k], v)
    jobs_j = J.generate_trace("helios", 40, seed=3)
    jobs_t = T.generate_trace("helios", 40, seed=3)
    for w, g in zip(jp.predict_quantiles(jobs_j), tp.predict_quantiles(jobs_t)):
        np.testing.assert_allclose(g, w, rtol=RTOL_QUANTILES, atol=0)
    bad = dict(src, w3=np.zeros((12, 3), np.float32))
    with pytest.raises(ValueError, match="shape"):
        convert.load_quantile_mlp_params(tp.mlp, bad)
    with pytest.raises(ValueError, match="keys"):
        convert.load_quantile_mlp_params(tp.mlp, {"w1": src["w1"]})


def test_failover_roundtrip_preserves_predictor():
    """save_state mid-stream, load_state, drain: the pickled predictor drops
    its device copy, is rebound, keeps training, and the schedule equals an
    uninterrupted run's and the reference's."""
    sigs = {}
    for pkg, Pred, Eng, kw in ((J, JRuntimePredictor, JSchedulerEngine, {}),
                               (T, RuntimePredictor, SchedulerEngine,
                                {"device": "cpu"})):
        p = Pred(assist=True, seed=0, **kw)
        eng = Eng(pkg.make_cluster("helios"), _est_pri(pkg),
                  allocator="pack", hooks=(p,), predictor=p)
        jobs = pkg.generate_trace("helios", 60, seed=5)
        eng.submit(jobs)
        eng.step(jobs[30].submit_time)
        blob = eng.save_state()
        eng2 = Eng.load_state(blob)
        if pkg is T:
            assert p._dev_params is not None        # the live one uploaded
            assert pickle.loads(pickle.dumps(p))._dev_params is None
            assert eng2.predictor._dev_params is None
        assert eng2.predictor.engine is eng2
        assert eng2.predictor in eng2.hooks
        eng.drain()
        eng2.drain()
        assert _signature(eng) == _signature(eng2)
        assert eng.predictor.train_steps == eng2.predictor.train_steps
        sigs[pkg.__name__] = _signature(eng2)
    assert sigs["repro_torch.core"] == sigs["repro.core"]
