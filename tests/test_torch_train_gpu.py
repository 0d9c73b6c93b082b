"""The port's PPO training on the card against the same on the CPU.  Needs
a CUDA card and ``nvcc`` (rollouts launch the policy-MLP kernel): every
test here carries the ``gpu`` marker and skips without a card.  It imports
neither JAX nor the ``repro`` package, so it runs where only the port's
dependencies are installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_train_gpu.py

Tolerances (TF32 off on the card, so both sides are IEEE f32 in another
order of sums): the loss within 1e-5 of the CPU's; each gradient leaf
within 1e-4 of its largest CPU entry, but the last actor bias (zero in
exact arithmetic: both sides give rounding noise below 1e-5 of the last
actor weight's largest gradient); after Adam, all parameters but a fraction
of 1e-4 within 1e-6 of the CPU's and the rest within ``2 * lr * epochs``
(Adam's first steps move a parameter by about ``lr * sign(g)``, so an entry
whose gradient is rounding noise can move the other way)."""
import copy

import numpy as np
import pytest
import torch

from repro_torch.core import agent as T
from repro_torch.core.features import CV_SIZE, MAX_QUEUE_SIZE, OV_SIZE
from repro_torch.kernels import policy_mlp as pm
from repro_torch.rl import RLTuneTrainer, TrainerConfig

PPO = dict(clip_eps=0.2, value_coef=0.5, entropy_coef=0.01)


@pytest.fixture
def cuda_device():
    """The first CUDA device, TF32 off; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the policy-MLP kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _leaves(tree) -> list[tuple[str, np.ndarray]]:
    return [(f"{net}[{i}].{k}", lyr[k].detach().cpu().numpy().copy())
            for net in ("actor", "critic")
            for i, lyr in enumerate(tree[net]) for k in ("w", "b")]


def _batch(seed: int, Tc: int, P: int = 512) -> dict[str, np.ndarray]:
    """A padded PPO batch: Tc steps with 1..256 valid rows each (one step
    with a single row), then P - Tc padded steps (all-zero mask, valid 0)."""
    rng = np.random.default_rng(seed)
    n = rng.integers(1, MAX_QUEUE_SIZE + 1, size=Tc)
    n[:1] = 1
    b = {"ov": np.zeros((P, MAX_QUEUE_SIZE, OV_SIZE), np.float32),
         "cv": np.zeros((P, MAX_QUEUE_SIZE, CV_SIZE), np.float32),
         "mask": np.zeros((P, MAX_QUEUE_SIZE), np.float32),
         "action": np.zeros(P, np.int64)}
    for i, k in enumerate(n):
        b["ov"][i, :k] = rng.uniform(size=(k, OV_SIZE))
        b["cv"][i, :k] = rng.uniform(size=(k, CV_SIZE))
        b["mask"][i, :k] = 1.0
        b["action"][i] = rng.integers(k)
    for key, val in (("logp", -np.log(n) + rng.normal(size=Tc) * 0.05),
                     ("ret", rng.normal(size=Tc)),
                     ("adv", np.clip(rng.normal(size=Tc), -5, 5)),
                     ("valid", np.ones(Tc))):
        b[key] = np.zeros(P, np.float32)
        b[key][:Tc] = val
    return b


def _assert_params_close(got, want, bound: float) -> None:
    total = loose = 0
    for (name, g), (_, w) in zip(_leaves(got), _leaves(want)):
        err = np.abs(g - w)
        assert (err <= bound).all(), name
        total += err.size
        loose += int((err > 1e-6).sum())
    assert loose <= 1e-4 * total, (loose, total)


@pytest.mark.gpu
def test_ppo_update_step_on_card_matches_cpu(cuda_device):
    cpu = T.init_params(T.PPOConfig(seed=3), device="cpu")
    card = copy.deepcopy(cpu).to(cuda_device)
    b = _batch(0, 300)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    cb = {k: v.to(cuda_device) for k, v in tb.items()}
    l_cpu, g_cpu = T._loss_and_grads(cpu, tb, **PPO)
    l_card, g_card = T._loss_and_grads(card, cb, **PPO)
    assert abs(float(l_card) - float(l_cpu)) <= 1e-5 * max(1.0,
                                                           abs(float(l_cpu)))
    ref = dict(_leaves(g_cpu))
    for name, got in _leaves(g_card):
        if name == "actor[2].b":
            assert np.abs(got).max() <= 1e-5 * np.abs(ref["actor[2].w"]).max()
            continue
        assert np.isfinite(got).all()
        err = np.abs(got - ref[name]).max()
        assert err <= 1e-4 * np.abs(ref[name]).max(), (name, err)
    # one full step: Adam's state stays on the card
    lr = 3e-4
    p_cpu, s_cpu, _ = T.ppo_update_step(cpu, T.adam_init(cpu.params), tb,
                                        lr=lr, max_norm=0.5, **PPO)
    p_card, s_card, loss = T.ppo_update_step(card, T.adam_init(card.params),
                                             cb, lr=lr, max_norm=0.5, **PPO)
    assert loss.device.type == "cuda" and s_card["t"].device.type == "cuda"
    assert s_card["t"].dtype == torch.float32 and float(s_card["t"]) == 1.0
    _assert_params_close(p_card, p_cpu, 2 * lr)


def _traj(seed: int, n: int) -> dict[str, list]:
    rng = np.random.default_rng(seed)
    out = {k: [] for k in T._TRAJ_KEYS}
    for _ in range(n):
        k = int(rng.integers(1, MAX_QUEUE_SIZE + 1))
        ov = np.zeros((MAX_QUEUE_SIZE, OV_SIZE), np.float32)
        cv = np.zeros((MAX_QUEUE_SIZE, CV_SIZE), np.float32)
        ov[:k] = rng.uniform(size=(k, OV_SIZE))
        cv[:k] = rng.uniform(size=(k, CV_SIZE))
        out["ov"].append(ov)
        out["cv"].append(cv)
        out["mask"].append((np.arange(MAX_QUEUE_SIZE) < k).astype(np.float32))
        out["action"].append(int(rng.integers(k)))
        out["logp"].append(float(np.float32(-np.log(k))))
        out["value"].append(float(np.float32(rng.normal())))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("dense", [False, True])
def test_finish_episode_on_card_matches_cpu(cuda_device, dense):
    """The terminal and the dense pathway on the card: the same trajectory
    gives the CPU's parameters after 4 epochs, within the stated bound."""
    cfg = T.PPOConfig(seed=4)
    agents = [T.PPOAgent(cfg, device=d) for d in ("cpu", cuda_device)]
    agents[1].load_state_dict(agents[0].state_dict())
    before = _leaves(agents[1].params)
    traj = _traj(1, 120)
    rewards = np.random.default_rng(2).normal(size=120).astype(np.float32)
    out = []
    for agent in agents:
        agent._traj = copy.deepcopy(traj)
        out.append(agent.finish_episode_dense(rewards, bootstrap_value=0.3)
                   if dense else agent.finish_episode(0.7))
    assert out[0]["updated"] == out[1]["updated"] == 1.0
    assert out[1]["steps"] == 120 and np.isfinite(out[1]["loss"])
    assert abs(out[1]["loss"] - out[0]["loss"]) <= 1e-4 * max(
        1.0, abs(out[0]["loss"]))
    assert float(agents[1].opt_state["t"]) == cfg.update_epochs
    assert any((a != b).any() for (_, a), (_, b) in
               zip(before, _leaves(agents[1].params)))
    _assert_params_close(agents[1].params, agents[0].params,
                         2 * cfg.lr * cfg.update_epochs)


@pytest.mark.gpu
def test_rltune_trainer_on_card_changes_params(cuda_device):
    cfg = TrainerConfig(trace="helios", base_policy="fcfs", batch_size=32,
                        batches_per_epoch=2, epochs=1)
    tr = RLTuneTrainer(cfg, device=cuda_device)
    assert tr.agent.device.type == "cuda"
    before = _leaves(tr.agent.params)
    steps = []
    real = tr.agent.finish_episode

    def tapped(reward):
        out = real(reward)
        steps.append(out["steps"])
        return out
    tr.agent.finish_episode = tapped
    pm.launches = 0
    hist = tr.train()[0]
    torch.cuda.synchronize()
    assert len(hist.rewards) == 2
    assert all(np.isfinite(hist.rewards)) and all(np.isfinite(hist.losses))
    assert pm.launches >= sum(steps) > 0
    assert any((a != b).any() for (_, a), (_, b) in
               zip(before, _leaves(tr.agent.params)))
    ev = tr.evaluate(num_batches=1)
    assert all(np.isfinite(v) for side in ev.values() for v in side.values())
