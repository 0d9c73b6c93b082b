"""The port's PPO training half (``repro_torch.core.agent``: Adam, the PPO
loss and update step, GAE, ``finish_episode*``) against
``repro.core.agent`` on the CPU, plus the port analogs of
``tests/test_agent.py``.

Inputs come from numpy seeds; weights are carried across with
``repro_torch.convert`` (the packages' RNGs cannot be matched).
Tolerances, each with its reason:

- ``adam_update`` on identical gradients: with the clip off, the moments and
  the step count are equal bit for bit, and every parameter lies within two
  ulps of the larger of its old and new values (the reference's CPU
  ``sqrt`` in f32 is not correctly rounded, torch's is, so the step's last
  bit can differ; where the step cancels most of the parameter, that bit is
  a few ulps of the result).  With the clip on, the global norm is a sum of
  174,817 squares in another order, so the moments are held to rtol 1e-6
  and the parameters as with the clip off.
- ``_ppo_loss``: within 1e-6 of the reference (a sum over 512 steps and
  f32 products in another order).  Gradients: each leaf within 2e-5 of its
  largest reference entry, but the last actor bias, whose gradient is zero
  in exact arithmetic (the loss does not change when every logit moves by
  the same amount): there both packages give rounding noise below 1e-5 of
  the last actor weight's largest gradient.
- ``ppo_update_step``: Adam's first step moves a parameter by about
  ``lr * sign(g)``, so an entry whose gradient is rounding noise can move
  the other way.  All entries but a fraction of 1e-4 lie within 1e-6; the
  rest within ``2 * lr`` (one epoch).
- ``gae_advantages`` and what ``finish_episode*`` hand to the update: bit
  for bit (the same numpy code).
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import agent as J
from repro.core.features import CV_SIZE, MAX_QUEUE_SIZE, OV_SIZE
from repro_torch import convert
from repro_torch.core import agent as T
from test_torch_train_gpu import _batch, _traj

PPO = dict(clip_eps=0.2, value_coef=0.5, entropy_coef=0.01)
LOSS_TOL = 1e-6
GRAD_RTOL = 2e-5
STEP_ATOL = 1e-6
STEP_FRACTION = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU threads contend with JAX's in one process; one thread
    keeps the port's side fast.  Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(tree) -> list[tuple[str, np.ndarray]]:
    """(name, numpy copy) of each leaf, in a fixed order."""
    return [(f"{net}[{i}].{k}", np.array(
        t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t))
            for net in ("actor", "critic")
            for i, lyr in enumerate(tree[net]) for k in ("w", "b")
            for t in (lyr[k],)]


def _random_tree(params, rng, scale, positive=False):
    out = jax.tree.map(lambda a: (rng.normal(size=np.shape(a)) * scale)
                       .astype(np.float32), params)
    return jax.tree.map(np.abs, out) if positive else out


def _ref_params(seed: int) -> dict:
    return J.PPOAgent(J.PPOConfig(seed=seed)).state_dict()["params"]


def _net(params: dict) -> T.ActorCritic:
    net = T.init_params(T.PPOConfig(), device="cpu")
    convert.load_numpy_params(net, params)
    return net


def _torch_tree(tree):
    return jax.tree.map(lambda a: torch.tensor(np.asarray(a)), tree)


def _jax_batch(b):
    return {k: jnp.asarray(v.astype(np.int32) if k == "action" else v)
            for k, v in b.items()}


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


# -------------------------------------------------------------------- Adam ----


@pytest.mark.parametrize("t0", [0, 4])
@pytest.mark.parametrize("clip", [False, True])
def test_adam_update_matches_reference(clip, t0):
    """t = 1 (from a fresh state) and t = 5; gradients of norm ~0.4 (clip
    off) or ~400 (clip on, max_norm 0.5)."""
    params = _ref_params(1)
    rng = np.random.default_rng(10 * t0 + clip)
    scale = 1.0 if clip else 1e-3
    grads = _random_tree(params, rng, scale)
    m = _random_tree(params, rng, 0.1 * scale)
    v = _random_tree(params, rng, scale * scale, positive=True)
    if t0 == 0:
        m, v = (jax.tree.map(np.zeros_like, x) for x in (m, v))
    j_params, j_state = J.adam_update(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, grads),
        {"m": jax.tree.map(jnp.asarray, m), "v": jax.tree.map(jnp.asarray, v),
         "t": jnp.asarray(np.float32(t0))}, 3e-4)
    t_params, t_state = T.adam_update(
        _torch_tree(params), _torch_tree(grads),
        {"m": _torch_tree(m), "v": _torch_tree(v),
         "t": torch.tensor(np.float32(t0))}, 3e-4)
    assert t_state["t"].dtype == torch.float32
    assert float(t_state["t"]) == float(j_state["t"]) == t0 + 1
    for key in ("m", "v"):
        for (name, want), (_, got) in zip(_leaves(j_state[key]),
                                          _leaves(t_state[key])):
            if clip:
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=0,
                                           err_msg=f"{key} {name}")
            else:
                np.testing.assert_array_equal(got, want, f"{key} {name}")
    for (name, old), (_, want), (_, got) in zip(
            _leaves(params), _leaves(j_params), _leaves(t_params)):
        ulp = np.spacing(np.maximum.reduce([np.abs(old), np.abs(want),
                                            np.abs(got)]))
        assert (np.abs(got - want) <= 2 * ulp).all(), name


def test_adam_bias_correction_rounds_in_f32():
    """``1 - 0.999 ** t`` at t = 1 is 0.00099998713 in f32 (not 0.001)."""
    t = torch.ones((), dtype=torch.float32)
    assert (1 - 0.999 ** t).dtype == torch.float32
    assert float(1 - 0.999 ** t) == float(np.float32(1) - np.float32(0.999))
    state = T.adam_init(_torch_tree(_ref_params(0)))
    assert state["t"].dtype == torch.float32 and state["t"].shape == ()
    assert all(not x.any()
               for _, x in _leaves(state["m"]) + _leaves(state["v"]))


# -------------------------------------------------------------- PPO loss ----


@pytest.mark.parametrize("seed,Tc", [(0, 300), (1, 512), (2, 17)])
def test_ppo_loss_and_grads_match_reference(seed, Tc):
    params = _ref_params(seed + 3)
    b = _batch(seed, Tc)
    j_loss, j_grads = jax.value_and_grad(J._ppo_loss)(
        jax.tree.map(jnp.asarray, params), _jax_batch(b), *PPO.values())
    loss, grads = T._loss_and_grads(_net(params), _torch_batch(b), **PPO)
    assert abs(float(loss) - float(j_loss)) <= LOSS_TOL * max(1.0,
                                                              abs(float(j_loss)))
    ref = dict(_leaves(j_grads))
    got = dict(_leaves(grads))
    for name, want in ref.items():
        if name == "actor[2].b":
            scale = np.abs(ref["actor[2].w"]).max()
            assert np.abs(want).max() <= 1e-5 * scale
            assert np.abs(got[name]).max() <= 1e-5 * scale
            continue
        err = np.abs(got[name] - want).max()
        assert err <= GRAD_RTOL * np.abs(want).max(), (name, err)


def test_padded_steps_give_zero_gradient():
    """Padded steps (valid 0, all-zero mask, every logit -1e9, old logp 0)
    add nothing: an all-padded batch has loss 0 and gradients exactly 0,
    even with non-zero features in the padded rows, and nothing is NaN."""
    b = _batch(5, 0, P=8)
    rng = np.random.default_rng(5)
    b["ov"][3:] = rng.uniform(size=b["ov"][3:].shape)
    b["cv"][3:] = rng.uniform(size=b["cv"][3:].shape)
    b["ret"][:] = 1.0
    net = _net(_ref_params(4))
    loss, grads = T._loss_and_grads(net, _torch_batch(b), **PPO)
    assert float(loss) == 0.0
    for name, g in _leaves(grads):
        assert np.isfinite(g).all() and not g.any(), name
    # beside real steps, what the padded steps hold changes neither the
    # loss nor the gradients, bit for bit (same shapes, so same sum order)
    real = _batch(6, 3, P=8)
    junk = {k: v.copy() for k, v in real.items()}
    junk["ov"][3:] = b["ov"][3:]
    junk["cv"][3:] = b["cv"][3:]
    junk["ret"][3:] = 1.0
    l1, g1 = T._loss_and_grads(net, _torch_batch(real), **PPO)
    l2, g2 = T._loss_and_grads(net, _torch_batch(junk), **PPO)
    assert float(l1) == float(l2) != 0.0
    for (name, x), (_, y) in zip(_leaves(g1), _leaves(g2)):
        assert np.isfinite(x).all()
        np.testing.assert_array_equal(x, y, name)


def test_loss_runs_modules_under_autograd_not_the_kernel(monkeypatch):
    """The loss must not reach ``ops.policy_mlp`` (no backward) and must
    carry an autograd graph; a loss without one raises."""
    from repro_torch.kernels import ops

    def forbidden(*a, **kw):
        raise AssertionError("PPO loss called ops.policy_mlp")

    monkeypatch.setattr(ops, "policy_mlp", forbidden)
    net = _net(_ref_params(0))
    b = _torch_batch(_batch(7, 5, P=8))
    loss = T._ppo_loss(net, b, **PPO)
    assert loss.requires_grad
    with torch.no_grad(), pytest.raises(RuntimeError, match="autograd"):
        T._loss_and_grads(net, b, **PPO)


def test_ppo_update_step_matches_reference():
    params = _ref_params(8)
    b = _batch(8, 300)
    lr = 3e-4
    j_params, j_state, j_loss = J.ppo_update_step(
        jax.tree.map(jnp.asarray, params),
        J.adam_init(jax.tree.map(jnp.asarray, params)), _jax_batch(b),
        lr=lr, max_norm=0.5, **PPO)
    net = _net(params)
    t_params, t_state, t_loss = T.ppo_update_step(
        net, T.adam_init(net.params), _torch_batch(b), lr=lr, max_norm=0.5,
        **PPO)
    assert isinstance(t_loss, torch.Tensor) and not t_loss.requires_grad
    assert abs(float(t_loss) - float(j_loss)) <= LOSS_TOL * max(
        1.0, abs(float(j_loss)))
    assert float(t_state["t"]) == 1.0
    total = loose = 0
    for (name, want), (_, got) in zip(_leaves(j_params), _leaves(t_params)):
        err = np.abs(got - want)
        assert (err <= 2 * lr).all(), name
        total += err.size
        loose += int((err > STEP_ATOL).sum())
    assert loose <= STEP_FRACTION * total, (loose, total)
    # the net itself now holds the new parameters
    for (_, a), (_, c) in zip(_leaves(t_params), _leaves(net.params)):
        np.testing.assert_array_equal(a, c)


# --------------------------------------------------------------------- GAE ----


@pytest.mark.parametrize("T_len,boot", [(1, 0.0), (37, 0.3), (300, -1.7)])
def test_gae_advantages_bit_for_bit(T_len, boot):
    rng = np.random.default_rng(T_len)
    rewards = rng.normal(size=T_len).astype(np.float32)
    values = rng.normal(size=T_len).astype(np.float32)
    for gamma, lam in ((0.99, 0.95), (0.9, 0.8)):
        want = J.gae_advantages(rewards, values, boot, gamma, lam)
        got = T.gae_advantages(rewards, values, boot, gamma, lam)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------ what finish_episode* feed ----


def _capturing_pair(monkeypatch, **cfg):
    """A reference and a port agent whose ``_run_update`` records what it
    is handed and skips the update."""
    ja = J.PPOAgent(J.PPOConfig(**cfg))
    ta = T.PPOAgent(T.PPOConfig(**cfg), device="cpu")
    seen = {"ref": [], "port": []}
    for side, agent in (("ref", ja), ("port", ta)):
        def capture(cat, rets, adv, Tc, _side=side):
            seen[_side].append((copy.deepcopy(cat), rets.copy(), adv.copy(),
                                Tc))
            return 0.0
        monkeypatch.setattr(agent, "_run_update", capture)
    return ja, ta, seen


def _assert_same_updates(seen):
    assert len(seen["ref"]) == len(seen["port"]) > 0
    for (jc, jr, jad, jt), (tc, tr, tad, tt) in zip(seen["ref"], seen["port"]):
        assert jt == tt
        assert jr.dtype == tr.dtype and jad.dtype == tad.dtype
        np.testing.assert_array_equal(tr, jr)
        np.testing.assert_array_equal(tad, jad)
        for k in T._TRAJ_KEYS:
            np.testing.assert_array_equal(np.asarray(tc[k]), np.asarray(jc[k]))


def test_finish_episode_feeds_the_same_advantages(monkeypatch):
    """Terminal pathway with three episodes pooled; together they pass
    max_steps (512), so the update sees the first 512 steps."""
    ja, ta, seen = _capturing_pair(monkeypatch, episodes_per_update=3)
    updated = []
    for i, (n, reward) in enumerate(((200, 0.25), (250, -1.5), (150, 7.0),
                                     (40, 0.0), (3, 1.0), (9, -0.1))):
        traj = _traj(i, n)
        for agent in (ja, ta):
            agent._traj = copy.deepcopy(traj)
        j = ja.finish_episode(reward)
        t = ta.finish_episode(reward)
        assert t == j
        updated.append(t["updated"])
    assert updated == [0.0, 0.0, 1.0, 0.0, 0.0, 1.0]
    assert [u[3] for u in seen["port"]] == [512, 52]
    _assert_same_updates(seen)


def test_finish_episode_dense_feeds_the_same_advantages(monkeypatch):
    """GAE pathway (normalised, clipped advantages) with two episodes
    pooled, truncated and bootstrapped."""
    ja, ta, seen = _capturing_pair(monkeypatch, episodes_per_update=2)
    rng = np.random.default_rng(3)
    for i, (n, boot) in enumerate(((7, 0.4), (300, 0.0), (400, -0.8),
                                   (200, 1.1), (1, 0.0), (1, 2.0))):
        traj = _traj(10 + i, n)
        rewards = rng.normal(size=n).astype(np.float32) * 3
        for agent in (ja, ta):
            agent._traj = copy.deepcopy(traj)
        j = ja.finish_episode_dense(rewards, bootstrap_value=boot)
        t = ta.finish_episode_dense(rewards, bootstrap_value=boot)
        assert t == j
    assert [u[3] for u in seen["port"]] == [307, 512, 2]
    _assert_same_updates(seen)


@pytest.mark.parametrize("dense", [False, True])
def test_finish_episode_update_matches_reference(dense):
    """The whole update (pad, upload once, ``update_epochs`` steps) on one
    trajectory: the last epoch's loss within LOSS_TOL, the parameters all
    but STEP_FRACTION within STEP_ATOL and the rest within
    ``2 * lr * epochs``."""
    cfg = dict(seed=4)
    ja = J.PPOAgent(J.PPOConfig(**cfg))
    ta = T.PPOAgent(T.PPOConfig(**cfg), device="cpu")
    ta.load_state_dict(ja.state_dict())
    traj = _traj(21, 120)
    rewards = np.random.default_rng(2).normal(size=120).astype(np.float32)
    out = []
    for agent in (ja, ta):
        agent._traj = copy.deepcopy(traj)
        out.append(agent.finish_episode_dense(rewards, bootstrap_value=0.3)
                   if dense else agent.finish_episode(0.7))
    want, got = out
    assert got["updated"] == want["updated"] == 1.0
    assert abs(got["loss"] - want["loss"]) <= LOSS_TOL * max(
        1.0, abs(want["loss"]))
    epochs = ta.cfg.update_epochs
    assert float(ta.opt_state["t"]) == float(ja.opt_state["t"]) == epochs
    total = loose = 0
    for (name, w), (_, g) in zip(_leaves(ja.params), _leaves(ta.params)):
        err = np.abs(g - w)
        assert (err <= 2 * ta.cfg.lr * epochs).all(), name
        total += err.size
        loose += int((err > STEP_ATOL).sum())
    assert loose <= STEP_FRACTION * total, (loose, total)


# ---------------------------------------------- port analogs of test_agent ----


def _state(n=16, seed=0):
    rng = np.random.default_rng(seed)
    ov = np.zeros((MAX_QUEUE_SIZE, OV_SIZE), np.float32)
    cv = np.zeros((MAX_QUEUE_SIZE, CV_SIZE), np.float32)
    ov[:n] = rng.random((n, OV_SIZE))
    cv[:n] = rng.random((n, CV_SIZE))
    mask = np.zeros((MAX_QUEUE_SIZE,), np.float32)
    mask[:n] = 1
    return ov, cv, mask


def _logits(agent, ov, mask):
    with torch.no_grad():
        return T.actor_logits(agent.net, torch.from_numpy(ov),
                              torch.from_numpy(mask)).numpy()


def _params_np(agent):
    return [a for _, a in _leaves(agent.params)]


def test_masked_actions_never_selected():
    agent = T.PPOAgent(T.PPOConfig(seed=0), device="cpu")
    ov, cv, mask = _state(5)
    for _ in range(20):
        a, logits = agent.act(ov, cv, mask, explore=True, record=False)
        assert a < 5
    assert (logits[5:] < -1e8).all()


def test_greedy_is_argsort():
    net = T.init_params(T.PPOConfig(), device="cpu")
    ov, _, mask = _state(8)
    order = T.greedy_step(net, torch.from_numpy(ov), torch.from_numpy(mask))
    with torch.no_grad():
        lg = T.actor_logits(net, torch.from_numpy(ov),
                            torch.from_numpy(mask)).numpy()
    assert order[0] == int(np.argmax(lg))


def test_logp_matches_softmax():
    net = T.init_params(T.PPOConfig(), device="cpu")
    ov, cv, mask = _state(6)
    args = [torch.from_numpy(x) for x in (ov, cv, mask)]
    with torch.no_grad():
        out = T.policy_step(net, *args,
                            generator=torch.Generator().manual_seed(0))
        want = torch.log_softmax(T.actor_logits(net, args[0], args[2]),
                                 -1)[out["action"]]
    assert abs(float(out["logp"] - want)) < 1e-5


def test_ppo_update_changes_params():
    agent = T.PPOAgent(T.PPOConfig(seed=1), device="cpu")
    before = _params_np(agent)
    ov, cv, mask = _state(10)
    for _ in range(8):
        agent.act(ov, cv, mask, explore=True, record=True)
    stats = agent.finish_episode(reward=1.0)
    assert stats["steps"] == 8 and stats["updated"] == 1.0
    assert np.isfinite(stats["loss"])
    assert max(float(np.abs(a - b).max())
               for a, b in zip(before, _params_np(agent))) > 0
    assert float(agent.opt_state["t"]) == agent.cfg.update_epochs


def test_positive_reward_reinforces_actions():
    """Positive-reward episodes on action 2 must raise its probability.
    (Episodes where other actions were sampled are dropped, isolating the
    reinforcement property from Adam's sign-noise under per-episode
    updates.)"""
    agent = T.PPOAgent(T.PPOConfig(seed=2, lr=3e-3, entropy_coef=0.0),
                       device="cpu")
    ov, cv, mask = _state(4, seed=3)
    p0 = float(torch.softmax(torch.from_numpy(_logits(agent, ov, mask)),
                             -1)[2])
    updates = 0
    while updates < 12:
        agent.reset_buffer()
        a, _ = agent.act(ov, cv, mask, explore=True, record=True)
        if a == 2:
            agent.finish_episode(reward=1.0)
            updates += 1
        else:
            agent.reset_buffer()
    probs = torch.softmax(torch.from_numpy(_logits(agent, ov, mask)),
                          -1).numpy()[:4]
    assert probs[2] > p0, (p0, probs)
    assert probs[2] == probs.max()


def test_state_dict_roundtrip_resets_optimizer():
    a = T.PPOAgent(T.PPOConfig(seed=0), device="cpu")
    b = T.PPOAgent(T.PPOConfig(seed=9), device="cpu")
    ov, cv, mask = _state(5)
    b.act(ov, cv, mask, explore=True, record=True)
    b.finish_episode(reward=1.0)
    assert float(b.opt_state["t"]) > 0
    b.load_state_dict(a.state_dict())
    np.testing.assert_allclose(_logits(a, ov, mask), _logits(b, ov, mask))
    assert float(b.opt_state["t"]) == 0.0
    assert all(not x.any() for _, x in _leaves(b.opt_state["m"]))


def test_episodes_per_update_pooling():
    """With episodes_per_update=3, updates trigger only every 3rd episode."""
    agent = T.PPOAgent(T.PPOConfig(seed=5, episodes_per_update=3),
                       device="cpu")
    ov, cv, mask = _state(6)
    updated = []
    for _ in range(7):
        agent.reset_buffer()
        for _ in range(3):
            agent.act(ov, cv, mask, explore=True, record=True)
        st = agent.finish_episode(reward=0.5)
        updated.append(st["updated"])
    assert updated == [0.0, 0.0, 1.0, 0.0, 0.0, 1.0, 0.0]


def test_finish_episode_dense_updates_params():
    agent = T.PPOAgent(T.PPOConfig(seed=3), device="cpu")
    ov, cv, mask = _state(8)
    for _ in range(6):
        agent.act(ov, cv, mask, explore=True, record=True)
    assert agent.rollout_len == 6
    before = _params_np(agent)
    st = agent.finish_episode_dense(np.linspace(-1, 1, 6),
                                    bootstrap_value=0.2)
    assert st["updated"] == 1.0 and st["steps"] == 6
    assert agent.rollout_len == 0
    assert max(float(np.abs(a - b).max())
               for a, b in zip(before, _params_np(agent))) > 0


def test_finish_episode_dense_rejects_misaligned_rewards():
    for agent in (T.PPOAgent(T.PPOConfig(seed=4), device="cpu"),
                  J.PPOAgent(J.PPOConfig(seed=4))):
        ov, cv, mask = _state(5)
        agent.act(ov, cv, mask, explore=True, record=True)
        with pytest.raises(ValueError, match="got 3 rewards for 1 recorded"):
            agent.finish_episode_dense(np.zeros(3))


def test_dense_pooling_respects_episodes_per_update():
    agent = T.PPOAgent(T.PPOConfig(seed=5, episodes_per_update=2),
                       device="cpu")
    ov, cv, mask = _state(4)
    updated = []
    for _ in range(4):
        agent.act(ov, cv, mask, explore=True, record=True)
        st = agent.finish_episode_dense(np.ones(1))
        updated.append(st["updated"])
    assert updated == [0.0, 1.0, 0.0, 1.0]


def test_terminal_and_dense_buffers_are_independent():
    """A dense episode must not leak into the terminal pathway, and
    ``reset_buffer`` keeps both pools."""
    agent = T.PPOAgent(T.PPOConfig(seed=6, episodes_per_update=2),
                       device="cpu")
    ov, cv, mask = _state(4)
    agent.act(ov, cv, mask, explore=True, record=True)
    agent.finish_episode_dense(np.ones(1))        # pools in _dense
    agent.reset_buffer()
    agent.act(ov, cv, mask, explore=True, record=True)
    st = agent.finish_episode(reward=1.0)          # pools in _episodes
    assert st["updated"] == 0.0                    # only 1 of 2 terminal eps
    assert len(agent._dense) == 1 and len(agent._episodes) == 1
    agent.reset_buffer()
    assert len(agent._dense) == 1 and len(agent._episodes) == 1
