"""The port's PPO agent (serving half) against repro.core.agent.

Weights are carried across with ``repro_torch.convert`` (the two packages'
RNGs cannot be matched).  Tolerances: logits atol 1e-5 (the policy-MLP
sweep's bound); the critic value rtol/atol 1e-5 (a 1280-wide f32 dot in
another summation order); log-probabilities atol 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import agent as J
from repro.core.features import CV_SIZE, MAX_QUEUE_SIZE, OV_SIZE
from repro_torch import convert
from repro_torch.core import agent as T

ATOL = 1e-5


def _unit_params(seed: int) -> dict:
    """Unit-scale weights and biases in the reference's nested layout, so
    that logits are well separated (init_params scales the last actor
    layer by 0.01)."""
    rng = np.random.default_rng(seed)
    cfg = J.PPOConfig()
    out = {}
    for net, sizes in (("actor", [OV_SIZE, *cfg.actor_hidden, 1]),
                       ("critic", [MAX_QUEUE_SIZE * CV_SIZE,
                                   *cfg.critic_hidden, 1])):
        out[net] = [{"w": (rng.normal(size=(a, b)) / np.sqrt(a)).astype(np.float32),
                     "b": rng.normal(size=(b,)).astype(np.float32)}
                    for a, b in zip(sizes[:-1], sizes[1:])]
    return out


def _state(seed: int, n_valid: int):
    rng = np.random.default_rng(seed)
    ov = np.zeros((MAX_QUEUE_SIZE, OV_SIZE), np.float32)
    cv = np.zeros((MAX_QUEUE_SIZE, CV_SIZE), np.float32)
    ov[:n_valid] = rng.uniform(0, 1, size=(n_valid, OV_SIZE))
    cv[:n_valid] = rng.uniform(0, 1, size=(n_valid, CV_SIZE))
    mask = (np.arange(MAX_QUEUE_SIZE) < n_valid).astype(np.float32)
    return ov, cv, mask


def _pair(params: dict):
    """(reference params as jnp, port ActorCritic on the CPU)."""
    jp = jax.tree.map(jnp.asarray, params)
    net = T.init_params(T.PPOConfig(), device="cpu")
    convert.load_numpy_params(net, params)
    return jp, net


PARAM_SOURCES = {
    "reference_init": lambda: J.PPOAgent(J.PPOConfig(seed=5)).state_dict()["params"],
    "unit_scale": lambda: _unit_params(7),
}


@pytest.mark.parametrize("n_valid", [1, 37, 256])
@pytest.mark.parametrize("source", sorted(PARAM_SOURCES))
def test_actor_logits_and_value_match(source, n_valid):
    jp, net = _pair(PARAM_SOURCES[source]())
    ov, cv, mask = _state(n_valid, n_valid)
    want = np.asarray(J.actor_logits(jp, jnp.asarray(ov), jnp.asarray(mask)))
    with torch.no_grad():
        got = T.actor_logits(net, torch.tensor(ov), torch.tensor(mask)).numpy()
        v = T.value(net, torch.tensor(cv)).item()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    v_ref = float(J.value(jp, jnp.asarray(cv)))
    np.testing.assert_allclose(v, v_ref, rtol=ATOL, atol=ATOL)


@pytest.mark.parametrize("n_valid", [2, 100, 256])
def test_greedy_step_same_order(n_valid):
    """Separated logits: identical order, masked rows last in index order
    (both sorts are stable on the -1e9 ties)."""
    jp, net = _pair(_unit_params(11))
    ov, _, mask = _state(3 + n_valid, n_valid)
    want = np.asarray(J.greedy_step(jp, jnp.asarray(ov), jnp.asarray(mask)))
    got = T.greedy_step(net, torch.tensor(ov), torch.tensor(mask))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[n_valid:],
                                  np.arange(n_valid, MAX_QUEUE_SIZE))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_policy_step_with_injected_gumbel(seed):
    """Gumbel-max with the same noise picks the action JAX's argmax of
    logits + g picks; logp matches jax.nn.log_softmax."""
    jp, net = _pair(_unit_params(seed))
    ov, cv, mask = _state(seed, 90)
    g = np.random.default_rng(100 + seed).gumbel(size=MAX_QUEUE_SIZE) \
        .astype(np.float32)
    j_logits = J.actor_logits(jp, jnp.asarray(ov), jnp.asarray(mask))
    j_action = int(jnp.argmax(j_logits + jnp.asarray(g)))
    j_logp = float(jax.nn.log_softmax(j_logits)[j_action])
    with torch.no_grad():
        out = T.policy_step(net, torch.tensor(ov), torch.tensor(cv),
                            torch.tensor(mask), gumbel=torch.tensor(g))
    assert int(out["action"]) == j_action
    assert mask[j_action] > 0
    np.testing.assert_allclose(float(out["logp"]), j_logp, atol=ATOL, rtol=0)
    np.testing.assert_allclose(float(out["value"]),
                               float(J.value(jp, jnp.asarray(cv))),
                               rtol=ATOL, atol=ATOL)


def test_policy_step_samples_inside_mask():
    net = T.init_params(T.PPOConfig(), device="cpu")
    ov, cv, mask = _state(4, 12)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for _ in range(50):
            out = T.policy_step(net, torch.tensor(ov), torch.tensor(cv),
                                torch.tensor(mask), generator=gen)
            a = int(out["action"])
            assert mask[a] > 0
            lp = torch.log_softmax(out["logits"], -1)[a]
            assert float(out["logp"]) == pytest.approx(float(lp), abs=ATOL)


def test_agent_act_matches_reference_agent():
    """Greedy act of an agent loaded from the reference agent's
    state_dict returns the reference's action and synthesized logits."""
    ja = J.PPOAgent(J.PPOConfig(seed=2))
    ja.load_state_dict({"params": _unit_params(2)})
    ta = T.PPOAgent(device="cpu")
    ta.load_state_dict(ja.state_dict())
    for n_valid in (1, 50, 256):
        ov, cv, mask = _state(n_valid, n_valid)
        a_j, l_j = ja.act(ov, cv, mask, explore=False)
        a_t, l_t = ta.act(ov, cv, mask, explore=False)
        assert a_t == a_j
        np.testing.assert_array_equal(l_t, np.asarray(l_j))
    assert ta.rollout_len == 0


def test_agent_explore_records_rollout():
    ta = T.PPOAgent(device="cpu")
    ov, cv, mask = _state(6, 20)
    for i in range(3):
        a, logits = ta.act(ov, cv, mask, explore=True, record=i < 2)
        assert mask[a] > 0 and logits.shape == (MAX_QUEUE_SIZE,)
    assert ta.rollout_len == 2
    assert all(np.isfinite(ta.rollout_values))
    ta.reset_buffer()
    assert ta.rollout_len == 0


def test_state_dict_round_trip_and_shape_check():
    ja = J.PPOAgent()
    ta = T.PPOAgent(device="cpu")
    ta.load_state_dict(ja.state_dict())
    sd = ta.state_dict()["params"]
    for net in ("actor", "critic"):
        for mine, ref in zip(sd[net], ja.state_dict()["params"][net]):
            for k in ("w", "b"):
                np.testing.assert_array_equal(mine[k], np.asarray(ref[k]))
    bad = ja.state_dict()
    bad["params"]["actor"][0]["w"] = np.zeros((9, 64), np.float32)
    with pytest.raises(ValueError, match="shape"):
        ta.load_state_dict(bad)
    assert sd["actor"][1]["w"].shape == (64, 32)
    assert sd["critic"][0]["w"].dtype == np.float32


def test_init_params_seeded_and_scaled():
    cfg = T.PPOConfig(seed=4)
    a, b = T.init_params(cfg, device="cpu"), T.init_params(cfg, device="cpu")
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)
    other = T.init_params(T.PPOConfig(seed=5), device="cpu")
    assert not torch.equal(a.actor.layers[0].w, other.actor.layers[0].w)
    shapes = {k: [tuple(l["w"].shape) for l in v] for k, v in a.params.items()}
    assert shapes == {"actor": [(8, 64), (64, 32), (32, 1)],
                      "critic": [(1280, 128), (128, 64), (64, 1)]}
    # the last actor layer is scaled by 0.01, as in the reference
    assert a.actor.layers[2].w.abs().max() < 0.05
    assert all(float(l["b"].detach().abs().max()) == 0.0
               for l in a.params["actor"])


def test_agent_defaults_to_cuda_and_raises_without_it(monkeypatch):
    """The agent, ``init_params`` and both trainers run on the card unless
    given ``device="cpu"``, and raise without CUDA."""
    from repro_torch.rl import (RLTuneTrainer, StreamingConfig,
                                StreamingTrainer, TrainerConfig)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    small = TrainerConfig(batch_size=8, batches_per_epoch=1)
    for make in (T.PPOAgent, lambda **kw: T.init_params(T.PPOConfig(), **kw),
                 lambda **kw: RLTuneTrainer(small, **kw),
                 lambda **kw: StreamingTrainer(StreamingConfig(), **kw)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make(device="cuda")
    assert T.PPOAgent(device="cpu").device == torch.device("cpu")
    assert T.init_params(T.PPOConfig(), device="cpu").actor.layers[0].w \
        .device == torch.device("cpu")
    assert RLTuneTrainer(small, device="cpu").agent.device.type == "cpu"
    assert StreamingTrainer(device="cpu").agent.device.type == "cpu"
