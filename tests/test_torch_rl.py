"""The port's RL training stack (``repro_torch.rl``, ``repro_torch.core.live``,
``repro_torch.core.trainer``) against the JAX package's on the CPU, plus the
port analogs of ``tests/test_system.py`` and ``tests/test_rl_streaming.py``.

The packages' samplers cannot be matched (threefry against a
``torch.Generator``), so the parity tests inject the reference's own draws
into the port: the reference agent's key chain starts at
``PRNGKey(seed + 1)`` and splits once per exploring ``act``, and each draw
is ``jax.random.gumbel(sub, (256,))``.  Every step first checks that
``argmax(logits + g)`` gives the reference's sampled action.  Weights are
carried across from the reference agent.

What is held, with its tolerance:

- actions, rewards (terminal and shaped, per step), scores, ``evaluate()``
  and the live driver's ``BatchResult`` and rescans: equal, bit for bit
  (host numpy on the same decisions);
- PPO losses: within rtol 1e-4 / atol 1e-6 (each update's sums run in
  another order, and the parameters drift apart by rounding over the run);
- the critic's bootstrap values: within rtol/atol 1e-5, not bit for bit (a
  1,280-wide f32 dot in another order, on parameters that differ by
  rounding after the first update; ``tests/test_torch_agent.py`` holds the
  value so).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.core.agent as J
import repro.core.env as j_env
import repro.core.live as j_live
import repro.rl as JRL
import repro.sched as JS
import repro_torch.core.agent as T
import repro_torch.core.env as t_env
import repro_torch.core.live as t_live
import repro_torch.rl as TRL
import repro_torch.sched as TS
from repro.core import generate_trace as j_generate_trace
from repro.core import make_cluster as j_make_cluster
from repro.core.features import MAX_QUEUE_SIZE
from repro_torch.core import generate_trace, make_cluster, reward_from_scores
from repro_torch.core.env import RLPrioritizer, StreamStats
from repro_torch.core.types import Job
from repro_torch.rl import (EpisodeCutter, RewardWeights, StreamingConfig,
                            StreamingTrainer, WindowStats, shaped_reward)

LOSS_RTOL, LOSS_ATOL = 1e-4, 1e-6
VALUE_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU threads contend with JAX's in one process; one thread
    keeps the port's side fast.  Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _GumbelChain:
    """The reference agent's exploration noise, draw by draw."""

    def __init__(self, seed: int):
        self.key = jax.random.PRNGKey(seed + 1)

    def __call__(self) -> np.ndarray:
        self.key, sub = jax.random.split(self.key)
        return np.array(jax.random.gumbel(sub, (MAX_QUEUE_SIZE,)))


@pytest.fixture
def inject(monkeypatch):
    """``inject(seed)`` patches both packages' ``policy_step``: the
    reference's checks that its draw reproduces the sampled action and
    records it; the port's samples with the same draw and records its
    action.  Returns ``{"ref": [...], "port": [...]}``."""
    def setup(seed: int) -> dict[str, list[int]]:
        actions = {"ref": [], "port": []}
        ref_chain, port_chain = _GumbelChain(seed), _GumbelChain(seed)
        real_ref, real_port = J.policy_step, T.policy_step

        def ref_step(params, ov, cv, mask, key):
            out = real_ref(params, ov, cv, mask, key)
            a = int(out["action"])
            g = ref_chain()
            assert int(np.argmax(np.asarray(out["logits"]) + g)) == a
            actions["ref"].append(a)
            return out

        def port_step(net, ov, cv, mask, generator=None, gumbel=None):
            g = torch.from_numpy(port_chain()).to(ov.device)
            out = real_port(net, ov, cv, mask, gumbel=g)
            actions["port"].append(int(out["action"]))
            return out

        monkeypatch.setattr(J, "policy_step", ref_step)
        monkeypatch.setattr(T, "policy_step", port_step)
        return actions
    return setup


def _tap_dense(monkeypatch, agent, seen: list) -> None:
    """Record (rewards, bootstrap value) of every dense episode handed to
    ``agent``, then run the real update."""
    real = agent.finish_episode_dense

    def tapped(rewards, *, bootstrap_value=0.0):
        seen.append((np.array(rewards, dtype=np.float32),
                     float(bootstrap_value)))
        return real(rewards, bootstrap_value=bootstrap_value)
    monkeypatch.setattr(agent, "finish_episode_dense", tapped)


def _assert_same_episodes(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        g, w = dataclasses.asdict(g), dataclasses.asdict(w)
        assert np.isclose(g.pop("loss"), w.pop("loss"), rtol=LOSS_RTOL,
                          atol=LOSS_ATOL)
        assert g == w


def _batch_tuple(res) -> tuple:
    return ((res.makespan, res.total_wait, res.gpu_seconds_used,
             res.decisions, res.milp_calls, res.backfills, res.restarts),
            sorted((j.job_id, j.start_time, j.finish_time) for j in res.jobs))


# ------------------------------------------------------------------ parity ----


@pytest.mark.parametrize("trace,batch,batches", [("helios", 32, 3),
                                                 ("philly", 48, 2)])
def test_rltune_trainer_matches_reference(inject, trace, batch, batches):
    actions = inject(0)
    cfg = dict(trace=trace, base_policy="fcfs", batch_size=batch,
               batches_per_epoch=batches, epochs=1)
    jt = JRL.RLTuneTrainer(JRL.TrainerConfig(**cfg))
    tt = TRL.RLTuneTrainer(TRL.TrainerConfig(**cfg), device="cpu")
    tt.agent.load_state_dict(jt.agent.state_dict())
    want, got = jt.train()[0], tt.train()[0]
    assert len(actions["port"]) > 0
    assert actions["port"] == actions["ref"]
    assert got.rewards == want.rewards
    assert got.abs_scores == want.abs_scores
    assert got.ars_scores == want.ars_scores
    np.testing.assert_allclose(got.losses, want.losses, rtol=LOSS_RTOL,
                               atol=LOSS_ATOL)
    assert tt.evaluate(num_batches=2) == jt.evaluate(num_batches=2)


@pytest.mark.parametrize("scenario", ["flash-crowd", "sku-skew"])
def test_episode_cutter_matches_reference(inject, monkeypatch, scenario):
    """The cutter on a shared stream: the same actions, the same shaped
    reward on every recorded step, the same episodes."""
    actions = inject(0)
    ja = J.PPOAgent(J.PPOConfig())
    ta = T.PPOAgent(T.PPOConfig(), device="cpu")
    ta.load_state_dict(ja.state_dict())
    out = {}
    for side, pkg, sched, agent, env in (("ref", JRL, JS, ja, j_env),
                                         ("port", TRL, TS, ta, t_env)):
        seen: list = []
        _tap_dense(monkeypatch, agent, seen)
        pri = env.RLPrioritizer(agent, explore=True, streaming=True)
        cutter = pkg.EpisodeCutter(agent, pri, horizon=4, warmup_windows=1,
                                   scenario=scenario)
        run = sched.get_scenario(scenario).build(64, 3)
        sched.run_stream(run.spec, [j.clone_pending() for j in run.jobs], pri,
                         rescan_interval=300.0, allocator="pack",
                         fault_model=run.fault_model, chunked_submit=True,
                         hooks=(cutter,), on_window=cutter.on_window)
        cutter.flush()
        out[side] = (seen, cutter.episodes, cutter.decisions)
    assert actions["port"] == actions["ref"] and actions["port"]
    (j_seen, j_eps, j_dec), (t_seen, t_eps, t_dec) = out["ref"], out["port"]
    assert t_dec == j_dec
    assert len(t_seen) == len(j_seen) > 1
    for (t_r, t_boot), (j_r, j_boot) in zip(t_seen, j_seen):
        np.testing.assert_array_equal(t_r, j_r)
        assert np.isclose(t_boot, j_boot, rtol=VALUE_TOL, atol=VALUE_TOL)
    _assert_same_episodes(t_eps, j_eps)


def test_train_stream_matches_reference(inject):
    actions = inject(0)
    cfg = dict(scenarios=("steady",), num_jobs=64, horizon=4,
               warmup_windows=1)
    jtr = JRL.StreamingTrainer(JRL.StreamingConfig(**cfg))
    ttr = TRL.StreamingTrainer(TRL.StreamingConfig(**cfg), device="cpu")
    ttr.agent.load_state_dict(jtr.agent.state_dict())
    want = jtr.train_stream("steady", seed=0)
    got = ttr.train_stream("steady", seed=0)
    assert actions["port"] == actions["ref"] and actions["port"]
    _assert_same_episodes(got, want)
    assert ttr.history == got


def test_run_live_matches_reference():
    ja = J.PPOAgent(J.PPOConfig(seed=0))
    ta = T.PPOAgent(T.PPOConfig(seed=0), device="cpu")
    ta.load_state_dict(ja.state_dict())
    j_jobs = j_generate_trace("helios", 96, seed=9)
    jobs = generate_trace("helios", 96, seed=9)
    sla = frozenset({jobs[10].user})
    j_res, j_rescans = j_live.run_live(
        j_make_cluster("helios"), j_jobs, ja,
        j_live.LiveConfig(rescan_interval=60.0, sla_users=sla))
    res, rescans = t_live.run_live(
        make_cluster("helios"), jobs, ta,
        t_live.LiveConfig(rescan_interval=60.0, sla_users=sla))
    assert rescans == j_rescans > 0
    assert _batch_tuple(res) == _batch_tuple(j_res)


@pytest.mark.parametrize("seed", [0, 1])
def test_shaped_reward_matches_reference(seed):
    rng = np.random.default_rng(seed)
    for w_kw in ({}, {"clip": 0.7, "wait_scale": 600.0, "utilization": 2.0}):
        for _ in range(50):
            a, b = (dict(time=float(rng.uniform(0, 1e5)),
                         wait_p99=float(rng.exponential(5000.0)),
                         utilization=float(rng.uniform()),
                         backlog=int(rng.integers(0, 400)))
                    for _ in range(2))
            want = JRL.shaped_reward(JRL.WindowStats(**a), JRL.WindowStats(**b),
                                     JRL.RewardWeights(**w_kw))
            got = shaped_reward(WindowStats(**a), WindowStats(**b),
                                RewardWeights(**w_kw))
            assert got == want


def test_rl_exports_match_reference():
    assert sorted(TRL.__all__) == sorted(JRL.__all__)
    for name in JRL.__all__:
        assert getattr(TRL, name).__module__.startswith("repro_torch.rl")


# ------------------------------------------------ analogs of test_system ----


def test_reward_sign_convention():
    assert reward_from_scores(100.0, 50.0) > 0    # RL better -> positive
    assert reward_from_scores(50.0, 100.0) < 0
    assert reward_from_scores(0.0, 0.0) == 0.0
    assert abs(reward_from_scores(1e-9, 1e9)) <= 10.0  # clipped


def test_trainer_pipelines_identical_jobs():
    """Base and RL pipelines must see identical job copies (paper Fig. 8)."""
    cfg = TRL.TrainerConfig(trace="helios", base_policy="fcfs", batch_size=32,
                            batches_per_epoch=1, epochs=1)
    tr = TRL.RLTuneTrainer(cfg, device="cpu")
    batch = tr.train_jobs[:32]
    base_res, rl_res = tr.run_batch_pair(batch, explore=False,
                                         use_estimates=False)
    assert {j.job_id for j in base_res.jobs} == {j.job_id for j in rl_res.jobs}
    # pipelines must not mutate the source jobs
    assert all(j.start_time < 0 for j in batch)


def test_training_produces_learning_signal():
    cfg = TRL.TrainerConfig(trace="philly", base_policy="fcfs", metric="wait",
                            batch_size=48, batches_per_epoch=6, epochs=1,
                            seed=0)
    tr = TRL.RLTuneTrainer(cfg, device="cpu")
    hist = tr.train()
    assert len(hist[0].rewards) == 6
    assert all(np.isfinite(r) for r in hist[0].rewards)
    assert any(r != 0 for r in hist[0].rewards)


def test_evaluation_reports_all_metrics():
    cfg = TRL.TrainerConfig(trace="helios", base_policy="sjf", batch_size=32,
                            batches_per_epoch=2, epochs=1)
    tr = TRL.RLTuneTrainer(cfg, device="cpu")
    tr.train()
    ev = tr.evaluate(num_batches=2, batch_size=32)
    for side in ("base", "rl"):
        for metric in ("wait", "jct", "bsld", "util"):
            assert np.isfinite(ev[side][metric])
    assert ev["base"]["bsld"] >= 1.0 and ev["rl"]["bsld"] >= 1.0


@pytest.mark.parametrize("variant", ["naive", "inspector"])
def test_variants_run(variant):
    cfg = TRL.TrainerConfig(trace="helios", base_policy="fcfs", batch_size=24,
                            batches_per_epoch=2, epochs=1, variant=variant)
    tr = TRL.RLTuneTrainer(cfg, device="cpu")
    hist = tr.train()
    assert len(hist[0].rewards) == 2


def test_transfer_across_policies():
    """Agent trained on FCFS evaluated under SJF (paper Table 7 mechanism)."""
    cfg = TRL.TrainerConfig(trace="helios", base_policy="fcfs", batch_size=32,
                            batches_per_epoch=3, epochs=1)
    tr = TRL.RLTuneTrainer(cfg, device="cpu")
    tr.train()
    state = tr.agent.state_dict()
    cfg2 = TRL.TrainerConfig(trace="helios", base_policy="sjf", batch_size=32,
                             batches_per_epoch=1, epochs=1)
    tr2 = TRL.RLTuneTrainer(cfg2, device="cpu")
    tr2.agent.load_state_dict(state)
    ev = tr2.evaluate(num_batches=2, batch_size=32)
    assert np.isfinite(ev["rl"]["wait"])


def test_improvement_helper():
    assert TRL.improvement(100, 50) == 50.0
    assert TRL.improvement(100, 150) == -50.0
    assert TRL.improvement(1.0, 2.0, lower_is_better=False) == 100.0


def test_live_driver_rescan_and_sla():
    """Live mode (paper Sec 3.1.2/5.6): 1-minute rescan loop + SLA bypass;
    no ranking puts an SLA job behind a non-SLA one."""
    jobs = generate_trace("helios", 48, seed=9)
    sla_user = jobs[10].user
    agent = T.PPOAgent(T.PPOConfig(seed=0), device="cpu")
    cfg = t_live.LiveConfig(rescan_interval=60.0,
                            sla_users=frozenset({sla_user}))
    orders = []
    real_rank = t_live.LivePrioritizer.rank

    def rank(self, q, cluster, now):
        order = real_rank(self, q, cluster, now)
        orders.append([q[i].user == sla_user for i in order])
        return order
    t_live.LivePrioritizer.rank = rank
    try:
        res, rescans = t_live.run_live(make_cluster("helios"), jobs, agent,
                                       cfg)
    finally:
        t_live.LivePrioritizer.rank = real_rank
    assert len(res.jobs) == 48
    assert rescans >= 1 and orders
    for flags in orders:
        assert flags == sorted(flags, reverse=True)
    sla_waits = [j.wait_time for j in res.jobs if j.user == sla_user]
    other = [j.wait_time for j in res.jobs if j.user != sla_user]
    if sla_waits and other:
        assert max(sla_waits) <= max(other) + 1e-6


# ------------------------------------------ analogs of test_rl_streaming ----


def _state(n=6, seed=0):
    from repro_torch.core.features import CV_SIZE, OV_SIZE
    rng = np.random.default_rng(seed)
    ov = np.zeros((MAX_QUEUE_SIZE, OV_SIZE), np.float32)
    cv = np.zeros((MAX_QUEUE_SIZE, CV_SIZE), np.float32)
    ov[:n] = rng.random((n, OV_SIZE))
    cv[:n] = rng.random((n, CV_SIZE))
    mask = np.zeros((MAX_QUEUE_SIZE,), np.float32)
    mask[:n] = 1
    return ov, cv, mask


def test_gae_advantages_matches_hand_computation():
    rewards = np.array([1.0, 0.0, -1.0], dtype=np.float32)
    values = np.array([0.5, 0.2, 0.1], dtype=np.float32)
    gamma, lam, boot = 0.9, 0.8, 0.3
    deltas = [1.0 + 0.9 * 0.2 - 0.5,
              0.0 + 0.9 * 0.1 - 0.2,
              -1.0 + 0.9 * 0.3 - 0.1]
    a2 = deltas[2]
    a1 = deltas[1] + gamma * lam * a2
    a0 = deltas[0] + gamma * lam * a1
    adv = T.gae_advantages(rewards, values, boot, gamma, lam)
    np.testing.assert_allclose(adv, [a0, a1, a2], rtol=1e-6)


def test_gae_terminal_vs_bootstrap_differ():
    rewards = np.zeros(4, dtype=np.float32)
    values = np.full(4, 0.5, dtype=np.float32)
    a_term = T.gae_advantages(rewards, values, 0.0, 0.99, 0.95)
    a_boot = T.gae_advantages(rewards, values, 1.0, 0.99, 0.95)
    assert a_boot[-1] > a_term[-1]


def test_shaped_reward_signs():
    w = RewardWeights()
    base = WindowStats(time=0.0, wait_p99=3600.0, utilization=0.5, backlog=10)
    better = WindowStats(time=1.0, wait_p99=1800.0, utilization=0.6, backlog=5)
    worse = WindowStats(time=1.0, wait_p99=7200.0, utilization=0.4, backlog=40)
    assert shaped_reward(base, better, w) > 0
    assert shaped_reward(base, worse, w) < 0
    assert shaped_reward(base, base, w) == 0.0


def test_shaped_reward_clips():
    w = RewardWeights(clip=2.0)
    base = WindowStats(time=0.0, wait_p99=0.0, utilization=0.0, backlog=0)
    spike = WindowStats(time=1.0, wait_p99=1e9, utilization=0.0, backlog=0)
    assert shaped_reward(base, spike, w) == -2.0


def test_stream_stats_ewma():
    s = StreamStats(alpha=0.5)
    j1 = Job(job_id=1, user=0, submit_time=0.0, runtime=100.0,
             est_runtime=100.0, num_gpus=1)
    j1.start_time, j1.finish_time = 10.0, 110.0
    s.update(j1)
    assert s.ewma_wait == pytest.approx(10.0)      # first finish seeds
    j2 = Job(job_id=2, user=0, submit_time=0.0, runtime=100.0,
             est_runtime=100.0, num_gpus=1)
    j2.start_time, j2.finish_time = 30.0, 130.0
    s.update(j2)
    assert s.ewma_wait == pytest.approx(20.0)      # halfway to 30


def _train_one_stream(scenario="flash-crowd", num_jobs=64, horizon=4,
                      warmup=0, seed=0):
    cfg = StreamingConfig(scenarios=(scenario,), num_jobs=num_jobs,
                          horizon=horizon, warmup_windows=warmup,
                          rescan_interval=300.0, seed=seed)
    tr = StreamingTrainer(cfg, device="cpu")
    eps = tr.train_stream(scenario, seed=seed)
    return tr, eps


def test_cutter_cuts_fixed_horizon_episodes():
    tr, eps = _train_one_stream(horizon=4)
    assert len(eps) >= 2
    # every mid-stream episode is exactly horizon windows; only the last may
    # be a shorter terminal remainder
    for e in eps[:-1]:
        assert e.windows == 4 and not e.terminal
    assert eps[-1].windows <= 4
    assert all(e.steps > 0 for e in eps)
    assert all(np.isfinite(e.reward_sum) and np.isfinite(e.loss) for e in eps)
    # the agent's rollout buffer must be drained after flush
    assert tr.agent.rollout_len == 0


def test_cutter_reward_step_alignment():
    """Every recorded decision receives exactly one reward entry."""
    agent = T.PPOAgent(T.PPOConfig(seed=0), device="cpu")
    pri = RLPrioritizer(agent, explore=True, streaming=True)
    cutter = EpisodeCutter(agent, pri, horizon=1000)   # never auto-cuts
    run = TS.get_scenario("steady").build(48, seed=2)
    TS.run_stream(run.spec, [j.clone_pending() for j in run.jobs], pri,
                  rescan_interval=300.0, allocator="pack", chunked_submit=True,
                  hooks=(cutter,), on_window=cutter.on_window)
    assert cutter.decisions > 0                 # per-decision hook fired
    recorded = agent.rollout_len
    assert recorded > 0
    st = cutter.flush()
    assert st is not None and st.steps == recorded
    assert st.terminal


def test_cutter_carry_survives_decisionless_tail():
    """Reward deferred from decision-less windows must not be dropped at an
    episode cut: with recorded steps it folds into the last step."""
    agent = T.PPOAgent(T.PPOConfig(seed=11), device="cpu")
    pri = RLPrioritizer(agent, explore=True, streaming=True)
    cutter = EpisodeCutter(agent, pri, horizon=100)

    class _Eng:   # minimal engine surface for _probe via telemetry.probe
        now = 0.0
        pending = []
        running = {}

        class cluster:
            total_gpus = np.array([8])
            free_gpus = np.array([8])
            retired = np.zeros(1, dtype=bool)

    eng = _Eng()
    cutter.telemetry.on_tick(0.0, eng)
    ov, cv, mask = _state(4)
    agent.act(ov, cv, mask, explore=True, record=True)
    eng.now, eng.pending = 300.0, [None] * 8     # backlog 8 -> negative r
    cutter.telemetry.on_tick(300.0, eng)
    cutter.on_window(eng, 300.0, 1)
    assert len(cutter._rewards) == 1 and cutter._rewards[0] < 0
    eng.now, eng.pending = 600.0, []             # drained -> deferred r > 0
    cutter.telemetry.on_tick(600.0, eng)
    cutter.on_window(eng, 600.0, 2)
    assert cutter._carry > 0
    carried = cutter._carry
    before_last = cutter._rewards[-1]
    st = cutter.cut(terminal=True)
    assert st is not None
    assert st.reward_sum == pytest.approx(before_last + carried)
    assert cutter._carry == 0.0


def test_cutter_warmup_skips_recording():
    """Warm-up windows run the policy but record nothing."""
    _, eps_cold = _train_one_stream(horizon=1000, warmup=0, seed=3)
    _, eps_warm = _train_one_stream(horizon=1000, warmup=6, seed=3)
    assert sum(e.steps for e in eps_warm) < sum(e.steps for e in eps_cold)


def test_streaming_trainer_scenario_distribution_deterministic():
    cfg = StreamingConfig(scenarios=("steady", "flash-crowd"), num_jobs=32,
                          streams=2, horizon=4, warmup_windows=0,
                          rescan_interval=600.0, seed=9)
    a = StreamingTrainer(cfg, device="cpu").train()
    b = StreamingTrainer(cfg, device="cpu").train()
    assert [(e.scenario, e.steps, e.windows) for e in a] == \
        [(e.scenario, e.steps, e.windows) for e in b]
    assert [e.reward_sum for e in a] == pytest.approx(
        [e.reward_sum for e in b])


def test_streaming_evaluate_reports_all_contenders():
    tr, _ = _train_one_stream(num_jobs=32, horizon=4)
    ev = tr.evaluate(("steady",), num_jobs=32, seed=7,
                     baselines=("fcfs", "sjf"))
    row = ev["steady"]
    assert set(row) == {"rl", "fcfs", "sjf"}
    for m in row.values():
        assert m["completed"] == 32
        for v in m.values():
            assert np.isfinite(v)


@pytest.mark.slow
def test_streaming_training_multi_stream_runs_and_learns_signal():
    """Multi-stream training (slow tier): rewards stay finite and at least
    one PPO update fires per stream on congested scenarios."""
    cfg = StreamingConfig(scenarios=("flash-crowd", "sku-skew"), num_jobs=128,
                          streams=4, horizon=8, warmup_windows=2,
                          rescan_interval=300.0, seed=1)
    tr = StreamingTrainer(cfg, device="cpu")
    eps = tr.train()
    assert len(eps) >= 4
    assert all(np.isfinite(e.reward_sum) for e in eps)
    assert any(e.updated for e in eps)


def test_core_trainer_is_rl_batch_reexport():
    import repro_torch.core
    import repro_torch.core.trainer as legacy
    import repro_torch.rl.batch as batch
    assert legacy.RLTuneTrainer is batch.RLTuneTrainer
    assert legacy.TrainerConfig is batch.TrainerConfig
    assert legacy.improvement is batch.improvement
    # and the lazy package attribute resolves to the same object
    assert repro_torch.core.RLTuneTrainer is batch.RLTuneTrainer
    with pytest.raises(AttributeError, match="no attribute"):
        repro_torch.core.NoSuchTrainer


def test_legacy_batch_trainer_deterministic_across_runs():
    """Same config + seeds => identical rewards and losses."""
    cfg = TRL.TrainerConfig(trace="helios", base_policy="fcfs", batch_size=24,
                            batches_per_epoch=2, epochs=1, seed=3)
    h1 = TRL.RLTuneTrainer(cfg, device="cpu").train()
    h2 = TRL.RLTuneTrainer(cfg, device="cpu").train()
    assert h1[0].rewards == h2[0].rewards
    assert h1[0].losses == h2[0].losses
