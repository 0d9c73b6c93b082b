"""PPO Actor-Critic agent in torch (Sec. 3.2, Fig. 9).

The actor is a 3-layer MLP applied per job with shared weights (the paper's
"sliding-window" evaluation) over the 8-feature Observation Vector; a softmax
over the queue yields normalized priorities.  The critic is a 3-layer MLP over
the flattened 5-feature Critic Vector (all jobs at once) estimating the batch
return.  MAX_QUEUE_SIZE = 256 with zero-padding keeps state/action spaces
fixed.  Training uses PPO-clip over one of two reward pathways:

- **terminal** (paper-faithful, ``finish_episode``): the sparse batch reward
  is the normalized base-vs-RL performance gap, assigned to every step
  (gamma = 1);
- **dense** (``finish_episode_dense``, used by ``repro_torch.rl``): per-step
  shaped rewards from rolling-telemetry deltas with GAE(gamma, lambda)
  advantages, the streaming-episode pathway.

Weights keep the reference's ``(fan_in, fan_out)`` layout (``x @ w + b``),
so parameters carry across from ``repro.core.agent`` without transposes
(``repro_torch.convert``).  ``actor_logits`` goes through
``kernels.ops.policy_mlp``: the hand-written CUDA kernel for tensors on the
GPU, its plain torch version for tensors on the CPU.  The critic stays
``torch.matmul``.  f32 matmuls run in full f32: on a CUDA device the agent
turns TF32 off (``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32``), which the 1280-wide critic needs to
stay within 1e-5 of the reference.

Rollouts (``act``) go through the kernel; the PPO update does not.  The
reference trains through its plain MLP, not its Pallas kernel, and no kernel
has a backward: ``_ppo_loss`` runs the actor and critic modules under
autograd over the padded batch at once (the reference's ``vmap`` written
out as a batch axis).  ``adam_update`` is the reference's Adam with its
global-norm clip, operation for operation, with the step count kept as an
f32 tensor so the bias corrections round as they do there.  The update runs
on the agent's device; ``_run_update`` uploads a padded batch once and
synchronises once, for the loss.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from repro_torch.convert import load_numpy_params, params_to_numpy
from repro_torch.core import spans
from repro_torch.core.features import CV_SIZE, MAX_QUEUE_SIZE, OV_SIZE
from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    actor_hidden: tuple[int, int] = (64, 32)
    critic_hidden: tuple[int, int] = (128, 64)
    lr: float = 3e-4
    clip_eps: float = 0.2
    value_coef: float = 0.5
    entropy_coef: float = 0.01
    update_epochs: int = 4
    max_grad_norm: float = 0.5
    max_steps: int = 512          # trajectory padding length
    episodes_per_update: int = 1  # >1: batch episodes before PPO (beyond-paper
    #                               variance reduction; 1 = paper-faithful)
    gamma: float = 0.99           # dense-reward discount (GAE pathway only;
    gae_lambda: float = 0.95      #  the terminal pathway stays gamma = 1)
    seed: int = 0


# ------------------------------------------------------------------ networks ----


class Dense(nn.Module):
    """``x @ w + b`` with ``w`` stored (fan_in, fan_out), as in the reference."""

    def __init__(self, fan_in: int, fan_out: int):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(fan_in, fan_out))
        self.b = nn.Parameter(torch.zeros(fan_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.w + self.b


class MLP(nn.Module):
    """Dense layers with tanh between them (none after the last)."""

    def __init__(self, sizes: list[int]):
        super().__init__()
        self.layers = nn.ModuleList(Dense(i, o)
                                    for i, o in zip(sizes[:-1], sizes[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, lyr in enumerate(self.layers):
            x = lyr(x)
            if i < len(self.layers) - 1:
                x = torch.tanh(x)
        return x

    def param_list(self) -> list[dict[str, torch.Tensor]]:
        """The reference's ``[{"w", "b"}, ...]`` view of the parameters."""
        return [{"w": lyr.w, "b": lyr.b} for lyr in self.layers]


class ActorCritic(nn.Module):
    def __init__(self, cfg: PPOConfig):
        super().__init__()
        h1, h2 = cfg.actor_hidden
        c1, c2 = cfg.critic_hidden
        self.actor = MLP([OV_SIZE, h1, h2, 1])
        self.critic = MLP([MAX_QUEUE_SIZE * CV_SIZE, c1, c2, 1])

    @property
    def params(self) -> dict[str, list[dict[str, torch.Tensor]]]:
        """``{"actor": [...], "critic": [...]}``, the reference's Params
        layout (tensors share storage with the module)."""
        return {"actor": self.actor.param_list(),
                "critic": self.critic.param_list()}


def _mlp_init(mlp: MLP, gen: torch.Generator, scale: float) -> None:
    n = len(mlp.layers)
    for i, lyr in enumerate(mlp.layers):
        fan_in, fan_out = lyr.w.shape
        s = scale if i == n - 1 else 1.0
        w = torch.randn(fan_in, fan_out, generator=gen) * s * (2.0 / fan_in) ** 0.5
        with torch.no_grad():
            lyr.w.copy_(w)
            lyr.b.zero_()


def init_params(cfg: PPOConfig, generator: torch.Generator | None = None,
                device: torch.device | str | None = None) -> ActorCritic:
    """He-normal weights, zero biases; the last actor layer scaled by 0.01
    and the last critic layer by 0.1, as in the reference.  Draws come from
    ``generator`` (a CPU generator seeded with ``cfg.seed`` by default), so
    the same seed gives the same weights on every device; they are not the
    reference's ``jax.random`` draws.  ``device`` ``None`` means ``"cuda"``,
    which raises without CUDA."""
    dev = _resolve_device(device, "init_params")
    gen = generator if generator is not None else \
        torch.Generator().manual_seed(cfg.seed)
    net = ActorCritic(cfg)
    _mlp_init(net.actor, gen, 0.01)
    _mlp_init(net.critic, gen, 0.1)
    return net.to(dev)


def actor_logits(net: ActorCritic, ov: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """(Q, 8), (Q,) -> masked logits (Q,).  Shared MLP per job (sliding
    window), through the fused policy-MLP op."""
    return ops.policy_mlp(ov, net.actor.param_list(), mask)


def value(net: ActorCritic, cv: torch.Tensor) -> torch.Tensor:
    """(Q, 5) -> scalar value estimate."""
    return net.critic(cv.reshape(-1))[0]


def policy_step(net: ActorCritic, ov: torch.Tensor, cv: torch.Tensor,
                mask: torch.Tensor, generator: torch.Generator | None = None,
                gumbel: torch.Tensor | None = None) -> dict[str, torch.Tensor]:
    """One decision: sample an action (job index), return logp/value/logits.

    Sampling is Gumbel-max, as ``jax.random.categorical``: the action is
    ``argmax(logits + g)``.  ``g`` is drawn from ``generator`` unless the
    caller injects it as ``gumbel`` (a (Q,) tensor), which is how tests
    compare against the reference's draws."""
    logits = actor_logits(net, ov, mask)
    if gumbel is None:
        u = torch.rand(logits.shape, generator=generator, device=logits.device)
        u = u.clamp_(min=torch.finfo(torch.float32).tiny)
        gumbel = -torch.log(-torch.log(u))
    action = torch.argmax(logits + gumbel)
    logp = torch.log_softmax(logits, dim=-1)[action]
    return {"action": action, "logp": logp, "value": value(net, cv),
            "logits": logits}


def greedy_step(net: ActorCritic, ov: torch.Tensor,
                mask: torch.Tensor) -> np.ndarray:
    """Deterministic ranking (descending priority) for evaluation.

    Sorted on the host with a stable sort, as ``jnp.argsort``: exact ties
    (masked rows at -1e9) keep their index order."""
    logits = actor_logits(net, ov, mask).detach()
    sp = spans.ACTIVE
    if sp is not None and logits.device.type != "cpu":
        spans.count_copy(sp, "d2h", logits.numel() * 4)
    return np.argsort(-logits.cpu().numpy(), kind="stable")


# ---------------------------------------------------------------------- Adam -----


def _leaves(tree) -> list[torch.Tensor]:
    """The tensors of a nested dict/list tree in ``jax.tree.leaves`` order
    (dict keys sorted), so sums over leaves run in the reference's order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for sub in tree for t in _leaves(sub)]
    return [tree]


def _tree_map(fn, tree, *rest):
    """``jax.tree.map`` over nested dicts and lists of tensors."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def adam_init(params) -> dict:
    """Zero moments laid out like ``params`` on its device; the step count
    ``t`` is an f32 scalar tensor, as the reference's ``jnp.zeros(())``."""
    dev = _leaves(params)[0].device
    return {"m": _tree_map(torch.zeros_like, params),
            "v": _tree_map(torch.zeros_like, params),
            "t": torch.zeros((), dtype=torch.float32, device=dev)}


def adam_update(params, grads, state: dict, lr: float, b1: float = 0.9,
                b2: float = 0.999, eps: float = 1e-8,
                max_norm: float = 0.5) -> tuple[dict, dict]:
    """The reference's ``adam_update``, operation for operation: clip the
    gradients to global norm ``max_norm`` (``min(1, max_norm / (gnorm +
    1e-9))``), then Adam with bias correction and ``eps`` added to
    ``sqrt(vhat)``.  ``b1 ** t`` and ``b2 ** t`` round in f32, as ``t`` is
    an f32 tensor.  Returns new tensors; nothing is updated in place."""
    gnorm = torch.sqrt(sum(torch.sum(g * g) for g in _leaves(grads)))
    scale = torch.clamp(max_norm / (gnorm + 1e-9), max=1.0)
    grads = _tree_map(lambda g: g * scale, grads)
    t = state["t"] + 1
    m = _tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g, state["m"], grads)
    v = _tree_map(lambda v_, g: b2 * v_ + (1 - b2) * g * g, state["v"], grads)
    mhat = _tree_map(lambda x: x / (1 - b1 ** t), m)
    vhat = _tree_map(lambda x: x / (1 - b2 ** t), v)
    params = _tree_map(lambda p, mh, vh: p - lr * mh / (torch.sqrt(vh) + eps),
                       params, mhat, vhat)
    return params, {"m": m, "v": v, "t": t}


# ----------------------------------------------------------------- PPO update ----


def _ppo_loss(net: ActorCritic, batch: dict[str, torch.Tensor],
              clip_eps: float, value_coef: float,
              entropy_coef: float) -> torch.Tensor:
    """PPO-clip loss over a padded batch of P steps: ov (P, Q, 8), cv
    (P, Q, 5), mask (P, Q), action (P,) int64, logp / ret / adv / valid
    (P,).  The reference's per-step ``vmap`` as one batched computation
    through the plain actor and critic modules (never the kernel, which has
    no backward); the sum over steps is divided by ``max(sum(valid), 1)``."""
    mask = batch["mask"]
    logits = net.actor(batch["ov"])[..., 0]
    logits = torch.where(mask > 0, logits, -1e9)
    logp_all = torch.log_softmax(logits, dim=-1)
    logp = logp_all.gather(-1, batch["action"][:, None])[:, 0]
    ratio = torch.exp(logp - batch["logp"])
    clipped = torch.clamp(ratio, 1 - clip_eps, 1 + clip_eps)
    adv = batch["adv"]
    pg = -torch.minimum(ratio * adv, clipped * adv)
    v = net.critic(batch["cv"].reshape(mask.shape[0], -1))[:, 0]
    v_loss = (v - batch["ret"]) ** 2
    probs = torch.softmax(logits, dim=-1)
    ent = -torch.sum(torch.where(mask > 0, probs * logp_all, 0.0), dim=-1)
    losses = batch["valid"] * (pg + value_coef * v_loss - entropy_coef * ent)
    return torch.sum(losses) / torch.clamp(torch.sum(batch["valid"]), min=1.0)


def _loss_and_grads(net: ActorCritic, batch: dict[str, torch.Tensor], *,
                    clip_eps: float, value_coef: float,
                    entropy_coef: float) -> tuple[torch.Tensor, dict]:
    """``jax.value_and_grad(_ppo_loss)``: the loss (detached) and its
    gradients laid out like ``net.params``."""
    params = net.params
    loss = _ppo_loss(net, batch, clip_eps, value_coef, entropy_coef)
    if not loss.requires_grad:
        raise RuntimeError("PPO loss has no autograd graph: it must run the "
                           "actor and critic modules, not the kernel")
    leaves = _leaves(params)
    by_id = dict(zip(map(id, leaves), torch.autograd.grad(loss, leaves)))
    return loss.detach(), _tree_map(lambda p: by_id[id(p)], params)


def ppo_update_step(net: ActorCritic, opt_state: dict,
                    batch: dict[str, torch.Tensor], *, clip_eps: float,
                    value_coef: float, entropy_coef: float, lr: float,
                    max_norm: float) -> tuple[dict, dict, torch.Tensor]:
    """One PPO epoch: loss and gradients, then ``adam_update``.  The new
    parameters are copied into ``net`` in place; returns ``(net.params,
    opt_state, loss)`` as tensors on the net's device, without
    synchronising."""
    loss, grads = _loss_and_grads(net, batch, clip_eps=clip_eps,
                                  value_coef=value_coef,
                                  entropy_coef=entropy_coef)
    params = net.params
    with torch.no_grad():
        new, opt_state = adam_update(params, grads, opt_state, lr,
                                     max_norm=max_norm)
        for dst, src in zip(_leaves(params), _leaves(new)):
            dst.copy_(src)
    return params, opt_state, loss


def gae_advantages(rewards: np.ndarray, values: np.ndarray,
                   bootstrap_value: float, gamma: float,
                   lam: float) -> np.ndarray:
    """Generalized Advantage Estimation over one episode.

    ``bootstrap_value`` is V(s_{T+1}) for truncated episodes (0.0 for
    terminal ones): adv_t = sum_l (gamma*lam)^l * delta_{t+l} with
    delta_t = r_t + gamma * V_{t+1} - V_t.
    """
    T = len(rewards)
    adv = np.zeros(T, dtype=np.float32)
    last = 0.0
    nxt = float(bootstrap_value)
    for t in range(T - 1, -1, -1):
        delta = float(rewards[t]) + gamma * nxt - float(values[t])
        last = delta + gamma * lam * last
        adv[t] = last
        nxt = float(values[t])
    return adv


# ------------------------------------------------------------------- agent ----


def _resolve_device(device: torch.device | str | None,
                    owner: str = "PPOAgent") -> torch.device:
    """``None`` means ``"cuda"``.  A CUDA device without CUDA raises (pass
    ``device="cpu"`` to run on the CPU); on CUDA, TF32 matmuls are turned
    off so f32 stays f32."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"{owner}: CUDA is not available; pass "
                               "device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


_TRAJ_KEYS = ("ov", "cv", "mask", "action", "logp", "value")


class PPOAgent:
    """Stateful wrapper: decisions on one device, rollout recording and PPO
    updates."""

    def __init__(self, cfg: PPOConfig | None = None, *,
                 device: torch.device | str | None = None,
                 generator: torch.Generator | None = None):
        self.cfg = cfg or PPOConfig()
        self.device = _resolve_device(device)
        self.net = init_params(self.cfg, generator, self.device)
        self.opt_state = adam_init(self.params)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(self.cfg.seed + 1)
        self.reset_buffer()

    @property
    def params(self) -> dict[str, list[dict[str, torch.Tensor]]]:
        return self.net.params

    # ------------------------------------------------------------- rollout ----
    def reset_buffer(self) -> None:
        self._traj: dict[str, list] = {k: [] for k in _TRAJ_KEYS}
        if not hasattr(self, "_episodes"):
            self._episodes: list[tuple[dict, float]] = []
        if not hasattr(self, "_dense"):
            # (traj, per-step rewards, bootstrap value) per dense episode
            self._dense: list[tuple[dict, np.ndarray, float]] = []

    @property
    def rollout_len(self) -> int:
        """Steps recorded in the open (unfinished) episode."""
        return len(self._traj["action"])

    @property
    def rollout_values(self) -> list[float]:
        """Critic value estimates of the open episode's recorded steps."""
        return list(self._traj["value"])

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        a = np.ascontiguousarray(a, dtype=np.float32)
        sp = spans.ACTIVE
        if sp is not None and self.device.type != "cpu":
            spans.count_copy(sp, "h2d", a.nbytes)
        return torch.from_numpy(a).to(self.device)

    def act(self, ov: np.ndarray, cv: np.ndarray, mask: np.ndarray,
            explore: bool = True, record: bool = True) -> tuple[int, np.ndarray]:
        """Returns (chosen index, full logits) and records the step."""
        if explore:
            with torch.no_grad():
                out = policy_step(self.net, self._tensor(ov), self._tensor(cv),
                                  self._tensor(mask), generator=self._gen)
            action = int(out["action"])
            if record:
                self._traj["ov"].append(ov)
                self._traj["cv"].append(cv)
                self._traj["mask"].append(mask)
                self._traj["action"].append(action)
                self._traj["logp"].append(float(out["logp"]))
                self._traj["value"].append(float(out["value"]))
            logits = out["logits"]
            sp = spans.ACTIVE
            if sp is not None and logits.device.type != "cpu":
                # the action, logp and value scalars, then the logits
                n = 3 if record else 1
                spans.count_copy(sp, "d2h", 8 + 4 * (n - 1), n)
                spans.count_copy(sp, "d2h", logits.numel() * 4)
            return action, logits.cpu().numpy()
        with torch.no_grad():
            order = greedy_step(self.net, self._tensor(ov), self._tensor(mask))
        logits = np.zeros(mask.shape, dtype=np.float32)
        logits[order] = -np.arange(len(mask), dtype=np.float32)
        return int(order[0]), logits

    # -------------------------------------------------------------- update ----
    def _run_update(self, cat: dict[str, list], rets: np.ndarray,
                    adv: np.ndarray, Tc: int) -> float:
        """Pad the concatenated rollout to ``max_steps`` on the host, upload
        the eight arrays once, run the PPO-clip epochs on the device and
        synchronise once, for the last epoch's loss.  Shared by the terminal
        and dense reward pathways."""
        cfg = self.cfg
        P = cfg.max_steps

        def padded(arr, shape, dtype=np.float32):
            out = np.zeros((P,) + shape, dtype=dtype)
            out[:Tc] = np.asarray(arr[:Tc], dtype=dtype)
            return out

        batch = {
            "ov": padded(cat["ov"], (MAX_QUEUE_SIZE, OV_SIZE)),
            "cv": padded(cat["cv"], (MAX_QUEUE_SIZE, CV_SIZE)),
            "mask": padded(cat["mask"], (MAX_QUEUE_SIZE,)),
            "action": padded(cat["action"], (), np.int64),
            "logp": padded(cat["logp"], ()),
            "ret": padded(rets, ()),
            "adv": padded(adv, ()),
            "valid": padded(np.ones((Tc,)), ()),
        }
        batch = {k: torch.from_numpy(v).to(self.device)
                 for k, v in batch.items()}
        loss = 0.0
        for _ in range(cfg.update_epochs):
            _, self.opt_state, loss = ppo_update_step(
                self.net, self.opt_state, batch,
                clip_eps=cfg.clip_eps, value_coef=cfg.value_coef,
                entropy_coef=cfg.entropy_coef, lr=cfg.lr,
                max_norm=cfg.max_grad_norm)
        return float(loss)

    def finish_episode(self, reward: float) -> dict[str, float]:
        """Assign the terminal batch reward to every step (gamma = 1, sparse
        terminal reward => return_t = R).  With episodes_per_update > 1,
        episodes are pooled before the PPO update (variance reduction)."""
        T = len(self._traj["action"])
        steps = T
        if T:
            self._episodes.append((self._traj, reward))
        self._traj = {k: [] for k in _TRAJ_KEYS}
        if not self._episodes or \
                len(self._episodes) < self.cfg.episodes_per_update:
            return {"loss": 0.0, "steps": steps, "updated": 0.0}
        cfg = self.cfg
        P = cfg.max_steps

        # concatenate pooled episodes (truncate to the padding budget)
        cat: dict[str, list] = {k: [] for k in _TRAJ_KEYS}
        rets_l: list[float] = []
        for traj, rew in self._episodes:
            n = len(traj["action"])
            for k in cat:
                cat[k].extend(traj[k])
            rets_l.extend([rew] * n)
        Tc = min(len(cat["action"]), P)

        values = np.asarray(cat["value"][:Tc], dtype=np.float32)
        rets = np.asarray(rets_l[:Tc], dtype=np.float32)
        # no per-episode advantage normalization: with a constant terminal
        # reward it would divide by the (tiny) std of the value net's noise
        # and blow up the gradient.  The critic is the baseline.
        adv = np.clip(rets - values, -5.0, 5.0)

        loss = self._run_update(cat, rets, adv, Tc)
        self._episodes = []
        return {"loss": loss, "steps": steps, "updated": 1.0}

    def finish_episode_dense(self, rewards, *,
                             bootstrap_value: float = 0.0) -> dict[str, float]:
        """Close the open episode with **per-step dense rewards** and run a
        GAE(gamma, lambda) PPO update (the streaming pathway,
        ``repro_torch.rl``).

        ``rewards`` must have one entry per recorded step;
        ``bootstrap_value`` is V(s_{T+1}) for truncated (non-terminal)
        episodes.  Advantages are normalized per update (shaped rewards
        vary step to step), then clipped like the terminal path.  Respects
        ``episodes_per_update`` pooling.
        """
        T = len(self._traj["action"])
        rewards = np.asarray(rewards, dtype=np.float32)
        if rewards.shape != (T,):
            raise ValueError(f"got {rewards.shape[0] if rewards.ndim else 0} "
                             f"rewards for {T} recorded steps")
        steps = T
        if T:
            self._dense.append((self._traj, rewards, float(bootstrap_value)))
        self._traj = {k: [] for k in _TRAJ_KEYS}
        if not self._dense or len(self._dense) < self.cfg.episodes_per_update:
            return {"loss": 0.0, "steps": steps, "updated": 0.0,
                    "mean_reward": float(rewards.mean()) if T else 0.0}
        cfg = self.cfg

        cat: dict[str, list] = {k: [] for k in _TRAJ_KEYS}
        rets_l: list[np.ndarray] = []
        advs_l: list[np.ndarray] = []
        rews_l: list[np.ndarray] = []
        for traj, rews, boot in self._dense:
            vals = np.asarray(traj["value"], dtype=np.float32)
            adv = gae_advantages(rews, vals, boot, cfg.gamma, cfg.gae_lambda)
            rets_l.append(adv + vals)
            advs_l.append(adv)
            rews_l.append(rews)
            for k in cat:
                cat[k].extend(traj[k])
        Tc = min(len(cat["action"]), cfg.max_steps)
        rets = np.concatenate(rets_l)[:Tc].astype(np.float32)
        adv = np.concatenate(advs_l)[:Tc].astype(np.float32)
        std = float(adv.std())
        if std > 1e-6:
            adv = (adv - float(adv.mean())) / (std + 1e-8)
        adv = np.clip(adv, -5.0, 5.0)

        loss = self._run_update(cat, rets, adv, Tc)
        mean_r = float(np.concatenate(rews_l).mean())
        self._dense = []
        return {"loss": loss, "steps": steps, "updated": 1.0,
                "mean_reward": mean_r}

    # ------------------------------------------------------------- persist ----
    def state_dict(self) -> dict:
        """``{"params": nested numpy}``, the reference agent's format."""
        return {"params": params_to_numpy(self.net)}

    def load_state_dict(self, state: dict) -> None:
        """Load ``{"params": ...}`` as ``state_dict`` gives it, from this
        package or from ``repro.core.agent.PPOAgent.state_dict()``.  The
        optimizer starts afresh, as in the reference."""
        load_numpy_params(self.net, state["params"])
        self.opt_state = adam_init(self.params)
