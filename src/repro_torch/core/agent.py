"""PPO Actor-Critic agent in torch (Sec. 3.2, Fig. 9): the serving half.

The actor is a 3-layer MLP applied per job with shared weights (the paper's
"sliding-window" evaluation) over the 8-feature Observation Vector; a softmax
over the queue yields normalized priorities.  The critic is a 3-layer MLP over
the flattened 5-feature Critic Vector (all jobs at once) estimating the batch
return.  MAX_QUEUE_SIZE = 256 with zero-padding keeps state/action spaces
fixed.

Weights keep the reference's ``(fan_in, fan_out)`` layout (``x @ w + b``),
so parameters carry across from ``repro.core.agent`` without transposes
(``repro_torch.convert``).  ``actor_logits`` goes through
``kernels.ops.policy_mlp``: the hand-written CUDA kernel for tensors on the
GPU, its plain torch version for tensors on the CPU.  The critic stays
``torch.matmul``.  f32 matmuls run in full f32: on a CUDA device the agent
turns TF32 off (``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32``), which the 1280-wide critic needs to
stay within 1e-5 of the reference.

PPO training (the loss, Adam, GAE and the ``finish_episode*`` pathways) is
not ported yet; the agent records rollouts for it.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from repro_torch.convert import load_numpy_params, params_to_numpy
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
                device: torch.device | str = "cpu") -> ActorCritic:
    """He-normal weights, zero biases; the last actor layer scaled by 0.01
    and the last critic layer by 0.1, as in the reference.  Draws come from
    ``generator`` (a CPU generator seeded with ``cfg.seed`` by default), so
    the same seed gives the same weights on every device; they are not the
    reference's ``jax.random`` draws."""
    gen = generator if generator is not None else \
        torch.Generator().manual_seed(cfg.seed)
    net = ActorCritic(cfg)
    _mlp_init(net.actor, gen, 0.01)
    _mlp_init(net.critic, gen, 0.1)
    return net.to(device)


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
    logits = actor_logits(net, ov, mask).detach().cpu().numpy()
    return np.argsort(-logits, kind="stable")


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
    """Stateful wrapper: decisions on one device + rollout recording."""

    def __init__(self, cfg: PPOConfig | None = None, *,
                 device: torch.device | str | None = None,
                 generator: torch.Generator | None = None):
        self.cfg = cfg or PPOConfig()
        self.device = _resolve_device(device)
        self.net = init_params(self.cfg, generator, self.device)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(self.cfg.seed + 1)
        self.reset_buffer()

    @property
    def params(self) -> dict[str, list[dict[str, torch.Tensor]]]:
        return self.net.params

    # ------------------------------------------------------------- rollout ----
    def reset_buffer(self) -> None:
        self._traj: dict[str, list] = {k: [] for k in _TRAJ_KEYS}

    @property
    def rollout_len(self) -> int:
        """Steps recorded in the open (unfinished) episode."""
        return len(self._traj["action"])

    @property
    def rollout_values(self) -> list[float]:
        """Critic value estimates of the open episode's recorded steps."""
        return list(self._traj["value"])

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)) \
            .to(self.device)

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
            return action, out["logits"].cpu().numpy()
        with torch.no_grad():
            order = greedy_step(self.net, self._tensor(ov), self._tensor(mask))
        logits = np.zeros(mask.shape, dtype=np.float32)
        logits[order] = -np.arange(len(mask), dtype=np.float32)
        return int(order[0]), logits

    # ------------------------------------------------------------- persist ----
    def state_dict(self) -> dict:
        """``{"params": nested numpy}``, the reference agent's format."""
        return {"params": params_to_numpy(self.net)}

    def load_state_dict(self, state: dict) -> None:
        """Load ``{"params": ...}`` as ``state_dict`` gives it, from this
        package or from ``repro.core.agent.PPOAgent.state_dict()``."""
        load_numpy_params(self.net, state["params"])
