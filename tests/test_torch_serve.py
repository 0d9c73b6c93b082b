"""The port's serving engine against the JAX package's, on the CPU.

Six requests of different prompt lengths and budgets, served two at a time
(left-padded prefill, a dummy request filling the last batch, greedy decode
to each request's budget), through the hybrid (Jamba) and MoE (Granite)
smoke configs in f32 with the reference's parameters carried across: the
port must give the reference's outputs token for token.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models.lm import LM as JLM
from repro.serve.engine import Request as JRequest, ServeEngine as JServeEngine
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.launch import serve as serve_cli
from repro_torch.models import build_model
from repro_torch.serve import Request, ServeEngine


def _requests(cls, vocab: int, n: int = 6, seed: int = 0):
    rng = np.random.default_rng(seed)
    return [cls(req_id=i,
                prompt=[int(t) for t in rng.integers(1, vocab, size=5 + 3 * i)],
                max_new_tokens=3 + i % 4)
            for i in range(n)]


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "granite-moe-1b-a400m"])
def test_serve_engine_matches_reference(arch):
    jcfg = dataclasses.replace(jget_config(arch, smoke=True), dtype=jnp.float32)
    tcfg = dataclasses.replace(tget_config(arch, smoke=True),
                               dtype=torch.float32)
    jmodel = JLM(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    want = JServeEngine(jmodel, jparams, batch_size=2, max_len=64).run(
        _requests(JRequest, jcfg.vocab_size))
    model = build_model(tcfg, device="cpu")
    params = lm_params_from_jax(jax.tree.map(np.asarray, jparams), model)
    got = ServeEngine(model, params, batch_size=2, max_len=64,
                      device="cpu").run(_requests(Request, tcfg.vocab_size))
    assert [r.req_id for r in got] == [r.req_id for r in want]
    for g, w in zip(got, want):
        assert len(g.output) == g.max_new_tokens
        assert g.output == [int(t) for t in w.output], g.req_id
        assert g.done == w.done


def test_serve_engine_needs_cuda_unless_asked_for_the_cpu(monkeypatch):
    model = build_model("jamba-v0.1-52b", smoke=True, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServeEngine(model, {}, batch_size=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_cli.main(["--arch", "jamba-v0.1-52b", "--smoke"])
    assert ServeEngine(model, {}, device="cpu").device.type == "cpu"


def test_serve_cli_on_the_cpu(capsys):
    serve_cli.main(["--arch", "jamba-v0.1-52b", "--smoke", "--device", "cpu",
                    "--requests", "3", "--batch", "2", "--max-new", "4"])
    out = capsys.readouterr().out
    assert "[serve] 3 requests, 12 tokens" in out and "on cpu" in out
