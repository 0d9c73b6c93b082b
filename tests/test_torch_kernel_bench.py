"""The port's kernel bench and roofline table against the reference's, on
the CPU.

- ``benchmarks_torch.bench_kernels`` on ``--device cpu``: the reference's
  three rows under their names, the plain outputs at the reference's
  shapes equal to the JAX oracles (``repro.kernels.ref.flash_attention_ref``,
  ``repro.models.mamba.ssd_chunked`` at chunk 256,
  ``repro.kernels.ref.moe_router_ref``) on the same numpy inputs, at
  ``tests/test_torch_lm_kernels.py``'s tolerances (attention 2e-5, SSD
  2e-3, router weights 1e-5 and indices equal), and a record with every
  key of a row, no kernel launched.
- ``benchmarks_torch.roofline`` on a record that the port's dry-run CLI
  writes gives the reference's ``benchmarks/roofline.py`` CSV rows on that
  record (the reference's reader is given the ``arg_bytes`` /
  ``temp_bytes`` it expects).
"""
import json
import shutil

import jax.numpy as jnp
import numpy as np
import pytest

import benchmarks_torch.bench_kernels as bk
from repro.kernels import ref as jref


@pytest.fixture(scope="module")
def cpu_record(tmp_path_factory):
    path = tmp_path_factory.mktemp("bench") / "BENCH_kernels.json"
    mp = pytest.MonkeyPatch()
    mp.setattr(bk, "JSON_PATH", str(path))
    rows: list[str] = []
    try:
        doc = bk.run(rows, device="cpu", smoke=True)
    finally:
        mp.undo()
    return doc, rows, json.loads(path.read_text())


def test_reference_rows_on_the_cpu(cpu_record):
    doc, rows, written = cpu_record
    names = ["kernels/attention_ref_1k", "kernels/ssd_chunked_1k",
             "kernels/moe_router_4k"]
    assert [r.split(",")[0] for r in rows] == names
    assert [r["name"] for r in written["rows"]] == names
    assert rows[0].endswith("TF/s")
    assert written["device"] == "cpu"
    assert written["provenance"]["card"] is None
    for r in written["rows"]:
        assert set(r) == set(bk.KEYS), r
        assert r["us"] is None and r["launches"] == 0
        assert r["plain_us"] > 0 and r["bound_us"] > 0
        assert r["bound_by"] in ("operations", "bytes")
    assert json.loads(json.dumps(doc)) == written


def test_full_row_list_names_every_kernel():
    cases = bk.cases()
    assert {c.kernel for c in cases} == set(bk.KERNELS)
    assert [c.name for c in cases if c.reference] == [
        "kernels/attention_ref_1k", "kernels/ssd_chunked_1k",
        "kernels/moe_router_4k"]
    assert [c.shape["Q"] for c in cases if c.kernel == "policy_mlp"] == \
        list(bk.POLICY_QS)
    assert 4096 in bk.POLICY_QS
    assert len({c.name for c in cases}) == len(cases)


def _case(name):
    return next(c for c in bk.cases() if c.name == name)


def _np(t):
    return t.float().numpy()


def test_attention_plain_equals_the_jax_oracle():
    case = _case("kernels/attention_ref_1k")
    a = bk.inputs(case, "cpu", 0)
    got = bk.plain(case, a)
    B, H, L, D = a["q"].shape
    G = H // a["k"].shape[1]
    q = jnp.asarray(_np(a["q"]).reshape(B * H, L, D))
    k, v = (jnp.asarray(np.repeat(_np(a[n]), G, axis=1).reshape(B * H, L, D))
            for n in ("k", "v"))
    want = np.asarray(jref.flash_attention_ref(q, k, v, causal=True))
    np.testing.assert_allclose(_np(got).reshape(B * H, L, D), want,
                               atol=2e-5, rtol=2e-5)


def test_ssd_plain_equals_the_jax_ssd_chunked():
    from repro.models.mamba import ssd_chunked as jssd
    case = _case("kernels/ssd_chunked_1k")
    a = bk.inputs(case, "cpu", 1)
    y, S = bk.plain(case, a)
    jy, jS = jssd(*(jnp.asarray(_np(a[n])) for n in ("xh", "dt", "A", "Bs",
                                                      "Cs")), chunk=256)
    np.testing.assert_allclose(_np(y), np.asarray(jy), atol=2e-3, rtol=2e-3)
    np.testing.assert_allclose(_np(S), np.asarray(jS), atol=2e-3, rtol=2e-3)


def test_router_plain_equals_the_jax_oracle():
    case = _case("kernels/moe_router_4k")
    a = bk.inputs(case, "cpu", 2)
    w, i = bk.plain(case, a)
    jw, ji = jref.moe_router_ref(jnp.asarray(_np(a["x"])),
                                 jnp.asarray(_np(a["w"])), 8)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=1e-5)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))


def test_a_row_on_a_card_needs_a_card():
    """A kernel wrapper takes no CPU tensor: on the CPU the bench never
    calls one (the record above launched nothing)."""
    case = _case("kernels/moe_router_4k")
    a = bk.inputs(case, "cpu", 2)
    with pytest.raises(ValueError, match="CUDA"):
        bk._kernel_fn(case, a)()


def test_roofline_rows_equal_the_reference(tmp_path, monkeypatch, capsys):
    import benchmarks.roofline as jroof
    import benchmarks_torch.roofline as troof
    from repro_torch.launch import dryrun
    port = tmp_path / "port"
    dryrun.main(["--arch", "whisper-tiny", "--shape", "decode_32k",
                 "--out", str(port)])
    ref = tmp_path / "ref"
    shutil.copytree(port, ref)
    for f in (ref / "singlepod").glob("*.json"):
        rec = json.loads(f.read_text())
        rec["memory"].update(arg_bytes=rec["memory"]["bytes_per_device"],
                             temp_bytes=0)
        f.write_text(json.dumps(rec))
    mine: list[str] = []
    troof.run(mine, root=str(port))
    out_port = capsys.readouterr().out
    monkeypatch.setattr(jroof, "DRY", str(ref))
    theirs: list[str] = []
    jroof.run(theirs)
    out_ref = capsys.readouterr().out
    assert mine == theirs and len(mine) == 1
    assert mine[0].startswith("roofline/singlepod/whisper-tiny/decode_32k,")
    assert "no multipod artifacts" in out_port
    assert "python -m repro_torch.launch.dryrun" in out_port
    # the table is the reference's too, mem/dev read from bytes_per_device
    strip = [ln for ln in out_port.splitlines() if ln.startswith("whisper")]
    assert strip == [ln for ln in out_ref.splitlines()
                     if ln.startswith("whisper")]


def test_runner_covers_every_reference_module():
    """``python -m benchmarks_torch.run`` covers every module of
    ``benchmarks/run.py``, ``kernels`` and ``roofline`` in the reference's
    places, and finds each one's module."""
    import importlib

    import benchmarks.run as jrun
    import benchmarks_torch.run as trun
    assert set(trun.MODULES) == set(jrun.MODULES)
    assert trun.MODULES[:3] == jrun.MODULES[:3] == ("latency", "kernels",
                                                     "roofline")
    for name in ("kernels", "roofline"):
        mod = importlib.import_module(trun.SPECIAL.get(
            name, f"benchmarks_torch.bench_{name}"))
        assert callable(mod.run)
