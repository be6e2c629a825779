"""The port's latency harness (``octproz_tpu_torch.latency``) against the
JAX harness (``benchmarks/latency.py``) on the CPU: the same chain,
curves and geometries (read from the JAX script's own source: they are
built inside its ``main``), buffer 0 and two steady buffers through the
port's step equal to JAX's ``pipeline.make_step`` within
``test_torch_pipeline._close`` (1e-4 display units, a bf16 step more on a
bf16 store), the JSON line's keys, and no move to the CPU."""

import argparse
import ast
import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import octproz_tpu.params as jparams
import test_torch_pipeline as tp
from octproz_tpu import curves as jcurves
from octproz_tpu import pipeline as jpipeline
from octproz_tpu_torch import bench, latency
from octproz_tpu_torch.models.fdoct import FdOctModel
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_LATENCY = os.path.join(ROOT, "benchmarks", "latency.py")


def _jax_main():
    tree = ast.parse(open(JAX_LATENCY).read(), JAX_LATENCY)
    return next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")


def _calls(name):
    """The calls of ``name`` (a plain or dotted name's last part) in the
    JAX harness's ``main``, in source order."""
    def called(node):
        f = node.func
        return getattr(f, "id", None) == name or getattr(f, "attr", None) == name

    return [n for n in ast.walk(_jax_main()) if isinstance(n, ast.Call) and called(n)]


def _eval(node, **space):
    space.update(ProcConfig=jparams.ProcConfig, AcqParams=jparams.AcqParams,
                 FpnMode=jparams.FpnMode, Interpolation=jparams.Interpolation,
                 WindowType=jparams.WindowType)
    return eval(compile(ast.Expression(node), JAX_LATENCY, "eval"), space)


def _jax_acq(small):
    small_call, full_call = sorted(_calls("AcqParams"), key=lambda n: n.lineno)
    return _eval(small_call if small else full_call)


def _jax_cfg(backend, compute_dtype):
    args = argparse.Namespace(backend=backend, compute_dtype=compute_dtype)
    (call,) = _calls("ProcConfig")
    return _eval(call, args=args)


@pytest.mark.parametrize("small", [True, False])
def test_geometry_is_the_jax_harnesss(small):
    acq = latency.SMALL_ACQ if small else bench.FULL_ACQ
    want = _jax_acq(small)
    for field in ("samples_per_line", "ascans_per_bscan", "bscans_per_buffer", "bit_depth"):
        assert getattr(acq, field) == getattr(want, field)


@pytest.mark.parametrize("backend", ["pallas", "xla"])
@pytest.mark.parametrize("compute_dtype", ["bfloat16", "float32"])
def test_chain_is_the_jax_harnesss(backend, compute_dtype):
    """Every field of the port's chain equals the JAX harness's ProcConfig."""
    assert tp._jax_cfg(latency.latency_config(backend, compute_dtype)) == \
        _jax_cfg(backend, compute_dtype)


def test_defaults_are_the_jax_harnesss():
    """The JAX harness's flag defaults are the port's."""
    jax_defaults = {c.args[0].value: next((k.value.value for k in c.keywords
                                           if k.arg == "default"), None)
                    for c in _calls("add_argument")}
    port = {a.option_strings[0]: a.default for a in latency.build_parser()._actions
            if a.option_strings}
    for flag in ("--n", "--backend", "--compute-dtype"):
        assert port[flag] == jax_defaults[flag], flag
    assert latency.latency_config() == latency.latency_config("pallas", "bfloat16")


@pytest.mark.parametrize("small", [True, False])
def test_curves_are_the_jax_harnesss(small):
    """The make_curves keywords, evaluated on the harness's geometry."""
    (call,) = _calls("make_curves")
    acq = _jax_acq(small)
    want = {k.arg: _eval(k.value, acq=acq) for k in call.keywords}
    got = latency.curve_kwargs(latency.SMALL_ACQ if small else bench.FULL_ACQ)
    assert set(got) == set(want)
    assert got["window_type"].value == want["window_type"].value
    for key in ("resample_coeffs", "dispersion_coeffs"):
        assert tuple(got[key]) == tuple(want[key])


@pytest.mark.parametrize("backend,compute_dtype", [("pallas", "bfloat16"),
                                                   ("pallas", "float32"),
                                                   ("xla", "float32")])
def test_step_matches_jax_make_step(backend, compute_dtype):
    """Buffer 0 (the FPN determination) and two steady buffers: the port's
    model of the harness's chain against JAX's ``pipeline.make_step`` on
    the same numpy-seeded buffers."""
    acq = latency.SMALL_ACQ
    cfg = latency.latency_config(backend, compute_dtype)
    jacq, jcfg = _jax_acq(True), tp._jax_cfg(cfg)
    jkw = dict(latency.curve_kwargs(acq), window_type=jparams.WindowType.HANNING)
    jcv = jcurves.make_curves(jacq, jcfg, **jkw)
    jstep = jpipeline.make_step(jacq, jcfg)
    jstate = jpipeline.initial_fpn_state(jacq)
    model = FdOctModel(acq, cfg, **latency.curve_kwargs(acq), device="cpu")
    rng = np.random.default_rng(31)
    for k in range(3):
        raw = rng.integers(0, 4096, size=acq.buffer_shape).astype(np.uint16)
        got = model.process_buffer(raw)
        want, jstate = jstep(jnp.asarray(raw), jcv, jstate)
        tp._close(got, np.asarray(want, np.float32))
    np.testing.assert_allclose(model.fpn_state.mean_line.numpy(),
                               np.asarray(jstate.mean_line), rtol=1e-5,
                               atol=1e-5 * max(np.abs(np.asarray(jstate.mean_line)).max(), 1.0))


def _jax_keys():
    """The keys of the JSON line the JAX harness prints."""
    dumps = next(c for c in _calls("dumps"))
    return {k.value for k in dumps.args[0].keys}


def test_cli_cpu_small_prints_the_jax_keys(capsys):
    """``--device cpu --small --n 5``: one JSON line with the JAX line's keys,
    and the card's name and power limit (none on the CPU)."""
    assert latency.main(["--device", "cpu", "--small", "--n", "5"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert set(rec) == _jax_keys() | {"device_name", "power_limit"}
    assert rec["metric"] == "per_buffer_latency" and rec["unit"] == "ms"
    assert rec["n"] == 5 and 0 < rec["p50"] <= rec["p90"] <= rec["p99"] <= rec["max"]
    assert rec["amortized_pipelined_ms"] > 0
    assert rec["platform"] == "cpu" and rec["device_name"] is None
    assert rec["ascans_per_buffer"] == latency.SMALL_ACQ.ascans_per_buffer
    assert (rec["fold_backend"], rec["compute_dtype"]) == ("pallas", "bfloat16")


def test_cuda_without_a_card_exits_nonzero(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        latency.main(["--small", "--n", "2"])
    assert e.value.code not in (0, None)


def test_zero_buffers_refused():
    with pytest.raises(SystemExit) as e:
        latency.main(["--device", "cpu", "--small", "--n", "0"])
    assert e.value.code == 2
    with pytest.raises(ValueError):
        latency.measure(latency.SMALL_ACQ, latency.latency_config(), "cpu", n=0)


@pytest.mark.parametrize("n", [1, 5, 8, 20, 32, 60, 100])
def test_pipelined_count_is_the_jax_harnesss(n):
    (assign,) = [a for a in ast.walk(_jax_main()) if isinstance(a, ast.Assign)
                 and getattr(a.targets[0], "id", None) == "m"]
    assert latency.pipelined_count(n) == _eval(assign.value, args=argparse.Namespace(n=n))


def test_measure_stops_at_the_cap(monkeypatch):
    """The timed loop ends once 60 s have passed, with what it timed: on a
    clock that moves 10 s a reading (three readings a buffer after the
    loop's start), the third buffer ends at 90 s."""
    clock = iter(range(0, 10_000, 10))
    monkeypatch.setattr(latency.time, "perf_counter", lambda: float(next(clock)))
    acq = dataclasses.replace(latency.SMALL_ACQ, bscans_per_buffer=2)
    rec = latency.measure(acq, latency.latency_config(), "cpu", n=10)
    assert latency.CAP_S == 60.0 and rec["n"] == 3 and rec["p50"] == 10_000.0
