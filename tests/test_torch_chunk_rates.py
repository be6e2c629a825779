"""The bench's chunked dispatch (``bench.chunk_ms``, ``paths.chunk``) on the
CPU: its attempts are the JAX bench's chunked ones (read from the root
``bench.py``'s own source), the stacks of ``chunk_ms``'s model through
``process_chunk`` -- scan and batch -- equal the per-buffer steps and the
JAX package's ``process_chunk`` on the same buffers, and ``chunk_ms``
returns the time per buffer of the calls it times."""

import ast
import dataclasses
import os

import numpy as np
import pytest
import torch

import octproz_tpu.models.fdoct as jfdoct
import octproz_tpu.params as jparams
import test_torch_pipeline as tp
from octproz_tpu_torch import bench
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_BENCH = os.path.join(ROOT, "bench.py")
#: 1024-sample lines (the benchmark curves'), few of them.
ACQ = dataclasses.replace(bench.FULL_ACQ, ascans_per_bscan=32, bscans_per_buffer=4)


def _jax_attempts():
    """The JAX bench's attempt specs (its ``main``'s ``attempts`` list)."""
    tree = ast.parse(open(JAX_BENCH).read(), JAX_BENCH)
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    (assign,) = [a for a in ast.walk(main) if isinstance(a, ast.Assign)
                 and getattr(a.targets[0], "id", None) == "attempts"]
    return [e.value for e in assign.value.body.elts]


def _as_port(spec):
    """``<backend>[:chunk[:compute_dtype[:precision[:output_dtype]]]]`` as
    (strategy, chunk, rung, store); the JAX bench's defaults
    (``bench.py:549-554``)."""
    parts = spec.split(":") + [""] * 4
    backend, chunk = parts[0], int(parts[1] or 1)
    dtype, precision, store = parts[2] or "float32", parts[3] or "default", parts[4] or "float32"
    return ({"mega": "batch", "pallas": "scan"}.get(backend), chunk,
            "bfloat16" if dtype == "bfloat16" else precision, store)


def test_attempts_are_the_jax_benchs_chunked_ones():
    """Every chunked kernel-route attempt of the JAX bench ("mega" the
    batch, "pallas" the scan), in its order, and the batch at 8 at the
    default rung beside the scan there."""
    want = [a for a in map(_as_port, _jax_attempts()) if a[0] and a[1] > 1]
    assert want[0] == ("batch", 32, "bfloat16", "bfloat16")
    assert list(bench.CHUNK_ATTEMPTS) == want + [("batch", 8, "default", "float32")]


def _cfg(rung, store):
    return bench.at_rung(bench.bench_config(output_dtype=store), rung)


@pytest.mark.parametrize("strategy", ["scan", "batch"])
@pytest.mark.parametrize("rung,store", [("bfloat16", "float32"), ("bfloat16", "bfloat16"),
                                        ("default", "float32")])
def test_chunk_model_stacks_equal_per_buffer_steps(strategy, rung, store):
    """The stack of ``chunk_ms``'s model through ``process_chunk`` equals
    the per-buffer steps on the same model and JAX's ``process_chunk``.
    The scan exactly; the batch within ``_close`` (1e-4 display units):
    its plain version is one matmul over all the chunk's lines, which the
    CPU's BLAS blocks otherwise than one buffer's (up to 2.1e-5 apart at
    this size, near the display floor).  On the card, where each line's
    sums do not depend on the launch's line count, the smoke holds the
    batch to atol 1e-5."""
    cfg = _cfg(rung, store)
    model, stack = bench.chunk_model(cfg, "cpu", 3, ACQ)
    assert model.fpn_state.determined
    chunk = model.process_chunk(stack, strategy)
    assert tuple(chunk.shape) == (3, *ACQ.processed_buffer_shape)
    jm = jfdoct.FdOctModel(jparams.AcqParams(**dataclasses.asdict(ACQ)), tp._jax_cfg(cfg),
                           **dict(bench.CURVE_KW, window_type=jparams.WindowType.HANNING))
    stack_np = stack.numpy()
    jm.process_buffer(stack_np[0])
    jchunk = np.asarray(jm.process_chunk(stack_np, strategy), np.float32)
    for i in range(3):
        want = model.process_buffer(stack[i])
        if strategy == "scan":
            assert torch.equal(chunk[i], want)
        else:
            tp._close(chunk[i], want.float().numpy())
        tp._close(chunk[i], jchunk[i])


def test_chunk_ms_is_per_buffer(monkeypatch):
    """``chunk_ms`` times ``process_chunk`` on its stack with the strategy
    asked for and divides by the chunk."""
    calls = []

    def timed(fn, iters, warmup):
        for _ in range(warmup + iters):
            calls.append(fn())
        return 12.0

    monkeypatch.setattr(bench, "cuda_ms", timed)
    ms = bench.chunk_ms(_cfg("bfloat16", "float32"), "cpu", 4, "batch", acq=ACQ, iters=2)
    assert ms == 3.0 and len(calls) == 3
    assert all(tuple(c.shape) == (4, *ACQ.processed_buffer_shape) for c in calls)


def test_chunk_path_record_takes_each_steady_once(monkeypatch):
    """``paths.chunk`` holds every attempt under its key, each beside the
    steady ms of its (rung, store), taken once per pair, and the stack copy
    for the scans only."""
    steadies, chunks = [], []
    monkeypatch.setattr(bench, "steady_ms_per_buffer",
                        lambda cfg, dev: steadies.append((cfg.compute_dtype,
                                                          cfg.matmul_precision,
                                                          cfg.output_dtype)) or 2.0)
    monkeypatch.setattr(bench, "chunk_ms",
                        lambda cfg, dev, chunk, strategy, iters: chunks.append(chunk) or 1.0)
    monkeypatch.setattr(bench, "stack_ms", lambda cfg, dev, chunk: 0.25)
    rec = bench.chunk_path_record("cpu")
    assert list(rec) == [":".join(map(str, a)) for a in bench.CHUNK_ATTEMPTS]
    assert len(steadies) == len(set(steadies)) == 3
    assert chunks == [a[1] for a in bench.CHUNK_ATTEMPTS]
    for (strategy, chunk, rung, store), r in zip(bench.CHUNK_ATTEMPTS, rec.values()):
        assert (r["strategy"], r["chunk"], r["rung"], r["output_dtype"]) == \
            (strategy, chunk, rung, store)
        assert r["ms_per_buffer"] == 1.0 and r["steady_ms_per_buffer"] == 2.0
        assert ("stack_ms_per_buffer" in r) == (strategy == "scan")


def test_batch_refused_before_fpn_is_determined():
    """The batch strategy needs a constant mean line: without the FPN
    determination ``chunk_model`` makes, the model refuses it."""
    model, stack = bench.chunk_model(_cfg("bfloat16", "float32"), "cpu", 2, ACQ)
    model.redetermine_fpn()
    with pytest.raises(ValueError, match="batch"):
        model.process_chunk(stack, "batch")
