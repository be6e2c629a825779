"""What the benchmark loads: never JAX nor the JAX package, judged by each
module's top-level name compared whole (the port's name begins with the
JAX package's); and the yardstick -- the reference, the comparison, the
counts, the trace's reduction, the inputs, the traffic -- imports nothing
of the port."""

from __future__ import annotations

import ast
import subprocess
import sys
import textwrap

from portbench import cells

DRY_PASS = textwrap.dedent("""
    import sys, time, torch
    sys.path.insert(0, "portbench/tests")
    torch.set_num_threads(1)
    from conftest import load, shrink
    from portbench import cells, run, sweep, readings
    for name in ("figshare.replay", "handheld.live"):
        cell = shrink(load(name))
        r = run.run_cell(cell, 3, 0.1, False, "cpu", time.perf_counter())
        assert r["correct"], r["checks"]
        cells.metric_reader("step_roofline")
    for m in load("handheld.replay").per_layer + load("figshare.live").per_layer:
        cells.metric_reader(m["name"])
    print(sorted({m.split(".")[0] for m in sys.modules}))
    print("forbidden:", run.forbidden_modules())
""")

YARDSTICK = ("reference.py", "judge.py", "roofline.py", "devtrace.py", "interferograms.py",
             "loadgen.py")


def test_dry_pass_loads_no_jax_and_no_jax_package():
    out = subprocess.run([sys.executable, "-c", DRY_PASS], cwd=cells.REPO, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    top = set(eval(out.stdout.splitlines()[-2]))  # noqa: S307 -- our own printout
    assert "octproz_tpu_torch" in top and "portbench" in top
    assert not top & {"jax", "jaxlib", "flax", "octproz_tpu"}
    assert out.stdout.splitlines()[-1] == "forbidden: []"


def test_forbidden_names_are_compared_whole(monkeypatch):
    from portbench import run

    fake = type(sys)("fake")
    for name in ("octproz_tpu_torch_x", "jaxy", "octproz_tpu.params", "jaxlib.xla"):
        monkeypatch.setitem(sys.modules, name, fake)
    found = run.forbidden_modules()
    assert "octproz_tpu.params" in found and "jaxlib.xla" in found
    assert "octproz_tpu_torch_x" not in found and "jaxy" not in found


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_yardstick_imports_nothing_of_the_port():
    for name in YARDSTICK:
        tops = {m.split(".")[0] for m in _imports(cells.HERE / name)}
        assert not tops & {"octproz_tpu_torch", "octproz_tpu", "jax", "jaxlib", "flax"}, name
    for path in (cells.HERE / "metrics").glob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & {"octproz_tpu_torch", "octproz_tpu", "jax"}, path.name


def test_harness_reads_nothing_of_the_jax_benchmarks():
    for path in cells.HERE.rglob("*.py"):
        if "tests" in path.parts:
            continue
        text = path.read_text()
        assert "benchmarks/" not in text and "bench.py" not in text.replace("portbench", ""), path
