"""The port stands alone: it imports with JAX and the JAX package blocked,
and no source file of it imports either.  The machine with the GPU has no
JAX, so a stray import would break the port there and nowhere else."""

import os
import re
import subprocess
import sys

import pytest

from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "octproz_tpu_torch")

MODULES = ["octproz_tpu_torch", "octproz_tpu_torch.models.fdoct",
           "octproz_tpu_torch.models.presets", "octproz_tpu_torch.ops.fft",
           "octproz_tpu_torch.kernels.fused_prep", "octproz_tpu_torch.kernels.build",
           "octproz_tpu_torch.bench", "octproz_tpu_torch.interop",
           "octproz_tpu_torch.utils.fidelity", "octproz_tpu_torch.utils.memory",
           "octproz_tpu_torch.runtime", "octproz_tpu_torch.io.source",
           "octproz_tpu_torch.io.recorder", "octproz_tpu_torch.io.volume",
           "octproz_tpu_torch.plugins", "octproz_tpu_torch.ops.quantize",
           "octproz_tpu_torch.utils.configmap", "octproz_tpu_torch.ab",
           "octproz_tpu_torch.kernels.diagnose", "octproz_tpu_torch.utils",
           "octproz_tpu_torch.utils.profiling", "octproz_tpu_torch.utils.deviceinfo",
           "octproz_tpu_torch.utils.console", "octproz_tpu_torch.native",
           "octproz_tpu_torch.io.hwbridge", "octproz_tpu_torch.io.phytooct",
           "octproz_tpu_torch.io.systems", "octproz_tpu_torch.io.curvefiles",
           "octproz_tpu_torch.extensions", "octproz_tpu_torch.extensions.statistics",
           "octproz_tpu_torch.extensions.peaks", "octproz_tpu_torch.extensions.demo",
           "octproz_tpu_torch.extensions.socketstream", "octproz_tpu_torch.extensions.camera",
           "octproz_tpu_torch.extensions.calibration", "octproz_tpu_torch.ops.projections",
           "octproz_tpu_torch.viz", "octproz_tpu_torch.viz.image",
           "octproz_tpu_torch.viz.plots", "octproz_tpu_torch.viz.render",
           "octproz_tpu_torch.viz.live", "octproz_tpu_torch.control",
           "octproz_tpu_torch.cli", "octproz_tpu_torch.parallel",
           "octproz_tpu_torch.parallel.sharding", "octproz_tpu_torch.parallel.multihost",
           "octproz_tpu_torch.parallel.traffic", "octproz_tpu_torch.fullgeom_fidelity",
           "octproz_tpu_torch.soak", "octproz_tpu_torch.latency",
           "octproz_tpu_torch.scaling"]


@pytest.mark.parametrize("module", MODULES)
def test_imports_with_jax_blocked(module):
    """In a subprocess: this test process has imported JAX already."""
    code = ("import sys; sys.modules['jax'] = None; sys.modules['octproz_tpu'] = None; "
            f"import {module}; "
            "bad = [m for m in sys.modules if (m == 'jax' or m.startswith(('jax.', 'octproz_tpu.')))"
            " and sys.modules[m] is not None]; "
            "assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def _sources():
    """The package's Python files, without the kernel build directory (its
    contents are made at run time, not sources of the package)."""
    for base, dirs, files in os.walk(PKG):
        dirs[:] = [d for d in dirs if d != "_build"]
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(base, name)


def test_no_source_imports_jax_or_the_jax_package():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|octproz_tpu)(\.|\s|$)"
                         r"|import_module\(\s*['\"](jax|octproz_tpu)[.'\"]"
                         r"|\boctproz_tpu\.")
    found = []
    for path in _sources():
        with open(path) as f:
            for no, line in enumerate(f, 1):
                if pattern.search(line):
                    found.append(f"{os.path.relpath(path, ROOT)}:{no}: {line.strip()}")
    assert not found, found
    assert len(list(_sources())) >= 15


def test_chip_smoke_imports_no_jax():
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        text = f.read()
    assert not re.search(r"^\s*(import|from)\s+(jax|octproz_tpu)(\.|\s|$)", text, re.M)
    assert "octproz_tpu_torch" in text


def test_chip_smoke_fails_without_a_gpu():
    """Without CUDA the smoke test exits nonzero and prints no result line."""
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                          cwd=ROOT, capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_every_port_test_file_runs_torch_on_one_thread():
    """Each port test file imports the autouse ``one_torch_thread`` of
    tests/torch_threads.py: under xdist a thread per core in every worker
    oversubscribes the cores, and a repeat the tests compare bit for bit
    keeps threading out of it."""
    tests = os.path.join(ROOT, "tests")
    names = sorted(n for n in os.listdir(tests) if re.fullmatch(r"test_torch_\w+\.py", n))
    line = re.compile(r"^from torch_threads import one_torch_thread\b", re.M)
    missing = [n for n in names if not line.search(open(os.path.join(tests, n)).read())]
    assert len(names) >= 28 and not missing, missing


def test_the_fixture_holds_torch_at_one_thread():
    import torch

    assert torch.get_num_threads() == 1
