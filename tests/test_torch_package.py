"""The port stands alone: it imports with JAX and the JAX package blocked,
and no source file of it imports either.  The machine with the GPU has no
JAX, so a stray import would break the port there and nowhere else."""

import os
import re
import subprocess
import sys

import pytest

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
           "octproz_tpu_torch.utils.console"]


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
