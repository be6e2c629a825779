"""Accelerator inventory report.

Capability-equivalent of the reference's ``GpuInfo``
(octproz_project/octproz/src/gpuinfo.{h,cpp}: cudaGetDeviceProperties ->
memory, SMs, clock, concurrent-kernel flags), and the counterpart of
``octproz_tpu/utils/deviceinfo.py``: one entry per CUDA device with its
name and live memory from ``torch.cuda.mem_get_info``.  Without a CUDA
device the report lists the CPU the process runs on, as the JAX report
lists its CPU device; nothing runs there on its account.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch


def device_report() -> List[Dict[str, Any]]:
    """Per device: ``id``, ``platform`` ("gpu" or "cpu"), ``device_kind``,
    ``process_index`` (0: one process) and, for a CUDA device,
    ``memory_limit_mb`` and ``memory_in_use_mb`` (the whole device's use,
    other processes included)."""
    if not torch.cuda.is_available():
        return [{"id": 0, "platform": "cpu", "device_kind": "cpu", "process_index": 0}]
    out: List[Dict[str, Any]] = []
    for i in range(torch.cuda.device_count()):
        free, total = torch.cuda.mem_get_info(i)
        out.append({"id": i, "platform": "gpu",
                    "device_kind": torch.cuda.get_device_name(i),
                    "process_index": 0,
                    "memory_limit_mb": round(total / 1e6, 1),
                    "memory_in_use_mb": round((total - free) / 1e6, 1)})
    return out


def format_report() -> str:
    lines = []
    for info in device_report():
        parts = [f"device {info['id']}: {info['device_kind']} ({info['platform']})"]
        if "memory_limit_mb" in info:
            parts.append(f"{info.get('memory_in_use_mb', 0.0):.0f}/"
                         f"{info['memory_limit_mb']:.0f} MB HBM")
        lines.append(", ".join(parts))
    return "\n".join(lines)
