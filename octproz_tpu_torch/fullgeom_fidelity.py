"""Full-geometry fidelity anchor and the SNR bound it derives, on the port.

Counterpart of ``scripts/fullgeom_fidelity.py`` (the same functions and
report keys), running the port's ``FdOctModel`` on a CUDA GPU (or on the
CPU, where the kernels' plain versions run).

**Bound derivation.**  The PhytoOCT device model (``io/phytooct.py``)
gives both the 12-bit codes its ADC writes and the analog interferogram
before the ADC.  The float64 oracle (``tests/oracle.py``, numpy only) on
each, scaled as the reference scales its output (20 log10 |IFFT|, then the
grayscale window), gives the acquisition's own quantization noise in
display units: their PSNR is the SNR bound.  A rung whose PSNR against
the oracle on the codes clears it adds less error than the ADC does.

**Rungs.**  Each rung ("bfloat16" -- ``compute_dtype="bfloat16"`` --,
"default", "high", "highest") runs the device's recommended chain on the
fold path through ``FdOctModel.process_buffer`` from a fresh FPN state:
with FPN off the steady-state kernel (B2, or B4 at the split rungs, the
one-term kernel at bf16) makes the image; with FPN on (once, from the
first four B-scans) the FPN buffer's planar kernel (B1, B3 at the split
rungs), then the torch FPN and scaling, against the oracle running the
same tie-banded FPN selection.  ``cli compare`` gates the "highest" rung's
output against the saved oracle volume at the bound.

    python -m octproz_tpu_torch.fullgeom_fidelity             # 1024 x 512 x 256 on cuda:0
    python -m octproz_tpu_torch.fullgeom_fidelity --small --device cpu

``--small`` is the 256 x 64 x 8 geometry of the CPU tests
(``tests/test_torch_fullgeom_fidelity.py``).  At the full geometry the
device model and three float64 oracle runs take about a minute of host
time on eight threads, and some 10 GB of host memory.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .io.phytooct import PhytoDeviceConfig, PortableOctSystem
from .params import FpnMode

#: The precision rungs, in the JAX script's order.
RUNGS = ("bfloat16", "default", "high", "highest")
#: The B-scans the FPN-on rungs determine their mean line from.
FPN_BSCANS = 4
#: Host threads of the device model and the oracle, B-scan by B-scan
#: (numpy releases the GIL in their array loops and FFTs).
HOST_THREADS = min(8, os.cpu_count() or 1)


def device_and_volumes(samples=1024, ascans=512, bscans=256, seed=7):
    """Full-geometry PhytoOCT volume: returns (device, raw uint16 codes,
    analog float codes in 12-bit units)."""
    dev = PhytoDeviceConfig(samples_per_line=samples, ascans_per_bscan=ascans,
                            bscans_per_buffer=bscans, buffers_per_volume=1,
                            bidirectional=False, seed=seed)
    system = PortableOctSystem(dev)  # never started: no acquisition ring
    model = system.model
    pos = model.scan_positions(False)
    raw = np.empty((bscans, ascans, samples), np.uint16)
    analog = np.empty((bscans, ascans, samples), np.float64)

    def bscan(b):
        spec = model._ascan_spectrum(pos, noise_key=b)
        analog[b] = spec * 4096.0                        # analog, 12-bit units
        raw[b] = (spec * 4096.0).astype(np.uint16) << 4  # the device ADC

    with ThreadPoolExecutor(HOST_THREADS) as pool:
        list(pool.map(bscan, range(bscans)))
    return system, raw, analog


def anchor_config(system):
    """The device's recommended chain (the fold path) with FPN off and no
    flip (the volume is unidirectional).  Quantized and analog inputs can
    pick different FPN segments, so the bound keeps FPN out; the FPN-on
    fidelity is measured by :func:`fpn_on_rung_psnrs`."""
    return dataclasses.replace(system.recommended_config(), fpn_mode=FpnMode.OFF,
                               bscan_flip=False)


def host_curves(system, cfg):
    """The chain's curves on the host, for the oracle."""
    from . import curves as curves_mod

    return curves_mod.make_curves(system.acq, cfg, **system.curve_kwargs(), device="cpu")


def _oracle_args(cfg, curves):
    return dict(resample_curve=np.asarray(curves.resample_curve),
                interpolation=cfg.interpolation.value, window=np.asarray(curves.window),
                phase=np.asarray(curves.phase), log_scaling=cfg.log_scaling,
                gmin=cfg.grayscale_min, gmax=cfg.grayscale_max, addend=cfg.addend,
                coeff=cfg.multiplicator, sinusoidal=cfg.sinusoidal_correction, fast=True)


def oracle_volume(x, cfg, curves, fpn_lines=0):
    """``tests/oracle.py``'s ``full_pipeline`` on float64 12-bit code values
    ``x`` (bscans, ascans, samples), in blocks of B-scans on
    ``HOST_THREADS`` threads -- the FPN mean line from the first
    ``fpn_lines`` lines, the sinusoidal correction (its last-A-scan guard
    spans the volume) on the whole -- equal to one call, bit for bit."""
    from .bench import _oracle

    oracle = _oracle()
    args = _oracle_args(cfg, curves)
    sinusoidal = args.pop("sinusoidal")
    mean = None
    if fpn_lines:
        first = -(-fpn_lines // x.shape[1])
        _, mean = oracle.full_pipeline(x[:first], 12, bitshift=False, fpn_lines=fpn_lines,
                                       **args)
    step = -(-x.shape[0] // (2 * HOST_THREADS))

    def block(b):
        return oracle.full_pipeline(x[b:b + step], 12, bitshift=False, fpn_lines=fpn_lines,
                                    fpn_mean=mean, **args)[0]

    with ThreadPoolExecutor(HOST_THREADS) as pool:
        out = np.concatenate(list(pool.map(block, range(0, x.shape[0], step))))
    return oracle.sinusoidal_correction(out) if sinusoidal else out


def oracle_display(x_codes, system, cfg, curves):
    """float64-oracle display output for 12-bit codes (int or analog)."""
    out = oracle_volume(np.asarray(x_codes, np.float64), cfg, curves)
    return np.clip(out, 0.0, 1.0)


def derive_snr_bound(system, raw, analog, cfg, curves):
    """Display-domain PSNR between the oracle on the quantized codes and on
    the analog signal, and the former (the rungs' reference)."""
    from .utils.fidelity import psnr

    quant = oracle_display(raw >> 4, system, cfg, curves)
    clean = oracle_display(analog, system, cfg, curves)
    return float(psnr(quant, clean, data_range=1.0)), quant


def _no_watch(rung, cfg):
    return contextlib.nullcontext()


def rung_psnrs(system, raw, ref_display, cfg, rungs=None, device="cuda", watch=None):
    """PSNR of each precision rung's ``FdOctModel.process_buffer`` output,
    from a fresh FPN state, vs the float64-oracle display reference.
    ``watch(rung, cfg)`` is a context manager around each rung's run (the
    caller's launch counts)."""
    from .bench import at_rung
    from .models.fdoct import FdOctModel
    from .utils.fidelity import psnr

    results = {}
    for rung in rungs or RUNGS:
        c = at_rung(cfg, rung)
        t0 = time.perf_counter()
        with (watch or _no_watch)(rung, c):
            model = FdOctModel(system.acq, c, **system.curve_kwargs(), device=device)
            got = np.clip(model.fetch(model.process_buffer(raw)).astype(np.float64), 0.0, 1.0)
            del model
        results[rung] = {"psnr_db": float(psnr(got, ref_display, data_range=1.0)),
                         "seconds": time.perf_counter() - t0}
    return results


def fpn_on_rung_psnrs(system, raw, cfg, curves, rungs=None, bscans_for_noise=FPN_BSCANS,
                      device="cuda", watch=None):
    """Each rung's output with FPN once enabled vs the float64 oracle
    running the same FPN chain (``tests/oracle.py`` ``min_variance_mean``,
    the tie-banded selection of ``ops/fpn.py``)."""
    cfg_on = dataclasses.replace(cfg, fpn_mode=FpnMode.ONCE, bscans_for_noise=bscans_for_noise)
    # the oracle reads the 12-bit code values; the chain's bitshift decodes
    # the <<4 container
    ref = np.clip(oracle_volume(np.asarray(raw >> 4, np.float64), cfg_on, curves,
                                fpn_lines=bscans_for_noise * system.acq.ascans_per_bscan),
                  0.0, 1.0)
    return rung_psnrs(system, raw, ref, cfg_on, rungs, device, watch)


def cli_compare_gate(system, raw, cfg, ref_path, work_dir, min_psnr, device="cuda",
                     watch=None):
    """The port's ``compare`` command as the pass/fail gate: the volume at
    ``matmul_precision="highest"``, saved, against the oracle volume at
    ``ref_path`` with ``--min-psnr`` the bound (to 0.1 dB)."""
    from .cli import main as cli_main
    from .models.fdoct import FdOctModel

    c = dataclasses.replace(cfg, matmul_precision="highest")
    with (watch or _no_watch)("highest (cli compare)", c):
        model = FdOctModel(system.acq, c, **system.curve_kwargs(), device=device)
        out = model.fetch(model.process_buffer(raw))
        del model
    got_path = os.path.join(work_dir, "fullgeom_highest.raw")
    np.clip(out.astype(np.float32), 0.0, 1.0).tofile(got_path)
    acq = system.acq
    argv = ["compare", got_path, ref_path,
            "--bscans", str(acq.bscans_per_buffer),
            "--ascans", str(acq.ascans_per_bscan),
            "--depth", str(acq.output_ascan_length),
            "--data-range", "1.0", "--clip01",
            "--min-psnr", str(round(min_psnr, 1))]
    rc = cli_main(argv)
    return {"argv": argv, "returncode": rc, "passed": rc == 0}


def _platform(device) -> dict:
    """The report's platform keys: "gpu" with the card's name and power
    limit (nvidia-smi), or "cpu"."""
    import torch

    if torch.device(device).type != "cuda":
        return {"platform": "cpu"}
    from .bench import device_info

    info = device_info()
    return {"platform": "gpu", "device_name": info["device_name"],
            "power_limit": info["power_limit"], "nvidia_smi": info["nvidia_smi"]}


def run(samples=1024, ascans=512, bscans=256, out_json=None, save_pair_dir=None, rungs=None,
        device="cuda", watch=None, log=None):
    """The anchor: the bound, the rungs with FPN off and on, and with
    ``save_pair_dir`` the input/oracle pair and the ``cli compare`` gate.
    Returns the report (the JAX script's keys; numbers unrounded)."""
    import torch

    log = log or (lambda msg: print(msg, file=sys.stderr))
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("fullgeom_fidelity: no CUDA device (pass device='cpu' for the "
                           "kernels' plain versions)")
    t0 = time.perf_counter()
    system, raw, analog = device_and_volumes(samples, ascans, bscans)
    cfg = anchor_config(system)
    curves = host_curves(system, cfg)
    log(f"volume generated in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    bound_db, ref_display = derive_snr_bound(system, raw, analog, cfg, curves)
    del analog
    log(f"SNR bound: {bound_db:.4f} dB ({time.perf_counter() - t0:.1f} s)")

    rr = rung_psnrs(system, raw, ref_display, cfg, rungs=rungs, device=device, watch=watch)
    for r in rr.values():
        r["within_reference_snr_bound"] = bool(r["psnr_db"] >= bound_db)
    log(f"FPN-off rungs: { {k: round(v['psnr_db'], 2) for k, v in rr.items()} }")

    t0 = time.perf_counter()
    rr_fpn = fpn_on_rung_psnrs(system, raw, cfg, curves, rungs=rungs, device=device,
                               watch=watch)
    for r in rr_fpn.values():
        r["within_reference_snr_bound"] = bool(r["psnr_db"] >= bound_db)
    log(f"FPN-on rungs: { {k: round(v['psnr_db'], 2) for k, v in rr_fpn.items()} } "
        f"({time.perf_counter() - t0:.1f} s with the oracle)")

    report = {
        **_platform(device),
        "platform_note": (
            "rung PSNRs measure the port's numerics on this device; on the card "
            "'default' is a float32 product (the operator's three bf16 parts against "
            "x_hi + x_lo on the tensor cores), 'high' and 'highest' the split rungs, "
            "'bfloat16' one rounded bf16 term"),
        "geometry": {"samples": samples, "ascans": ascans, "bscans": bscans},
        "anchor": "PhytoDeviceModel physics volume (io/phytooct.py), unidirectional, "
                  "sinusoidal scan, factory k-lin curve, FPN off",
        "snr_bound_db": bound_db,
        "snr_bound_definition": (
            "display-domain PSNR between the float64 oracle on the 12-bit quantized "
            "codes and on the analog interferogram: the acquisition quantization-noise "
            "floor in the reference's output units (processing.md:134-146 scaling)"),
        "rungs": rr,
        "rungs_fpn_on": rr_fpn,
        "fpn_on_note": (
            f"end-to-end PSNR with FPN once enabled ({FPN_BSCANS} B-scans), the oracle "
            "running the same tie-banded minimum-variance selection (ops/fpn.py)"),
    }

    if save_pair_dir:
        os.makedirs(save_pair_dir, exist_ok=True)
        raw_path = os.path.join(save_pair_dir, "fullgeom_input.raw")
        ref_path = os.path.join(save_pair_dir, "fullgeom_oracle.raw")
        raw.tofile(raw_path)
        ref_display.astype(np.float32).tofile(ref_path)
        report["pair"] = {"input": raw_path, "oracle": ref_path}
        report["cli_compare"] = cli_compare_gate(system, raw, cfg, ref_path, save_pair_dir,
                                                 min_psnr=bound_db, device=device, watch=watch)

    if out_json:
        with open(out_json, "w") as f:
            json.dump(report, f, indent=1)
    return report


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--small", action="store_true",
                   help="256x64x8 quick run (the CPU tests' geometry)")
    p.add_argument("--out", default=None, help="write the report here as JSON")
    p.add_argument("--save-pair", default=None,
                   help="directory for the input/oracle .raw pair (also runs the cli "
                        "compare gate)")
    p.add_argument("--device", default="cuda", help="torch device (default cuda:0)")
    args = p.parse_args(argv)
    geometry = (256, 64, 8) if args.small else (1024, 512, 256)
    report = run(*geometry, out_json=args.out, save_pair_dir=args.save_pair,
                 device=args.device)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
