"""The port's scaling harness (``octproz_tpu_torch.scaling``) against the
JAX harness (``benchmarks/scaling.py``) on the CPU: the sweep's rows carry
the JAX rows' keys plus ``shared_device`` and each mesh's distance to the
single-device step (held to tests/test_torch_sharding.py's 2e-4), the
traffic report's tallies and efficiency model equal the JAX report's on
the same three meshes and inputs, the gloo anchor runs two real process
worlds (checked as tests/test_benchmarks.py checks the JAX anchor), and no
TPU figure is a default."""

import ast
import dataclasses
import inspect
import json
import os
import sys

import pytest
import torch

import octproz_tpu.params as jparams
from octproz_tpu_torch import latency, scaling
from octproz_tpu_torch.parallel import make_mesh, make_simulated_multihost_mesh
from octproz_tpu_torch.params import AcqParams

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_SCALING = os.path.join(ROOT, "benchmarks", "scaling.py")
sys.path.insert(0, os.path.dirname(JAX_SCALING))
import scaling as jscaling  # noqa: E402  (benchmarks/scaling.py)
from torch_threads import one_torch_thread  # noqa: E402,F401  (autouse: one intra-op thread)

ACQ = AcqParams(samples_per_line=256, ascans_per_bscan=32, bscans_per_buffer=8, bit_depth=12)
CPUS = [torch.device("cpu")] * 8
SMALL = ["--device", "cpu", "--samples", "256", "--ascans", "32", "--bscans", "8"]
#: The JAX report's links (ICI, DCN) and their latency floors, as the port's
#: model takes them.
JAX_LINKS = (("ici", 100.0, 10e-6, "given"), ("dcn", 25.0, 100e-6, "given"))


def _jax(obj):
    if isinstance(obj, AcqParams):
        return jparams.AcqParams(**dataclasses.asdict(obj))
    enums = {"fpn_mode": jparams.FpnMode, "interpolation": jparams.Interpolation}
    return jparams.ProcConfig(**{
        f.name: (enums[f.name](getattr(obj, f.name).value) if f.name in enums
                 else getattr(obj, f.name)) for f in dataclasses.fields(obj)})


def _jax_function(name):
    tree = ast.parse(open(JAX_SCALING).read(), JAX_SCALING)
    return next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == name)


def _jax_row_keys():
    """The keys of a JAX sweep row (``rec = dict(label, ...)``), without the
    label's."""
    (assign,) = [a for a in ast.walk(_jax_function("run_scaling")) if isinstance(a, ast.Assign)
                 and getattr(a.targets[0], "id", None) == "rec"]
    return {k.arg for k in assign.value.keywords}


def test_chain_and_curves_are_the_jax_harnesss():
    (call,) = [c for c in ast.walk(_jax_function("main")) if isinstance(c, ast.Call)
               and getattr(c.func, "id", None) == "ProcConfig"]
    space = dict(ProcConfig=jparams.ProcConfig, FpnMode=jparams.FpnMode,
                 Interpolation=jparams.Interpolation)
    want = eval(compile(ast.Expression(call), JAX_SCALING, "eval"), space)
    assert _jax(scaling.scaling_config()) == want
    curves = [c for c in ast.walk(_jax_function("run_scaling")) if isinstance(c, ast.Call)
              and getattr(c.func, "attr", None) == "make_curves"]
    kw = {k.arg: eval(compile(ast.Expression(k.value), JAX_SCALING, "eval"), {"acq": ACQ})
          for k in curves[0].keywords}
    assert kw == scaling.curve_kwargs(ACQ)


@pytest.mark.parametrize("sizes", [(1, 2, 4)])
def test_virtual_sweep_rows_and_parity(sizes):
    """1, 2 and 4 repeats of the CPU: the JAX rows' keys plus
    ``shared_device`` (true) and ``max_abs_diff``, each mesh's last steady
    output within 2e-4 of the single-device step's."""
    builders = [({"mesh": f"{n}x1"}, lambda n=n: make_mesh(n, 1, devices=CPUS[:n]))
                for n in sizes]
    rows = scaling.run_scaling(builders, ACQ, scaling.scaling_config(), n_iters=2,
                               shared_device=True)
    assert [r["devices"] for r in rows] == list(sizes)
    for r in rows:
        assert set(r) == _jax_row_keys() | {"mesh", "shared_device", "max_abs_diff"}
        assert r["shared_device"] is True
        assert r["max_abs_diff"] <= 2e-4
        assert r["ascans_per_s"] > 0 and r["ms_per_buffer"] > 0
    assert rows[0]["scaling_efficiency"] == 1.0


def test_parity_catches_a_wrong_mesh(monkeypatch):
    """A sharded step whose output is off shows in ``max_abs_diff``."""
    from octproz_tpu_torch import parallel

    real = parallel.make_sharded_step

    def off(acq, cfg, mesh):
        step = real(acq, cfg, mesh)

        def wrong(raw, curves, state):
            out, state = step(raw, curves, state)
            return out.map(lambda t: t + 1e-3), state

        return wrong

    monkeypatch.setattr(parallel, "make_sharded_step", off)
    (row,) = scaling.run_scaling([({"mesh": "2x1"}, lambda: make_mesh(2, 1, devices=CPUS[:2]))],
                                 ACQ, scaling.scaling_config(), n_iters=1)
    assert row["max_abs_diff"] == pytest.approx(1e-3, rel=1e-3)


def test_default_sweep_on_the_cpu_is_one_row(capsys):
    """Without --virtual the sweep runs over the machine's devices: on the
    CPU one 1x1 row, not shared."""
    assert scaling.main(SMALL + ["--iters", "2"]) == 0
    (line,) = capsys.readouterr().out.strip().splitlines()
    row = json.loads(line)
    assert row["mesh"] == "1x1" and row["devices"] == 1 and row["shared_device"] is False


def test_hosts_sweep(capsys):
    """``--virtual --hosts 2`` over the 8 repeats: a 4-position mesh, then
    the (2, 4, 1) host mesh, as the JAX ``--hosts`` sweep builds them."""
    assert scaling.VIRTUAL_REPEATS == 8
    assert scaling.main(SMALL + ["--virtual", "--hosts", "2", "--iters", "2"]) == 0
    rows = [json.loads(l) for l in capsys.readouterr().out.strip().splitlines()]
    assert [(r["hosts"], r["devices"]) for r in rows] == [(1, 4), (2, 8)]
    assert all(r["shared_device"] and r["max_abs_diff"] <= 2e-4 for r in rows)


def test_traffic_report_equals_jax(tmp_path):
    """The three meshes' tallies (the port's ``all_reduce`` is JAX's HLO
    ``all-reduce``), the expected FPN reduction, and the efficiency model
    with the JAX report's links and latency floors."""
    cfg = scaling.scaling_config()
    got = scaling.run_traffic_report(ACQ, cfg, 1.7e-3, str(tmp_path / "port.json"), CPUS,
                                     links=JAX_LINKS)
    want = jscaling.run_traffic_report(_jax(ACQ), _jax(cfg), 1.7e-3,
                                       str(tmp_path / "jax.json"))
    assert set(got["meshes"]) == set(want["meshes"]) == {"bscan8", "host2x4", "bscan4_ascan2"}
    for name, w in want["meshes"].items():
        assert got["meshes"][name]["by_op"] == {k.replace("-", "_"): v
                                                for k, v in w["by_op"].items()}
        assert got["meshes"][name]["total_bytes"] == w["total_bytes"] == 13824
    assert got["expected_fpn_psum_bytes"] == want["expected_fpn_psum_bytes"]
    for name in ("ici", "dcn"):
        g, w = got["efficiency_model"][name], want["efficiency_model"][name]
        for key in ("link_gbps", "latency_floor_s", "fpn_once", "fpn_continuous"):
            assert g[key] == w[key], (name, key)
    assert got["predicted_efficiency"]["fpn_once_dcn"] == \
        want["predicted_efficiency"]["fpn_once_dcn"]
    assert json.loads((tmp_path / "port.json").read_text()) == got


def test_traffic_report_default_links_are_published(tmp_path, capsys):
    """``--traffic`` on the CPU with a given compute time: NVLink and NDR
    InfiniBand at their published rates, labelled so, no latency floor."""
    out = tmp_path / "t.json"
    assert scaling.main(SMALL + ["--traffic", str(out), "--compute-ms", "1.5"]) == 0
    rep = json.loads(out.read_text())
    assert rep["compute_s_per_buffer"] == 1.5e-3 and "given" in rep["compute_source"]
    links = rep["efficiency_model"]
    assert (links["nvlink"]["link_gbps"], links["infiniband"]["link_gbps"]) == (900.0, 50.0)
    for link in links.values():
        assert "published, not measured" in link["source"] and link["latency_floor_s"] == 0.0
    assert set(rep["predicted_efficiency"]) == {"note", "fpn_once_infiniband",
                                                "fpn_continuous_infiniband"}
    assert rep["devices"] == ["cpu"] * 8


def test_a_given_link_rate_is_labelled_given():
    """A rate other than the published one is the caller's, and no link
    has a latency floor."""
    nvlink, infiniband = scaling.default_links(500.0)
    assert nvlink == ("nvlink", 500.0, 0.0, "given")
    assert infiniband == ("infiniband", 50.0, 0.0, "published, not measured")


def test_traffic_on_the_cpu_needs_a_compute_time(tmp_path):
    with pytest.raises(SystemExit) as e:
        scaling.main(SMALL + ["--traffic", str(tmp_path / "t.json")])
    assert e.value.code not in (0, None)


def test_no_tpu_figure_is_a_default():
    """No 1.463 ms compute default (the JAX report's TPU headline), no
    100 / 25 GB/s link and no 10 / 100 us latency floor (the TPU's ICI and
    DCN) in the port's harnesses."""
    defaults = {a.dest: a.default for a in scaling.build_parser()._actions}
    assert defaults["compute_ms"] is None
    assert defaults["nvlink_gbps"] == scaling.NVLINK_GBPS == 900.0
    assert defaults["infiniband_gbps"] == scaling.INFINIBAND_GBPS == 50.0
    for link in scaling.default_links():
        assert link[1] not in (100.0, 25.0) and link[2] not in (10e-6, 100e-6)
    for module in (scaling, latency):
        assert "1.463" not in inspect.getsource(module)


def test_cuda_without_a_card_exits_nonzero(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        scaling.main(["--virtual"])
    assert e.value.code not in (0, None)


def test_launch_ranks_reports_a_failed_rank():
    """A rank that exits nonzero fails the launch with its stderr's tail;
    the others' stdout comes back in order when all succeed."""
    ok = (["json.tool", "--help"], 0, 1)
    assert len(scaling.launch_ranks([ok, ok], 120, "pair")) == 2
    with pytest.raises(RuntimeError, match=r"(?s)pair: rank 1 of 2 failed .*No module named"):
        scaling.launch_ranks([(["json.tool", "--help"], 0, 2),
                              (["no_such_module_here"], 1, 2)], 120, "pair")


def test_launch_ranks_kills_a_stalled_rank():
    """Past the deadline every process is killed and the launch fails."""
    with pytest.raises(RuntimeError, match="did not finish within 2 s"):
        scaling.launch_ranks([(["http.server", "--help"], 0, 1),
                              (["timeit", "-n", "1", "import time; time.sleep(60)"], 1, 2)],
                             2, "stall")


def test_simulated_host_mesh_in_the_report_is_the_jax_layout():
    """The report's host2x4 mesh is (host 2, bscan 4, ascan 1), as JAX's."""
    mesh = make_simulated_multihost_mesh(2, 4, 1, devices=CPUS)
    assert mesh.shape == {"host": 2, "bscan": 4, "ascan": 1}


def test_gloo_anchor_measured_ratio(tmp_path, capsys):
    """One pair on the CPU (iters 6): one process with a 2-position mesh,
    then two processes of one position each over gloo; structural checks
    only, as for the JAX anchor -- wall-clock ratios on a loaded shared
    CPU are arbitrarily noisy."""
    out = tmp_path / "anchor.json"
    assert scaling.main(SMALL + ["--gloo-anchor", str(out), "--iters", "6", "--pairs", "1",
                                 "--timeout", "300"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec == json.loads(out.read_text())
    pair = rec["pairs"][0]
    assert pair["one_process_2dev"]["devices"] == 2 and pair["one_process_2dev"]["hosts"] == 1
    assert pair["two_process_gloo"]["hosts"] == 2 and pair["two_process_gloo"]["devices"] == 2
    assert pair["one_process_2dev"]["via"] == pair["two_process_gloo"]["via"] == "gloo"
    ranks = pair["two_process_ranks"]
    assert [r["process"] for r in ranks] == [0, 1]
    assert pair["two_process_gloo"] == min(ranks, key=lambda r: r["ascans_per_s"])
    assert pair["ratio"] == pair["two_process_gloo"]["ascans_per_s"] \
        / pair["one_process_2dev"]["ascans_per_s"]
    assert rec["measured_protocol_ratio"] > 0
    assert "measured" in rec["note"]
