"""The port's design-space exploration (``repro_torch.dse``: ``cache``,
``sweep``, ``search``, the CLI; copies of the JAX package's) against the
JAX one on the CPU, on the cases of ``tests/test_dse.py`` and
``tests/test_dse_fast.py`` at their own small axes and sequence lengths:
sweep rows, Pareto frontiers, knees, search rungs and artifacts equal
JAX's by ``to_dict``, with and without a ``CalibrationReport``; the
fingerprints and cache keys equal JAX's; rows from worker processes equal
serial rows byte for byte; ``python -m repro_torch.dse --json`` writes
``python -m repro.dse``'s artifact."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro import dse as jdse
from repro.configs import registry as jregistry
from repro.configs.hardware import HardwareConfig as JHardwareConfig
from repro.configs.hardware import STREAMDCIM_BASE as J_BASE
from repro.dse import __main__ as jcli
from repro.plan import plan_model as jplan_model
from repro.sim.replay import CalibrationReport as JCalibrationReport
from repro_torch.configs import registry
from repro_torch.configs.hardware import (HW_PRESETS, HardwareConfig,
                                          STREAMDCIM_BASE)
from repro_torch.dse import (Axes, SimCache, SweepRow, dominates,
                             energy_fingerprint, grid_points, hw_fingerprint,
                             pareto_frontier, resolve_plan_json, run_sweep,
                             sample_space, sim_cache_key, simulate_point,
                             successive_halving, utilization_knee)
from repro_torch.plan import plan_model
from repro_torch.plan.planner import ExecutionPlan
from repro_torch.sim import simulate_plan
from repro_torch.sim.replay import KERNEL_TRACE_VERSION, CalibrationReport

ROOT = Path(__file__).resolve().parents[1]
SEQ = 1024          # tests/test_dse.py's
FAST_SEQ = 512      # tests/test_dse_fast.py's
SMALL = dict(groups=((2, 1), (4, 2), (8, 4)), rewrite_bus_bits=(512,),
             ping_pong=(True,))
GRID = dict(groups=((2, 1), (4, 2), (8, 4)), rewrite_bus_bits=(512, 1024),
            ping_pong=(True, False))
FAST_KW = dict(models=["whisper-base"], seq_lens=(FAST_SEQ,),
               include_presets=False)
# A calibration report of the kind phase 18 of chip_smoke.py fits on the
# card (the numbers are made up here: only their use is compared).
CALIBRATION = json.dumps({
    "version": KERNEL_TRACE_VERSION, "name": "vilbert-base/tile_stream",
    "model": "vilbert-base", "hw": "streamdcim-base", "clock_hz": 1e9,
    "per_class": {"attention": {"count": 12, "ratio": 0.5}},
    "scale": {"ATTN": 0.4, "GEN": 1.7, "HBM": 1.25}})


def _rows(result):
    return [r.to_dict() for r in result.rows]


def _both(**kw):
    """run_sweep in the port and in JAX with the same arguments; the
    ``axes`` entry is a dict of Axes fields, built in each package."""
    axes = kw.pop("axes", None)
    got = run_sweep(**kw, **({"axes": Axes(**axes)} if axes else {}))
    want = jdse.run_sweep(**kw,
                          **({"axes": jdse.Axes(**axes)} if axes else {}))
    return got, want


def _same(got, want):
    assert _rows(got) == _rows(want)
    assert got.skipped == want.skipped
    assert got.to_dict() == want.to_dict()
    assert {k: r.to_dict() for k, r in got.knees().items()} == \
        {k: r.to_dict() for k, r in want.knees().items()}
    assert [r.to_dict() for r in got.pareto()] == \
        [r.to_dict() for r in want.pareto()]


@pytest.fixture(scope="module")
def sweep():
    got, want = _both(models=["vilbert-base", "whisper-base"], axes=SMALL,
                      seq_lens=(SEQ,), include_presets=False)
    _same(got, want)
    return got


# ------------------------------------------------------ sweep construction

def test_sweep_constructor_validates_and_names_as_jax():
    for kw, match in ((dict(num_groups=2, gen_groups=3), "gen_groups"),
                      (dict(rewrite_bus_bits=100), "multiple of 8"),
                      (dict(num_groups=0, gen_groups=0),
                       "num_groups must be > 0"),
                      (dict(nmu_groups=8), "unknown")):
        with pytest.raises(ValueError, match=match):
            HardwareConfig.sweep(**kw)
    for kw in (dict(num_groups=8, gen_groups=4, rewrite_bus_bits=1024),
               dict(ping_pong=True), dict(ping_pong=False)):
        assert dataclasses.asdict(HardwareConfig.sweep(**kw)) == \
            dataclasses.asdict(JHardwareConfig.sweep(**kw))
    assert HardwareConfig.sweep(num_groups=8, gen_groups=4,
                                rewrite_bus_bits=1024).name == \
        "streamdcim-base/g8-gg4-bus1024"


@pytest.mark.parametrize("axes", [
    None, SMALL, GRID,
    dict(groups=((2, 1), (2, 2)), rewrite_bus_bits=(512,),
         ping_pong=(True,)),
    dict(groups=((4, 2),), rewrite_bus_bits=(512,), ping_pong=(True,),
         extra={"macros_per_group": (8, 16)})])
def test_grid_points_equal_jax(axes):
    presets = tuple(HW_PRESETS.values())
    jpresets = tuple(jregistry.HW_CONFIGS.values())
    got = grid_points(presets=presets,
                      **({"axes": Axes(**axes)} if axes else {}))
    want = jdse.grid_points(presets=jpresets,
                            **({"axes": jdse.Axes(**axes)} if axes else {}))
    assert [dataclasses.asdict(p) for p in got[0]] == \
        [dataclasses.asdict(p) for p in want[0]]
    assert got[1] == want[1]
    if axes is None:
        assert [p.name for p in got[0]][:3] == list(HW_PRESETS)


def test_extra_axes_reject_builtin_collisions():
    with pytest.raises(ValueError, match="collide"):
        Axes(groups=((8, 4),), extra={"num_groups": (2,)})
    axes = Axes(groups=((4, 2),), rewrite_bus_bits=(512,),
                ping_pong=(True,), extra={"macros_per_group": (8, 16)})
    assert [ov["macros_per_group"] for ov in axes.overrides()] == [8, 16]


# --------------------------------------------------------------- sweep rows

def test_sweep_rows_carry_full_record(sweep):
    assert len(sweep.rows) == 2 * 3
    for row in sweep.rows:
        assert row.latency_cycles > 0 and row.energy_pj > 0
        assert row.edp == pytest.approx(row.energy_pj * row.latency_cycles)
        assert 0.0 < row.utilization["ATTN"] <= 1.0
        assert sum(row.energy_by_resource.values()) == pytest.approx(
            row.energy_pj)
        assert ExecutionPlan.from_json(row.plan_json).model == row.model
        json.dumps(row.to_dict())


def test_pareto_frontier_and_knee(sweep):
    for model in sweep.models():
        frontier, rows = sweep.pareto(model), sweep.rows_for(model)
        assert frontier
        for f in frontier:
            assert not any(dominates(r, f) for r in rows)
        for r in rows:
            if r not in frontier:
                assert any(dominates(f, r) for f in frontier)
    rows = sweep.rows_for("vilbert-base")
    knee = utilization_knee(rows, tolerance=0.10)
    best = min(r.latency_cycles for r in rows)
    assert knee.latency_cycles <= 1.10 * best
    assert all(r.latency_cycles > 1.10 * best for r in rows
               if r.num_macros < knee.num_macros)
    assert utilization_knee([]) is None
    assert utilization_knee(rows, tolerance=float("inf")).num_macros == \
        min(r.num_macros for r in rows)
    assert sweep.label("vilbert-base", SEQ) == "vilbert-base"
    assert set(sweep.knees()) == {"vilbert-base", "whisper-base"}


def test_frontier_row_replays_exactly(sweep):
    row = sweep.pareto("vilbert-base")[0]
    res = simulate_plan(ExecutionPlan.from_json(row.plan_json))
    rep = res.energy(registry.get_energy_model(row.energy_model))
    assert (res.cycles, rep.total_pj, rep.edp, res.hbm_bytes) == \
        (row.latency_cycles, row.energy_pj, row.edp, row.hbm_bytes)


def test_base_not_energy_dominated_by_small_as_jax():
    cfg, jcfg = (registry.get_config("vilbert-base"),
                 jregistry.get_config("vilbert-base"))
    for name in ("streamdcim-base", "streamdcim-small"):
        assert simulate_point(cfg, HW_PRESETS[name]).to_dict() == \
            jdse.simulate_point(jcfg,
                                jregistry.HW_CONFIGS[name]).to_dict()
    base = simulate_point(cfg, HW_PRESETS["streamdcim-base"])
    small = simulate_point(cfg, HW_PRESETS["streamdcim-small"])
    assert not dominates(small, base)
    assert small.latency_cycles > base.latency_cycles


def test_multi_shape_sweep_equals_jax():
    got, want = _both(models=["whisper-base"],
                      axes=dict(groups=((4, 2),), rewrite_bus_bits=(512,),
                                ping_pong=(True,)),
                      seq_lens=(256, 1024), include_presets=False)
    _same(got, want)
    assert got.groups() == [("whisper-base", 256), ("whisper-base", 1024)]
    assert set(got.knees()) == {"whisper-base@seq256",
                                "whisper-base@seq1024"}


def test_points_budget_keeps_presets_first():
    got, want = _both(models=["whisper-base"], points=2, seq_lens=(SEQ,))
    _same(got, want)
    assert [r.hw for r in got.rows] == ["streamdcim-base",
                                        "streamdcim-small"]
    assert got.frontier_sensitivity() == {}


def test_pareto_frontier_helper_on_synthetic_rows():
    def row(lat, pj):
        return SweepRow(model="m", seq_len=0, hw=f"hw{lat}",
                        hw_params={"num_groups": 4, "macros_per_group": 16},
                        energy_model="e", latency_cycles=lat, hbm_bytes=0,
                        energy_pj=pj, edp=lat * pj, utilization={},
                        energy_by_resource={}, plan_json="{}")
    front = pareto_frontier([row(10, 50.0), row(20, 20.0), row(30, 30.0),
                             row(10, 60.0)])
    assert [(r.latency_cycles, r.energy_pj) for r in front] == \
        [(10, 50.0), (20, 20.0)]
    assert len(pareto_frontier([row(100, 5.0), row(100, 5.0),
                                row(200, 3.0)])) == 3
    assert len(pareto_frontier([row(100, 5.0), row(110, 5.0)])) == 1


@pytest.mark.parametrize("points", [3, 4])
def test_energy_axis_equals_jax(points):
    names = list(registry.ENERGY_CONFIGS)[:2 if points == 3 else None]
    got = run_sweep(models=["whisper-base"], points=points, seq_lens=(SEQ,),
                    energy_models=[registry.ENERGY_CONFIGS[n]
                                   for n in names])
    want = jdse.run_sweep(models=["whisper-base"], points=points,
                          seq_lens=(SEQ,),
                          energy_models=[jregistry.ENERGY_CONFIGS[n]
                                         for n in names])
    _same(got, want)
    assert got.frontier_sensitivity() == want.frontier_sensitivity()
    assert got.energy_models() == names
    assert len(got.rows) == points * len(names)


def test_calibrated_sweep_equals_jax():
    """The calibration axis (phase 18's record -> calibrate -> sweep on the
    card): the analytic rows equal a sweep without calibration, the
    calibrated rows JAX's under the same report, finite and positive."""
    cal = CalibrationReport.from_json(CALIBRATION)
    jcal = JCalibrationReport.from_json(CALIBRATION)
    kw = dict(models=["vilbert-base"], points=4, seq_lens=(SEQ,))
    got = run_sweep(calibrations=(None, cal), **kw)
    want = jdse.run_sweep(calibrations=(None, jcal), **kw)
    _same(got, want)
    assert got.calibrations() == ["analytic", "vilbert-base/tile_stream"]
    plain = run_sweep(**kw)
    assert [r.to_dict() for r in got.rows
            if r.calibration == "analytic"] == _rows(plain)
    for r in got.rows_for("vilbert-base",
                          calibration="vilbert-base/tile_stream"):
        assert r.latency_cycles > 0 and 0 < r.energy_pj < float("inf")
        assert r.calibration_scale == cal.scale


# ------------------------------------------------------------ cache keying

def test_fingerprints_and_cache_keys_equal_jax():
    points, _ = grid_points(axes=Axes(**GRID),
                            presets=tuple(HW_PRESETS.values()))
    jpoints, _ = jdse.grid_points(axes=jdse.Axes(**GRID),
                                  presets=tuple(
                                      jregistry.HW_CONFIGS.values()))
    plan = plan_model(registry.get_config("whisper-base"),
                      seq_len=FAST_SEQ).to_json()
    jplan = jplan_model(jregistry.get_config("whisper-base"),
                        seq_len=FAST_SEQ).to_json()
    assert plan == jplan
    for hw, jhw in zip(points, jpoints):
        assert hw_fingerprint(hw) == jdse.hw_fingerprint(jhw)
        for kw in (dict(), dict(evaluator="proxy"),
                   dict(scale={"ATTN": 2.0, "GEN": 0.5}),
                   dict(lowering="tiled")):
            assert sim_cache_key(plan, hw, **kw) == \
                jdse.sim_cache_key(jplan, jhw, **kw), kw
    for name, em in registry.ENERGY_CONFIGS.items():
        assert energy_fingerprint(em) == \
            jdse.energy_fingerprint(jregistry.ENERGY_CONFIGS[name])
    renamed = dataclasses.replace(STREAMDCIM_BASE, name="other-name")
    assert hw_fingerprint(renamed) == hw_fingerprint(STREAMDCIM_BASE)
    assert hw_fingerprint(dataclasses.replace(
        STREAMDCIM_BASE, rewrite_bus_bits=1024)) != \
        hw_fingerprint(STREAMDCIM_BASE)
    em = next(iter(registry.ENERGY_CONFIGS.values()))
    assert energy_fingerprint(dataclasses.replace(em, name="other")) != \
        energy_fingerprint(em)
    assert sim_cache_key('{"plan": 1}', J_BASE) == \
        sim_cache_key('{"plan": 1}', STREAMDCIM_BASE)


# ------------------------------------------------- cache hit == cold run

def test_cache_hits_reproduce_cold_rows_and_jax(tmp_path):
    cache = SimCache()
    cold = run_sweep(cache=cache, axes=Axes(**SMALL), **FAST_KW)
    want = jdse.run_sweep(axes=jdse.Axes(**SMALL), **FAST_KW)
    assert _rows(cold) == _rows(want)
    assert (cold.cache_stats["misses"], cold.cache_stats["hits"]) == \
        (len(cold.rows), 0)
    warm = run_sweep(cache=cache, axes=Axes(**SMALL), **FAST_KW)
    assert (warm.cache_stats["hits"], warm.cache_stats["misses"],
            warm.cache_stats["stores"]) == (len(warm.rows), 0, 0)
    assert _rows(warm) == _rows(cold)
    store = str(tmp_path / "simcache")
    run_sweep(cache=store, axes=Axes(**SMALL), **FAST_KW)
    disk = run_sweep(cache=SimCache(store), axes=Axes(**SMALL), **FAST_KW)
    assert disk.cache_stats["hits"] == len(disk.rows)
    assert disk.cache_stats["disk_hits"] > 0
    assert _rows(disk) == _rows(cold)


def test_partial_energy_folds_resimulate_and_union():
    ems = list(registry.ENERGY_CONFIGS.values())
    cache = SimCache()
    kw = dict(cache=cache, axes=Axes(**SMALL), **FAST_KW)
    run_sweep(energy_models=ems[:1], **kw)
    both = run_sweep(energy_models=ems[:2], **kw)
    assert both.cache_stats["hits"] == 0
    again = run_sweep(energy_models=ems[:2], **kw)
    assert again.cache_stats["hits"] * 2 == len(again.rows)
    first = run_sweep(energy_models=ems[:1], **kw)
    assert first.cache_stats["hits"] == len(first.rows)


# ------------------------------------------------------- parallel executor

WORKERS = """
import json, sys
from repro_torch.dse import Axes, SimCache, run_sweep
kw = dict(models=["whisper-base"], seq_lens=(512,), include_presets=False,
          axes=Axes(groups=((2, 1), (4, 2), (8, 4)), rewrite_bus_bits=(512,),
                    ping_pong=(True,)))
seen = []
serial = run_sweep(**kw)
parallel = run_sweep(workers=2, progress=lambda r: seen.append(r.hw),
                     cache=sys.argv[1], **kw)
warm = run_sweep(cache=SimCache(sys.argv[1]), **kw)
print(json.dumps({
    "serial": [r.to_dict() for r in serial.rows],
    "parallel": [r.to_dict() for r in parallel.rows],
    "warm": [r.to_dict() for r in warm.rows],
    "skipped": [serial.skipped, parallel.skipped],
    "stats": [parallel.cache_stats, warm.cache_stats],
    "progress": seen}, sort_keys=True))
"""


def test_workers_rows_byte_identical_to_serial(tmp_path):
    """run_sweep(workers=2) forks its pool from a process that imported
    torch: in a process of its own under a time limit, its rows equal the
    serial rows byte for byte (and JAX's), its progress comes in serial
    order, and its on-disk cache warms a serial sweep."""
    run = subprocess.run(
        [sys.executable, "-c", WORKERS, str(tmp_path / "simcache")],
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert run.returncode == 0, run.stderr
    out = json.loads(run.stdout)
    assert json.dumps(out["parallel"], sort_keys=True) == \
        json.dumps(out["serial"], sort_keys=True)
    assert out["skipped"][0] == out["skipped"][1]
    want = jdse.run_sweep(axes=jdse.Axes(**SMALL), **FAST_KW)
    assert out["serial"] == json.loads(json.dumps(_rows(want)))
    assert out["progress"] == [r.hw for r in want.rows]
    n = len(out["serial"])
    stats, warm = out["stats"]
    assert (stats["misses"], stats["stores"], warm["hits"]) == (n, n, n)
    assert out["warm"] == out["serial"]


# ---------------------------------------------------------- plan interning

def test_plan_interning_equals_jax():
    names = list(registry.ENERGY_CONFIGS)
    got = run_sweep(energy_models=list(registry.ENERGY_CONFIGS.values()),
                    axes=Axes(**SMALL), **FAST_KW)
    want = jdse.run_sweep(
        energy_models=[jregistry.ENERGY_CONFIGS[n] for n in names],
        axes=jdse.Axes(**SMALL), **FAST_KW)
    art = got.to_dict()
    assert art == want.to_dict()
    assert got.to_dict(intern_plans=False) == \
        want.to_dict(intern_plans=False)
    assert all("plan_json" not in rd for rd in art["rows"])
    assert len(art["plan_table"]) * len(names) == len(art["rows"])
    for rd, row in zip(art["rows"], got.rows):
        assert resolve_plan_json(art, rd) == row.plan_json


# ------------------------------------------------- successive-halving search

def test_sample_space_equals_jax():
    for seed in (7, 8):
        got, _ = sample_space(5, seed=seed)
        want, _ = jdse.sample_space(5, seed=seed)
        assert [dataclasses.asdict(p) for p in got] == \
            [dataclasses.asdict(p) for p in want]
    a, _ = sample_space(5, seed=7)
    assert [p.name for p in a[:3]] == list(registry.HW_CONFIGS)


def test_search_equals_jax_and_recovers_grid_frontier():
    kw = dict(models=["whisper-base"], seq_len=FAST_SEQ,
              include_presets=False)
    found = successive_halving(axes=Axes(**GRID), cache=SimCache(), **kw)
    want = jdse.successive_halving(axes=jdse.Axes(**GRID),
                                   cache=jdse.SimCache(), **kw)
    assert found.to_dict() == want.to_dict()
    assert [dataclasses.asdict(r) for r in found.rungs] == \
        [dataclasses.asdict(r) for r in want.rungs]
    grid = run_sweep(models=["whisper-base"], axes=Axes(**GRID),
                     seq_lens=(FAST_SEQ,), include_presets=False)
    assert sorted((r.hw, r.latency_cycles, r.energy_pj)
                  for r in found.sweep.pareto()) == \
        sorted((r.hw, r.latency_cycles, r.energy_pj) for r in grid.pareto())
    assert found.full_sims <= len(grid.rows) / 2
    assert found.space_size == len(grid.rows) == 12
    by_hw = {r.hw: r.to_dict() for r in grid.rows}
    for row in found.sweep.rows:
        assert row.to_dict() == by_hw[row.hw]
    with pytest.raises(ValueError, match="eta"):
        successive_halving(models=["whisper-base"], eta=1)


# --------------------------------------------------------------------- CLI

@pytest.mark.parametrize("extra", [[], ["--calibration"]])
def test_cli_writes_jax_artifact(tmp_path, capsys, extra):
    """``python -m repro_torch.dse --points 2 --models vilbert-base --json``
    (run as a module; with ``--calibration`` reading a CalibrationReport)
    writes ``python -m repro.dse``'s artifact and prints its tables."""
    argv = ["--points", "2", "--models", "vilbert-base", "--seq",
            str(SEQ)]
    if extra:
        cal = tmp_path / "calibration.json"
        cal.write_text(CALIBRATION)
        argv += ["--calibration", str(cal)]
    jcli.main(argv + ["--json", str(tmp_path / "jax.json")])
    jtext = capsys.readouterr().out
    out = tmp_path / "port.json"
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.dse", *argv, "--json", str(out)],
        capture_output=True, text=True, timeout=120, cwd=tmp_path,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert run.returncode == 0, run.stderr
    assert json.loads(out.read_text()) == \
        json.loads((tmp_path / "jax.json").read_text())
    assert run.stdout == jtext
