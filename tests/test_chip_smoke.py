"""chip_smoke.py off the card: it must refuse to run and print no result,
and its gates must reject the faults they exist to catch."""

import importlib.util
import json
import os
import pathlib
import subprocess
import sys
from typing import NamedTuple

import numpy as np
import pytest

_ROOT = pathlib.Path(__file__).resolve().parents[1]


def _load():
    spec = importlib.util.spec_from_file_location("chip_smoke", _ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_device_check_raises_on_cpu():
    with pytest.raises(SystemExit, match="no GPU"):
        _load().device_check()


def test_script_exits_nonzero_without_a_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, str(_ROOT / "chip_smoke.py")],
                         cwd=_ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    for line in out.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)


def test_tolerances_state_their_reason():
    tol = _load().TOL
    assert {"route_du", "route_dj", "route_dx", "forks", "block_forks",
            "loop_forks", "loop_block_forks", "head_du", "rel_dj", "loop_dx",
            "agree", "unc"} == set(tol)
    for lim, why in tol.values():
        assert lim > 0 and len(why) > 20


class _Solve(NamedTuple):
    U: np.ndarray
    J: np.ndarray


def _two_routes(B=1024, seed=0):
    """Two float32-like solves that differ in the last bits on every lane."""
    rng = np.random.default_rng(seed)
    U = rng.normal(0.0, 1.0, (B, 50, 2))
    J = rng.uniform(50.0, 200.0, B)
    other = _Solve(U + rng.normal(0.0, 1e-5, U.shape), J * (1 + 1e-6))
    return _Solve(U, J), other


@pytest.mark.parametrize("fault", ["none", "one_lane", "sparse_forks"])
def test_route_gate_passes_summation_order_and_forks(fault):
    smoke = _load()
    want, got = _two_routes()
    if fault == "one_lane":
        got.U[300, :10] += 0.3
    elif fault == "sparse_forks":
        got.U[::256, :10] += 0.3  # 4 of 1024 lanes, one per 256
    apart = smoke.compare_routes("routes", got, want)
    assert apart.sum() == {"none": 0, "one_lane": 1, "sparse_forks": 4}[fault]


@pytest.mark.parametrize("fault", ["one_program", "every_program_lane_0",
                                   "cost_only", "half_the_lanes"])
def test_route_gate_rejects_a_faulty_kernel(fault):
    """A fault confined to lanes the float64 sample would rarely touch: one
    whole 64-lane program, one lane of every program, a J that alone is
    wrong, or half of every program."""
    smoke = _load()
    want, got = _two_routes()
    if fault == "one_program":
        got.U[128:192, :10] += 0.05
    elif fault == "every_program_lane_0":
        got.U[::64, :10] += 0.05
    elif fault == "cost_only":
        got.J[640:704] *= 1.01
    else:
        got.U.reshape(16, 64, 50, 2)[:, 32:, :10] += 0.05
    with pytest.raises(AssertionError):
        smoke.compare_routes("routes", got, want)


@pytest.mark.parametrize("kind", ["loop_ok", "loop_sparse_forks",
                                  "loop_one_program", "first_cycle_one_program"])
def test_loop_route_gate(kind):
    """Closed loops: the first cycle's J of every lane to the solve limits,
    final positions to loop_dx (forks of later cycles add up there)."""
    smoke = _load()
    rng = np.random.default_rng(1)
    want = rng.normal(0.0, 50.0, (2048, 4))
    got = want + rng.normal(0.0, 1e-5, want.shape)
    J = rng.uniform(50.0, 200.0, (5, 2048))
    rec, rec_got = {"J": J}, {"J": J * (1 + 1e-6)}
    if kind == "loop_sparse_forks":
        got[::64, :2] += 0.3  # one lane in every program: 1.6%
    elif kind == "loop_one_program":
        got[1024:1088, :2] += 0.1
    elif kind == "first_cycle_one_program":
        rec_got["J"][0, 64:128] *= 1.01
    if kind in ("loop_ok", "loop_sparse_forks"):
        forks = smoke.compare_loop_routes("loops", got, rec_got, want, rec)
        assert forks.sum() == (0 if kind == "loop_ok" else 32)
    else:
        with pytest.raises(AssertionError):
            smoke.compare_loop_routes("loops", got, rec_got, want, rec)


@pytest.mark.parametrize("case", ["fork_on_both", "gpu_only_fork", "gpu_only"])
def test_float64_gate_blames_only_the_gpu_route(case):
    """A lane apart from float64 passes only when the float32 XLA route is
    apart too, or the two float32 routes already differ there (a fork)."""
    smoke = _load()
    lanes = np.arange(64)
    d = np.full(64, 1e-3)
    ok = np.ones(64, bool)
    d32, ok32 = d.copy(), ok.copy()
    forks = np.zeros(64, bool)
    d[5], ok[5] = 0.4, False
    if case == "fork_on_both":
        d32[5], ok32[5] = 0.4, False
    elif case == "gpu_only_fork":
        forks[5] = True
    failed = np.zeros(64, bool)
    if case == "gpu_only":
        with pytest.raises(AssertionError, match="GPU route only"):
            smoke.compare_with_f64("f64", lanes, d, ok, d32, ok32, forks, failed)
    else:
        smoke.compare_with_f64("f64", lanes, d, ok, d32, ok32, forks, failed)


def test_sample_lanes_add_failed_lanes():
    smoke = _load()
    failed = np.zeros(32768, bool)
    failed[[5, 1246, 30001]] = True
    lanes = smoke.sample_lanes(32768, failed)
    assert {0, 32767, 5, 1246, 30001} <= set(lanes.tolist())
    assert lanes.size == smoke.N_REF + 3
    many = np.ones(32768, bool)
    assert smoke.sample_lanes(32768, many).size <= smoke.N_REF + smoke.N_REF_FAILED
