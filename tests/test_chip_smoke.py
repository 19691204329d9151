"""``chip_smoke.py`` pieces that run without a GPU: its numpy reference of
the flagship operator, its command line and output format, its refusal to
run on the CPU, and the compile-cache helper it shares with the benchmarks.
"""
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke as cs
from jets_tpu.models.seismic import make_seismic_problem
from jets_tpu.solvers import lsqr

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("grid,nshots,nrecv",
                         [((40, 36), 6, 64), ((12, 10, 14), 4, 27)])
def test_reference_matches_operator(grid, nshots, nrecv):
    """The numpy float64 reference reproduces the flagship's forward and
    adjoint (float64 operator, so agreement is to roundoff)."""
    A, m, d = make_seismic_problem(grid, nshots, nrecv, noise=0.05,
                                   dtype=jnp.float64)
    ref = cs.FlagshipReference.of(A)
    assert ref.rcv.shape == (nrecv,) and ref.wr.shape == (nshots, nrecv)
    want = ref.forward(np.asarray(m))
    assert np.max(np.abs(want)) > 0.0
    np.testing.assert_allclose(np.asarray(A(m)), want, rtol=1e-12,
                               atol=1e-12 * np.max(np.abs(want)))
    adj = ref.adjoint(np.asarray(d))
    assert np.max(np.abs(adj)) > 0.0
    np.testing.assert_allclose(np.asarray(A.H(d)), adj, rtol=1e-12,
                               atol=1e-12 * np.max(np.abs(adj)))


def test_reference_lsqr_matches_jets_lsqr():
    """scipy's LSQR on the reference and ``jets_tpu.solvers.lsqr`` on the
    operator reach the same residual after the same iteration count."""
    A, _, d = make_seismic_problem((32, 32), 4, 64, noise=0.05,
                                   dtype=jnp.float64)
    ref = cs.FlagshipReference.of(A)
    x = np.asarray(lsqr(A, d, maxiter=25, tol=0.0).x)
    xs = ref.scipy_lsqr(np.asarray(d), 25)
    rr = cs.rel_err(ref.forward(x), np.asarray(d))
    rs = cs.rel_err(ref.forward(xs), np.asarray(d))
    assert 0.0 < rs < 1.0
    assert abs(rr - rs) < 1e-8, (rr, rs)


def test_np_laplacian_is_self_adjoint_with_zero_boundary():
    rng = np.random.default_rng(0)
    a, b = rng.standard_normal((2, 7, 9, 5))
    assert abs(np.sum(cs.np_laplacian(a) * b)
               - np.sum(a * cs.np_laplacian(b))) < 1e-10
    one = np.zeros((5, 5))
    one[0, 0] = 1.0
    lap = cs.np_laplacian(one)
    assert lap[0, 0] == -4.0 and lap[0, 1] == lap[1, 0] == 1.0


@pytest.mark.parametrize("argv,phases", [
    ([], ("A", "B", "C", "D")),
    (["--four-cards"], ("four_cards",)),
])
def test_phase_selection(argv, phases):
    assert cs.select_phases(argv) == phases
    assert set(phases) <= set(cs.PHASES)


def test_result_line_format():
    dev = SimpleNamespace(platform="gpu", device_kind="NVIDIA H100 80GB HBM3")
    line = cs.result_line(dev, 4)
    assert "\n" not in line
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4}}


def test_refuses_to_run_without_a_gpu(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert "no GPU" in out.stderr
    for line in out.stdout.splitlines():
        assert not line.lstrip().startswith("{"), line


@pytest.mark.parametrize("at_least,value,limit,ok", [
    (False, 1e-6, 1e-5, True), (False, 2e-5, 1e-5, False),
    (True, 0.9995, 0.999, True), (True, 0.99, 0.999, False),
])
def test_check_raises_on_violation(at_least, value, limit, ok):
    if ok:
        cs.check("x", value, limit, at_least=at_least)
    else:
        with pytest.raises(AssertionError):
            cs.check("x", value, limit, at_least=at_least)


def test_assert_live_rejects_a_zero_signal():
    cs.assert_live("ok", np.array([0.0, 1e-30]))
    with pytest.raises(AssertionError, match="vacuous"):
        cs.assert_live("zero", np.zeros(4))


def test_all_cards_check_needs_a_shard_on_every_device():
    from jets_tpu.parallel.sharded import make_block_mesh, shard_blocks

    devs = jax.devices()[:4]
    x = shard_blocks(jnp.zeros((8, 3)), make_block_mesh(4))
    cs._check_all_cards_hold("sharded", devs, [None] * 4, x)
    with pytest.raises(AssertionError, match="no shard"):
        cs._check_all_cards_hold("one card", devs, [None] * 4,
                                 jax.device_put(jnp.zeros(3), devs[0]))


_CACHE_PROBE = (
    "import jax; from jets_tpu.utils.compile_cache import "
    "enable_compile_cache; p = enable_compile_cache(); "
    "print(p); print(jax.config.jax_compilation_cache_dir)")


@pytest.mark.parametrize("env_dir", [True, False])
def test_compile_cache_location(tmp_path, env_dir):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "cc")
    out = subprocess.run([sys.executable, "-c", _CACHE_PROBE], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    reported, configured = out.stdout.split()
    want = str(tmp_path / "cc") if env_dir else str(ROOT / ".jax_cache")
    assert reported == configured == want
