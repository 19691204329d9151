"""Checks that need the card: the main paths compiled for the GPU against
the host CPU in the same process. They skip where JAX has no GPU; run them
on one with ``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke as cs


@pytest.fixture
def gpu():
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs a GPU (JAX_PLATFORMS=cuda,cpu python -m pytest "
                    "-m gpu tests/)")
    return devs[0]


@pytest.mark.gpu
def test_iso_forward_and_int8_gradient_match_cpu(gpu):
    from jets_tpu.ops.wave import wave_propagator

    grid = (48, 40, 64)
    kw = cs.wave_geometry(grid, 60)
    fwd = jax.jit(lambda op, m: op(m))
    grad = jax.jit(lambda op, m, r: op.linearize(m).H(r))
    F = wave_propagator(grid, store_adjoint="int8", dtype=jnp.float32, **kw)
    c = jax.device_put(cs.velocity(grid), gpu)
    d = fwd(F, c)
    r = fwd(F, 1.02 * c) - d
    g = grad(F, c, r)
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        Fc = wave_propagator(grid, dtype=jnp.float64, **kw)
        cc = jnp.asarray(np.asarray(c, np.float64))
        dc = fwd(Fc, cc)
        gc = grad(Fc, cc, jnp.asarray(np.asarray(r, np.float64)))
    cs.assert_live("traces", dc)
    assert cs.rel_err(d, dc) < 1e-4
    assert cs.cosine(g, gc) > 0.999


@pytest.mark.gpu
def test_flagship_forward_adjoint_match_reference(gpu):
    from jets_tpu.models.seismic import make_seismic_problem

    with jax.default_device(gpu):
        A, m, d = make_seismic_problem((256, 256), 8, 1024, noise=0.05,
                                       dtype=jnp.float32)
        fm, ad = A(m), A.H(d)
    ref = cs.FlagshipReference.of(A)
    assert cs.rel_err(fm, ref.forward(np.asarray(m))) < 1e-5
    assert cs.rel_err(ad, ref.adjoint(np.asarray(d))) < 1e-5
