"""Observability/robustness utilities tests."""
import jax.numpy as jnp
import numpy as np

from blitzdg_jax.context import BC_OUT
from blitzdg_jax.mesh import box_triangles
from blitzdg_jax.specgrid.triangle import build_triangle_context
from blitzdg_jax.utils import (
    StepTimer,
    build_sponge_coefficient,
    checked_update,
    instability_guard,
)


def test_instability_guard():
    ok = jnp.ones((4, 4))
    assert not bool(instability_guard(ok))
    assert bool(instability_guard(ok * jnp.inf))
    assert bool(instability_guard(ok.at[0, 0].set(jnp.nan)))
    assert bool(instability_guard(ok * 1e9))


def test_checked_update_freezes_on_blowup():
    old = {"u": jnp.ones(3)}
    good = {"u": 2 * jnp.ones(3)}
    bad = {"u": jnp.array([1.0, jnp.nan, 3.0])}
    out, flag = checked_update(good, old)
    assert not bool(flag)
    np.testing.assert_allclose(np.asarray(out["u"]), 2.0)
    out, flag = checked_update(bad, old)
    assert bool(flag)
    np.testing.assert_allclose(np.asarray(out["u"]), 1.0)


def test_sponge_coefficient_ramp():
    ctx = build_triangle_context(2, box_triangles(4, 4))
    bc = np.asarray(ctx.bc_table)
    # mark east boundary faces as open
    mask = np.zeros((ctx.k_elem, ctx.n_faces * ctx.n_fp), dtype=bool)
    vm = np.asarray(ctx.vmapM)
    xf = np.asarray(ctx.x).reshape(-1)[vm]
    mask[(xf > 1.0 - 1e-9)] = True
    sponge = np.asarray(build_sponge_coefficient(ctx, mask, width=0.5, strength=2.0))
    x = np.asarray(ctx.x)
    # max at the open boundary, zero far away
    assert sponge[x > 0.999].min() > 1.9
    assert np.allclose(sponge[x < 0.4], 0.0)
    assert sponge.max() <= 2.0 + 1e-12


def test_step_timer():
    t = StepTimer()
    with t.measure():
        pass
    assert len(t.times) == 1
    assert "mean" in t.summary()
