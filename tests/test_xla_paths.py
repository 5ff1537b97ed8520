"""The plain XLA paths that carry the large-mesh, curved and sharded
workloads: `ssprk2_step` over `sw2d_rhs` under `lax.scan`, `solve_mpc` /
`solve_mpc_gn`, and the ppermute-halo rollout.

Checked against the from-the-book x64 oracle (tests/oracle/sw2d_oracle.py)
on in-repo meshes, against central finite differences for the adjoint,
against the gather RHS for the dense-trace RHS, against one device for the
scenario- and element-sharded gradients, and for lake-at-rest balance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from blitzdg_jax.context import BC_OUT
from blitzdg_jax.mesh import box_quads, box_triangles, disk_triangles
from blitzdg_jax.mpc import MPCProblem, mpc_cost, solve_mpc, solve_mpc_gn
from blitzdg_jax.ops.sw2d import (SWPhysics, SWState, apply_filter, sw2d_rhs,
                                  sw2d_timestep)
from blitzdg_jax.ops.sw2d_dense import build_dense_trace_ops, sw2d_rhs_dense
from blitzdg_jax.specgrid.quad import build_quad_context
from blitzdg_jax.specgrid.triangle import build_triangle_context
from blitzdg_jax.timestepping import ssprk2_step
from oracle import sw2d_oracle


@pytest.mark.parametrize("mesh_fn,n_order,steps", [
    (lambda: box_triangles(4, 4), 1, 40),
    (lambda: box_triangles(3, 5), 3, 15),
    (lambda: disk_triangles(3), 2, 20),
    (lambda: box_triangles(2, 3), 4, 10),
    (lambda: box_triangles(2, 2), 5, 6),
])
def test_rollout_matches_x64_oracle(mesh_fn, n_order, steps):
    """sw2d-simple configuration (wall BCs, adaptive dt, modal filter on
    every RHS) on in-repo meshes: the XLA scan equals the oracle to 1e-9."""
    mesh = mesh_fn()
    ctx = build_triangle_context(n_order, mesh, filter_cutoff=0.9 * n_order,
                                 filter_order=n_order)
    o = sw2d_oracle.Sw2dOracle(np.asarray(mesh.verts), np.asarray(mesh.etov),
                               n_order)
    np.testing.assert_allclose(np.asarray(ctx.x), o.x.T, atol=1e-12)
    filt = sw2d_oracle.filter_2d(n_order, o.V, 0.9 * n_order, n_order)
    g, cfl = 9.81, 0.65

    eta = jnp.exp(-10.0 * ctx.x ** 2 - 10.0 * ctx.y ** 2)
    state = SWState(h=10.0 + eta, hu=0.1 * eta, hv=-0.05 * eta)
    phys = SWPhysics(g=g)

    def body(carry, _):
        s, t = carry
        dt = sw2d_timestep(ctx, s, g, cfl)
        s = ssprk2_step(lambda ss, tt: sw2d_rhs(ctx, ss, tt, phys), s, t, dt,
                        post_stage=lambda f: apply_filter(ctx, f))
        return (s, t + dt), None

    (out, t), _ = jax.jit(lambda s: jax.lax.scan(
        body, (s, 0.0), None, length=steps))(state)

    h, hu, hv = (np.asarray(f).T for f in state)
    t_o = 0.0
    for _ in range(steps):
        dt = sw2d_oracle.timestep(o, h, hu, hv, g, cfl)
        k = [filt @ r for r in sw2d_oracle.sw2d_rhs(o, h, hu, hv, g)]
        h1, hu1, hv1 = (a + 0.5 * dt * b for a, b in zip((h, hu, hv), k))
        k = [filt @ r for r in sw2d_oracle.sw2d_rhs(o, h1, hu1, hv1, g)]
        h, hu, hv = (a + dt * b for a, b in zip((h, hu, hv), k))
        t_o += dt
    np.testing.assert_allclose(float(t), t_o, rtol=1e-10)
    for got, want in zip(out, (h, hu, hv)):
        np.testing.assert_allclose(np.asarray(got), want.T, atol=1e-9)


def _open_east(mesh):
    """Mark the wall faces on the east edge (x = max) as tidal BC_OUT."""
    bc = np.asarray(mesh.bc_type).copy()
    mids = 0.5 * (mesh.verts[mesh.etov]
                  + mesh.verts[np.roll(mesh.etov, -1, axis=1)])
    xmax = float(mesh.verts[:, 0].max())
    bc[(bc > 0) & (np.abs(mids[:, :, 0] - xmax) < 1e-9)] = BC_OUT
    mesh.set_bc_type(bc)
    return mesh


def _tide(t):
    return 12.0 + 0.2 * jnp.cos(2.0 * t) * jnp.minimum(t / 0.02, 1.0)


def _physics(ctx, variant):
    """Shallow-water physics of one configuration: 'flat', 'bathymetry'
    (well-balanced shelf), 'tidal' (flat, BC_OUT tide), 'drag_coriolis',
    or 'coastal' (all of them)."""
    kw = {}
    if variant in ("bathymetry", "coastal"):
        # shelf reaching the tide's mean depth on the open east edge x = 1
        H = 8.0 + 2.0 * (ctx.x + 1.0) + 0.5 * (1.0 - ctx.x) * jnp.sin(ctx.y)
        Hx, Hy = ctx.grad(H)
        kw.update(H=H, Hx=Hx, Hy=Hy)
    if variant in ("drag_coriolis", "coastal"):
        kw.update(cd=2.5e-3, f_cor=1e-4)
    tide = _tide if variant in ("tidal", "coastal") else None
    return SWPhysics(g=9.81, **kw), tide


def _coastal_problem(variant):
    mesh = box_triangles(3, 3)
    if variant in ("tidal", "coastal"):
        _open_east(mesh)
    ctx = build_triangle_context(1, mesh, filter_cutoff=0.9, filter_order=1)
    phys, tide = _physics(ctx, variant)
    H = phys.H if phys.H is not None else 12.0 + 0.0 * ctx.x
    rhs_fn = None
    if tide is not None:
        rhs_fn = lambda s, t: sw2d_rhs(ctx, s, t, phys, tidal_forcing=tide)  # noqa
    prob = MPCProblem(ctx=ctx, phys=phys, dt=2e-3, horizon=3,
                      steps_per_control=2, q_eta=0.5, q_terminal=1.0,
                      r_control=1e-6, rhs_fn=rhs_fn)
    bump = jnp.exp(-8.0 * (ctx.x ** 2 + ctx.y ** 2))

    def forcing(c, control, state, t):
        return jnp.zeros_like(state.h), control[0] * bump, control[1] * bump

    state0 = SWState(h=H, hu=jnp.zeros_like(H), hv=jnp.zeros_like(H))
    target = 1e-2 * jnp.exp(-5.0 * ((ctx.x - 0.2) ** 2 + ctx.y ** 2))
    return prob, forcing, state0, target, H


@pytest.mark.parametrize("variant",
                         ["flat", "tidal", "drag_coriolis", "coastal"])
def test_mpc_cost_adjoint_matches_finite_differences(variant):
    """Reverse-mode gradient of the shooting cost (through the remat'd
    scan) equals central differences in x64, from flat to full coastal
    (bathymetry, drag, Coriolis, tidal BC_OUT)."""
    prob, forcing, state0, target, H = _coastal_problem(variant)
    cost = jax.jit(lambda c: mpc_cost(prob, state0, c, target, forcing, H))
    c0 = 0.3 * jax.random.normal(jax.random.PRNGKey(1), (prob.horizon, 2),
                                 jnp.float64)
    g = np.asarray(jax.grad(cost)(c0))
    eps = 1e-5
    fd = np.zeros_like(g)
    for idx in np.ndindex(*g.shape):
        e = np.zeros(g.shape)
        e[idx] = eps
        fd[idx] = (float(cost(c0 + e)) - float(cost(c0 - e))) / (2 * eps)
    np.testing.assert_allclose(g, fd, rtol=1e-5, atol=1e-9 * np.abs(g).max())


@pytest.mark.parametrize("variant",
                         ["flat", "bathymetry", "tidal", "drag_coriolis"])
def test_dense_rhs_matches_gather_rhs_batched(variant):
    """The dense-trace RHS on a scenario batch equals the gather RHS
    vmapped over it, for each physics term on its own."""
    mesh = box_triangles(3, 4)
    if variant == "tidal":
        _open_east(mesh)
    ctx = build_triangle_context(1, mesh)
    phys, tide = _physics(ctx, variant)
    base = phys.H if phys.H is not None else 12.0 + 0.0 * ctx.x
    scale = jnp.linspace(0.5, 1.5, 3)[:, None, None]
    bump = jnp.exp(-5.0 * (ctx.x ** 2 + ctx.y ** 2))
    states = SWState(h=base + 0.3 * scale * bump, hu=0.2 * scale * bump,
                     hv=-0.1 * scale * bump)
    out = sw2d_rhs_dense(ctx, build_dense_trace_ops(ctx), states, 0.3, phys,
                         tidal_forcing=tide)
    ref = jax.vmap(lambda s: sw2d_rhs(ctx, s, 0.3, phys,
                                      tidal_forcing=tide))(states)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-11,
                                   atol=1e-11)


@pytest.mark.parametrize("kind,n_order", [
    ("triangles", 3), ("triangles", 4), ("quads", 2), ("quads", 3),
    ("dense", 3),
])
def test_lake_at_rest_over_discontinuous_bathymetry(kind, n_order):
    """h = H with zero momentum over bathymetry that jumps across faces is
    a steady state of the well-balanced RHS on triangles, quads and the
    dense-trace path."""
    if kind == "quads":
        ctx = build_quad_context(n_order, box_quads(4, 3))
    else:
        ctx = build_triangle_context(n_order, box_triangles(4, 3))
    rng = np.random.default_rng(n_order)
    H = 10.0 + 2.0 * jnp.abs(ctx.x) + jnp.asarray(
        rng.uniform(0.0, 4.0, size=(ctx.k_elem, 1)))
    Hx, Hy = ctx.grad(H)
    phys = SWPhysics(g=9.81, H=H, Hx=Hx, Hy=Hy)
    rest = SWState(h=H, hu=jnp.zeros_like(H), hv=jnp.zeros_like(H))
    if kind == "dense":
        r = sw2d_rhs_dense(ctx, build_dense_trace_ops(ctx), rest, 0.0, phys)
    else:
        r = sw2d_rhs(ctx, rest, 0.0, phys)
    scale = float(9.81 * jnp.max(H) * jnp.max(jnp.abs(H)))
    for f in r:
        assert float(jnp.max(jnp.abs(f))) < 1e-12 * scale


@pytest.mark.parametrize("ndev", [2, 4, 8])
def test_scenario_sharded_mpc_value_and_grad_matches_single(ndev):
    """Scenario-sharded value-and-gradient of the batched coastal shooting
    cost: every shard lands on its own device and the result equals the
    one-device result."""
    prob, forcing, state0, _, H = _coastal_problem("coastal")
    ctx, batch = prob.ctx, 8
    states = jax.tree.map(lambda a: jnp.broadcast_to(a, (batch,) + a.shape),
                          state0)
    targets = jax.vmap(lambda o: 1e-2 * jnp.exp(
        -5.0 * ((ctx.x - o) ** 2 + ctx.y ** 2)))(jnp.linspace(-0.3, 0.3,
                                                               batch))
    ctrls = 0.3 * jax.random.normal(jax.random.PRNGKey(4),
                                    (batch, prob.horizon, 2), jnp.float64)

    def loss(c, s, tg):
        return jnp.sum(jax.vmap(lambda cc, ss, tt: mpc_cost(
            prob, ss, cc, tt, forcing, H))(c, s, tg))

    vg = jax.jit(jax.value_and_grad(loss))
    v1, g1 = vg(ctrls, states, targets)
    mesh = Mesh(np.array(jax.devices()[:ndev]), ("scenario",))
    args = jax.tree.map(lambda a: jax.device_put(a, NamedSharding(
        mesh, P("scenario", *([None] * (a.ndim - 1))))),
        (ctrls, states, targets))
    v, g = vg(*args)
    assert {s.device for s in g.addressable_shards} == set(mesh.devices.flat)
    np.testing.assert_allclose(float(v), float(v1), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(g), np.asarray(g1), rtol=1e-10,
                               atol=1e-14)


@pytest.mark.parametrize("variant,ndev", [
    ("flat", 4), ("coastal", 4), ("coastal", 2),
])
def test_halo_control_gradient_matches_single(variant, ndev):
    """The gradient of a terminal-momentum cost w.r.t. a control sequence,
    taken through the element-sharded ppermute-halo rollout, equals the
    single-device gradient, flat and full coastal (tidal BC_OUT)."""
    from blitzdg_jax.parallel import (build_halo_plan, context_shard_specs,
                                      halo_sw2d_rhs, halo_tables,
                                      partition_mesh)

    mesh = box_triangles(4, 4)
    if variant == "coastal":
        _open_east(mesh)
    mesh, _, _ = partition_mesh(mesh, ndev)
    ctx = build_triangle_context(1, mesh, filter_cutoff=0.9, filter_order=1)
    phys, tide = _physics(ctx, variant)
    plan = build_halo_plan(ctx, ndev)
    tables = halo_tables(plan)
    tgt = 0.01 * jnp.exp(-4.0 * ((ctx.x - 0.3) ** 2 + ctx.y ** 2))
    dt = 1e-3

    def run(c, ph, tb, cs, tgt, rhs_of):
        bump = jnp.exp(-8.0 * (c.x ** 2 + c.y ** 2))
        h = ph.H if ph.H is not None else jnp.full_like(c.x, 12.0)
        s = SWState(h=h, hu=jnp.zeros_like(h), hv=jnp.zeros_like(h))

        def body(s, ctrl):
            def rhs(ss, t):
                r = rhs_of(c, ss, t, ph, tb)
                return r._replace(hu=r.hu + ctrl[0] * bump,
                                  hv=r.hv + ctrl[1] * bump)
            return ssprk2_step(rhs, s, 0.0, dt,
                               post_stage=lambda f: apply_filter(c, f)), None

        return jnp.sum((jax.lax.scan(body, s, cs)[0].hu - tgt) ** 2)

    single = lambda cs: run(  # noqa: E731
        ctx, phys, None, cs, tgt,
        lambda c, s, t, ph, tb: sw2d_rhs(c, s, t, ph, tidal_forcing=tide))
    el_mesh = Mesh(np.array(jax.devices()[:ndev]), ("element",))
    el2 = P("element", None)
    tb_specs = tuple(P("element", *([None] * (a.ndim - 1))) for a in tables)
    sharded_loss = jax.shard_map(
        lambda c, ph, tb, cs, tg: jax.lax.psum(run(
            c, ph, tb, cs, tg,
            lambda c_, s, t, ph_, tb_: halo_sw2d_rhs(
                c_, s, t, ph_, tb_, plan, tidal_forcing=tide)),
            "element"),
        mesh=el_mesh,
        in_specs=(context_shard_specs(ctx), jax.tree.map(lambda a: el2, phys),
                  tb_specs, P(), el2),
        out_specs=P())
    sharded = lambda cs: sharded_loss(ctx, phys, tables, cs, tgt)  # noqa

    cs = 0.5 * jax.random.normal(jax.random.PRNGKey(2), (4, 2), jnp.float64)
    np.testing.assert_allclose(float(jax.jit(sharded)(cs)),
                               float(jax.jit(single)(cs)), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(jax.jit(jax.grad(sharded))(cs)),
                               np.asarray(jax.jit(jax.grad(single))(cs)),
                               rtol=1e-9, atol=1e-15)


def _curved_problem():
    from blitzdg_jax.mesh.curved import (circle_projection,
                                         gordon_hall_deform,
                                         snap_boundary_vertices)
    from blitzdg_jax.ops.sw2d_curved import SWStateTracer, sw2d_curved_rhs
    from blitzdg_jax.specgrid.cubature import (build_cubature_context,
                                               build_gauss_face_context)

    n = 2
    mesh = disk_triangles(2, radius=1.0)
    proj = circle_projection(0.0, 0.0, 1.0)
    cf = snap_boundary_vertices(mesh, proj, tol=0.3)
    c0 = build_triangle_context(n, mesh, dtype=None)
    x2, y2, _ = gordon_hall_deform(n, mesh, c0.x, c0.y, cf, proj)
    ctx = build_triangle_context(n, mesh, coords=(x2, y2),
                                 filter_cutoff=0.9 * n, filter_order=4)
    cub = build_cubature_context(n, mesh, x2, y2, c0.V)
    gauss = build_gauss_face_context(n, mesh, x2, y2, c0.V)
    phys = SWPhysics(g=9.81)
    prob = MPCProblem(ctx=ctx, phys=phys, dt=2e-3, horizon=3,
                      steps_per_control=2, q_eta=0.0, q_terminal=1.0,
                      r_control=1e-16,
                      rhs_fn=lambda s, t: sw2d_curved_rhs(ctx, cub, gauss, s,
                                                          t, phys))
    bump = jnp.exp(-8.0 * (ctx.x ** 2 + ctx.y ** 2))

    def forcing(c, control, s, t):
        return jnp.zeros_like(s.h), control[0] * bump, control[1] * bump

    h = jnp.ones_like(ctx.x)
    s0 = SWStateTracer(h=h, hu=0 * h, hv=0 * h, hN=0 * h)
    # reachable target: the elevation a known control sequence produces
    from blitzdg_jax.mpc import rollout_controls

    c_true = jnp.tile(jnp.array([[0.5, -0.3]]), (prob.horizon, 1))
    final, _ = rollout_controls(prob, s0, c_true, forcing)
    return prob, forcing, s0, final.h - 1.0


@pytest.fixture(scope="module")
def curved_problem():
    return _curved_problem()


def test_curved_mpc_adam_reduces_cost(curved_problem):
    prob, forcing, s0, target = curved_problem
    sol = jax.jit(lambda s, tg: solve_mpc(
        prob, s, tg, forcing, 2, iters=40, learning_rate=0.1,
        H_rest=1.0))(s0, target)
    hist = np.asarray(sol.cost_history)
    assert np.all(np.isfinite(hist))
    assert float(sol.cost) < 0.1 * hist[0]


def test_curved_mpc_gauss_newton_converges(curved_problem):
    prob, forcing, s0, target = curved_problem
    sol = jax.jit(lambda s, tg: solve_mpc_gn(
        prob, s, tg, forcing, 2, gn_iters=3, cg_iters=6,
        H_rest=1.0))(s0, target)
    c0 = float(mpc_cost(prob, s0, jnp.zeros((prob.horizon, 2)), target,
                        forcing, 1.0))
    assert np.isfinite(float(sol.cost))
    assert float(sol.cost) < 1e-3 * c0
    assert np.all(np.diff(np.asarray(sol.cost_history)) <= 0)
