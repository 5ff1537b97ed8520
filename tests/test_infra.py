"""Package infrastructure: the pytree dataclass helper, the compile-cache
location, and the GPU-only guard of chip_smoke.py."""
import os
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from blitzdg_jax import struct
from blitzdg_jax.config import enable_compile_cache

ROOT = pathlib.Path(__file__).resolve().parent.parent


@struct.dataclass
class _Point:
    x: jnp.ndarray
    n: int = struct.field(static=True)
    tag: str = struct.field(static=True, default="a")
    y: jnp.ndarray | None = None


def test_struct_flatten_unflatten_roundtrip():
    p = _Point(x=jnp.arange(3.0), n=2, y=jnp.ones(2))
    leaves, treedef = jax.tree_util.tree_flatten(p)
    assert len(leaves) == 2  # x and y; statics live in the treedef
    q = jax.tree_util.tree_unflatten(treedef, leaves)
    assert q.n == 2 and q.tag == "a"
    np.testing.assert_array_equal(q.x, p.x)
    doubled = jax.tree.map(lambda a: 2 * a, p)
    assert doubled.n == 2
    np.testing.assert_array_equal(doubled.y, 2 * np.ones(2))


def test_struct_none_field_is_empty_subtree():
    p = _Point(x=jnp.zeros(1), n=1)
    assert len(jax.tree_util.tree_leaves(p)) == 1


def test_struct_statics_key_the_jit_cache():
    traces = []

    @jax.jit
    def f(p):
        traces.append(p.n)
        return p.x * p.n

    f(_Point(x=jnp.ones(2), n=3))
    f(_Point(x=jnp.zeros(2), n=3))  # equal statics: cache hit
    assert traces == [3]
    out = f(_Point(x=jnp.ones(2), n=4))  # new static: retrace
    assert traces == [3, 4]
    np.testing.assert_array_equal(out, 4 * np.ones(2))


def test_struct_frozen_and_replace():
    p = _Point(x=jnp.ones(1), n=1)
    with pytest.raises(Exception):
        p.n = 2
    q = p.replace(n=5, tag="b")
    assert (q.n, q.tag, p.n) == (5, "b", 1)


@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_honours_env(monkeypatch, restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/where")
    before = jax.config.jax_compilation_cache_dir
    assert enable_compile_cache() == "/some/where"
    assert jax.config.jax_compilation_cache_dir == before  # nothing set


def test_compile_cache_defaults_to_checkout(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = enable_compile_cache()
    assert path == str(ROOT / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path


@pytest.fixture
def chip_smoke(monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke

    return chip_smoke


def test_chip_smoke_refuses_cpu(chip_smoke):
    with pytest.raises(SystemExit) as exc:
        chip_smoke.require_gpu(jax.devices())
    assert exc.value.code != 0


def test_chip_smoke_main_fails_without_gpu_and_prints_no_result(
        chip_smoke, capsys):
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert exc.value.code != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out and "FAIL" in out


def test_chip_smoke_alone_fails(tmp_path):
    """Copied into a directory without the package, the script exits
    non-zero before printing any result."""
    import shutil
    import subprocess

    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.parametrize("phase,kwargs", [
    ("phase_headline", dict(B=4, iters=3)),
    ("phase_large_mesh", dict(batch=2, cells=4, long_steps=32)),
    ("phase_elliptic", dict(cells=4)),
    ("phase_curved", dict(batch=4, iters=3)),
])
def test_chip_smoke_phase_rehearsal(chip_smoke, monkeypatch, phase, kwargs):
    """Each one-card phase of chip_smoke.py runs to its end at a tiny size
    on the CPU backend (the TF32 trajectory leg exists only on the GPU)."""
    monkeypatch.setattr(chip_smoke, "TRAJ_ALGOS",
                        chip_smoke.TRAJ_ALGOS[:1])
    getattr(chip_smoke, phase)(**kwargs)


def test_chip_smoke_sharded_rehearsal(chip_smoke):
    """The four-card phase on four virtual CPU devices: every sharded
    result lands on all four devices and matches its one-device result."""
    chip_smoke.phase_sharded(jax.devices()[:4], batch=8, cells=4)


def test_struct_equal_contexts_share_a_jit_cache_entry():
    """Two DG contexts built separately from equal meshes have equal
    statics, so a jitted function traces once for both."""
    from blitzdg_jax.mesh import box_triangles
    from blitzdg_jax.specgrid.triangle import build_triangle_context

    a, b = (build_triangle_context(2, box_triangles(2, 2)) for _ in range(2))
    traces = []

    @jax.jit
    def f(ctx):
        traces.append(ctx.n_p)
        return jnp.sum(ctx.x)

    f(a)
    f(b)
    assert traces == [a.n_p]


def test_graft_entry_forward_step():
    import __graft_entry__ as g

    fn, args = g.entry()
    out = jax.jit(fn)(*args)
    assert [o.shape for o in out] == [a.shape for a in args]
    assert all(np.all(np.isfinite(np.asarray(o))) for o in out)


@pytest.mark.parametrize("n_devices", [4, 8])
def test_graft_dryrun_multichip(n_devices, monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT))
    import __graft_entry__ as g

    g.dryrun_multichip(n_devices)


def test_bench_refuses_cpu(chip_smoke, monkeypatch, capsys):
    """bench.py exits non-zero without a GPU and prints no result line."""
    monkeypatch.setattr(chip_smoke, "log", chip_smoke.log)
    import bench

    with pytest.raises(SystemExit) as exc:
        bench.main()
    assert exc.value.code != 0
    assert '"metric"' not in capsys.readouterr().out


@pytest.mark.parametrize("name,marker", [
    ("highest", "precision = [HIGHEST, HIGHEST]"),
    ("F32_F32_F32", "lhs_precision_type = f32, rhs_precision_type = f32"),
])
def test_set_matmul_precision_reaches_dg_op_dots(name, marker):
    """`config.set_matmul_precision` decides the precision (or dot
    algorithm) of every matmul a DG operator lowers to."""
    from blitzdg_jax import config
    from blitzdg_jax.mesh import box_triangles
    from blitzdg_jax.ops.sw2d import SWPhysics, SWState, sw2d_rhs
    from blitzdg_jax.specgrid.triangle import build_triangle_context

    ctx = build_triangle_context(1, box_triangles(2, 2), dtype=jnp.float32)
    h = jnp.full_like(ctx.x, 10.0)
    state = SWState(h=h, hu=0 * h, hv=0 * h)
    config.set_matmul_precision(name)
    try:
        text = jax.jit(lambda s: sw2d_rhs(ctx, s, 0.0, SWPhysics())).lower(
            state).as_text()
    finally:
        config.set_matmul_precision("highest")
    dots = [ln for ln in text.splitlines() if "dot_general" in ln]
    assert dots and all(marker in ln for ln in dots)
