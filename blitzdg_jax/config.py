"""Framework-wide numerical and compilation configuration.

Default-precision float32 matmuls may run in reduced precision (TF32 on the
GPU's tensor cores, about three decimal digits), which is catastrophic for
spectral DG operators: O(1e-3) perturbations riding on O(10) states are
lost. All hot operators therefore run their matmuls under an explicit
precision scope, default ``"highest"`` (full float32). ``"high"`` (three
reduced-precision passes, close to float32) may be set where accuracy
tolerances allow; ``"default"`` is unusable for shallow-water rollouts.
"""
from __future__ import annotations

import contextlib
import os
from pathlib import Path

import jax

_MATMUL_PRECISION = "highest"


def set_matmul_precision(p: str) -> None:
    global _MATMUL_PRECISION
    _MATMUL_PRECISION = p


def matmul_precision() -> str:
    return _MATMUL_PRECISION


def precision_scope():
    """Context manager pinning jnp matmul precision for DG operators."""
    if _MATMUL_PRECISION == "default":
        return contextlib.nullcontext()
    return jax.default_matmul_precision(_MATMUL_PRECISION)


def dg_op(fn):
    """Decorator: run a DG operator under the framework matmul-precision
    scope (see module docstring). Applied to every hot RHS/operator."""
    import functools

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with precision_scope():
            return fn(*args, **kwargs)

    return wrapped


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    nothing is changed here. Otherwise the cache is ``.jax_cache`` at the
    root of the checkout this package is imported from.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = str(Path(__file__).resolve().parent.parent / ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


# ---------------------------------------------------------------------------
# Namelist configuration files (reference ins2d analog)
# ---------------------------------------------------------------------------

def read_namelist(path: str) -> dict:
    """Parse a KEY = value namelist file: '#' comments, blank lines ignored,
    keys upper-cased (reference src/ins2d/main.cpp:58-102 format). Values
    are returned as str; use typed accessors or cast at the call site."""
    config = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = [p.strip() for p in line.split("=")]
            if len(parts) != 2:
                raise ValueError(f"cannot parse namelist line: {line!r}")
            config[parts[0].upper()] = parts[1]
    return config


def namelist_get(config: dict, key: str, cast=str, default=None):
    """Typed accessor with optional default."""
    k = key.upper()
    if k not in config:
        if default is not None:
            return default
        raise KeyError(f"missing namelist key {k}")
    return cast(config[k])
