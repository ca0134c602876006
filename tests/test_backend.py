"""The backend resolver, the interval kernel's wrapper, the compile-cache
helper, the pytree dataclass and the chip smoke script's refusal on the
CPU."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from pdecontrolgym_jax.core import pytree
from pdecontrolgym_jax.envs.common import Boundary1DConfig
from pdecontrolgym_jax.envs.reaction_diffusion import (
    ReactionDiffusionConfig,
    ReactionDiffusionEnv,
)
from pdecontrolgym_jax.envs.transport import TransportEnv
from pdecontrolgym_jax.ops import backend as be
from pdecontrolgym_jax.ops import pallas1d
from pdecontrolgym_jax.rewards.tuned import TunedReward1D

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _transport(backend, dx=1.0 / 128, **kw):
    cfg = Boundary1DConfig(T=0.05, dt=1e-4, X=1.0, dx=dx,
                           control_sample_rate=0.01, backend=backend, **kw)
    return TransportEnv(cfg, TunedReward1D(500, -1e3, 3e2))


# -- resolver ----------------------------------------------------------------


def test_platform_cpu_picks_xla():
    assert be.platform() == "cpu"
    assert not be.use_kernel("auto", True)
    assert not _transport("auto")._uses_kernel()


def test_platform_gpu_picks_kernel(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert be.platform() == "gpu"
    assert be.use_kernel("auto", True)
    assert not be.use_kernel("auto", False)  # kernel lost to XLA there
    assert _transport("auto")._uses_kernel()
    assert not be.interpret_mode("pallas")  # compiled, never interpreted


@pytest.mark.parametrize("name", ["rocm", "metal", "xpu"])
def test_unknown_platform_raises(monkeypatch, name):
    monkeypatch.setattr(jax, "default_backend", lambda: name)
    with pytest.raises(RuntimeError, match="unsupported JAX platform"):
        be.platform()
    with pytest.raises(RuntimeError, match="unsupported JAX platform"):
        _transport("auto")._uses_kernel()


def test_backend_values():
    assert not be.use_kernel("xla", True)
    assert be.use_kernel("pallas", False) and be.use_kernel("interpret", False)
    assert be.interpret_mode("interpret")
    with pytest.raises(ValueError, match="backend must be one of"):
        be.use_kernel("fused", True)


def test_forced_pallas_on_cpu_refuses_instead_of_interpreting():
    env = _transport("pallas")
    keys = jax.random.split(jax.random.key(0), 4)
    state, _ = jax.vmap(env.init)(keys)
    with pytest.raises(RuntimeError, match="backend='interpret'"):
        env.step_batch(state, jnp.zeros(4))


def test_kernel_unsupported_configs_stay_on_xla(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    # rewards that need the previous row or a non-L2 ring: XLA path
    from pdecontrolgym_jax.rewards.norm import NormReward

    cfg = Boundary1DConfig(T=0.05, dt=1e-4, X=1.0, dx=1.0 / 128,
                           control_sample_rate=0.01)
    diff = TransportEnv(cfg, NormReward(nt=500, horizon="differential"))
    assert not diff._uses_kernel()
    inf = TransportEnv(cfg, NormReward(nt=500, horizon="t-horizon",
                                       norm="inf", t_horizon_length=5))
    assert not inf._uses_kernel()
    # implicit thomas/dense and normalized Neumann have no kernel body
    for solver in ("thomas", "dense"):
        rcfg = ReactionDiffusionConfig(
            T=0.02, dt=4e-4, X=1.0, dx=1.0 / 256, control_sample_rate=4e-3,
            scheme="implicit", theta=0.5, implicit_solver=solver)
        assert not ReactionDiffusionEnv(rcfg, TunedReward1D(50))._uses_kernel()
    ncfg = ReactionDiffusionConfig(T=0.01, dt=1e-5, dx=5e-3,
                                   control_sample_rate=1e-4,
                                   control_type="Neumann", normalize=True)
    assert not ReactionDiffusionEnv(ncfg, TunedReward1D(1000))._uses_kernel()


# -- the kernel wrapper ------------------------------------------------------


@pytest.mark.parametrize("state_dim,expect_np,expect_tb", [
    (128, 128, 16), (100, 128, 16), (257, 512, 4), (201, 256, 8), (2, 2, 1024),
])
def test_interval_fn_pads_to_power_of_two_tiles(state_dim, expect_np,
                                                 expect_tb):
    """The wrapper pads the state to a power-of-two column count and the
    batch to whole env tiles, and returns the caller's shapes."""
    spec = pallas1d.transport_spec(1e-3, 1.0 / state_dim, state_dim)
    fn = pallas1d.make_interval_fn(spec, sample_rate=3, nt=100,
                                   state_dim=state_dim, window=2,
                                   interpret=True)
    B = 5
    u = jnp.ones((B, state_dim), jnp.float32)
    jaxpr = jax.make_jaxpr(fn)(u, u, jnp.zeros((B, 1)),
                               jnp.zeros((B, 1), jnp.int32))
    calls = [e for e in jaxpr.jaxpr.eqns[0].params["jaxpr"].eqns
             if e.primitive.name == "pallas_call"]
    assert len(calls) == 1
    out_shapes = [v.aval.shape for v in calls[0].outvars]
    tb = -(-B // expect_tb) * expect_tb
    assert out_shapes[0] == (tb, expect_np)
    assert out_shapes[-1] == (2, tb, expect_np)  # the staging slots
    uo, norms, bsum, t = fn(u, u, jnp.zeros((B, 1)),
                            jnp.zeros((B, 1), jnp.int32))
    assert uo.shape == (B, state_dim) and norms.shape == (B, 2)
    assert bsum.shape == (B, 1) and t.shape == (B, 1)
    np.testing.assert_array_equal(np.asarray(t), 3)


def test_interval_fn_freezes_finished_envs():
    """Envs whose episode ends inside the interval stop at nt-1 and keep
    their state; their bsum counts only the executed sub-steps."""
    spec = pallas1d.transport_spec(1e-3, 1.0 / 16, 16)
    fn = pallas1d.make_interval_fn(spec, sample_rate=10, nt=20,
                                   state_dim=16, window=2, interpret=True)
    u = jnp.ones((3, 16), jnp.float32)
    t0 = jnp.asarray([[0], [15], [19]], jnp.int32)
    ctrl = jnp.full((3, 1), 0.5, jnp.float32)
    uo, _, bsum, t = fn(u, jnp.zeros_like(u), ctrl, t0)
    np.testing.assert_array_equal(np.asarray(t)[:, 0], [10, 19, 19])
    np.testing.assert_allclose(np.asarray(bsum)[:, 0], [5.0, 2.0, 0.0])
    np.testing.assert_array_equal(np.asarray(uo[2]), np.asarray(u[2]))


def test_kernel_spec_tiles():
    assert pallas1d.transport_spec(1e-4, 1 / 128, 128).tile_elems == 2048
    implicit = pallas1d.reaction_diffusion_implicit_spec(
        4e-4, 1 / 256, 257, 0.5, False)
    assert (implicit.tile_elems, implicit.num_warps) == (512, 8)


# -- compile cache -----------------------------------------------------------


def test_compile_cache_env_var_wins(monkeypatch, tmp_path):
    from pdecontrolgym_jax.utils import compile_cache as cc

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    assert cc.enable_compile_cache() == str(tmp_path)
    assert calls == []  # JAX reads the variable itself; nothing is set


def test_compile_cache_fixed_path_in_checkout(monkeypatch):
    from pdecontrolgym_jax.utils import compile_cache as cc

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    assert cc.enable_compile_cache() == os.path.join(REPO, ".jax_cache")
    assert calls == [("jax_compilation_cache_dir",
                      os.path.join(REPO, ".jax_cache"))]
    # the same path on every call: no time, process id or temp name in it
    assert cc.enable_compile_cache() == calls[0][1]
    # and none on the CPU
    monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
    assert cc.enable_compile_cache() is None


# -- pytree dataclass ----------------------------------------------------------


@pytree.dataclass
class _Pair:
    a: jnp.ndarray
    b: jnp.ndarray = None
    tag: str = pytree.field(pytree_node=False, default="x")


def test_pytree_dataclass_flatten_roundtrip():
    p = _Pair(jnp.arange(3.0), jnp.ones(2), tag="y")
    leaves, tree = jax.tree_util.tree_flatten(p)
    assert len(leaves) == 2
    q = jax.tree_util.tree_unflatten(tree, [2 * x for x in leaves])
    assert isinstance(q, _Pair) and q.tag == "y"
    np.testing.assert_array_equal(np.asarray(q.a), [0.0, 2.0, 4.0])
    # None children are empty subtrees
    assert len(jax.tree_util.tree_leaves(_Pair(jnp.zeros(1)))) == 1


def test_pytree_dataclass_static_field_and_replace():
    p = _Pair(jnp.zeros(2))
    r = p.replace(b=jnp.ones(2))
    assert p.b is None and r.b is not None and r.tag == "x"
    with pytest.raises(dataclasses.FrozenInstanceError):
        p.a = jnp.ones(2)
    # a static field is part of the treedef: changing it retraces
    traces = []

    @jax.jit
    def f(x):
        traces.append(x.tag)
        return x.a + 1

    f(p), f(p.replace(a=jnp.ones(2))), f(p.replace(tag="z"))
    assert traces == ["x", "z"]


# -- chip smoke ---------------------------------------------------------------


def test_chip_smoke_refuses_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout
    assert "no GPU" in p.stderr
