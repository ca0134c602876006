"""The main path imports and runs without the optional packages."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import importlib.abc, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("flax", "orbax", "gymnasium", "matplotlib"):
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, Block())
import jax, jax.numpy as jnp
from pdecontrolgym_jax.envs import TransportEnv, TransportConfig
from pdecontrolgym_jax.parallel.rollout import rollout
from pdecontrolgym_jax.agents.ppo import PPOConfig, PPOTrainer
from pdecontrolgym_jax.agents.sac import SACConfig, SACTrainer
from pdecontrolgym_jax.rewards.tuned import TunedReward1D
import pdecontrolgym_jax.utils

cfg = TransportConfig(T=0.02, dt=1e-3, dx=1 / 16, control_sample_rate=0.01)
env = TransportEnv(cfg, TunedReward1D(20))
(_, _), out = rollout(env, lambda o, k: jnp.zeros(o.shape[0]), 4, 3,
                      jax.random.key(0))
assert out.reward.shape == (3, 4)
ppo = PPOTrainer(env, PPOConfig(num_envs=4, num_steps=4, num_minibatches=2,
                                num_epochs=1, hidden=(8, 8)))
r, m = jax.jit(ppo.make_train_step())(ppo.init(jax.random.key(0)))
sac = SACTrainer(env, SACConfig(num_envs=4, buffer_size=64, batch_size=8,
                                steps_per_iter=2, updates_per_iter=1,
                                hidden=(8, 8)))
r, m = jax.jit(sac.make_train_step())(sac.init(jax.random.key(0)))
print("ok")
"""


def _blocked_run(code):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=600)


def test_main_path_without_optional_packages():
    p = _blocked_run(_SCRIPT)
    assert p.returncode == 0, p.stderr[-3000:]
    assert p.stdout.strip().endswith("ok")


def test_checkpoint_io_names_missing_package():
    code = _SCRIPT.split("import jax,")[0] + (
        "from pdecontrolgym_jax.utils import save_params\n"
        "try:\n    save_params('/nonexistent/x.msgpack', {})\n"
        "except ImportError as e:\n    print('ImportError:', e)\n"
    )
    p = _blocked_run(code)
    assert p.returncode == 0, p.stderr[-3000:]
    assert "ImportError:" in p.stdout and "flax" in p.stdout
