"""The small helpers around the main path: the compile-cache location,
the pytree dataclass that replaces flax.struct, chip_smoke.py's checks,
and the imports a CLI run pulls in."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
from merging_gym_tpu.utils import compile_cache, struct

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cache_config():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_respects_the_environment(monkeypatch, cache_config):
    jax.config.update("jax_compilation_cache_dir", None)
    monkeypatch.setenv(compile_cache.ENV_VAR, "/some/where")
    assert compile_cache.enable() == "/some/where"
    assert jax.config.jax_compilation_cache_dir is None


def test_compile_cache_default_is_fixed_and_ignored(monkeypatch,
                                                    cache_config):
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    path = compile_cache.enable()
    assert path == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


@struct.dataclass
class _Cfg:
    lr: float = 0.1
    hidden: tuple = struct.field(pytree_node=False, default=(4, 2))


@struct.dataclass
class _State:
    w: jax.Array
    cfg: _Cfg
    name: str = struct.field(pytree_node=False, default="s")


def _state():
    return _State(w=jnp.arange(3.0), cfg=_Cfg())


def test_struct_pytree_round_trip():
    s = _state()
    leaves, treedef = jax.tree.flatten(s)
    assert len(leaves) == 2                      # w and cfg.lr
    back = jax.tree.unflatten(treedef, leaves)
    assert isinstance(back, _State) and back.name == "s"
    np.testing.assert_array_equal(back.w, s.w)


def test_struct_static_fields_live_in_the_treedef():
    a, b = _state(), _state().replace(name="t")
    assert jax.tree.structure(a) != jax.tree.structure(b)
    c = _state().replace(cfg=_Cfg(hidden=(8, 2)))
    assert jax.tree.structure(a) != jax.tree.structure(c)
    assert jax.tree.structure(a) == jax.tree.structure(
        _state().replace(w=jnp.ones(3)))


def test_struct_is_frozen_and_replace_copies():
    s = _state()
    with pytest.raises(Exception):
        s.name = "x"
    t = s.replace(w=s.w + 1)
    np.testing.assert_array_equal(s.w, jnp.arange(3.0))
    np.testing.assert_array_equal(t.w, jnp.arange(1.0, 4.0))


def test_struct_under_jit_and_scan():
    traces = []

    @jax.jit
    def step(s):
        traces.append(1)
        return s.replace(w=s.w * s.cfg.lr)

    s = step(_state())
    s = step(s)
    assert len(traces) == 1                      # static fields hashable
    out, _ = jax.lax.scan(lambda c, _: (c.replace(w=c.w + 1), None),
                          _state(), None, length=4)
    np.testing.assert_allclose(out.w, jnp.arange(3.0) + 4)
    np.testing.assert_allclose(s.w, jnp.arange(3.0) * 0.01)


def _traj(T=3, N=5):
    rng = np.random.default_rng(0)
    got = {"obs": rng.normal(size=(T, 10, N)).astype(np.float32),
           "rewards": rng.normal(size=(T, 2, N)).astype(np.float32),
           "done": rng.random((T, N)) < 0.3,
           "winner": rng.integers(0, 3, (T, N)).astype(np.int32),
           "collision": rng.random((T, N)) < 0.1}
    want = dict(got, obs=np.swapaxes(got["obs"], 1, 2),
                rewards=np.swapaxes(got["rewards"], 1, 2))
    return got, want


@pytest.mark.parametrize("key,delta", [
    ("done", None), ("winner", None), ("collision", None),
    ("obs", 10 * chip_smoke.OBS_ATOL), ("rewards", 10 * chip_smoke.REWARD_ATOL),
])
def test_smoke_comparisons_reject_a_perturbed_input(key, delta):
    got, want = _traj()
    chip_smoke.compare_trajectories(got, want)     # unperturbed passes
    bad = np.array(got[key])
    if delta is None:
        bad[1, 2] = (~bad[1, 2]) if bad.dtype == bool else bad[1, 2] + 1
    else:
        bad[1, 0, 2] += delta
    with pytest.raises(chip_smoke.CheckFailed, match=key):
        chip_smoke.compare_trajectories(dict(got, **{key: bad}), want)


def test_smoke_counter_check_rejects_a_wrong_count():
    got, _ = _traj()
    cnt = chip_smoke.counters_of(got)
    chip_smoke.compare_counters(cnt, chip_smoke.counters_of(got))
    cnt = dict(cnt, wins2=cnt["wins2"] + (np.arange(5) == 3))
    with pytest.raises(chip_smoke.CheckFailed, match="wins2"):
        chip_smoke.compare_counters(cnt, chip_smoke.counters_of(got))


def test_smoke_main_refuses_a_cpu(capsys, cache_config):
    assert chip_smoke.main([]) == 1
    out, err = capsys.readouterr()
    assert '"ok"' not in out
    assert "needs 1 GPU" in err


@pytest.mark.parametrize("algo", ["dqn", "hdqn", "rainbow", "drqn"])
def test_cli_train_and_eval_import_no_optional_stack(algo, tmp_path):
    """A tiny ``cli train`` and ``cli eval`` import none of flax, orbax,
    gymnasium, pygame and torch: the main path needs JAX, optax and
    numpy only."""
    code = f"""
import json, sys
from merging_gym_tpu import cli
cli.main(["--cpu", "train", "--algo", "{algo}", "--num-envs", "8",
          "--chunk-steps", "5", "--max-chunks", "1",
          "--memory-capacity", "64", "--batch-size", "4",
          "--out", {str(tmp_path / "run")!r}])
cli.main(["--cpu", "eval", "--p1", "const:4", "--p2", "l0",
          "--episodes", "4", "--num-envs", "4"])
print(json.dumps(sorted(m for m in {chip_smoke.FORBIDDEN_MODULES!r}
                        if m in sys.modules)))
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, env=env, cwd=REPO)
    assert r.returncode == 0, r.stderr[-2000:]
    assert json.loads(r.stdout.strip().splitlines()[-1]) == []
