import os
import sys

# NOTE: no XLA_FLAGS here on purpose — smoke tests and benches must see the
# single real CPU device; only launch/dryrun.py forces 512 host devices.
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402

from repro.configs import get  # noqa: E402
from repro.models import model as M  # noqa: E402
from repro.verify import scenarios  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device (hand-written kernels); the "
        "test skips itself where torch sees none")


def make_batch(cfg, b=2, s=16, key=0):
    """A well-formed training batch for any assigned architecture family."""
    rng = jax.random.PRNGKey(key)
    ks = jax.random.split(rng, 4)
    batch = {
        "tokens": jax.random.randint(ks[0], (b, s), 0, cfg.vocab_size),
        "labels": jax.random.randint(ks[1], (b, s), 0, cfg.vocab_size),
    }
    if cfg.enc_dec:
        batch["frames"] = jax.random.normal(
            ks[2], (b, cfg.enc_seq, cfg.d_model), jnp.float32) * 0.02
    if cfg.frontend == "vision":
        batch["image_embeds"] = jax.random.normal(
            ks[3], (b, cfg.vision_tokens, cfg.d_model), jnp.float32) * 0.02
    return batch


@pytest.fixture(scope="session")
def smoke_params_cache():
    cache = {}

    def get_params(name):
        if name not in cache:
            cfg = get(name, smoke=True)
            cache[name] = (cfg, M.init_params(cfg, jax.random.PRNGKey(0)))
        return cache[name]
    return get_params


# --------------------------------------------------------------------------
# shared tiny-config worlds (repro.verify.scenarios — the same builders the
# conformance oracles use, so tests and oracles can never drift on setup)
# --------------------------------------------------------------------------

@pytest.fixture(scope="session")
def tiny_mlp():
    """Factory: (cfg, data, spec) for a CPU-sized paper-MLP experiment."""
    return scenarios.tiny_mlp


@pytest.fixture(scope="session")
def tiny_lm():
    """Factory: (cfg, plan, batch_fn, spec, params) on a smoke LM config."""
    return scenarios.tiny_lm


@pytest.fixture(scope="session")
def serve_world():
    """Factory: (cfg, params) for serving tests, cached per (arch, window,
    seed) across the whole session — param init used to be re-run per test."""
    cache = {}

    def get_world(arch="qwen2-1.5b", window=0, seed=0):
        key = (arch, window, seed)
        if key not in cache:
            cfg = scenarios.serve_cfg(arch, window)
            cache[key] = (cfg, scenarios.serve_params(cfg, seed))
        return cache[key]
    return get_world
