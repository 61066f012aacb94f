"""Shared reference state of the port's parity tests: the JAX
``smollm-135m.reduced()`` model and its ``LM.init(PRNGKey(0))`` weights,
built once per process."""

import functools

import jax

from repro import configs as jconfigs
from repro.models import build_model as jbuild_model


@functools.lru_cache(maxsize=1)
def reference_lm():
    """(JAX model, JAX params).  The init program is compiled without XLA's
    backend optimizations: on one core that takes ~3 s instead of ~30 s.
    The draws may differ from an optimized build in the last bits, which
    does not matter here — every test feeds the same tree to both
    packages."""
    jmodel = jbuild_model(jconfigs.get("smollm-135m").reduced())
    key = jax.random.PRNGKey(0)
    init = jax.jit(jmodel.init).lower(key).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    return jmodel, init(key)
